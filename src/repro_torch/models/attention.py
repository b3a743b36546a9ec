"""Attention: GQA (with optional QKV bias / sliding window) and MLA
(DeepSeek compressed-KV, absorbed decode path), the port's counterpart of
``repro.models.attention``.

Under a mesh whose ``model`` axis splits the config (``dist.tensor_parallel``),
``gqa_apply``, ``gqa_decode``, ``mla_apply`` and ``mla_decode`` are
per-rank code in the layout of the reference's anchors: this rank's
KV-head group (``"heads"``) or its block of query rows (``"rows"``), and
in decode its block of the cache (KV heads, ``head_dim``, the KV length,
or MLA's latent and rope dims), with the collectives that layout implies.
The hybrid's shared block and the enc-dec's attentions run through the
same functions (``_project``: a projection with a LoRA delta;
``decode_q``, ``decode_attend`` and ``decode_out``: a decode step's
pieces, which the enc-dec's cross-attention reuses).

Train/prefill attention has two implementations:

* ``full``    — materialized (S x S) scores; fine to 8k.
* ``chunked`` — online softmax over KV chunks: O(S x chunk) live memory.

GQA uses grouped einsums (no materialized KV repetition).  Every step
keeps the reference's order of roundings: the score einsum returns the
compute dtype and is rounded there before the cast to f32 and the scale,
the mask (``NEG_INF``) and the softmax are f32, and the probabilities are
cast back to the compute dtype before the second einsum.  So no fused
attention call stands in for these einsums.
"""
from __future__ import annotations

import types

import torch
from torch import nn

from repro_torch.dist import context as dist_context
from repro_torch.dist import tensor_parallel as tpar

from .modules import (apply_rope, linear, linear_init, rmsnorm,
                      rmsnorm_init, rope_angles, rope_freqs)

NEG_INF = -1e30


def _einsum(spec, a, b):
    """``jnp.einsum``'s promotion: both operands to their common dtype
    (an f32 query against a bf16 cache reads the cache in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(spec, a.to(dt), b.to(dt))


# ----------------------------------------------------------------------- GQA
def gqa_init(generator, cfg, dtype, device=None) -> nn.Module:
    """wq, wk, wv, wo, and the rotary inverse frequencies (a buffer on the
    params' device, so a decode step copies nothing from the host)."""
    h, kv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    kw = dict(dtype=dtype, device=device)
    p = nn.Module()
    p.wq = linear_init(generator, d, h * hd, bias=cfg.qkv_bias, **kw)
    p.wk = linear_init(generator, d, kv * hd, bias=cfg.qkv_bias, **kw)
    p.wv = linear_init(generator, d, kv * hd, bias=cfg.qkv_bias, **kw)
    p.wo = linear_init(generator, h * hd, d,
                       scale=(h * hd) ** -0.5 / (2 * cfg.num_layers) ** 0.5,
                       **kw)
    p.register_buffer("freqs", rope_freqs(hd, cfg.rope_theta, device),
                      persistent=False)
    return p


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _causal_mask(sq, skv, offset, window, device=None):
    """(sq, skv) bool mask; offset = absolute position of query row 0."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(skv, device=device)[None, :]
    m = qi >= kj
    if window is not None:
        m = m & (qi - kj < window)
    return m


def _full_attn(q, k, v, mask):
    """q: (B,Sq,KV,G,hd)  k,v: (B,Skv,KV,hd)  mask: (Sq,Skv) bool."""
    scale = q.shape[-1] ** -0.5
    scores = _einsum("bqkgh,bskh->bkgqs", q, k).to(torch.float32) * scale
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _einsum("bkgqs,bskh->bqkgh", probs, v)


def _chunked_attn(q, k, v, *, offset, window, chunk: int = 1024,
                  causal: bool = True):
    """Online-softmax attention over KV chunks (flash-style).

    q: (B,Sq,KV,G,hd); k,v: (B,Skv,KV,hd). Causal with optional window.
    """
    b, sq, kvh, g, hd = q.shape
    vd = v.shape[-1]
    skv = k.shape[1]
    chunk = min(chunk, skv)
    if skv % chunk:
        raise ValueError(f"kv length {skv} is no multiple of chunk {chunk}")
    scale = hd ** -0.5
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((b, kvh, g, sq), NEG_INF, **f32)
    l = torch.zeros((b, kvh, g, sq), **f32)
    acc = torch.zeros((b, kvh, g, sq, vd), **f32)
    for ci in range(skv // chunk):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        scores = _einsum("bqkgh,bskh->bkgqs", q, kb).to(torch.float32) \
            * scale
        if causal:
            mask = _causal_mask(sq, chunk, offset - ci * chunk, window,
                                q.device)
            scores = torch.where(mask[None, None, None], scores, NEG_INF)
        m_cur = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(scores - m_cur[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _einsum(
            "bkgqs,bskh->bkgqh", p.to(q.dtype), vb).to(torch.float32)
        m = m_cur
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype).permute(0, 3, 1, 2, 4)   # (B,Sq,KV,G,hd)


def _attn_constrain(q5, k, v):
    """The reference's attention anchors: kv heads over ``model`` where
    their count divides it, else the query sequence (context
    parallelism).  ``constrain`` returns its input (per-rank code)."""
    mesh = dist_context.get_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return q5, k, v
    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    if q5.shape[2] % tp == 0:
        q5 = dist_context.constrain(q5, "dp", None, "tp", None, None)
        k = dist_context.constrain(k, "dp", None, "tp", None)
        v = dist_context.constrain(v, "dp", None, "tp", None)
    elif q5.shape[1] % tp == 0:
        q5 = dist_context.constrain(q5, "dp", "tp", None, None, None)
        k = dist_context.constrain(k, "dp", None, None, None)
        v = dist_context.constrain(v, "dp", None, None, None)
    return q5, k, v


def _local_heads(p, cfg, tp):
    """(q heads, KV heads) of ``wq``/``wk``'s columns, checked to be this
    rank's KV-head group over ``tp`` (all of them without it): never a
    head cut in two."""
    m = 1 if tp is None else tp.size
    hd = cfg.head_dim
    h, kvh = p.wq.w.shape[1] // hd, p.wk.w.shape[1] // hd
    if (h, kvh) != (cfg.num_heads // m, cfg.num_kv_heads // m):
        raise ValueError(f"the attention's weights hold {h} q and {kvh} KV "
                         f"heads: not a block of {cfg.num_heads} and "
                         f"{cfg.num_kv_heads} over {m}")
    return h, kvh


def _project(lin, x, tp=None):
    """``linear``, plus the LoRA delta ``(x @ a) @ b`` where ``lin``
    carries one (``lin.lora = (a, b)``: the hybrid's per-site q, k, v).
    With ``tp`` (the ``"heads"`` layout, ``b`` this rank's columns) the
    whole ``a`` enters behind ``copy_in``."""
    y = linear(lin, x)
    lora = getattr(lin, "lora", None)
    if lora is not None:
        a, b = tpar.copy_in(lora[0], tp), lora[1]
        y = y + torch.matmul(torch.matmul(x, a.to(x.dtype)), b.to(x.dtype))
    return y


def _attend(q, k, v, *, offset, window, impl, chunk, causal):
    """The grouped attention of ``q`` (B,Sq,KV,G,hd) against ``k``, ``v``
    (B,Skv,KV,hd), its rows from absolute position ``offset``."""
    if impl == "chunked":
        return _chunked_attn(q, k, v, offset=offset, window=window,
                             chunk=chunk, causal=causal)
    sq, skv = q.shape[1], k.shape[1]
    if causal:
        mask = _causal_mask(sq, skv, offset, window, q.device)
    else:
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    return _full_attn(q, k, v, mask)


def gqa_apply(p, cfg, x, *, positions, impl: str = "full", chunk: int = 1024,
              causal: bool = True):
    """Training/prefill self-attention. x: (B,S,D); positions: (S,) int;
    ``causal=False``: the encoder's bidirectional attention (no window).
    ``p``'s projections may carry a LoRA delta (``_project``).  Under a
    splitting mesh (``dist.context.tp_layout``): this rank's KV-head group
    (its columns of ``wq``, ``wk``, ``wv``, local attention, its rows of
    ``wo``, then the sum over ``model``), or its block of query rows
    (``_gqa_rows``)."""
    tp = tpar.plan(cfg)
    layout = dist_context.tp_layout(cfg, dist_context.get_mesh(), x.shape[1])
    window = cfg.sliding_window if causal else None
    if layout == "rows":
        return _gqa_rows(p, cfg, x, positions, impl, chunk, tp, causal,
                         window)
    tp = tp if layout == "heads" else None
    h, kvh = _local_heads(p, cfg, tp)
    hd = cfg.head_dim
    g = h // kvh
    b, s, _ = x.shape
    x = tpar.copy_in(x, tp)
    q = _split_heads(_project(p.wq, x, tp), h, hd)
    k = _split_heads(_project(p.wk, x, tp), kvh, hd)
    v = _split_heads(_project(p.wv, x, tp), kvh, hd)
    cos, sin = rope_angles(positions, p.freqs)
    q = apply_rope(q, cos[None, :, None], sin[None, :, None])
    k = apply_rope(k, cos[None, :, None], sin[None, :, None])
    q = q.reshape(b, s, kvh, g, hd)
    q, k, v = _attn_constrain(q, k, v)
    out = _attend(q, k, v, offset=0, window=window, impl=impl, chunk=chunk,
                  causal=causal)
    out = out.reshape(b, s, h * hd)
    return tpar.reduce_out(linear(p.wo, out), tp)


def _whole(lin, tp):
    """``lin`` (a projection, with its bias and LoRA factors) whole on
    every model rank, each tensor behind ``copy_in``: a rank's gradient
    is the part its block of rows gives, summed over the model axis
    backward."""
    out = types.SimpleNamespace(w=tpar.copy_in(lin.w, tp))
    if hasattr(lin, "b"):
        out.b = tpar.copy_in(lin.b, tp)
    lora = getattr(lin, "lora", None)
    if lora is not None:
        out.lora = tuple(tpar.copy_in(t, tp) for t in lora)
    return out


def _gqa_rows(p, cfg, x, positions, impl, chunk, tp, causal, window):
    """``gqa_apply`` in the ``"rows"`` layout: this rank's block of query
    rows against the whole K and V (the causal and sliding-window mask
    offset by the block's first row), ``wo`` on those rows, then the rows
    gathered back into the replicated residual."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    _local_heads(p, cfg, None)
    b, s, _ = x.shape
    x = tpar.copy_in(x, tp)
    wq, wk, wv, wo = (_whole(lin, tp) for lin in (p.wq, p.wk, p.wv, p.wo))
    sl = s // tp.size
    r0 = tp.rank * sl
    q = _split_heads(_project(wq, x[:, r0:r0 + sl]), h, hd)
    k = _split_heads(_project(wk, x), kvh, hd)
    v = _split_heads(_project(wv, x), kvh, hd)
    cos, sin = rope_angles(positions, p.freqs)
    q = apply_rope(q, cos[None, r0:r0 + sl, None], sin[None, r0:r0 + sl,
                                                       None])
    k = apply_rope(k, cos[None, :, None], sin[None, :, None])
    q = q.reshape(b, sl, kvh, h // kvh, hd)
    out = _attend(q, k, v, offset=r0, window=window, impl=impl, chunk=chunk,
                  causal=causal)
    out = linear(wo, out.reshape(b, sl, h * hd))
    return tpar.gather(out, 1, tp)


# -------------------------------------------------------------- GQA decode
def decode_layout(cfg):
    """(``dist.context.tp_cache_layout`` on the installed mesh, its plan):
    ``"heads"``, ``"head_dim"`` or ``"length"`` with the plan, or
    ``("whole", None)`` where nothing splits."""
    mesh = dist_context.get_mesh()
    return dist_context.tp_cache_layout(cfg, mesh), tpar.plan(cfg, mesh)


def _decode_valid(s, pos, cfg, device, lo=0):
    """(1,1,1,1,s) the positions ``lo .. lo + s`` a step at ``pos`` reads:
    at most ``pos``, and within the sliding window."""
    kj = lo + torch.arange(s, device=device)[None, None, None, None, :]
    valid = kj <= pos
    if cfg.sliding_window is not None:
        valid = valid & (pos - kj < cfg.sliding_window)
    return valid


def _hd_cols(lin, n, hd, idx):
    """``lin``'s output columns ``idx`` of each of its ``n`` heads: a
    projection of (n * len(idx)) outputs (its LoRA ``b`` cut the same)."""
    def cols(w):
        return w.reshape(w.shape[0], n, hd)[:, :, idx].reshape(w.shape[0], -1)
    out = types.SimpleNamespace(w=cols(lin.w))
    if hasattr(lin, "b"):
        out.b = lin.b.reshape(n, hd)[:, idx].reshape(-1)
    lora = getattr(lin, "lora", None)
    if lora is not None:
        out.lora = (lora[0], cols(lora[1]))
    return out


def _rope_slice(x_own, x_partner, cos, sin, idx, half):
    """``apply_rope``'s values at the dims ``idx`` of the last axis, from
    ``x`` at ``idx`` and at each one's rotary partner (``idx`` +- half):
    the same products and sums, in the same order."""
    freq = idx % half
    c, s = cos[..., freq], sin[..., freq]
    xf, pf = x_own.to(torch.float32), x_partner.to(torch.float32)
    out = torch.where(idx < half, xf * c - pf * s, xf * c + pf * s)
    return out.to(x_own.dtype)


def _hd_index(cfg, tp, device):
    """This rank's dims of ``head_dim`` and their rotary partners."""
    hd = cfg.head_dim
    hl = hd // tp.size
    idx = torch.arange(tp.rank * hl, (tp.rank + 1) * hl, device=device)
    return idx, (idx + hd // 2) % hd


def decode_q(lin, cfg, x, layout, tp, cos=None, sin=None):
    """A decode step's projection ``lin`` of ``x`` (B,1,D) split in heads,
    as ``layout`` holds it: the heads of its columns (this rank's in
    ``"heads"``, whose weights are its blocks; all of them whole), or
    every head's slice of ``head_dim`` (rotated with its rotary
    partners); rotated where ``cos`` is given."""
    hd = cfg.head_dim
    n = lin.w.shape[1] // hd
    if layout == "head_dim":
        idx, partner = _hd_index(cfg, tp, x.device)
        y = _split_heads(_project(_hd_cols(lin, n, hd, idx), x), n,
                         idx.numel())
        if cos is None:
            return y
        yp = _split_heads(_project(_hd_cols(lin, n, hd, partner), x), n,
                          idx.numel())
        return _rope_slice(y, yp, cos, sin, idx, hd // 2)
    y = _split_heads(_project(lin, x), n, hd)
    return y if cos is None else apply_rope(y, cos, sin)


def decode_attend(q, cache_k, cache_v, valid, layout, tp, dtype, scale):
    """One query position against this rank's cache block: q
    (B,1,KV_l,G,hd_l), cache (B,S_l,KV_l,hd_l), ``valid`` the block's
    readable positions; the output (B,1,H_l*hd_l) before ``wo``.
    ``"head_dim"``: the partial q.k over this rank's slice summed over
    ``model`` before the softmax; ``"length"``: the softmax's max and
    sum over the ranks' blocks of positions, each rank's f32 partial
    ``probs . v`` summed and then rounded (flash-decoding); a block with
    no readable position gives exp(NEG_INF - max) = 0."""
    b = q.shape[0]
    if layout == "head_dim":
        dt = torch.promote_types(q.dtype, cache_k.dtype)
        scores = torch.einsum("bqkgh,bskh->bkgqs", q.to(torch.float32),
                              cache_k.to(torch.float32))
        scores = tpar.reduce_out(scores, tp).to(dt).to(torch.float32)
    else:
        scores = _einsum("bqkgh,bskh->bkgqs", q, cache_k).to(torch.float32)
    scores = torch.where(valid, scores * scale, NEG_INF)
    if layout != "length":
        probs = torch.softmax(scores, dim=-1).to(dtype)
        return _einsum("bkgqs,bskh->bqkgh", probs, cache_v).reshape(b, 1, -1)
    top = scores.new_full(scores.shape[:-1] + (1,), NEG_INF)
    if scores.shape[-1]:        # a block may hold no position (the memory's)
        top = scores.amax(dim=-1, keepdim=True)
    top = tpar.all_max(top, tp)
    e = torch.exp(scores - top)
    probs = (e / tpar.reduce_out(e.sum(dim=-1, keepdim=True), tp)).to(dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(torch.float32),
                       cache_v.to(torch.float32))
    dt = torch.promote_types(probs.dtype, cache_v.dtype)
    return tpar.reduce_out(out, tp).to(dt).reshape(b, 1, -1)


def decode_out(wo, cfg, out, layout, tp):
    """``wo`` on a decode step's attention output as ``layout`` holds it:
    this rank's rows of heads (``"heads"``) or of (every head, its slice
    of ``head_dim``), then the sum over ``model``; whole otherwise."""
    if layout == "head_dim":
        idx, _ = _hd_index(cfg, tp, out.device)
        w = wo.w.reshape(cfg.num_heads, cfg.head_dim, -1)[:, idx]
        out = torch.matmul(out, w.reshape(out.shape[-1], -1).to(out.dtype))
        return tpar.reduce_out(out, tp)
    return tpar.reduce_out(linear(wo, out), tp if layout == "heads" else None)


def gqa_decode(p, cfg, x, cache_k, cache_v, pos: int):
    """Single-token decode. x: (B,1,D); cache_k/v: (B,S,KV,hd), one
    layer's views of the cache; pos: the current length, also the write
    index.  Writes this token's k and v into the cache in place and
    returns (out, cache_k, cache_v).  Under a splitting mesh the cache
    views are this rank's block (``decode_layout``): its KV-head group
    (its heads end to end, its rows of ``wo``, then the sum over
    ``model``), its slice of ``head_dim`` (every head's q, k and v at its
    dims, the partial q.k summed before the softmax), or its block of
    positions (q, k, v whole, k and v written by the rank whose block
    holds ``pos``, the mask on absolute positions, ``decode_attend``).
    In that layout a cache of S positions on every rank reads as the
    blocks ``[r * S, (r + 1) * S)``: a whole one gives the same logits,
    rank 0's block holding every position, at m times the memory
    (``init_cache(mesh=)`` gives the block); a ``pos`` past the ranks'
    blocks raises."""
    layout, tp = decode_layout(cfg)
    _local_heads(p, cfg, tp if layout == "heads" else None)
    b = x.shape[0]
    position = torch.full((1,), pos, dtype=torch.float32, device=x.device)
    cos, sin = rope_angles(position, p.freqs)
    cos, sin = cos[None, :, None], sin[None, :, None]
    q = decode_q(p.wq, cfg, x, layout, tp, cos, sin)
    k = decode_q(p.wk, cfg, x, layout, tp, cos, sin)
    v = decode_q(p.wv, cfg, x, layout, tp)
    if tuple(cache_k.shape[2:]) != tuple(k.shape[2:]):
        raise ValueError(f"a cache of {tuple(cache_k.shape[2:])} (KV, hd): "
                         f"not this rank's {tuple(k.shape[2:])}")
    # the "length" layout's block holds positions rank * S_l onwards
    lo = tp.rank * cache_k.shape[1] if layout == "length" else 0
    if layout == "length" and pos >= tp.size * cache_k.shape[1]:
        raise ValueError(f"position {pos} past {tp.size} blocks of "
                         f"{cache_k.shape[1]} positions")
    if lo <= pos < lo + cache_k.shape[1]:
        cache_k[:, pos - lo].copy_(k[:, 0])
        cache_v[:, pos - lo].copy_(v[:, 0])
    q = q.reshape(b, 1, k.shape[2], q.shape[2] // k.shape[2], q.shape[3])
    out = decode_attend(q, cache_k, cache_v,
                        _decode_valid(cache_k.shape[1], pos, cfg, x.device,
                                      lo), layout, tp, x.dtype,
                        cfg.head_dim ** -0.5)
    return decode_out(p.wo, cfg, out, layout, tp), cache_k, cache_v


# ----------------------------------------------------------------------- MLA
def mla_init(generator, cfg, dtype, device=None) -> nn.Module:
    """The compressed-KV projections (``wdq``/``q_norm``/``wuq`` with a
    q LoRA rank, else ``wq``), ``wdkv``, ``kv_norm``, ``wuk``, ``wuv``,
    the shared-head ``wkr``, ``wo``, and the rope_head_dim rotary
    frequencies as a buffer."""
    d = cfg.d_model
    h = cfg.num_heads
    qk_nope, qk_rope, vh = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    kw = dict(dtype=dtype, device=device)
    p = nn.Module()
    if cfg.q_lora_rank:
        p.wdq = linear_init(generator, d, cfg.q_lora_rank, **kw)
        p.q_norm = rmsnorm_init(cfg.q_lora_rank, dtype, device=device)
        p.wuq = linear_init(generator, cfg.q_lora_rank,
                            h * (qk_nope + qk_rope), **kw)
    else:
        p.wq = linear_init(generator, d, h * (qk_nope + qk_rope), **kw)
    p.wdkv = linear_init(generator, d, cfg.kv_lora_rank, **kw)
    p.kv_norm = rmsnorm_init(cfg.kv_lora_rank, dtype, device=device)
    p.wuk = linear_init(generator, cfg.kv_lora_rank, h * qk_nope, **kw)
    p.wuv = linear_init(generator, cfg.kv_lora_rank, h * vh, **kw)
    p.wkr = linear_init(generator, d, qk_rope, **kw)   # shared-head k_rope
    p.wo = linear_init(generator, h * vh, d,
                       scale=(h * vh) ** -0.5 / (2 * cfg.num_layers) ** 0.5,
                       **kw)
    p.register_buffer("freqs", rope_freqs(qk_rope, cfg.rope_theta, device),
                      persistent=False)
    return p


def _mla_q(p, cfg, x, tp=None):
    """(q_nope, q_rope) of the heads ``p``'s ``wuq`` (or ``wq``) columns
    hold; the q LoRA's down projection and norm enter behind ``copy_in``
    (whole on every model rank)."""
    qk_nope, qk_rope = cfg.nope_head_dim, cfg.rope_head_dim
    if cfg.q_lora_rank:
        cq = rmsnorm(p.q_norm, linear(p.wdq, x), cfg.norm_eps)
        q = linear(p.wuq, tpar.copy_in(cq, tp))
    else:
        q = linear(p.wq, tpar.copy_in(x, tp))
    q = q.reshape(x.shape[:-1] + (-1, qk_nope + qk_rope))
    return q[..., :qk_nope], q[..., qk_nope:]


def _head_cols(lin, width, cfg, tp):
    """``lin`` as this rank's columns of heads of ``width`` each: itself
    where it holds them already (a train step's block), its view where it
    is whole (a serving rank holds MLA's ``wuk``/``wuv`` whole, for the
    absorbed decode's latent rows)."""
    n = lin.w.shape[1] // width
    if n == cfg.num_heads:
        return types.SimpleNamespace(w=tp.block(lin.w, 1))
    if n * tp.size != cfg.num_heads:
        raise ValueError(f"a projection of {n} heads: neither all "
                         f"{cfg.num_heads} nor this rank's block")
    return lin


def mla_apply(p, cfg, x, *, positions, impl: str = "full", chunk: int = 1024):
    """MLA train/prefill: decompress K/V for all positions (non-absorbed).
    Under a splitting mesh (``dist.context.tp_layout``), as the reference's
    ``_attn_constrain`` lays it out: this rank's heads (its columns of
    ``wuq``/``wq``, ``wuk``, ``wuv``, its rows of ``wo``, then the sum
    over ``model``; ``wdq``, ``q_norm``, ``wdkv``, ``kv_norm`` and ``wkr``
    whole, their outputs entering behind ``copy_in``), or its block of
    query rows against every position (all weights whole behind
    ``copy_in``, the rows gathered back)."""
    tp = tpar.plan(cfg)
    layout = dist_context.tp_layout(cfg, dist_context.get_mesh(), x.shape[1])
    b, s, _ = x.shape
    r0, sl = 0, s
    if layout == "heads":
        p = types.SimpleNamespace(**vars(p)["_modules"], freqs=p.freqs)
        qk = cfg.nope_head_dim + cfg.rope_head_dim
        for name, width in (("wq", qk), ("wuq", qk), ("wuk", cfg.nope_head_dim),
                            ("wuv", cfg.v_head_dim)):
            if hasattr(p, name):
                setattr(p, name, _head_cols(getattr(p, name), width, cfg, tp))
        wrap = tp
    elif layout == "rows":
        p = _mla_whole(p, tp)
        x = tpar.copy_in(x, tp)
        sl = s // tp.size
        r0, wrap = tp.rank * sl, None
    else:
        tp = wrap = None
    qk_nope, qk_rope, vh = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, cfg, x[:, r0:r0 + sl], wrap)
    h = q_nope.shape[2]
    cos, sin = rope_angles(positions, p.freqs)
    q_rope = apply_rope(q_rope, cos[None, r0:r0 + sl, None],
                        sin[None, r0:r0 + sl, None])

    ckv = tpar.copy_in(rmsnorm(p.kv_norm, linear(p.wdkv, x), cfg.norm_eps),
                       wrap)
    k_nope = linear(p.wuk, ckv).reshape(b, s, h, qk_nope)
    v = linear(p.wuv, ckv).reshape(b, s, h, vh)
    k_rope = tpar.copy_in(apply_rope(linear(p.wkr, x), cos, sin),
                          wrap)                        # (B,S,rope) shared

    q = torch.cat([q_nope, q_rope], dim=-1)            # (B,Sl,H,nope+rope)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, qk_rope)],
                  dim=-1)
    # MLA is MHA (kv heads == heads): the grouped attention with G = 1
    q5 = q.reshape(b, sl, h, 1, qk_nope + qk_rope)
    q5, k, v = _attn_constrain(q5, k, v)
    out = _attend(q5, k, v, offset=r0, window=None, impl=impl, chunk=chunk,
                  causal=True)
    out = linear(p.wo, out.reshape(b, sl, h * vh))
    if layout == "rows":
        return tpar.gather(out, 1, tp)
    return tpar.reduce_out(out, tp)


def _mla_whole(p, tp):
    """MLA's weights whole on every model rank, each behind ``copy_in``
    (the ``"rows"`` layout)."""
    out = types.SimpleNamespace(freqs=p.freqs)
    for name, mod in vars(p)["_modules"].items():
        if hasattr(mod, "scale"):
            out.__dict__[name] = types.SimpleNamespace(
                scale=tpar.copy_in(mod.scale, tp))
        else:
            out.__dict__[name] = _whole(mod, tp)
    return out


def _owned(full: int, held: int, tp):
    """(first index, width) of the part of a cache's last dim this rank
    adds into a sum over ``model``: its block where the dim is split
    (``held`` < ``full``), all of it on rank 0 and none elsewhere where
    every rank holds it whole (all of it without ``tp``)."""
    if held != full:
        return 0, held
    return 0, full if tp is None or tp.rank == 0 else 0


def mla_decode(p, cfg, x, cache_ckv, cache_kr, pos: int):
    """Absorbed-matrices MLA decode (DeepSeek-V2 inference optimization):
    attend directly in the kv_lora latent space, all in f32; the cache is
    one layer's (B,S,kv_lora) + (B,S,rope) views, this token's entries
    written at ``pos`` in place.  Returns (out, cache_ckv, cache_kr).
    Under a splitting mesh (``_mla_decode_tp``) the cache views are this
    rank's blocks of the latent and rope dims."""
    return _mla_decode_tp(p, cfg, x, cache_ckv, cache_kr, pos,
                          tpar.plan(cfg))


def _mla_decode_tp(p, cfg, x, cache_ckv, cache_kr, pos, tp):
    """``mla_decode`` on this rank's cache blocks (the reference's
    ``cache_specs``: ``ckv`` on its latent dim, ``kr`` on its rope dim,
    each where the axis divides it), or on the whole cache with no
    collective without ``tp``.  q for every head (this rank's heads of
    ``wuq`` gathered over ``model`` where they are split), ``ckv`` and
    ``kr`` whole, cut to the blocks after ``kv_norm`` and after the
    rotary, ``q_eff`` on this rank's latent rows of the whole ``wuk``
    (design (a): a serving rank holds ``wuk`` and ``wuv`` whole), the
    partial scores (latent part plus rope part) summed over ``model``,
    the softmax on every head, ``ctx`` on the latent block, its product
    with this rank's latent rows of ``wuv`` summed, then ``wo`` on this
    rank's heads where it holds their rows."""
    f32 = torch.float32
    b = x.shape[0]
    h = cfg.num_heads
    qk_nope, qk_rope, vh = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    lora = cfg.kv_lora_rank
    if p.wuk.w.shape[1] != h * qk_nope or p.wuv.w.shape[1] != h * vh:
        raise ValueError("the absorbed decode reads wuk and wuv whole: a "
                         "serving rank's layout (sharding.tp_blocks)")
    q_nope, q_rope = _mla_q(p, cfg, x)
    if q_nope.shape[2] != h:                            # this rank's heads
        q_nope, q_rope = tpar.gather(q_nope, 2, tp), tpar.gather(q_rope, 2,
                                                                 tp)
    position = torch.full((1,), pos, dtype=f32, device=x.device)
    cos, sin = rope_angles(position, p.freqs)
    q_rope = apply_rope(q_rope, cos[None, :, None], sin[None, :, None])
    ckv = rmsnorm(p.kv_norm, linear(p.wdkv, x), cfg.norm_eps)  # (B,1,lora)
    kr = apply_rope(linear(p.wkr, x), cos, sin)                # (B,1,rope)
    ln, rn = cache_ckv.shape[-1], cache_kr.shape[-1]
    l0 = 0 if ln == lora else tp.rank * ln
    r0 = 0 if rn == qk_rope else tp.rank * rn
    cache_ckv[:, pos].copy_(ckv[:, 0, l0:l0 + ln])
    cache_kr[:, pos].copy_(kr[:, 0, r0:r0 + rn])
    lo, la = _owned(lora, ln, tp)
    ro, ra = _owned(qk_rope, rn, tp)
    ckv_c = cache_ckv[..., lo:lo + la].to(f32)
    wuk = p.wuk.w[l0 + lo:l0 + lo + la].reshape(la, h, qk_nope)
    q_eff = torch.einsum("bqhn,lhn->bqhl", q_nope.to(f32), wuk.to(f32))
    part = (torch.einsum("bqhl,bsl->bhqs", q_eff, ckv_c)
            + torch.einsum("bqhr,bsr->bhqs",
                           q_rope[..., r0 + ro:r0 + ro + ra].to(f32),
                           cache_kr[..., ro:ro + ra].to(f32)))
    scores = tpar.reduce_out(part, tp) * ((qk_nope + qk_rope) ** -0.5)
    valid = torch.arange(cache_ckv.shape[1], device=x.device)[
        None, None, None, :] <= pos
    probs = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
    ctx = torch.einsum("bhqs,bsl->bqhl", probs, ckv_c)
    wuv = p.wuv.w[l0 + lo:l0 + lo + la].reshape(la, h, vh)
    out = tpar.reduce_out(torch.einsum("bqhl,lhv->bqhv", ctx, wuv.to(f32)),
                          tp)
    out = out.to(x.dtype)
    hl = p.wo.w.shape[0] // vh
    if hl != h:                                         # its rows of wo
        out = tp.block(out, 2)
        return tpar.reduce_out(linear(p.wo, out.reshape(b, 1, hl * vh)),
                               tp), cache_ckv, cache_kr
    return linear(p.wo, out.reshape(b, 1, h * vh)), cache_ckv, cache_kr
