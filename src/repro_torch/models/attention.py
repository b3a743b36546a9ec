"""Attention: GQA (with optional QKV bias / sliding window) and MLA
(DeepSeek compressed-KV, absorbed decode path), the port's counterpart of
``repro.models.attention``.

Under a mesh whose ``model`` axis splits the config (``dist.tensor_parallel``),
``gqa_apply`` and ``gqa_decode`` are per-rank code in the layout of the
reference's anchors: this rank's KV-head group (``"heads"``) or its block
of query rows (``"rows"``), and in decode its block of the cache (KV heads
or ``head_dim``), with the collectives that layout implies.

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


def gqa_apply(p, cfg, x, *, positions, impl: str = "full", chunk: int = 1024):
    """Training/prefill self-attention. x: (B,S,D); positions: (S,) int.
    Under a splitting mesh (``dist.context.tp_layout``): this rank's
    KV-head group (its columns of ``wq``, ``wk``, ``wv``, local attention,
    its rows of ``wo``, then the sum over ``model``), or its block of
    query rows (``_gqa_rows``)."""
    tp = tpar.plan(cfg)
    layout = dist_context.tp_layout(cfg, dist_context.get_mesh(), x.shape[1])
    if layout == "rows":
        return _gqa_rows(p, cfg, x, positions, impl, chunk, tp)
    tp = tp if layout == "heads" else None
    h, kvh = _local_heads(p, cfg, tp)
    hd = cfg.head_dim
    g = h // kvh
    b, s, _ = x.shape
    x = tpar.copy_in(x, tp)
    q = _split_heads(linear(p.wq, x), h, hd)
    k = _split_heads(linear(p.wk, x), kvh, hd)
    v = _split_heads(linear(p.wv, x), kvh, hd)
    cos, sin = rope_angles(positions, p.freqs)
    q = apply_rope(q, cos[None, :, None], sin[None, :, None])
    k = apply_rope(k, cos[None, :, None], sin[None, :, None])
    q = q.reshape(b, s, kvh, g, hd)
    q, k, v = _attn_constrain(q, k, v)
    if impl == "chunked":
        out = _chunked_attn(q, k, v, offset=0, window=cfg.sliding_window,
                            chunk=chunk)
    else:
        mask = _causal_mask(s, s, 0, cfg.sliding_window, x.device)
        out = _full_attn(q, k, v, mask)
    out = out.reshape(b, s, h * hd)
    return tpar.reduce_out(linear(p.wo, out), tp)


def _whole_weights(p, cfg, tp):
    """The attention's four weights, whole on every model rank, each
    behind ``copy_in``: a rank's gradient of a weight is the part its
    block of rows gives, summed over the model axis backward."""
    _local_heads(p, cfg, None)

    def one(lin):
        out = types.SimpleNamespace(w=tpar.copy_in(lin.w, tp))
        if hasattr(lin, "b"):
            out.b = tpar.copy_in(lin.b, tp)
        return out
    return one(p.wq), one(p.wk), one(p.wv), one(p.wo)


def _gqa_rows(p, cfg, x, positions, impl, chunk, tp):
    """``gqa_apply`` in the ``"rows"`` layout: this rank's block of query
    rows against the whole K and V (the causal and sliding-window mask
    offset by the block's first row), ``wo`` on those rows, then the rows
    gathered back into the replicated residual."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b, s, _ = x.shape
    x = tpar.copy_in(x, tp)
    wq, wk, wv, wo = _whole_weights(p, cfg, tp)
    sl = s // tp.size
    r0 = tp.rank * sl
    q = _split_heads(linear(wq, x[:, r0:r0 + sl]), h, hd)
    k = _split_heads(linear(wk, x), kvh, hd)
    v = _split_heads(linear(wv, x), kvh, hd)
    cos, sin = rope_angles(positions, p.freqs)
    q = apply_rope(q, cos[None, r0:r0 + sl, None], sin[None, r0:r0 + sl,
                                                       None])
    k = apply_rope(k, cos[None, :, None], sin[None, :, None])
    q = q.reshape(b, sl, kvh, h // kvh, hd)
    if impl == "chunked":
        out = _chunked_attn(q, k, v, offset=r0, window=cfg.sliding_window,
                            chunk=chunk)
    else:
        out = _full_attn(q, k, v, _causal_mask(sl, s, r0, cfg.sliding_window,
                                               x.device))
    out = linear(wo, out.reshape(b, sl, h * hd))
    return tpar.gather(out, 1, tp)


def _decode_valid(s, pos, cfg, device):
    kj = torch.arange(s, device=device)[None, None, None, None, :]
    valid = kj <= pos
    if cfg.sliding_window is not None:
        valid = valid & (pos - kj < cfg.sliding_window)
    return valid


def gqa_decode(p, cfg, x, cache_k, cache_v, pos: int):
    """Single-token decode. x: (B,1,D); cache_k/v: (B,S,KV,hd), one
    layer's views of the cache; pos: the current length, also the write
    index.  Writes this token's k and v into the cache in place and
    returns (out, cache_k, cache_v).  Under a splitting mesh the cache
    views are this rank's block (``dist.context.tp_cache_layout``): its
    KV-head group (its heads end to end, its rows of ``wo``, then the sum
    over ``model``), else its slice of ``head_dim`` (``_gqa_decode_hd``),
    else the whole cache, which the reference leaves unsplit over
    ``model`` there."""
    tp = tpar.plan(cfg)
    hd = cfg.head_dim
    if tp is not None and tp.cache == "head_dim":
        return _gqa_decode_hd(p, cfg, x, cache_k, cache_v, pos, tp)
    tp = tp if tp is not None and tp.cache == "heads" else None
    h, kvh = _local_heads(p, cfg, tp)
    if tuple(cache_k.shape[2:]) != (kvh, hd):
        raise ValueError(f"a cache of {tuple(cache_k.shape[2:])} (KV, hd): "
                         f"not this rank's ({kvh}, {hd})")
    g = h // kvh
    b = x.shape[0]
    s = cache_k.shape[1]
    q = _split_heads(linear(p.wq, x), h, hd)        # (B,1,H,hd)
    k = _split_heads(linear(p.wk, x), kvh, hd)
    v = _split_heads(linear(p.wv, x), kvh, hd)
    position = torch.full((1,), pos, dtype=torch.float32, device=x.device)
    cos, sin = rope_angles(position, p.freqs)
    q = apply_rope(q, cos[None, :, None], sin[None, :, None])
    k = apply_rope(k, cos[None, :, None], sin[None, :, None])
    cache_k[:, pos].copy_(k[:, 0])
    cache_v[:, pos].copy_(v[:, 0])
    q = q.reshape(b, 1, kvh, g, hd)
    scale = hd ** -0.5
    scores = _einsum("bqkgh,bskh->bkgqs", q, cache_k).to(torch.float32)
    scores = scores * scale
    scores = torch.where(_decode_valid(s, pos, cfg, x.device), scores,
                         NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _einsum("bkgqs,bskh->bqkgh", probs, cache_v)
    out = out.reshape(b, 1, h * hd)
    return tpar.reduce_out(linear(p.wo, out), tp), cache_k, cache_v


def _hd_cols(lin, n, hd, idx):
    """``lin``'s output columns ``idx`` of each of its ``n`` heads: a
    linear layer of (n * len(idx)) outputs."""
    w = lin.w.reshape(lin.w.shape[0], n, hd)[:, :, idx]
    out = types.SimpleNamespace(w=w.reshape(w.shape[0], -1))
    if hasattr(lin, "b"):
        out.b = lin.b.reshape(n, hd)[:, idx].reshape(-1)
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


def _gqa_decode_hd(p, cfg, x, cache_k, cache_v, pos, tp):
    """Decode with the cache's ``head_dim`` over ``model`` (the KV heads do
    not divide the axis; the weights are whole on every rank): this
    rank's slice of every head's q, k and v (q and k with their rotary
    partners), its slice of k and v written into its cache block, the
    partial q.k over its slice summed over ``model`` before the softmax,
    then ``probs . v_slice``, the rows of ``wo`` for (every head, this
    slice), and the sum."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hl = hd // tp.size
    if cache_k.shape[-1] != hl:
        raise ValueError(f"a cache of head_dim {cache_k.shape[-1]}: not this "
                         f"rank's block of {hd}")
    b = x.shape[0]
    half = hd // 2
    idx = torch.arange(tp.rank * hl, (tp.rank + 1) * hl, device=x.device)
    partner = (idx + half) % hd
    q = _split_heads(linear(_hd_cols(p.wq, h, hd, idx), x), h, hl)
    qp = _split_heads(linear(_hd_cols(p.wq, h, hd, partner), x), h, hl)
    k = _split_heads(linear(_hd_cols(p.wk, kvh, hd, idx), x), kvh, hl)
    kp = _split_heads(linear(_hd_cols(p.wk, kvh, hd, partner), x), kvh, hl)
    v = _split_heads(linear(_hd_cols(p.wv, kvh, hd, idx), x), kvh, hl)
    position = torch.full((1,), pos, dtype=torch.float32, device=x.device)
    cos, sin = rope_angles(position, p.freqs)
    cos, sin = cos[None, :, None], sin[None, :, None]
    q = _rope_slice(q, qp, cos, sin, idx, half)
    k = _rope_slice(k, kp, cos, sin, idx, half)
    cache_k[:, pos].copy_(k[:, 0])
    cache_v[:, pos].copy_(v[:, 0])
    q = q.reshape(b, 1, kvh, h // kvh, hl)
    dt = torch.promote_types(q.dtype, cache_k.dtype)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.to(torch.float32),
                          cache_k.to(torch.float32))
    scores = tpar.reduce_out(scores, tp).to(dt).to(torch.float32)
    scores = scores * hd ** -0.5
    scores = torch.where(_decode_valid(cache_k.shape[1], pos, cfg,
                                       x.device), scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _einsum("bkgqs,bskh->bqkgh", probs, cache_v).reshape(b, 1, h * hl)
    wo = p.wo.w.reshape(h, hd, -1)[:, idx].reshape(h * hl, -1)
    out = torch.matmul(out, wo.to(out.dtype))
    return tpar.reduce_out(out, tp), cache_k, cache_v


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


def _mla_q(p, cfg, x):
    h = cfg.num_heads
    qk_nope, qk_rope = cfg.nope_head_dim, cfg.rope_head_dim
    if cfg.q_lora_rank:
        cq = rmsnorm(p.q_norm, linear(p.wdq, x), cfg.norm_eps)
        q = linear(p.wuq, cq)
    else:
        q = linear(p.wq, x)
    q = q.reshape(x.shape[:-1] + (h, qk_nope + qk_rope))
    return q[..., :qk_nope], q[..., qk_nope:]


def mla_apply(p, cfg, x, *, positions, impl: str = "full", chunk: int = 1024):
    """MLA train/prefill: decompress K/V for all positions (non-absorbed)."""
    b, s, _ = x.shape
    h = cfg.num_heads
    qk_nope, qk_rope, vh = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, cfg, x)
    cos, sin = rope_angles(positions, p.freqs)
    q_rope = apply_rope(q_rope, cos[None, :, None], sin[None, :, None])

    ckv = rmsnorm(p.kv_norm, linear(p.wdkv, x), cfg.norm_eps)
    k_nope = linear(p.wuk, ckv).reshape(b, s, h, qk_nope)
    v = linear(p.wuv, ckv).reshape(b, s, h, vh)
    k_rope = apply_rope(linear(p.wkr, x), cos, sin)        # (B,S,rope) shared

    q = torch.cat([q_nope, q_rope], dim=-1)                # (B,S,H,nope+rope)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, qk_rope)],
                  dim=-1)
    # MLA is MHA (kv heads == heads): the grouped attention with G = 1
    q5 = q.reshape(b, s, h, 1, qk_nope + qk_rope)
    q5, k, v = _attn_constrain(q5, k, v)
    if impl == "chunked":
        out = _chunked_attn(q5, k, v, offset=0, window=None, chunk=chunk)
    else:
        out = _full_attn(q5, k, v, _causal_mask(s, s, 0, None, x.device))
    out = out.reshape(b, s, h * vh)
    return linear(p.wo, out)


def mla_decode(p, cfg, x, cache_ckv, cache_kr, pos: int):
    """Absorbed-matrices MLA decode (DeepSeek-V2 inference optimization):
    attend directly in the kv_lora latent space, all in f32; the cache is
    one layer's (B,S,kv_lora) + (B,S,rope) views, this token's entries
    written at ``pos`` in place.  Returns (out, cache_ckv, cache_kr)."""
    f32 = torch.float32
    b = x.shape[0]
    h = cfg.num_heads
    qk_nope, qk_rope, vh = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    lora = cfg.kv_lora_rank
    s = cache_ckv.shape[1]

    q_nope, q_rope = _mla_q(p, cfg, x)                  # (B,1,H,*)
    position = torch.full((1,), pos, dtype=f32, device=x.device)
    cos, sin = rope_angles(position, p.freqs)
    q_rope = apply_rope(q_rope, cos[None, :, None], sin[None, :, None])

    ckv = rmsnorm(p.kv_norm, linear(p.wdkv, x), cfg.norm_eps)  # (B,1,lora)
    kr = apply_rope(linear(p.wkr, x), cos, sin)                # (B,1,rope)
    cache_ckv[:, pos].copy_(ckv[:, 0])
    cache_kr[:, pos].copy_(kr[:, 0])

    # absorb W_uk into q: q_eff (B,1,H,lora)
    wuk = p.wuk.w.reshape(lora, h, qk_nope)
    q_eff = torch.einsum("bqhn,lhn->bqhl", q_nope.to(f32), wuk.to(f32))
    scores = (torch.einsum("bqhl,bsl->bhqs", q_eff, cache_ckv.to(f32))
              + torch.einsum("bqhr,bsr->bhqs", q_rope.to(f32),
                             cache_kr.to(f32)))
    scores = scores * ((qk_nope + qk_rope) ** -0.5)
    valid = torch.arange(s, device=x.device)[None, None, None, :] <= pos
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqs,bsl->bqhl", probs, cache_ckv.to(f32))
    wuv = p.wuv.w.reshape(lora, h, vh)
    out = torch.einsum("bqhl,lhv->bqhv", ctx, wuv.to(f32))
    out = out.to(x.dtype).reshape(b, 1, h * vh)
    return linear(p.wo, out), cache_ckv, cache_kr
