"""Attention, the GQA half (with optional QKV bias / sliding window): the
port's counterpart of ``repro.models.attention``.  MLA waits for the MoE
family (ROADMAP queue 1, 13.4).

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

import torch
from torch import nn

from .modules import apply_rope, linear, linear_init, rope_angles, rope_freqs

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


def gqa_apply(p, cfg, x, *, positions, impl: str = "full", chunk: int = 1024):
    """Training/prefill self-attention. x: (B,S,D); positions: (S,) int."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // kvh
    b, s, _ = x.shape
    q = _split_heads(linear(p.wq, x), h, hd)
    k = _split_heads(linear(p.wk, x), kvh, hd)
    v = _split_heads(linear(p.wv, x), kvh, hd)
    cos, sin = rope_angles(positions, p.freqs)
    q = apply_rope(q, cos[None, :, None], sin[None, :, None])
    k = apply_rope(k, cos[None, :, None], sin[None, :, None])
    q = q.reshape(b, s, kvh, g, hd)
    if impl == "chunked":
        out = _chunked_attn(q, k, v, offset=0, window=cfg.sliding_window,
                            chunk=chunk)
    else:
        mask = _causal_mask(s, s, 0, cfg.sliding_window, x.device)
        out = _full_attn(q, k, v, mask)
    out = out.reshape(b, s, h * hd)
    return linear(p.wo, out)


def gqa_decode(p, cfg, x, cache_k, cache_v, pos: int):
    """Single-token decode. x: (B,1,D); cache_k/v: (B,S,KV,hd), one
    layer's views of the cache; pos: the current length, also the write
    index.  Writes this token's k and v into the cache in place and
    returns (out, cache_k, cache_v)."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
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
    kj = torch.arange(s, device=x.device)[None, None, None, None, :]
    valid = kj <= pos
    if cfg.sliding_window is not None:
        valid = valid & (pos - kj < cfg.sliding_window)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _einsum("bkgqs,bskh->bqkgh", probs, cache_v)
    out = out.reshape(b, 1, h * hd)
    return linear(p.wo, out), cache_k, cache_v
