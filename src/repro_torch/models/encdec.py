"""Encoder-decoder stack (seamless-m4t-large-v2 backbone): the port's
counterpart of ``repro.models.encdec``.

Encoder: bidirectional self-attention over precomputed frame embeddings
(the speech frontend is a stub per the assignment).  Decoder: causal
self-attention + cross-attention over encoder memory.  Decode caches:
self-attn K/V per layer plus cross-attn K/V precomputed once from the
encoder memory (``prefill_memory``); ``decode_step`` writes the self-attn
K/V at ``pos`` in place.  ``EncDec`` holds the parameters and runs them
under its own config, as ``transformer.Transformer`` does.  Under a mesh
whose ``model`` axis splits the config (``dist.tensor_parallel.plan``),
the encoder's, the decoder's and the cross-attention's heads, the MLP's
hidden and the vocab split as in ``transformer``; the memory's k and v
are this rank's cache block (``_mem_block``).
"""
from __future__ import annotations

import types

import torch
from torch import nn

from repro_torch.dist import context as dist_context
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.dist.context import constrain

from . import attention as attn
from .modules import (dtype_of, embedding_init, linear, linear_init, rmsnorm,
                      rmsnorm_init)
from .transformer import (_head, _remat, _vocab_plan, attention_cache,
                          mlp_apply, mlp_init, parallel_cross_entropy,
                          token_embeds)


def _xattn_init(generator, cfg, dtype, device=None) -> nn.Module:
    h, kv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    kw = dict(dtype=dtype, device=device)
    p = nn.Module()
    p.wq = linear_init(generator, d, h * hd, **kw)
    p.wk = linear_init(generator, d, kv * hd, **kw)
    p.wv = linear_init(generator, d, kv * hd, **kw)
    p.wo = linear_init(generator, h * hd, d,
                       scale=(h * hd) ** -0.5 / (2 * cfg.num_layers) ** 0.5,
                       **kw)
    return p


def enc_layer_init(generator, cfg, dtype, device=None) -> nn.Module:
    p = nn.Module()
    p.ln1 = rmsnorm_init(cfg.d_model, dtype, device=device)
    p.attn = attn.gqa_init(generator, cfg, dtype, device)
    p.ln2 = rmsnorm_init(cfg.d_model, dtype, device=device)
    p.mlp = mlp_init(generator, cfg, dtype, cfg.d_ff, device)
    return p


def dec_layer_init(generator, cfg, dtype, device=None) -> nn.Module:
    p = enc_layer_init(generator, cfg, dtype, device)
    p.ln_x = rmsnorm_init(cfg.d_model, dtype, device=device)
    p.xattn = _xattn_init(generator, cfg, dtype, device)
    return p


def _bidir_attn(p, cfg, x, positions):
    """Encoder self-attention (no causal mask): ``attention.gqa_apply``
    with ``causal=False``, its layouts over ``model`` included."""
    impl = "chunked" if x.shape[1] > 8192 else "full"
    return attn.gqa_apply(p, cfg, x, positions=positions, impl=impl,
                          causal=False)


def _cross_attn(p, cfg, x, memory):
    """x: (B,Sq,D) against the encoder memory (B,Skv,D), whose k and v
    ``_mem_kv`` computes.  Under a splitting mesh, as the reference's
    ``_attn_constrain`` lays it out: this rank's KV-head group (its
    columns of ``wq``, ``wk``, ``wv``, its rows of ``wo``, the sum over
    ``model``), or its block of query rows against the whole memory (the
    weights whole behind ``copy_in``, the rows gathered back)."""
    tp = tpar.plan(cfg)
    layout = dist_context.tp_layout(cfg, dist_context.get_mesh(), x.shape[1])
    if layout == "whole":
        tp = None
    b, sq, _ = x.shape
    r0, sl = 0, sq
    if layout == "rows":
        p = types.SimpleNamespace(**{n: attn._whole(getattr(p, n), tp)
                                     for n in ("wq", "wk", "wv", "wo")})
        sl = sq // tp.size
        r0 = tp.rank * sl
    x, memory = tpar.copy_in(x, tp), tpar.copy_in(memory, tp)
    mem_k, mem_v = _mem_kv(p, cfg, memory)
    kvh, hd = mem_k.shape[2], cfg.head_dim
    h = p.wq.w.shape[1] // hd
    skv = mem_k.shape[1]
    q = linear(p.wq, x[:, r0:r0 + sl]).reshape(b, sl, kvh, h // kvh, hd)
    q, mem_k, mem_v = attn._attn_constrain(q, mem_k, mem_v)
    impl = "chunked" if max(sq, skv) > 8192 and sq > 1 else "full"
    out = attn._attend(q, mem_k, mem_v, offset=0, window=None, impl=impl,
                       chunk=1024, causal=False)
    out = linear(p.wo, out.reshape(b, sl, h * hd))
    if layout == "rows":
        return tpar.gather(out, 1, tp)
    return tpar.reduce_out(out, tp)


def _mem_kv(p, cfg, memory):
    """The memory's k and v (B,Skv,KV,hd): the heads ``wk``'s columns
    hold."""
    b, s, _ = memory.shape
    kvh = p.wk.w.shape[1] // cfg.head_dim
    k = linear(p.wk, memory).reshape(b, s, kvh, cfg.head_dim)
    v = linear(p.wv, memory).reshape(b, s, kvh, cfg.head_dim)
    return k, v


def _cross_decode(p, cfg, x, mem_k, mem_v):
    """The cross-attention at one decode position against this rank's
    block of the memory's k and v (``prefill_memory``), in the cache
    layout of ``attention.decode_layout``: its KV heads, its slice of
    ``head_dim`` (the partial q.k summed before the softmax) or its
    block of memory positions (the softmax's max and sum over the ranks'
    blocks); every memory position is read."""
    layout, tp = attn.decode_layout(cfg)
    b = x.shape[0]
    q = attn.decode_q(p.wq, cfg, x, layout, tp)
    q = q.reshape(b, 1, mem_k.shape[2], q.shape[2] // mem_k.shape[2],
                  q.shape[3])
    valid = torch.ones((mem_k.shape[1],), dtype=torch.bool, device=x.device)
    out = attn.decode_attend(q, mem_k, mem_v, valid, layout, tp, x.dtype,
                             cfg.head_dim ** -0.5)
    return attn.decode_out(p.wo, cfg, out, layout, tp)


class EncDec(nn.Module):
    """The parameters of an encoder-decoder LM, and ``forward``, ``loss``,
    ``init_cache``, ``prefill_memory`` and ``decode_step`` under its own
    config (the reference's ``Model`` of ``models/model.py``)."""

    def __init__(self, cfg, *, device, generator):
        super().__init__()
        self.cfg = cfg
        dtype = dtype_of(cfg.param_dtype)
        fd = cfg.frontend_dim or cfg.d_model
        self.embed = embedding_init(generator, cfg.padded_vocab, cfg.d_model,
                                    dtype, device=device)
        self.frontend_proj = linear_init(generator, fd, cfg.d_model,
                                         dtype=dtype, device=device)
        self.enc_layers = nn.ModuleList(
            enc_layer_init(generator, cfg, dtype, device)
            for _ in range(cfg.encoder_layers))
        self.dec_layers = nn.ModuleList(
            dec_layer_init(generator, cfg, dtype, device)
            for _ in range(cfg.num_layers))
        self.ln_enc = rmsnorm_init(cfg.d_model, dtype, device=device)
        self.ln_f = rmsnorm_init(cfg.d_model, dtype, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = linear_init(generator, cfg.d_model,
                                       cfg.padded_vocab, dtype=dtype,
                                       device=device)

    def forward(self, batch, *, impl: str | None = None):
        return forward(self, self.cfg, batch, impl=impl)

    def loss(self, batch):
        return loss_fn(self, self.cfg, batch)

    def init_cache(self, batch: int, max_len: int, enc_len: int = 1024,
                   dtype=torch.bfloat16):
        return init_cache(self.cfg, batch, max_len, enc_len, dtype,
                          device=self.embed.table.device,
                          mesh=dist_context.get_mesh())

    def prefill_memory(self, cache, embeds):
        return prefill_memory(self, self.cfg, cache, embeds)

    def decode_step(self, cache, tokens, pos: int):
        return decode_step(self, self.cfg, cache, tokens, pos)


def init_params(cfg, *, device=None, generator=None) -> EncDec:
    """The model's parameters on ``device``, drawn from ``generator``
    (left unset without one, for a caller that loads them)."""
    return EncDec(cfg, device=device, generator=generator)


def _enc_layer(lp, cfg, h, positions):
    hh = rmsnorm(lp.ln1, h, cfg.norm_eps)
    h = h + _bidir_attn(lp.attn, cfg, hh, positions)
    hh = rmsnorm(lp.ln2, h, cfg.norm_eps)
    return h + mlp_apply(lp.mlp, cfg, hh)


def encode(params, cfg, embeds):
    """embeds: (B,Senc,Fd) precomputed frame embeddings -> memory (B,Senc,D)."""
    cd = dtype_of(cfg.compute_dtype)
    x = linear(params.frontend_proj, embeds.to(cd))
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    layer = _remat(_enc_layer, cfg)
    for lp in params.enc_layers:
        x = layer(lp, cfg, x, positions)
    return rmsnorm(params.ln_enc, x, cfg.norm_eps)


def _dec_layer(lp, cfg, h, memory, positions, impl):
    hh = rmsnorm(lp.ln1, h, cfg.norm_eps)
    h = h + attn.gqa_apply(lp.attn, cfg, hh, positions=positions, impl=impl)
    hh = rmsnorm(lp.ln_x, h, cfg.norm_eps)
    h = h + _cross_attn(lp.xattn, cfg, hh, memory)
    hh = rmsnorm(lp.ln2, h, cfg.norm_eps)
    return h + mlp_apply(lp.mlp, cfg, hh)


def forward(params, cfg, batch, *, impl: str | None = None):
    """batch: {"embeds": (B,Senc,Fd), "tokens": (B,Sdec)}. Teacher-forced.
    Returns (logits, aux); the family has no aux loss (0)."""
    cd = dtype_of(cfg.compute_dtype)
    memory = encode(params, cfg, batch["embeds"])
    x = token_embeds(params.embed.table, batch["tokens"], cfg, cd)
    s = x.shape[1]
    if impl is None:
        impl = "chunked" if s > 8192 else "full"
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    layer = _remat(_dec_layer, cfg)
    for lp in params.dec_layers:
        x = layer(lp, cfg, x, memory, positions, impl)
    logits = constrain(_head(params, cfg, x), "dp", None, "tp")
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, cfg, batch):
    """Next-token CE, no aux term. batch needs "labels": (B,Sdec) int.
    Returns (loss, {"nll", "aux"})."""
    logits, aux = forward(params, cfg, batch)
    nll = parallel_cross_entropy(logits, batch["labels"], _vocab_plan(cfg))
    return nll.mean(), {"nll": nll.mean(), "aux": aux}


def init_cache(cfg, batch: int, max_len: int, enc_len: int,
               dtype=torch.bfloat16, *, device=None, mesh=None):
    """The self-attention's k and v of ``max_len`` positions and the
    cross-attention's ``mem_k``/``mem_v`` of ``enc_len``, zeroed: whole,
    or with ``mesh`` this rank's blocks over ``model``
    (``transformer.attention_cache``; ``prefill_memory`` replaces the
    memory's by its blocks, ``_mem_block``)."""
    L = cfg.num_layers

    def zeros(n):
        return torch.zeros(attention_cache(cfg, (L, batch), n, mesh),
                           dtype=dtype, device=device)
    return {"k": zeros(max_len), "v": zeros(max_len),
            "mem_k": zeros(enc_len), "mem_v": zeros(enc_len)}


@torch.no_grad()
def prefill_memory(params, cfg, cache, embeds):
    """Run the encoder once and fill the cross-attn K/V cache: returns a
    cache whose ``mem_k``/``mem_v`` hold the memory's Senc positions (the
    self-attn ``k``/``v`` are ``cache``'s own tensors)."""
    memory = encode(params, cfg, embeds)
    mk, mv = zip(*(_mem_block(lp.xattn, cfg, memory)
                   for lp in params.dec_layers))
    cache = dict(cache)
    cache["mem_k"] = torch.stack(mk).to(cache["mem_k"].dtype)
    cache["mem_v"] = torch.stack(mv).to(cache["mem_v"].dtype)
    return cache


def _mem_block(p, cfg, memory):
    """The memory's k and v as this rank's cache block holds them
    (``attention.decode_layout``): its KV heads (``wk``/``wv``'s column
    blocks), its slice of ``head_dim``, or its block of positions, the
    ``ceil(S / m)`` from ``rank * ceil(S / m)`` that the memory holds
    (the last blocks shorter, or empty, where m does not divide S: the
    cross-attention reads every position and no mask is needed)."""
    layout, tp = attn.decode_layout(cfg)
    if layout == "head_dim":
        b, s, _ = memory.shape
        return tuple(attn.decode_q(lin, cfg, memory.reshape(b * s, 1, -1),
                                   layout, tp).reshape(b, s,
                                                       cfg.num_kv_heads, -1)
                     for lin in (p.wk, p.wv))
    if layout == "length":
        c = -(-memory.shape[1] // tp.size)
        memory = memory[:, tp.rank * c:(tp.rank + 1) * c]
    return _mem_kv(p, cfg, memory)


@torch.no_grad()
def decode_step(params, cfg, cache, tokens, pos: int):
    """tokens: (B,1) int; pos: a Python int.  Writes each layer's k and v
    at ``pos`` into ``cache`` in place; returns (logits, cache)."""
    cd = dtype_of(cfg.compute_dtype)
    x = token_embeds(params.embed.table, tokens, cfg, cd)
    for i, lp in enumerate(params.dec_layers):
        hh = rmsnorm(lp.ln1, x, cfg.norm_eps)
        a, _, _ = attn.gqa_decode(lp.attn, cfg, hh, cache["k"][i],
                                  cache["v"][i], pos)
        x = x + a
        hh = rmsnorm(lp.ln_x, x, cfg.norm_eps)
        x = x + _cross_decode(lp.xattn, cfg, hh, cache["mem_k"][i].to(cd),
                              cache["mem_v"][i].to(cd))
        hh = rmsnorm(lp.ln2, x, cfg.norm_eps)
        x = x + mlp_apply(lp.mlp, cfg, hh)
    return _head(params, cfg, x), cache
