"""Encoder-decoder stack (seamless-m4t-large-v2 backbone): the port's
counterpart of ``repro.models.encdec``.

Encoder: bidirectional self-attention over precomputed frame embeddings
(the speech frontend is a stub per the assignment).  Decoder: causal
self-attention + cross-attention over encoder memory.  Decode caches:
self-attn K/V per layer plus cross-attn K/V precomputed once from the
encoder memory (``prefill_memory``); ``decode_step`` writes the self-attn
K/V at ``pos`` in place.  ``EncDec`` holds the parameters and runs them
under its own config, as ``transformer.Transformer`` does.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.embed_grad import embedding_lookup
from repro_torch.dist.context import constrain

from . import attention as attn
from .modules import (dtype_of, embedding_init, linear, linear_init, rmsnorm,
                      rmsnorm_init)
from .transformer import (_head, _remat, _rounded, mlp_apply, mlp_init,
                          parallel_cross_entropy)


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
    """Encoder self-attention (no causal mask)."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b, s, _ = x.shape
    q = linear(p.wq, x).reshape(b, s, h, hd)
    k = linear(p.wk, x).reshape(b, s, kvh, hd)
    v = linear(p.wv, x).reshape(b, s, kvh, hd)
    cos, sin = attn.rope_angles(positions, p.freqs)
    q = attn.apply_rope(q, cos[None, :, None], sin[None, :, None])
    k = attn.apply_rope(k, cos[None, :, None], sin[None, :, None])
    q = q.reshape(b, s, kvh, h // kvh, hd)
    q, k, v = attn._attn_constrain(q, k, v)
    if s > 8192:
        out = attn._chunked_attn(q, k, v, offset=0, window=None,
                                 causal=False)
    else:
        out = attn._full_attn(q, k, v, torch.ones((s, s), dtype=torch.bool,
                                                  device=x.device))
    return linear(p.wo, out.reshape(b, s, h * hd))


def _cross_attn(p, cfg, x, mem_k, mem_v):
    """x: (B,Sq,D); mem_k/v: (B,Skv,KV,hd) precomputed from encoder memory."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b, sq, _ = x.shape
    skv = mem_k.shape[1]
    q = linear(p.wq, x).reshape(b, sq, kvh, h // kvh, hd)
    q, mem_k, mem_v = attn._attn_constrain(q, mem_k, mem_v)
    if max(sq, skv) > 8192 and sq > 1:
        out = attn._chunked_attn(q, mem_k, mem_v, offset=0, window=None,
                                 causal=False)
    else:
        out = attn._full_attn(q, mem_k, mem_v, torch.ones(
            (sq, skv), dtype=torch.bool, device=x.device))
    return linear(p.wo, out.reshape(b, sq, h * hd))


def _mem_kv(p, cfg, memory):
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    b, s, _ = memory.shape
    k = linear(p.wk, memory).reshape(b, s, kvh, hd)
    v = linear(p.wv, memory).reshape(b, s, kvh, hd)
    return k, v


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
                          device=self.embed.table.device)

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


def _embed_tokens(params, cfg, tokens, cd):
    x = embedding_lookup(params.embed.table, tokens, cfg.embed_grad).to(cd)
    return x * _rounded(cfg.d_model ** 0.5, cd)


def _dec_layer(lp, cfg, h, memory, positions, impl):
    hh = rmsnorm(lp.ln1, h, cfg.norm_eps)
    h = h + attn.gqa_apply(lp.attn, cfg, hh, positions=positions, impl=impl)
    mk, mv = _mem_kv(lp.xattn, cfg, memory)
    hh = rmsnorm(lp.ln_x, h, cfg.norm_eps)
    h = h + _cross_attn(lp.xattn, cfg, hh, mk, mv)
    hh = rmsnorm(lp.ln2, h, cfg.norm_eps)
    return h + mlp_apply(lp.mlp, cfg, hh)


def forward(params, cfg, batch, *, impl: str | None = None):
    """batch: {"embeds": (B,Senc,Fd), "tokens": (B,Sdec)}. Teacher-forced.
    Returns (logits, aux); the family has no aux loss (0)."""
    cd = dtype_of(cfg.compute_dtype)
    memory = encode(params, cfg, batch["embeds"])
    x = _embed_tokens(params, cfg, batch["tokens"], cd)
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
    nll = parallel_cross_entropy(logits, batch["labels"])
    return nll.mean(), {"nll": nll.mean(), "aux": aux}


def init_cache(cfg, batch: int, max_len: int, enc_len: int,
               dtype=torch.bfloat16, *, device=None):
    L = cfg.num_layers
    kv, hd = cfg.num_kv_heads, cfg.head_dim

    def zeros(n):
        return torch.zeros((L, batch, n, kv, hd), dtype=dtype, device=device)
    return {"k": zeros(max_len), "v": zeros(max_len),
            "mem_k": zeros(enc_len), "mem_v": zeros(enc_len)}


@torch.no_grad()
def prefill_memory(params, cfg, cache, embeds):
    """Run the encoder once and fill the cross-attn K/V cache: returns a
    cache whose ``mem_k``/``mem_v`` hold the memory's Senc positions (the
    self-attn ``k``/``v`` are ``cache``'s own tensors)."""
    memory = encode(params, cfg, embeds)
    mk, mv = zip(*(_mem_kv(lp.xattn, cfg, memory) for lp in params.dec_layers))
    cache = dict(cache)
    cache["mem_k"] = torch.stack(mk).to(cache["mem_k"].dtype)
    cache["mem_v"] = torch.stack(mv).to(cache["mem_v"].dtype)
    return cache


@torch.no_grad()
def decode_step(params, cfg, cache, tokens, pos: int):
    """tokens: (B,1) int; pos: a Python int.  Writes each layer's k and v
    at ``pos`` into ``cache`` in place; returns (logits, cache)."""
    cd = dtype_of(cfg.compute_dtype)
    x = _embed_tokens(params, cfg, tokens, cd)
    for i, lp in enumerate(params.dec_layers):
        hh = rmsnorm(lp.ln1, x, cfg.norm_eps)
        a, _, _ = attn.gqa_decode(lp.attn, cfg, hh, cache["k"][i],
                                  cache["v"][i], pos)
        x = x + a
        hh = rmsnorm(lp.ln_x, x, cfg.norm_eps)
        x = x + _cross_attn(lp.xattn, cfg, hh, cache["mem_k"][i].to(cd),
                            cache["mem_v"][i].to(cd))
        hh = rmsnorm(lp.ln2, x, cfg.norm_eps)
        x = x + mlp_apply(lp.mlp, cfg, hh)
    return _head(params, cfg, x), cache
