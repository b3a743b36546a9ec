"""Decoder-LM spine, the ``dense`` / ``vlm`` families: the port's
counterpart of ``repro.models.transformer``.

  dense  — [attn, mlp] x L      (stablelm, qwen, minicpm, danube)
  vlm    — the same backbone over precomputed patch embeddings (internvl2)

The parameters live in ``nn.Module`` containers named as the reference's
pytree (``embed``, ``frontend_proj``, ``dense_layers``, ``ln_f``,
``lm_head``); the reference stacks the layers on a leading axis for
``lax.scan``, the port keeps one container per layer in an
``nn.ModuleList`` and loops over them.  The math is in functions of
(params, cfg, ...), as in the reference, so one set of weights runs under
another config's compute dtype; ``Transformer``'s methods call them with
its own config.  The reference's ``constrain`` anchors are no-ops without
a mesh and are left out on one card (the mesh substrate is ROADMAP
queue 1, 13.5); the MoE, SSM, hybrid and enc-dec families raise
``NotImplementedError`` (13.4), and the loss belongs to training (13.3).

The token embedding uses ``repro_torch.core.embedding_lookup`` — the
paper's sort+segment conflict resolution on the embedding-gradient MTTKRP
(cfg.embed_grad selects it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.embed_grad import embedding_lookup

from . import attention as attn
from .modules import (dtype_of, embedding_init, linear, linear_init,
                      rmsnorm, rmsnorm_init)

PORTED_FAMILIES = ("dense", "vlm")


def check_ported(cfg) -> None:
    """Raise for a config whose family the port does not run yet."""
    if cfg.family not in PORTED_FAMILIES or cfg.moe or cfg.is_encdec \
            or cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family (attention "
            f"{cfg.attention!r}) is not ported yet; the MoE, SSM, hybrid "
            f"and enc-dec families are ROADMAP queue 1, item 13.4")


# ------------------------------------------------------------------------ MLP
def mlp_init(generator, cfg, dtype, d_ff: int, device=None) -> nn.Module:
    d = cfg.d_model
    kw = dict(dtype=dtype, device=device)
    scale_out = d_ff ** -0.5 / (2 * max(1, cfg.num_layers)) ** 0.5
    p = nn.Module()
    p.wi = linear_init(generator, d, d_ff, **kw)
    if cfg.mlp_type == "swiglu":
        p.wg = linear_init(generator, d, d_ff, **kw)
    p.wo = linear_init(generator, d_ff, d, scale=scale_out, **kw)
    return p


def mlp_apply(p, cfg, x):
    if cfg.mlp_type == "swiglu":
        h = F.silu(linear(p.wg, x)) * linear(p.wi, x)
    else:
        h = F.gelu(linear(p.wi, x), approximate="tanh")   # jax.nn.gelu
    return linear(p.wo, h)


# ------------------------------------------------------------------- layers
def dense_layer_init(generator, cfg, dtype, device=None) -> nn.Module:
    p = nn.Module()
    p.ln1 = rmsnorm_init(cfg.d_model, dtype, device=device)
    p.attn = attn.gqa_init(generator, cfg, dtype, device)
    p.ln2 = rmsnorm_init(cfg.d_model, dtype, device=device)
    p.mlp = mlp_init(generator, cfg, dtype, cfg.d_ff, device)
    return p


def dense_layer_apply(p, cfg, x, positions, *, impl):
    h = rmsnorm(p.ln1, x, cfg.norm_eps)
    h = attn.gqa_apply(p.attn, cfg, h, positions=positions, impl=impl)
    x = x + h
    h = rmsnorm(p.ln2, x, cfg.norm_eps)
    return x + mlp_apply(p.mlp, cfg, h)


# ----------------------------------------------------------------- the model
class Transformer(nn.Module):
    """The parameters of a dense / vlm decoder LM, and ``forward``,
    ``init_cache`` and ``decode_step`` under its own config."""

    def __init__(self, cfg, *, device, generator):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dtype = dtype_of(cfg.param_dtype)
        self.embed = embedding_init(generator, cfg.padded_vocab, cfg.d_model,
                                    dtype, device=device)
        if cfg.input_mode == "embeddings":
            fd = cfg.frontend_dim or cfg.d_model
            self.frontend_proj = linear_init(generator, fd, cfg.d_model,
                                             dtype=dtype, device=device)
        self.dense_layers = nn.ModuleList(
            dense_layer_init(generator, cfg, dtype, device)
            for _ in range(cfg.num_layers))
        self.ln_f = rmsnorm_init(cfg.d_model, dtype, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = linear_init(generator, cfg.d_model,
                                       cfg.padded_vocab, dtype=dtype,
                                       device=device)

    def forward(self, batch, *, impl: str | None = None):
        return forward(self, self.cfg, batch, impl=impl)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        return init_cache(self.cfg, batch, max_len, dtype,
                          device=self.embed.table.device)

    def decode_step(self, cache, tokens, pos: int):
        return decode_step(self, self.cfg, cache, tokens, pos)


def init_params(cfg, *, device=None, generator=None) -> Transformer:
    """The model's parameters on ``device``, drawn from ``generator``
    (left unset without one, for a caller that loads them)."""
    return Transformer(cfg, device=device, generator=generator)


def _embed_in(p, cfg, batch, compute_dtype):
    if cfg.input_mode == "embeddings":
        x = linear(p.frontend_proj, batch["embeds"].to(compute_dtype))
    else:
        x = embedding_lookup(p.embed.table, batch["tokens"],
                             cfg.embed_grad).to(compute_dtype)
        # the reference scales by a weakly typed Python float, which JAX
        # rounds to the compute dtype before the product
        x = x * _rounded(cfg.d_model ** 0.5, compute_dtype)
    return x


def _rounded(value: float, dtype) -> float:
    """``value`` rounded to ``dtype`` on the host."""
    return float(torch.tensor(value, dtype=dtype))


def _head(p, cfg, x):
    x = rmsnorm(p.ln_f, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.matmul(x, p.embed.table.to(x.dtype).T)
    else:
        logits = linear(p.lm_head, x)
    return logits.to(torch.float32)


def forward(params, cfg, batch, *, impl: str | None = None):
    """batch: {"tokens": (B,S)} or {"embeds": (B,S,Fd)}. Returns (logits,
    aux); aux is the reference's MoE loss, 0 for these families."""
    cd = dtype_of(cfg.compute_dtype)
    x = _embed_in(params, cfg, batch, cd)
    s = x.shape[1]
    if impl is None:
        impl = "chunked" if s > 8192 else "full"
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    for lp in params.dense_layers:
        x = dense_layer_apply(lp, cfg, x, positions, impl=impl)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, cfg, x), aux


# ------------------------------------------------------------------- decode
def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device=None):
    """One (L, B, max_len, KV, hd) tensor each for k and v, zeroed."""
    check_ported(cfg)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


@torch.no_grad()
def decode_step(params, cfg, cache, tokens, pos: int):
    """One decode step. tokens: (B,1) int (or embeds (B,1,Fd)); pos: the
    current position, a Python int.  Writes each layer's k and v at
    ``pos`` into ``cache`` in place; returns (logits (B,1,V), cache)."""
    cd = dtype_of(cfg.compute_dtype)
    batch = {"tokens": tokens} if cfg.input_mode == "tokens" \
        else {"embeds": tokens}
    x = _embed_in(params, cfg, batch, cd)
    for i, lp in enumerate(params.dense_layers):
        hh = rmsnorm(lp.ln1, x, cfg.norm_eps)
        a, _, _ = attn.gqa_decode(lp.attn, cfg, hh, cache["k"][i],
                                  cache["v"][i], pos)
        x = x + a
        hh = rmsnorm(lp.ln2, x, cfg.norm_eps)
        x = x + mlp_apply(lp.mlp, cfg, hh)
    return _head(params, cfg, x), cache
