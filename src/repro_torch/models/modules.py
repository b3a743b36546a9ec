"""Parameter containers and the pure functions that apply them.

The port's counterpart of ``repro.models.modules``.  Conventions, as in
the reference:

* params are ``nn.Module`` containers, one where the reference has a
  dict, under the reference's names (``w``, ``b``, ``scale``, ``table``),
  so a state-dict key names the same leaf as the reference's pytree
  path (``convert.py``);
* the math is in functions of (container, input) — ``linear``,
  ``rmsnorm`` — that the model code calls with the config;
* params are stored in ``param_dtype`` and cast at use: matmuls run in
  the activations' dtype, norms and rotary in f32;
* the init helpers draw from an explicit ``torch.Generator``: a
  truncated normal on [-2, 2] times the scale, the reference's law with
  the port's own draws.  ``generator=None`` leaves the drawn weights
  unset for a caller that loads every tensor (``convert.params_from_jax``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _param(module, name, shape, dtype, device) -> nn.Parameter:
    p = nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    module.register_parameter(name, p)
    return p


def normal_(p, generator, scale: float):
    """Fill ``p`` in place with ``scale`` times a truncated normal on
    [-2, 2], drawn in f32 from ``generator`` (no-op without one)."""
    if generator is None:
        return p
    with torch.no_grad():
        t = p if p.dtype == torch.float32 else torch.empty(
            p.shape, dtype=torch.float32, device=p.device)
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.mul_(scale)
        if t is not p:
            p.copy_(t)
    return p


def linear_init(generator, d_in: int, d_out: int, *, bias: bool = False,
                dtype=torch.float32, scale: float | None = None,
                device=None) -> nn.Module:
    """``w``: (d_in, d_out), the reference's layout; ``b`` with ``bias``."""
    scale = scale if scale is not None else d_in ** -0.5
    p = nn.Module()
    normal_(_param(p, "w", (d_in, d_out), dtype, device), generator, scale)
    if bias:
        nn.init.zeros_(_param(p, "b", (d_out,), dtype, device))
    return p


def linear(p, x):
    # compute dtype follows the activations (set once at the embedding);
    # params are cast at use so they can be stored in fp32.
    y = torch.matmul(x, p.w.to(x.dtype))
    if hasattr(p, "b"):
        y = y + p.b.to(x.dtype)
    return y


def rmsnorm_init(d: int, dtype=torch.float32, *, device=None) -> nn.Module:
    p = nn.Module()
    nn.init.ones_(_param(p, "scale", (d,), dtype, device))
    return p


def rmsnorm(p, x, eps: float = 1e-5):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.to(torch.float32)).to(x.dtype)


def embedding_init(generator, vocab: int, d: int, dtype=torch.float32, *,
                   device=None) -> nn.Module:
    # d^-0.5 scale keeps tied-head logits O(1) (inputs are re-scaled by
    # sqrt(d) at lookup time).
    p = nn.Module()
    normal_(_param(p, "table", (vocab, d), dtype, device), generator,
            d ** -0.5)
    return p


# ------------------------------------------------------------------- rotary
def rope_freqs(dim: int, theta: float, device=None):
    """(dim//2,) f32 inverse frequencies.  Computed in numpy float64 and
    rounded once to f32, as the reference's f32 product rounds them: f32
    arithmetic here would move the angles by up to 2.4e-4 rad at 4096
    positions and rope_theta 1e6."""
    half = dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, half) * 2.0 / dim))
    return torch.from_numpy(freqs.astype(np.float32)).to(device)


def rope_angles(positions, freqs):
    """positions: (...,) int or float tensor; freqs: ``rope_freqs``'s ->
    (cos, sin) of shape (..., dim//2), fp32."""
    ang = positions.to(torch.float32)[..., None] * freqs[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., dim); cos/sin broadcastable to (..., dim//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    xf1, xf2 = x1.to(torch.float32), x2.to(torch.float32)
    return torch.cat(
        [xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def dtype_of(name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]
