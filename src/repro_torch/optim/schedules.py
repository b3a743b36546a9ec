"""LR schedules: cosine (default) and WSD (warmup-stable-decay, MiniCPM).

The port's counterparts of ``repro.optim.schedules``.  Each is computed in
f32 on the step's device, in the reference's order of operations (Python
floats enter as f32 scalars, as ``jnp``'s weakly typed ones do), so a
train step reads nothing back to the host.  ``step`` is a device int32
tensor, or a Python int (then on the CPU).
"""
from __future__ import annotations

import math

import torch


def _f32(step):
    return torch.as_tensor(step).to(torch.float32)


def cosine(step, *, peak_lr: float, warmup: int, total: int,
           final_frac: float = 0.1):
    step = _f32(step)
    warm = peak_lr * step / max(1, warmup)
    frac = torch.clamp((step - warmup) / max(1, total - warmup), 0, 1)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, peak_lr * cos)


def wsd(step, *, peak_lr: float, warmup: int, total: int,
        decay_frac: float = 0.1, final_frac: float = 0.01):
    """Warmup -> stable plateau -> sharp (exponential) decay over the last
    ``decay_frac`` of training (MiniCPM, arXiv:2404.06395)."""
    step = _f32(step)
    f32 = dict(dtype=torch.float32, device=step.device)
    decay_steps = torch.full((), max(1, total * decay_frac), **f32)
    decay_start = total - decay_steps
    warm = peak_lr * step / max(1, warmup)
    dec_t = torch.clamp((step - decay_start) / decay_steps, 0, 1)
    dec = peak_lr * torch.exp(torch.full((), final_frac, **f32).log() * dec_t)
    return torch.where(step < warmup, warm,
                       torch.where(step < decay_start, peak_lr, dec))


def make_schedule(name: str, **kw):
    return {"cosine": cosine, "wsd": wsd}[name], kw
