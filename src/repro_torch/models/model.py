"""Family dispatch: the port's counterpart of ``repro.models.model``.

``build_model`` returns the model's parameters as a module whose
``forward``, ``init_cache`` and ``decode_step`` run under its config
(the reference returns a ``Model`` of functions over a params pytree).
The dense and vlm families are ported; the others raise
``NotImplementedError`` (ROADMAP queue 1, 13.4).
"""
from __future__ import annotations

import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device

from . import transformer


def build_model(cfg, *, device=DEFAULT_DEVICE, generator=None):
    """The model of ``cfg`` on ``device`` (the card unless the caller asks
    for the CPU), its weights drawn from ``generator`` (a fresh generator
    on that device seeded 0 by default)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return transformer.init_params(cfg, device=dev, generator=generator)


def param_count(params) -> int:
    return sum(int(p.numel()) for p in params.parameters())
