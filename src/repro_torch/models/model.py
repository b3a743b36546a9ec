"""Family dispatch: the port's counterpart of ``repro.models.model``.

``build_model`` returns the model's parameters as a module whose
``forward``, ``loss``, ``init_cache`` and ``decode_step`` run under its
config (the reference returns a ``Model`` of functions over a params
pytree; ``Model.loss`` is ``Transformer.loss`` here): an
``encdec.EncDec`` for an enc-dec config, else a
``transformer.Transformer`` (dense, vlm, moe, ssm, hybrid).
``family(cfg)`` is the module of functions of (params, cfg, ...) that a
caller runs under another config (``forward``, ``loss_fn``,
``decode_step``, ``init_params``).
"""
from __future__ import annotations

import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device

from . import encdec, transformer


def family(cfg):
    """The module that holds ``cfg``'s model functions."""
    return encdec if cfg.is_encdec else transformer


def init_params(cfg, *, device=None, generator=None):
    """``cfg``'s model on ``device`` (``"meta"`` for shapes alone), drawn
    from ``generator``, or left unset without one."""
    return family(cfg).init_params(cfg, device=device, generator=generator)


def build_model(cfg, *, device=DEFAULT_DEVICE, generator=None):
    """The model of ``cfg`` on ``device`` (the card unless the caller asks
    for the CPU), its weights drawn from ``generator`` (a fresh generator
    on that device seeded 0 by default)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return init_params(cfg, device=dev, generator=generator)


def param_count(params) -> int:
    return sum(int(p.numel()) for p in params.parameters())
