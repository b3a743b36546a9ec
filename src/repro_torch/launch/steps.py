"""Step builders: the port's counterparts of ``repro.launch.steps``'s
``make_train_step``, ``make_prefill_step`` and ``make_serve_step``.

A train state is ``{"params": model, "opt": adamw state}`` (the model a
``repro_torch.models`` module, the optimizer state ``adamw.init_state``'s).
Each step runs its config's family functions (``models.model.family``):
the enc-dec loss has no aux term.
The reference's dry-run half of this module (``SHAPES``, the batch, cache
and state specs and shardings, ``build_cell``) needs the mesh substrate and
is not ported yet (ROADMAP queue 1, 13.5).
"""
from __future__ import annotations

import torch

from repro_torch.models import model as model_mod
from repro_torch.models import transformer
from repro_torch.optim import adamw


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *, donate: bool = False):
    """``step(state, batch) -> (new_state, metrics)``: the loss and its
    gradients (``torch.autograd.grad``; a parameter the loss never reads
    gets ``None``, which AdamW takes as zeros), then one AdamW update.
    The metrics are device tensors: loss, nll, aux, lr, grad_norm.

    ``donate=False``: out of place, the old state survives the call, as a
    jitted step without donation leaves it.  ``donate=True``: the update
    is made in place and the state returned is the one passed, the port's
    reading of the reference's ``TrainerConfig.donate`` (the old state is
    gone, so a non-finite step cannot be rolled back).  Only the in-place
    step fits a large model beside its optimizer state: the out-of-place
    one holds the old and the new (params, m, v) at once."""
    fam = model_mod.family(cfg)

    def train_step(state, batch):
        model = state["params"]
        named = dict(model.named_parameters())
        with torch.enable_grad():
            loss, metrics = fam.loss_fn(model, cfg, batch)
            grads = torch.autograd.grad(loss, list(named.values()),
                                        allow_unused=True)
        new_params, new_opt, om = adamw.apply_updates(
            named, dict(zip(named, grads)), state["opt"], opt_cfg,
            inplace=donate)
        if not donate:
            model = transformer.with_params(model, new_params)
        out_metrics = {"loss": loss.detach(), "nll": metrics["nll"].detach(),
                       "aux": metrics["aux"].detach(), **om}
        return {"params": model, "opt": new_opt}, out_metrics

    return train_step


def make_prefill_step(cfg):
    fam = model_mod.family(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = fam.forward(params, cfg, batch)
        return logits[:, -1]          # next-token logits

    return prefill_step


def make_serve_step(cfg):
    fam = model_mod.family(cfg)

    def serve_step(params, cache, tokens, pos):
        logits, cache = fam.decode_step(params, cfg, cache, tokens, pos)
        return logits[:, -1], cache

    return serve_step
