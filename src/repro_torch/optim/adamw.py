"""AdamW with global-norm clipping, WSD/cosine schedules, and an optional
int8-quantized second moment: the port's counterpart of
``repro.optim.adamw``.

The state mirrors the model's parameters: ``m`` and ``v`` (or ``v_q``)
map each parameter's state-dict name to a tensor of its shape, and
``step`` is a device int32.  The reference stacks a layer group's
parameters on a leading axis as one leaf, where the port keeps one tensor
per layer; where that shows in the numbers the port follows the
reference's leaves (``leaf_groups``): the global norm sums them in the
reference's order, a stacked leaf's layers (on one leading axis or the
hybrid's two) as one term, and
``v_scale`` holds one scale per reference leaf, over all its layers
(keyed by the leaf's path, ``dense_layers.attn.wq.w``).

``apply_updates`` keeps the reference's order of operations (clip, the
bias corrections in f32, m, v, then the update with decay on every leaf)
and reads nothing on the host: the step, the learning rate and the norm
stay device tensors.  A parameter whose gradient is ``None`` (a leaf the
loss never reads) counts as a zero gradient, as ``jax.value_and_grad``
gives one: it is still decayed, and its m and v still move.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from . import schedules


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quantize_v: str = "none"          # none | int8


def _named(params) -> dict:
    """A model's parameters, or a dict of them, by state-dict name."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def leaf_groups(names) -> dict[str, list[str]]:
    """The reference's leaves in its order (dict keys sorted at every
    level), each with the state-dict names of the port's tensors that make
    it up: a layer group's leaf (``dense_layers.attn.wq.w``) is its L
    per-layer tensors (``dense_layers.<i>.attn.wq.w``) in layer order, the
    hybrid's two-axis leaf (``group_layers.mamba.A_log``) its G x K
    tensors (``group_layers.<g>.<i>.mamba.A_log``) in the order of the
    index tuple (g, i), the reference's row-major stacking."""
    groups: dict[tuple, list] = {}
    for name in names:
        parts = name.split(".")
        path = tuple(p for p in parts if not p.isdigit())
        index = tuple(int(p) for p in parts if p.isdigit())
        groups.setdefault(path, []).append((index, name))
    return {".".join(path): [n for _, n in sorted(groups[path])]
            for path in sorted(groups)}


def init_state(params, cfg: AdamWConfig):
    named = _named(params)
    device = next(iter(named.values())).device
    state = {"step": torch.zeros((), dtype=torch.int32, device=device),
             "m": {n: torch.zeros_like(p) for n, p in named.items()}}
    if cfg.quantize_v == "int8":
        state["v_q"] = {n: torch.zeros(p.shape, dtype=torch.int8,
                                       device=p.device)
                        for n, p in named.items()}
        state["v_scale"] = {key: torch.zeros((), dtype=torch.float32,
                                             device=device)
                            for key in leaf_groups(named)}
    else:
        state["v"] = {n: torch.zeros_like(p) for n, p in named.items()}
    return state


def _global_norm(grads, reduce=None):
    """grads: state-dict name -> tensor.  The sum of squares over the
    reference's leaves in its order, a stacked leaf's layers summed
    first; with ``reduce``, each leaf's sum is taken over its shards."""
    keys, sums = [], []
    for key, names in leaf_groups(grads).items():
        sq = [torch.sum(torch.square(grads[n].to(torch.float32)))
              for n in names]
        keys.append(key)
        sums.append(sq[0] if len(sq) == 1 else torch.stack(sq).sum())
    if reduce is not None:
        sums = list(reduce(keys, torch.stack(sums), "sum"))
    total = 0
    for s in sums:
        total = total + s
    return torch.sqrt(total)


def _dequant(v_q, scale):
    return v_q.to(torch.float32) * scale


def _vmax(layers):
    return torch.stack([torch.max(torch.abs(v)) for v in layers]).max()


def _quant(layers, vmax=None):
    """One reference leaf's second moment, its layers' tensors: int8
    codes per layer and the one scale of the whole leaf (``vmax``: the
    leaf's largest |v| over all its blocks, where a mesh shards it)."""
    if vmax is None:
        vmax = _vmax(layers)
    scale = torch.clamp_min(vmax / 127.0, 1e-12)
    q = [torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
         for v in layers]
    return q, scale.to(torch.float32)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig, *,
                  inplace: bool = False, reduce=None):
    """One AdamW step. Returns (new_params, new_state, metrics).

    params: a model or its parameters by state-dict name; grads: the
    gradients by the same names (``None`` or missing: zeros).  Out of
    place (the default) the inputs are left as they are and the new
    parameters are new tensors.  With ``inplace`` the parameters, the
    state's tensors and the gradients are overwritten and returned: the
    arithmetic is the same, bit for bit.

    ``reduce``: for a state sharded over a mesh, where the tensors are
    this rank's blocks, ``reduce(keys, values, op)`` takes one value per
    reference leaf (by ``leaf_groups`` key) and returns each combined by
    ``op`` ("sum" or "max") over the ranks that hold the leaf's other
    blocks: the global norm and the int8 scale see whole leaves, and a
    replicated leaf counts once (``launch.steps.LeafReduce``)."""
    sched_fn = {"cosine": schedules.cosine, "wsd": schedules.wsd}[cfg.schedule]
    named = _named(params)
    step = state["step"] + 1
    lr = sched_fn(step, peak_lr=cfg.peak_lr, warmup=cfg.warmup,
                  total=cfg.total_steps)

    grads = {n: torch.zeros_like(p) if grads.get(n) is None else grads[n]
             for n, p in named.items()}
    gnorm = _global_norm(grads, reduce)
    clip = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)

    bc1 = 1 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1 - cfg.b2 ** step.to(torch.float32)

    def put(old, new):
        return old.copy_(new) if inplace else new

    def update(p, m, v):
        upd = (m.to(torch.float32) / bc1) / \
            (torch.sqrt(v.to(torch.float32) / bc2) + cfg.eps)
        newp = p.to(torch.float32) - lr * (upd + cfg.weight_decay *
                                           p.to(torch.float32))
        return put(p, newp.to(p.dtype))

    def int8_v(key, n, g):
        return cfg.b2 * _dequant(state["v_q"][n], state["v_scale"][key]) \
            + (1 - cfg.b2) * torch.square(g.to(torch.float32))

    new_params, new_m = {}, {}
    int8 = cfg.quantize_v == "int8"
    groups = leaf_groups(named)
    vmax = {}
    if int8 and reduce is not None:
        # every leaf's scale over its blocks in one reduction: each new v
        # is computed once more here, and no collective runs per leaf
        keys = list(groups)
        local = torch.stack([_vmax([int8_v(key, n, grads[n] * clip)
                                    for n in groups[key]]) for key in keys])
        vmax = dict(zip(keys, reduce(keys, local, "max")))
    new_v, new_vq, new_vs = {}, {}, {}
    for key, names in groups.items():
        vs = []
        for n in names:
            g = put(grads[n], grads[n] * clip)
            m = state["m"][n]
            new_m[n] = put(m, cfg.b1 * m + (1 - cfg.b1) * g.to(m.dtype))
            if int8:
                vs.append(int8_v(key, n, g))
            else:
                v = state["v"][n]
                new_v[n] = put(v, cfg.b2 * v + (1 - cfg.b2) *
                               torch.square(g.to(v.dtype)))
                new_params[n] = update(named[n], new_m[n], new_v[n])
        if int8:
            for n, v in zip(names, vs):
                new_params[n] = update(named[n], new_m[n], v)
            qs, scale = _quant(vs, vmax.get(key))
            for n, q in zip(names, qs):
                new_vq[n] = put(state["v_q"][n], q)
            new_vs[key] = put(state["v_scale"][key], scale)

    new_state = {"step": put(state["step"], step), "m": new_m}
    if int8:
        new_state.update(v_q=new_vq, v_scale=new_vs)
    else:
        new_state["v"] = new_v
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_params, new_state, metrics
