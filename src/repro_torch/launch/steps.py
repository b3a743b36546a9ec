"""Step builders and train-state specs: the port's counterparts of
``repro.launch.steps``'s ``make_train_step``, ``make_prefill_step``,
``make_serve_step``, ``abstract_train_state`` and
``train_state_shardings``.

A train state is ``{"params": model, "opt": adamw state}`` (the model a
``repro_torch.models`` module, the optimizer state ``adamw.init_state``'s).
Each step runs its config's family functions (``models.model.family``):
the enc-dec loss has no aux term.

On a mesh the state is ZeRO-sharded: every parameter and moment is a
``DTensor`` whose placements come from ``train_state_shardings``
(``shard_state`` puts a state there, ``gather_state`` brings it back
whole), and ``make_train_step(mesh=...)`` is the port's counterpart of
``jax.jit(train_step, in_shardings=(S, None), out_shardings=(S, None))``.
The reference's dry-run half (``SHAPES``, the batch and cache specs,
``build_cell``) waits for ROADMAP queue 1, 13.5d.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.distributed import axis_group
from repro_torch.dist import context as dist_context
from repro_torch.dist import sharding as shd
from repro_torch.models import model as model_mod
from repro_torch.models import transformer
from repro_torch.optim import adamw


# ---------------------------------------------------------------- state specs
def abstract_train_state(cfg, opt_cfg: adamw.AdamWConfig):
    """The train state's shapes and dtypes on the ``meta`` device (a
    generator cannot draw there: the parameters are left unset)."""
    params = model_mod.init_params(cfg, device="meta")
    return {"params": params, "opt": adamw.init_state(params, opt_cfg)}


def train_state_shardings(mesh, state):
    """The state's specs: ``{"params": {name: spec}, "opt": {...}}``, the
    parameters and each moment by ``sharding.param_shardings`` (ZeRO over
    the data axes), ``step`` and every ``v_scale`` replicated (``()``)."""
    p_sh = shd.param_shardings(mesh, _named(state["params"]))
    opt_sh = {}
    for k, v in state["opt"].items():
        if k == "step":
            opt_sh[k] = ()
        elif k == "v_scale":
            opt_sh[k] = {key: () for key in v}
        else:
            opt_sh[k] = shd.param_shardings(mesh, v)
    return {"params": p_sh, "opt": opt_sh}


def _named(params) -> dict:
    return dict(params.named_parameters()) if isinstance(
        params, torch.nn.Module) else dict(params)


def shard_state(state, mesh, shardings):
    """A whole train state (the same on every rank) on ``mesh``: each
    parameter and moment this rank's block as a ``DTensor``
    (``sharding.distribute``, no collective); ``step`` and ``v_scale``
    stay plain tensors, replicated."""
    model = state["params"]
    params = {n: shd.distribute(p, mesh, shardings["params"][n])
              for n, p in _named(model).items()}
    opt = {}
    for k, v in state["opt"].items():
        opt[k] = v if k in ("step", "v_scale") else {
            n: shd.distribute(t, mesh, shardings["opt"][k][n])
            for n, t in v.items()}
    return {"params": transformer.with_params(model, params), "opt": opt}


def _like(block, like):
    """``block`` as a ``DTensor`` placed as the ``DTensor`` ``like``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(block, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def init_sharded_state(model, opt_cfg: adamw.AdamWConfig, mesh, shardings):
    """A fresh train state on ``mesh`` from a whole model (the same on every
    rank): the parameters' blocks, and the moments made as blocks, never
    whole (``adamw.init_state`` of the blocks)."""
    params = {n: shd.distribute(p, mesh, shardings["params"][n])
              for n, p in _named(model).items()}
    opt = adamw.init_state({n: p.to_local() for n, p in params.items()},
                           opt_cfg)
    for k, v in opt.items():
        if k in ("m", "v", "v_q"):
            opt[k] = {n: _like(t, params[n]) for n, t in v.items()}
    return {"params": transformer.with_params(model, params), "opt": opt}


def gather_state(state, device=None):
    """The whole train state on every rank (a collective): each ``DTensor``
    gathered (``sharding.gather``), a plain tensor as it is, and, with a
    ``device``, each copied there as soon as it is whole (one tensor's
    gather on the card at a time; ``"meta"`` keeps only the shapes)."""
    def whole(t):
        t = shd.gather(t)
        return t if device is None else t.to(device, copy=True)
    model = state["params"]
    params = {n: whole(p) for n, p in _named(model).items()}
    opt = {k: {n: whole(t) for n, t in v.items()} if isinstance(v, dict)
           else whole(v) for k, v in state["opt"].items()}
    return {"params": transformer.with_params(model, params), "opt": opt}


class LeafReduce:
    """``apply_updates``' ``reduce`` for a state sharded by placements:
    a reference leaf's value is combined over the mesh axes that shard the
    leaf's tensors (one ``all_reduce`` per set of axes), and a replicated
    leaf's is its own."""

    def __init__(self, mesh, named: dict):
        from torch.distributed.tensor import Shard
        self.mesh = mesh
        self.axes = {}
        for key, names in adamw.leaf_groups(named).items():
            place = named[names[0]].placements
            self.axes[key] = tuple(a for a, p in zip(mesh.mesh_dim_names,
                                                     place)
                                   if isinstance(p, Shard))

    def __call__(self, keys, values, op: str):
        by_axes: dict[tuple, list] = {}
        for i, key in enumerate(keys):
            if self.axes[key]:
                by_axes.setdefault(self.axes[key], []).append(i)
        if not by_axes:
            return values
        values = values.clone()
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        for axes, rows in by_axes.items():
            part = values[rows]
            dist.all_reduce(part, op=red, group=axis_group(self.mesh, axes)[0])
            values[rows] = part
        return values


# ----------------------------------------------------------------- the steps
def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *, donate: bool = False,
                    mesh=None):
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
    one holds the old and the new (params, m, v) at once.

    ``mesh``: the sharded step (see ``_sharded_step``) for a state that
    ``shard_state`` put on it, with the mesh installed
    (``dist.set_mesh``)."""
    fam = model_mod.family(cfg)
    if mesh is not None:
        return _sharded_step(cfg, opt_cfg, fam, donate, mesh)

    def train_step(state, batch):
        model = state["params"]
        named = dict(model.named_parameters())
        loss, metrics, grads = _loss_and_grads(fam, model, cfg, batch)
        new_params, new_opt, om = adamw.apply_updates(
            named, dict(zip(named, grads)), state["opt"], opt_cfg,
            inplace=donate)
        if not donate:
            model = transformer.with_params(model, new_params)
        out_metrics = {"loss": loss.detach(), "nll": metrics["nll"].detach(),
                       "aux": metrics["aux"].detach(), **om}
        return {"params": model, "opt": new_opt}, out_metrics

    return train_step


def _loss_and_grads(fam, model, cfg, batch):
    with torch.enable_grad():
        loss, metrics = fam.loss_fn(model, cfg, batch)
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
    return loss, metrics, grads


def data_rows(mesh, batch: dict) -> dict:
    """This rank's rows of a global batch: ``B / dp`` of them per data
    coordinate, pod-major (the reference's ``_batch_spec``: the batch dim
    split over the data axes).  ``B`` must divide evenly."""
    dp = dist_context._resolve(mesh, "dp")
    if dp is None:
        return batch
    group, coord = axis_group(mesh, dp)
    n = dist.get_world_size(group)
    out = {}
    for k, v in batch.items():
        if v is not None:
            if v.shape[0] % n:
                raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not "
                                 f"a multiple of the {n} data ranks")
            rows = v.shape[0] // n
            v = v[coord * rows:(coord + 1) * rows]
        out[k] = v
    return out


def _sharded_step(cfg, opt_cfg, fam, donate, mesh):
    """The ZeRO train step, as per-rank code: gather each parameter whole
    (``sharding.gather``), run the loss on this rank's rows of the batch
    (the MoE splits its experts over ``model``), reduce each gradient as a
    mean over the data axes, and update this rank's blocks of the
    parameters and moments, the global norm and the int8 scale over whole
    leaves (``LeafReduce``).  The metrics are the same on every rank: loss
    and nll averaged over the data axes, aux already averaged in the
    MoE."""
    from torch.distributed.tensor import DTensor
    dp = dist_context._resolve(mesh, "dp")
    dp_group = axis_group(mesh, dp)[0] if dp is not None else None
    n_dp = dist.get_world_size(dp_group) if dp_group is not None else 1

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    def train_step(state, batch):
        if dist_context.get_mesh() is not mesh:
            raise ValueError("the sharded train step runs under its mesh: "
                             "repro_torch.dist.set_mesh(mesh) first")
        model = state["params"]
        named = dict(model.named_parameters())
        whole = transformer.with_params(
            model, {n: shd.gather(p) for n, p in named.items()})
        loss, metrics, grads = _loss_and_grads(fam, whole, cfg,
                                               data_rows(mesh, batch))
        blocks = {}
        for (n, p), g in zip(named.items(), grads):
            if g is None:
                g = torch.zeros(p.shape, dtype=p.dtype, device=p.device)
            if n_dp > 1:
                dist.all_reduce(g, group=dp_group)
                g.div_(n_dp)
            blocks[n] = shd.block(g, mesh, p.placements)
        del grads, whole
        opt = {k: v if k in ("step", "v_scale") else
               {n: local(t) for n, t in v.items()}
               for k, v in state["opt"].items()}
        new_params, new_opt, om = adamw.apply_updates(
            {n: local(p) for n, p in named.items()}, blocks, opt, opt_cfg,
            inplace=donate, reduce=LeafReduce(mesh, named))
        lossy = torch.stack([loss.detach(), metrics["nll"].detach()])
        if n_dp > 1:
            dist.all_reduce(lossy, group=dp_group)
            lossy = lossy / n_dp
        metrics_out = {"loss": lossy[0], "nll": lossy[1],
                       "aux": metrics["aux"].detach(), **om}
        if donate:
            return state, metrics_out
        new_state_opt = {k: v if k in ("step", "v_scale") else
                         {n: _like(t, state["opt"][k][n])
                          for n, t in v.items()}
                         for k, v in new_opt.items()}
        return {"params": transformer.with_params(
                    model, {n: _like(new_params[n], p)
                            for n, p in named.items()}),
                "opt": new_state_opt}, metrics_out

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
