"""The steps, train-state specs and the dry run's cells: the port's
counterpart of ``repro.launch.steps``.

Shapes (the reference's, assigned):
  train_4k    seq 4096,   global_batch 256   -> train_step (fwd+bwd+AdamW)
  prefill_32k seq 32768,  global_batch 32    -> prefill (fwd, last-pos logits)
  decode_32k  kv 32768,   global_batch 128   -> serve_step (1 new token)
  long_500k   kv 524288,  global_batch 1     -> serve_step; sub-quadratic
                                                archs only

A train state is ``{"params": model, "opt": adamw state}`` (the model a
``repro_torch.models`` module, the optimizer state ``adamw.init_state``'s).
Each step runs its config's family functions (``models.model.family``):
the enc-dec loss has no aux term.

On a mesh the state is ZeRO-sharded: every parameter and moment is a
``DTensor`` whose placements come from ``train_state_shardings``
(``shard_state`` puts a state there, ``gather_state`` brings it back
whole), and ``make_train_step(mesh=...)`` is the port's counterpart of
``jax.jit(train_step, in_shardings=(S, None), out_shardings=(S, None))``.
``make_prefill_step(cfg, mesh=)`` and ``make_serve_step(cfg, mesh=)`` are
the per-rank serving steps over parameters that ``shard_serve_params``
laid out.

The dry run's half: ``batch_specs`` and ``cache_specs`` give each cell's
batch and decode cache as ``meta`` tensors beside the reference's specs
(tuples, as ``dist.sharding`` keeps them: a batch dim splits over
``(pod,)+data`` when divisible, else stays replicated, and the KV length
takes the data axes instead), and ``build_cell`` returns a cell's
per-rank step with this rank's blocks of its arguments, which
``launch.dryrun`` traces on fake tensors.
"""
from __future__ import annotations

import math
import re

import torch
import torch.distributed as dist

from repro_torch.core.distributed import axis_group
from repro_torch.dist import context as dist_context
from repro_torch.dist import sharding as shd
from repro_torch.models import model as model_mod
from repro_torch.models import transformer
from repro_torch.optim import adamw


SHAPES = {
    "train_4k":    dict(kind="train",   seq=4096,   batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768,  batch=32),
    "decode_32k":  dict(kind="decode",  seq=32768,  batch=128),
    "long_500k":   dict(kind="decode",  seq=524288, batch=1),
}

ENC_LEN = 4096          # encoder memory length for enc-dec decode shapes


def shape_skip_reason(cfg, shape_name: str) -> str | None:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape_name == "long_500k" and not cfg.subquadratic:
        return ("full-attention arch: 500k-token decode KV does not meet the "
                "sub-quadratic requirement (DESIGN.md §5)")
    return None


def _dp(mesh):
    f = shd.fsdp_axes(mesh)
    return f if len(f) > 1 else f[0]


def _dp_size(mesh) -> int:
    sizes = shd.axis_sizes(mesh)
    return math.prod(sizes[a] for a in shd.fsdp_axes(mesh))


def _batch_spec(mesh, b: int, ndim: int) -> tuple:
    dp = _dp(mesh)
    spec = [None] * ndim
    if b % _dp_size(mesh) == 0:
        spec[0] = dp
    return tuple(spec)


def _empty(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


# --------------------------------------------------------------- batch specs
def batch_specs(cfg, shape_name: str, mesh, *, device="meta"):
    """(tensor tree, spec tree) for the step's batch argument: the global
    batch's shapes and dtypes as empty tensors on ``device`` (``meta`` by
    default; fake tensors under a ``FakeTensorMode``)."""
    info = SHAPES[shape_name]
    b, s = info["batch"], info["seq"]
    kind = info["kind"]
    fd = cfg.frontend_dim or cfg.d_model

    def sds(shape, dtype):
        return _empty(shape, dtype, device)

    if kind in ("train", "prefill"):
        batch, shard = {}, {}
        if cfg.is_encdec:
            batch["embeds"] = sds((b, s, fd), torch.bfloat16)
            shard["embeds"] = _batch_spec(mesh, b, 3)
            batch["tokens"] = sds((b, s), torch.int32)
            shard["tokens"] = _batch_spec(mesh, b, 2)
        elif cfg.input_mode == "embeddings":
            batch["embeds"] = sds((b, s, fd), torch.bfloat16)
            shard["embeds"] = _batch_spec(mesh, b, 3)
        else:
            batch["tokens"] = sds((b, s), torch.int32)
            shard["tokens"] = _batch_spec(mesh, b, 2)
        if kind == "train":
            batch["labels"] = sds((b, s), torch.int32)
            shard["labels"] = _batch_spec(mesh, b, 2)
        return batch, shard

    # decode: one new token against a KV cache of length s
    if cfg.input_mode == "embeddings" and not cfg.is_encdec:
        tok = sds((b, 1, fd), torch.bfloat16)
        tok_shard = _batch_spec(mesh, b, 3)
    else:
        tok = sds((b, 1), torch.int32)
        tok_shard = _batch_spec(mesh, b, 2)
    pos = sds((), torch.int32)
    return {"tokens": tok, "pos": pos}, {"tokens": tok_shard, "pos": ()}


def _init_cache(cfg, b: int, s: int, device):
    fam = model_mod.family(cfg)
    if cfg.is_encdec:
        return fam.init_cache(cfg, b, s, ENC_LEN, device=device)
    return fam.init_cache(cfg, b, s, device=device)


def cache_specs(cfg, shape_name: str, mesh):
    """(cache tree, spec tree): the global decode cache of the shape (the
    port's ``init_cache`` on the ``meta`` device) and the reference's
    specs, keyed by the cache's names."""
    info = SHAPES[shape_name]
    b, s = info["batch"], info["seq"]
    cache = _init_cache(cfg, b, s, "meta")
    return cache, _cache_shardings(mesh, cache, b)


def _cache_shardings(mesh, cache_tree, batch: int):
    dp = _dp(mesh)
    dps = _dp_size(mesh)
    tp = shd.axis_sizes(mesh)["model"]

    def one(key, leaf):
        nd = leaf.dim()
        shape = tuple(leaf.shape)
        spec = [None] * nd

        def put(i, ax, size):
            if spec[i] is None and shape[i] % size == 0 and ax not in spec:
                spec[i] = ax

        if key in ("k", "v", "attn_k", "attn_v", "mem_k", "mem_v") and nd == 5:
            # (L|G, B, S, KV, hd)
            if shape[1] % dps == 0:
                put(1, dp, dps)
            else:
                put(2, dp, dps)          # tiny batch: sequence-parallel cache
            if shape[3] % tp == 0:
                put(3, "model", tp)
            elif shape[4] % tp == 0:
                put(4, "model", tp)      # kv < tp: shard head_dim instead
            else:
                put(2, "model", tp)      # neither divides: KV-length shard
        elif key in ("ckv", "kr") and nd == 4:
            # (L, B, S, lora|rope)
            if shape[1] % dps == 0:
                put(1, dp, dps)
            else:
                put(2, dp, dps)
            put(3, "model", tp)
        elif key == "ssm":
            if nd == 5:                   # (L, B, H, N, P)
                put(1, dp, dps)
                put(2, "model", tp)
            elif nd == 6:                 # (G, per, B, H, N, P)
                put(2, dp, dps)
                put(3, "model", tp)
        elif key == "conv":
            if nd == 4:                   # (L, B, W, C)
                put(1, dp, dps)
                put(3, "model", tp)
            elif nd == 5:                 # (G, per, B, W, C)
                put(2, dp, dps)
                put(4, "model", tp)
        else:
            if nd >= 2 and shape[1] == batch:
                put(1, dp, dps)
        return tuple(spec)

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, str(k)) for k, v in tree.items()}
        return one(key, tree)

    return walk(cache_tree)


# ---------------------------------------------------------------- state specs
def abstract_train_state(cfg, opt_cfg: adamw.AdamWConfig, *, device="meta"):
    """The train state's shapes and dtypes, its parameters left unset: on
    the ``meta`` device by default (a generator cannot draw there), fake
    tensors on ``device`` under a ``FakeTensorMode``."""
    params = model_mod.init_params(cfg, device=device)
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


# the routed experts' stacked weights (E, ., .), which a serving rank keeps
# as its own E / tp block
_EXPERT = re.compile(r"(^|\.)moe\.w[igo]\.w$")


def serve_layout(mesh, named: dict) -> dict:
    """``{state-dict name: spec}`` of what a serving rank holds: the
    reference's serve-mode spec (``param_shardings(mode="serve")``), but a
    routed expert stack split on its expert dim over ``model`` (this
    rank's E / tp experts, as ``moe_apply_sharded`` runs them)."""
    specs = shd.param_shardings(mesh, named, mode="serve")
    if shd.axis_sizes(mesh).get("model", 1) > 1:
        for n in specs:
            if _EXPERT.search(n):
                specs[n] = ("model",) + (None,) * (named[n].dim() - 1)
    return specs


def shard_serve_params(model, mesh):
    """A whole model (the same on every rank) as this rank's serving
    blocks: each parameter a ``DTensor`` placed by ``serve_layout`` (no
    collective)."""
    named = _named(model)
    layout = serve_layout(mesh, named)
    return transformer.with_params(model, {
        n: shd.distribute(p, mesh, layout[n]) for n, p in named.items()})


def _serve_whole(params, mesh):
    """The model a serving rank runs: each parameter gathered whole
    (``sharding.gather``) but the routed experts on a ``model`` axis
    above 1, which stay this rank's block (``serve_layout``)."""
    from torch.distributed.tensor import DTensor
    if dist_context.get_mesh() is not mesh:
        raise ValueError("the per-rank serving steps run under their mesh: "
                         "repro_torch.dist.set_mesh(mesh) first")
    split = shd.axis_sizes(mesh).get("model", 1) > 1
    whole, blocks = {}, {}
    for n, p in _named(params).items():
        if split and isinstance(p, DTensor) and _EXPERT.search(n):
            blocks[n] = p.to_local().detach()
            whole[n] = torch.empty(p.shape, dtype=p.dtype, device="meta")
        else:
            whole[n] = shd.gather(p)
    model = transformer.with_params(params, whole)
    for n, blk in blocks.items():
        module, _, attr = n.rpartition(".")
        setattr(model.get_submodule(module), attr,
                torch.nn.Parameter(blk, requires_grad=False))
    return model


def _rows(mesh, batch: dict) -> dict:
    """This rank's rows of the batch (``data_rows``) where every entry's
    batch dim divides over the data axes; else the whole batch, which
    every rank runs (the reference's ``_batch_spec`` leaves it
    replicated)."""
    n = _dp_size(mesh)
    if all(v is None or v.shape[0] % n == 0 for v in batch.values()):
        return data_rows(mesh, batch)
    return batch


def make_prefill_step(cfg, *, mesh=None):
    """``prefill_step(params, batch) -> (B, V)`` next-token logits.  With
    ``mesh``: per-rank code over ``shard_serve_params``' blocks that
    gathers the parameters (the experts stay this rank's), runs this
    rank's rows of the global batch and returns their logits."""
    fam = model_mod.family(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        if mesh is not None:
            params, batch = _serve_whole(params, mesh), _rows(mesh, batch)
        logits, _ = fam.forward(params, cfg, batch)
        return logits[:, -1]          # next-token logits

    return prefill_step


def make_serve_step(cfg, *, mesh=None):
    """``serve_step(params, cache, tokens, pos) -> (logits, cache)``.  With
    ``mesh``: per-rank code as ``make_prefill_step``'s, ``cache`` this
    rank's (its rows of the batch where they divide, else the whole
    batch's) and ``tokens`` the global batch's."""
    fam = model_mod.family(cfg)

    def serve_step(params, cache, tokens, pos):
        if mesh is not None:
            params = _serve_whole(params, mesh)
            tokens = _rows(mesh, {"tokens": tokens})["tokens"]
        logits, cache = fam.decode_step(params, cfg, cache, tokens, pos)
        return logits[:, -1], cache

    return serve_step


# ------------------------------------------------------------- cell assembly
def build_cell(cfg, shape_name: str, mesh, *,
               opt_cfg: adamw.AdamWConfig | None = None, device="meta"):
    """Returns (fn, args, in_specs, out_specs): ``fn`` this rank's step,
    ``args`` this rank's blocks of its arguments as tensors on ``device``
    (fake ones under a ``FakeTensorMode``; a parameter's values are left
    unset), and the reference's specs of the cell's global arguments and
    outputs.  The step runs under ``set_mesh(mesh)``.

    train: the in-place ZeRO step (``make_train_step(donate=True,
    mesh=)``) over ``shard_state``'s blocks and the global batch.
    prefill and decode: ``make_prefill_step``/``make_serve_step`` over
    ``shard_serve_params``' blocks, the global batch's tokens, and a
    decode cache of this rank's rows (the whole batch's where the batch
    does not divide over the data axes) written at the last position."""
    info = SHAPES[shape_name]
    kind = info["kind"]
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    b = info["batch"]

    if kind == "train":
        state = abstract_train_state(cfg, opt_cfg, device=device)
        state_sh = train_state_shardings(mesh, state)
        state = shard_state(state, mesh, state_sh)
        batch, batch_sh = batch_specs(cfg, shape_name, mesh, device=device)
        fn = make_train_step(cfg, opt_cfg, donate=True, mesh=mesh)
        metrics_sh = {k: () for k in
                      ("loss", "nll", "aux", "lr", "grad_norm")}
        return (fn, (state, batch), (state_sh, batch_sh),
                (state_sh, metrics_sh))

    model = model_mod.init_params(cfg, device=device)
    params_sh = shd.param_shardings(mesh, _named(model), mode="serve")
    params = shard_serve_params(model, mesh)
    del model
    batch, batch_sh = batch_specs(cfg, shape_name, mesh, device=device)
    out_sh = _batch_spec(mesh, b, 2)
    if kind == "prefill":
        fn = make_prefill_step(cfg, mesh=mesh)
        return fn, (params, batch), (params_sh, batch_sh), out_sh

    # decode
    dps = _dp_size(mesh)
    rows = b // dps if b % dps == 0 else b
    cache = _init_cache(cfg, rows, info["seq"], device)
    cache_sh = _cache_shardings(mesh, cache_specs(cfg, shape_name, mesh)[0],
                                b)
    fn = make_serve_step(cfg, mesh=mesh)
    return (fn, (params, cache, batch["tokens"], info["seq"] - 1),
            (params_sh, cache_sh, batch_sh["tokens"], batch_sh["pos"]),
            (out_sh, cache_sh))
