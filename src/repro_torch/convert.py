"""Carry state across from the JAX package, as numpy arrays and plain values.

The port never imports the JAX package.  These helpers take what a caller
read out of it — arrays, tuples, floats — and build the port's objects, so
that one tensor and one set of factors can be fed to both packages:

    b = blco_from_arrays(ref.dims, ref.re.field_bits, ref.re.field_shift,
                         ref.re.block_bits, ref.idx_hi, ref.idx_lo,
                         ref.values,
                         [(k.key, k.start, k.end, k.upper) for k in ref.blocks],
                         [(l.block_ids, l.start, l.end) for l in ref.launches])

and the decoder LM's parameters both ways (``params_from_jax``,
``params_to_jax``), and its train state with them
(``train_state_from_jax``, ``train_state_to_jax``), which the
checkpoints write and read.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import linearize as lin
from repro_torch.core.blco import Block, BLCOTensor, Launch
from repro_torch.core.cp_als import CPState
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import model as model_mod


def blco_from_arrays(dims, field_bits, field_shift, block_bits, idx_hi,
                     idx_lo, values, blocks, launches) -> BLCOTensor:
    """A port ``BLCOTensor`` from the reference's arrays and tuples.

    blocks: ``(key, start, end, upper)`` tuples; launches:
    ``(block_ids, start, end)`` tuples.  The arrays are copied.
    """
    dims = tuple(int(d) for d in dims)
    re = lin.ReencodeSpec(tuple(int(x) for x in field_bits),
                          tuple(int(x) for x in field_shift),
                          tuple(int(x) for x in block_bits))
    idx_hi = np.array(idx_hi, dtype=np.uint32)
    idx_lo = np.array(idx_lo, dtype=np.uint32)
    values = np.array(values)
    if not idx_hi.shape == idx_lo.shape == values.shape:
        raise ValueError("idx_hi, idx_lo and values must share one shape")
    return BLCOTensor(
        dims=dims, spec=lin.LinearSpec.make(dims), re=re, idx_hi=idx_hi,
        idx_lo=idx_lo, values=values,
        blocks=[Block(key=int(k), start=int(s), end=int(e),
                      upper=tuple(int(u) for u in up))
                for k, s, e, up in blocks],
        launches=[Launch(block_ids=tuple(int(i) for i in ids), start=int(s),
                         end=int(e)) for ids, s, e in launches],
        construction_stats={})


def factors_from_numpy(arrays, device=DEFAULT_DEVICE) -> list:
    """Factor matrices as tensors on ``device``, dtype kept (copies)."""
    dev = resolve_device(device)
    return [torch.as_tensor(np.array(a)).to(dev) for a in arrays]


def cpstate_from_numpy(*, dims, rank: int, norm_x: float, tol: float,
                       factors, lam, fits=(), prev_fit: float = -np.inf,
                       iteration: int = 0, converged: bool = False,
                       device=DEFAULT_DEVICE) -> CPState:
    """A port ``CPState`` from the reference's state (arrays and values);
    the Gram matrices are recomputed from the factors."""
    fs = factors_from_numpy(factors, device)
    return CPState(dims=tuple(int(d) for d in dims), rank=int(rank),
                   norm_x=float(norm_x), tol=float(tol), factors=fs,
                   lam=torch.as_tensor(np.array(lam)).to(fs[0].device),
                   grams=[f.T @ f for f in fs], fits=list(fits),
                   prev_fit=float(prev_fit), iteration=int(iteration),
                   converged=bool(converged))


# the reference stacks each layer group's leaves on leading axes, one per
# group but two for the hybrid's (groups, layers per group)
STACKED = {"dense_layers": 1, "moe_layers": 1, "ssm_layers": 1,
           "pre_layers": 1, "group_layers": 2, "site_lora": 1,
           "enc_layers": 1, "dec_layers": 1}


def _flatten(tree, prefix=()):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def _unstacked(tree) -> dict:
    """The reference's nested dict of arrays as CPU tensors by state-dict
    name (copies), each stacked leaf split on its group's leading axes:
    ``(L, ...)`` into ``<group>.<i>...``, the hybrid's ``(G, K, ...)`` into
    ``group_layers.<g>.<i>...``."""
    out = {}
    for path, leaf in _flatten(tree):
        arr = torch.from_numpy(np.array(leaf))
        axes = STACKED.get(path[0], 0)
        for index in np.ndindex(*arr.shape[:axes]):
            out[".".join((path[0],) + tuple(map(str, index)) + path[1:])
                if axes else ".".join(path)] = arr[index]
    return out


def _check_like(got: dict, want: dict, what: str) -> None:
    """``got`` holds ``want``'s names, shapes and dtypes, or raise."""
    if set(got) != set(want):
        raise ValueError(f"the tree's leaves differ from {what}'s: "
                         f"missing {sorted(set(want) - set(got))}, extra "
                         f"{sorted(set(got) - set(want))}")
    for key, t in want.items():
        if got[key].shape != t.shape or got[key].dtype != t.dtype:
            raise ValueError(f"{key}: {tuple(got[key].shape)} "
                             f"{got[key].dtype}, {what} holds "
                             f"{tuple(t.shape)} {t.dtype}")


def params_from_jax(cfg, tree, *, device=DEFAULT_DEVICE):
    """The port's model of ``cfg`` holding the reference's parameters.

    tree: the reference's params pytree as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, model.init(key))``).  Each stacked (L, ...)
    leaf is split per layer; every array is copied with its dtype, and a
    missing, extra or mis-shaped leaf raises."""
    dev = resolve_device(device)
    model = model_mod.init_params(cfg, device=dev, generator=None)
    state = _unstacked(tree)
    _check_like(state, model.state_dict(), cfg.name)
    model.load_state_dict(state)
    return model



def tp_blocks_from_jax(cfg, tree, mesh) -> dict:
    """The reference's parameters (as ``params_from_jax`` reads them) cut
    to one rank's tensor-parallel blocks: ``{state-dict name: CPU
    tensor}``, this rank's ``chunk(m, dim)`` where ``sharding.tp_blocks``
    splits a leaf, else the whole leaf.  ``mesh`` needs the ``model``
    axis's extent and this rank's coordinate on it (``get_local_rank``);
    no process group is asked."""
    from repro_torch.dist.sharding import tp_blocks
    from repro_torch.dist.tensor_parallel import tp_rank, tp_size
    state = _unstacked(tree)
    dims = tp_blocks(state, cfg, mesh)
    m, r = tp_size(mesh), tp_rank(mesh)
    return {n: t if dims[n] is None else t.chunk(m, dim=dims[n])[r].clone()
            for n, t in state.items()}

def _host(t):
    """A tensor as a numpy array on the host; a meta tensor stays as it
    is (its shape is all a ``like`` tree needs)."""
    return t if t.is_meta else t.detach().cpu().numpy()


def _tree(named: dict, *, stack: bool = True) -> dict:
    """Tensors by dotted name as the reference's nested dict of numpy
    arrays, each layer group's per-layer tensors stacked on its leading
    axes (with ``stack``)."""
    tree: dict = {}
    for key, t in named.items():
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = t
    for group, axes in STACKED.items():
        if stack and group in tree:
            tree[group] = _stacked(tree[group], axes)
    return _map(tree, _host)


def _stacked(node: dict, axes: int) -> dict:
    """``node``'s children ``"0"``, ``"1"``, ... stacked on ``axes``
    leading axes, the innermost first."""
    items = [node[str(i)] for i in range(len(node))]
    if axes > 1:
        items = [_stacked(item, axes - 1) for item in items]
    return _stack(items)


def _stack(trees):
    first = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(first[k], dict)
            else torch.stack([t[k] for t in trees]) for k in first}


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def params_to_jax(model) -> dict:
    """The inverse: the model's parameters as the reference's pytree of
    numpy arrays, each layer group stacked on a leading axis."""
    return _tree(model.state_dict())


# the optimizer state's leaves that mirror the parameters
MOMENTS = ("m", "v", "v_q")


def train_state_to_jax(state) -> dict:
    """A train state ``{"params": model, "opt": {"step", "m", "v" | "v_q",
    "v_scale"}}`` as the reference's pytree of numpy arrays, stacked as
    ``params_to_jax`` stacks the parameters (``v_scale`` holds one scalar
    per reference leaf already).  A state on the meta device gives its
    shapes: the ``like`` tree of ``train.checkpoint.restore``."""
    opt = state["opt"]
    out = {"step": _host(opt["step"])}
    for k in MOMENTS:
        if k in opt:
            out[k] = _tree(opt[k])
    if "v_scale" in opt:
        out["v_scale"] = _tree(opt["v_scale"], stack=False)
    return {"params": params_to_jax(state["params"]), "opt": out}


def train_state_from_jax(cfg, tree, *, device=DEFAULT_DEVICE) -> dict:
    """The inverse: the reference's train state (nested dicts of numpy
    arrays, as ``jax.tree.map(np.asarray, state)`` or a checkpoint's
    restore gives it) as the port's, on ``device``; every leaf is copied
    and checked against the model's parameters."""
    model = params_from_jax(cfg, tree["params"], device=device)
    dev = model.embed.table.device
    params = dict(model.named_parameters())
    opt = tree["opt"]
    out = {"step": torch.from_numpy(np.array(opt["step"], np.int32)).to(dev)}
    for k in MOMENTS:
        if k in opt:
            named = _unstacked(opt[k])
            want = params if k != "v_q" else {
                n: p.to(dtype=torch.int8, device="meta")
                for n, p in params.items()}
            _check_like(named, want, f"{cfg.name}'s {k}")
            out[k] = {n: named[n].to(dev) for n in params}
    if "v_scale" in opt:
        out["v_scale"] = {".".join(path): torch.from_numpy(
            np.array(leaf, np.float32)).to(dev)
            for path, leaf in _flatten(opt["v_scale"])}
    return {"params": model, "opt": out}
