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
``params_to_jax``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import linearize as lin
from repro_torch.core.blco import Block, BLCOTensor, Launch
from repro_torch.core.cp_als import CPState
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import transformer


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


# the reference stacks each layer group's leaves on a leading axis
STACKED = ("dense_layers",)


def _flatten(tree, prefix=()):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def params_from_jax(cfg, tree, *, device=DEFAULT_DEVICE):
    """The port's model of ``cfg`` holding the reference's parameters.

    tree: the reference's params pytree as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, model.init(key))``).  Each stacked (L, ...)
    leaf is split per layer; every array is copied with its dtype, and a
    missing, extra or mis-shaped leaf raises."""
    dev = resolve_device(device)
    model = transformer.init_params(cfg, device=dev, generator=None)
    state = {}
    for path, leaf in _flatten(tree):
        arr = torch.from_numpy(np.array(leaf))
        if path[0] in STACKED:
            for i in range(arr.shape[0]):
                state[".".join((path[0], str(i)) + path[1:])] = arr[i]
        else:
            state[".".join(path)] = arr
    want = model.state_dict()
    if set(state) != set(want):
        raise ValueError(f"the tree's leaves differ from {cfg.name}'s: "
                         f"missing {sorted(set(want) - set(state))}, extra "
                         f"{sorted(set(state) - set(want))}")
    for key, t in want.items():
        if state[key].shape != t.shape or state[key].dtype != t.dtype:
            raise ValueError(f"{key}: {tuple(state[key].shape)} "
                             f"{state[key].dtype}, the model holds "
                             f"{tuple(t.shape)} {t.dtype}")
    model.load_state_dict(state)
    return model


def params_to_jax(model) -> dict:
    """The inverse: the model's parameters as the reference's pytree of
    numpy arrays, each layer group stacked on a leading axis."""
    tree: dict = {}
    for key, t in model.state_dict().items():
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = t.detach().cpu().numpy()
    for group in STACKED:
        if group in tree:
            tree[group] = _stack([tree[group][str(i)]
                                  for i in range(len(tree[group]))])
    return tree


def _stack(trees):
    first = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(first[k], dict)
            else np.stack([t[k] for t in trees]) for k in first}
