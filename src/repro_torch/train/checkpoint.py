"""Preemption-safe checkpointing (numpy-based): the port's counterpart of
``repro.train.checkpoint``, with its layout and protocol, so a checkpoint
of either package restores in the other.

Layout: ``<dir>/step_<N>/`` holding one ``.npy`` per leaf (path-encoded
filenames) + ``manifest.json`` (leaves, shapes, dtypes, step).
Write protocol: write into ``step_<N>.tmp`` then atomic ``os.rename`` —
a process killed mid-save never corrupts the latest-complete checkpoint,
and ``restore_latest`` simply picks the highest complete step.

A tree is the reference's pytree as nested dicts (keys sorted, as JAX
flattens them) and lists of numpy arrays: the port's train state goes
through ``convert.train_state_to_jax`` / ``train_state_from_jax``, which
stack the layers on a leading axis as the reference does.
Async save: ``save(..., blocking=False)`` copies every leaf to host
memory first and writes on a background thread — the training loop keeps
stepping.  The copy matters: ``.numpy()`` of a CPU tensor shares its
storage, and an in-place step would change the arrays under the writer.
Under a mesh (``save(..., mesh=...)``), every rank calls it and rank 0
alone writes its tree (the others may pass ``None``) — eight ranks
writing one step directory would race — while a blocking save holds
every rank at a barrier until the write is published.  A restore reads the tree on every rank, and the
caller puts it onto whatever mesh its run has
(``Trainer.state_from_host``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch.distributed as dist

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _leaf_name(path) -> str:
    """A leaf's file name from its path of dict keys and list indices."""
    return _SAFE.sub("_", "__".join(str(k) for k in path))


def _map(tree, fn, path=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, dict keys
    in sorted order; ``None`` is an empty node, as in JAX."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(tree[k], fn, path + (k,)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _flatten(tree) -> list:
    """(path, leaf) pairs in the reference's leaf order."""
    out = []
    _map(tree, lambda path, leaf: out.append((path, leaf)))
    return out


def save(ckpt_dir: str, step: int, tree, *, blocking: bool = True,
         keep: int = 3, mesh=None, copy: bool = True
         ) -> threading.Thread | None:
    """Snapshot ``tree`` (nested dicts of arrays) for ``step``; with a
    ``mesh``, only its rank 0 writes (see the module's docstring).
    ``copy=False`` writes the tree's arrays as they are: for a caller
    whose tree is its own fresh copy (a gathered state), which no step
    changes under the writer."""
    if mesh is not None and dist.get_rank() != 0:
        if blocking:
            dist.barrier()
        return None
    # copy to host memory first (so async writes see a consistent state)
    host = [(_leaf_name(p), np.array(leaf, copy=copy or None))
            for p, leaf in _flatten(tree)]
    manifest = {
        "step": int(step),
        "leaves": [{"name": n, "shape": list(a.shape), "dtype": str(a.dtype)}
                   for n, a in host],
    }

    def _write():
        tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        for name, arr in host:
            np.save(os.path.join(tmp, name + ".npy"), arr)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        _gc(ckpt_dir, keep)

    if blocking:
        _write()
        if mesh is not None:
            dist.barrier()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(list_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def restore(ckpt_dir: str, step: int, like_tree):
    """Restore into the structure of ``like_tree``, whose leaves need only
    a ``shape`` (arrays, meta tensors, ``jax.ShapeDtypeStruct``s); a
    shape that differs raises ``ValueError``."""
    base = os.path.join(ckpt_dir, f"step_{step}")

    def load(path, like):
        arr = np.load(os.path.join(base, _leaf_name(path) + ".npy"))
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{_leaf_name(path)}: the checkpoint holds "
                             f"{arr.shape}, expected {tuple(like.shape)}")
        return arr
    return _map(like_tree, load)


def restore_latest(ckpt_dir: str, like_tree):
    steps = list_steps(ckpt_dir)
    if not steps:
        return None, None
    s = steps[-1]
    return s, restore(ckpt_dir, s, like_tree)
