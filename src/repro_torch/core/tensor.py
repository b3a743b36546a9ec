"""Host-side sparse tensor container (COO), synthetic generators, FROSTT IO.

The port's own copy of ``repro.core.tensor``: it gives the same tensors for
the same arguments, byte for byte.  Two differences in how, not what:

* ``_dedupe`` sorts on one linear int64 key with a stable argsort where the
  dims allow it, which is the same permutation as the reference's
  ``np.lexsort`` and about three times faster at FROSTT scale;
* ``top_up_uniform`` is new: a skewed draw collapses under dedupe, so it
  tops such a tensor up with distinct uniform coordinates until it has
  exactly the requested nnz (the real data sets' counts).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """An N-order sparse tensor in coordinate (COO) form, host resident.

    indices: (nnz, N) int64, 0-based coordinates, deduplicated.
    values:  (nnz,) float32/float64.
    dims:    mode lengths.
    """
    dims: tuple[int, ...]
    indices: np.ndarray
    values: np.ndarray

    def __post_init__(self):
        assert self.indices.ndim == 2 and self.indices.shape[1] == len(self.dims)
        assert self.values.shape == (self.indices.shape[0],)
        assert self.indices.dtype == np.int64

    @property
    def order(self) -> int:
        return len(self.dims)

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]

    @property
    def density(self) -> float:
        size = float(np.prod([float(d) for d in self.dims]))
        return self.nnz / size

    def to_dense(self) -> np.ndarray:
        """Dense materialization — test oracle only (small tensors)."""
        dense = np.zeros(self.dims, dtype=self.values.dtype)
        dense[tuple(self.indices.T)] += self.values
        return dense

    def matricize(self, mode: int) -> np.ndarray:
        """Mode-n matricization X_(n) as a dense matrix — test oracle only."""
        dense = self.to_dense()
        perm = (mode,) + tuple(m for m in range(self.order) if m != mode)
        return dense.transpose(perm).reshape(self.dims[mode], -1)


def _lex_order(indices: np.ndarray, dims) -> np.ndarray:
    """Stable lexicographic order of the rows (column 0 most significant).

    Equal to ``np.lexsort(indices.T[::-1])``; a stable argsort of the
    row-major linear index gives the same permutation when every
    coordinate lies inside ``dims`` and the index fits int64.
    """
    if indices.shape[0] and math.prod(int(d) for d in dims) < 1 << 63:
        try:
            key = np.ravel_multi_index(tuple(indices.T), tuple(dims))
        except ValueError:          # a coordinate outside dims
            pass
        else:
            return np.argsort(key, kind="stable")
    return np.lexsort(indices.T[::-1])


def _dedupe(indices: np.ndarray, values: np.ndarray, dims) -> SparseTensor:
    # Lexicographic dedupe, summing duplicate values (standard COO semantics).
    order = _lex_order(indices, dims)
    indices = indices[order]
    values = values[order]
    keep = np.ones(len(values), dtype=bool)
    if len(values) > 1:
        same = np.all(indices[1:] == indices[:-1], axis=1)
        keep[1:] = ~same
    # sum duplicates into the kept representative
    group = np.cumsum(keep) - 1
    out_vals = np.zeros(int(group[-1]) + 1 if len(values) else 0, dtype=values.dtype)
    np.add.at(out_vals, group, values)
    return SparseTensor(tuple(int(d) for d in dims), indices[keep], out_vals)


def random_tensor(dims, nnz, *, seed=0, dtype=np.float32, dist="uniform") -> SparseTensor:
    """Synthetic sparse tensor.

    dist="uniform":   coordinates i.i.d. uniform (models hypersparse FROSTT sets
                      like Flickr/Delicious — density 1e-14).
    dist="powerlaw":  per-mode Zipf-distributed coordinates → dense fibers for a
                      few indices (models NELL-2 / Reddit fiber-density skew,
                      which drives the paper's conflict-resolution behavior).
    dist="clustered": coordinates drawn inside a few random sub-boxes (models
                      the block structure HiCOO exploits; stresses ALTO ordering).

    Duplicate draws are summed, so the result may hold fewer than ``nnz``
    non-zeros (see ``top_up_uniform``).
    """
    rng = np.random.default_rng(seed)
    dims = tuple(int(d) for d in dims)
    n = len(dims)
    nnz = int(nnz)
    idx = np.empty((nnz, n), dtype=np.int64)
    if dist == "uniform":
        for m, d in enumerate(dims):
            idx[:, m] = rng.integers(0, d, size=nnz)
    elif dist == "powerlaw":
        for m, d in enumerate(dims):
            # Zipf over the mode, clipped to the mode length.
            z = rng.zipf(1.3, size=nnz) - 1
            col = np.minimum(z, d - 1)
            rng.shuffle(col)        # decorrelate rank across modes
            idx[:, m] = col
    elif dist == "clustered":
        k = max(1, min(8, min(dims) // 2))
        centers = np.stack([rng.integers(0, d, size=k) for d in dims], axis=1)
        box = [max(1, d // 8) for d in dims]
        pick = rng.integers(0, k, size=nnz)
        for m, d in enumerate(dims):
            off = rng.integers(0, box[m], size=nnz)
            idx[:, m] = np.minimum(centers[pick, m] + off, d - 1)
    else:
        raise ValueError(f"unknown dist {dist!r}")
    vals = rng.standard_normal(nnz).astype(dtype)
    # avoid exact zeros (degenerate nnz)
    vals = np.where(vals == 0, np.asarray(1.0, dtype), vals).astype(dtype)
    return _dedupe(idx, vals, dims)


def top_up_uniform(head: SparseTensor, nnz, *, seed=0) -> SparseTensor:
    """``head`` followed by distinct uniform non-zeros, to exactly ``nnz``.

    A skewed draw collapses under dedupe (``random_tensor(dims, nnz,
    dist="powerlaw")`` keeps well under half of a FROSTT-scale draw), so
    this fills such a head up to a data set's real nnz with coordinates
    drawn uniformly from ``seed``: a dense-fiber head over a hypersparse
    background.  The head's rows come first, unchanged; the new rows follow
    in lexicographic order and carry standard-normal values of the head's
    dtype.
    """
    dims = head.dims
    nnz = int(nnz)
    size = math.prod(dims)
    if size >= 1 << 63:
        raise ValueError("top_up_uniform needs prod(dims) < 2^63")
    if not head.nnz <= nnz <= size:
        raise ValueError(f"cannot top {head.nnz} non-zeros up to {nnz} at "
                         f"dims {dims}")
    need = nnz - head.nnz
    if need == 0:
        return head
    rng = np.random.default_rng([seed, 1])
    taken = np.sort(np.ravel_multi_index(tuple(head.indices.T), dims))
    keys = np.empty(0, np.int64)
    while keys.size < need:
        # a little over what is missing: collisions are rare when sparse;
        # one sort dedupes the draw, a search drops what the head holds.
        # (np.sort, not np.unique: numpy 2.3's hash-based unique is far
        # slower than a sort on tens of millions of int64 keys)
        more = need - keys.size + need // 64 + 64
        keys = np.sort(np.concatenate(
            [keys, rng.integers(0, size, size=more)]))
        keys = keys[np.concatenate(([True], keys[1:] != keys[:-1]))]
        if taken.size:
            at = np.minimum(np.searchsorted(taken, keys), taken.size - 1)
            keys = keys[taken[at] != keys]
    # drop a uniform choice of the surplus: the rest is a uniform subset
    keys = np.delete(keys, rng.choice(keys.size, keys.size - need,
                                      replace=False))
    extra = np.stack(np.unravel_index(keys, dims), axis=1).astype(np.int64)
    vals = rng.standard_normal(need).astype(head.values.dtype)
    vals = np.where(vals == 0, np.asarray(1.0, vals.dtype), vals)
    return SparseTensor(dims, np.concatenate([head.indices, extra]),
                        np.concatenate([head.values, vals]))


def from_coo(indices, values, dims) -> SparseTensor:
    return _dedupe(np.asarray(indices, np.int64), np.asarray(values), dims)


def load_tns(path: str, dtype=np.float64) -> SparseTensor:
    """FROSTT ``.tns`` loader: one nnz per line, 1-based indices then value."""
    raw = np.loadtxt(path, dtype=np.float64, ndmin=2)
    idx = raw[:, :-1].astype(np.int64) - 1
    vals = raw[:, -1].astype(dtype)
    dims = tuple(int(d) for d in idx.max(axis=0) + 1)
    return _dedupe(idx, vals, dims)


# Shapes/nnz modeled on Table 2 of the paper, scaled for CPU-offline runs.
PAPER_LIKE_SUITE = {
    # name: (dims, nnz, dist) — scaled ~1000x down, preserving mode-length skew.
    "nips-like":   ((256, 256, 1024, 16), 30_000, "uniform"),
    "uber-like":   ((183, 24, 1140, 1717), 33_000, "powerlaw"),
    "chicago-like": ((620, 24, 77, 32), 53_000, "powerlaw"),
    "vast-like":   ((16384, 1024, 2), 26_000, "uniform"),
    "darpa-like":  ((2048, 2048, 65536), 28_000, "powerlaw"),
    "nell2-like":  ((1210, 920, 2880), 76_000, "powerlaw"),
    "fb-like":     ((262144, 262144, 166), 10_000, "uniform"),
    "deli-like":   ((8192, 65536, 32768, 1400), 14_000, "uniform"),
    "amazon-like": ((65536, 16384, 16384), 170_000, "powerlaw"),
}


def paper_like(name: str, *, seed=0, dtype=np.float32) -> SparseTensor:
    dims, nnz, dist = PAPER_LIKE_SUITE[name]
    return random_tensor(dims, nnz, seed=seed, dtype=dtype, dist=dist)
