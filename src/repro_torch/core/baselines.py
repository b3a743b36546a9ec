"""Baseline sparse-MTTKRP formats the paper compares against (§3, §6): the
port of ``repro.core.baselines``.

* ``COOFormat``   — plain coordinate list, per-nnz scatter-add (GenTen-style
  "atomic" path). Mode-agnostic, one copy, maximal update conflicts.
* ``FCOOFormat``  — F-COO (Liu et al.): one *mode-specific sorted copy per
  mode* with precomputed segment ids; segmented reduction + one update per
  segment.  Models both F-COO's strength (few conflicts) and its cost (N
  tensor copies + flag storage).
* ``CSFFormat``   — compressed-sparse-fiber tree (SPLATT/B-CSF family): one
  tree per root mode (N copies); root-mode MTTKRP is conflict-free (one write
  per sub-tree root), non-root modes fall back to scatter updates.  This is
  the CSF-1 traversal, not MM-CSF's mixed-root refinement.

The host formats are numpy, built exactly as the reference builds them.
The device side is plain PyTorch, as the reference's is XLA outside any
Pallas kernel: ``index_select`` gathers multiplied in place (one (nnz, R)
temporary per gather, never a tower of them), ``index_add_`` for the
scatter and the segment sums, ``scatter_reduce(..., "amax")`` for F-COO's
segment targets and index assignment for CSF's root rows.  Every format
shares the element-wise MTTKRP semantics, so each is validated against the
same dense oracle.  An empty tensor gives a zero output in every format.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device
from .tensor import SparseTensor


# ------------------------------------------------------------------ plain COO
@dataclasses.dataclass
class COOFormat:
    dims: tuple[int, ...]
    indices: np.ndarray     # (nnz, N) int32
    values: np.ndarray      # (nnz,)

    @staticmethod
    def build(t: SparseTensor) -> "COOFormat":
        return COOFormat(t.dims, t.indices.astype(np.int32), t.values)

    def device_bytes(self) -> int:
        return int(self.indices.nbytes + self.values.nbytes)


def _partial(indices, values, factors, mode: int):
    """(nnz, R) products ``values * prod_{m != mode} factors[m][indices[:,
    m]]`` at the promoted precision, multiplied in the reference's order
    (value first, then each factor by mode) and in place: one gathered
    (nnz, R) temporary at a time beside the result."""
    dtype = torch.promote_types(values.dtype, factors[0].dtype)
    partial = values[:, None].to(dtype)
    first = True
    for m, f in enumerate(factors):
        if m == mode:
            continue
        rows = f.index_select(0, indices[:, m])
        if first:
            # a fresh (nnz, R) tensor: the value times the first row is
            # the reference's first product (multiplication commutes)
            partial = rows.to(dtype).mul_(partial)
            first = False
        else:
            partial.mul_(rows)
        del rows
    return partial


def _coo_mttkrp(indices, values, factors, *, mode: int, out_rows: int):
    partial = _partial(indices, values, factors, mode)
    out = torch.zeros((out_rows, partial.shape[1]), dtype=partial.dtype,
                      device=partial.device)
    return out.index_add_(0, indices[:, mode], partial)


def _as_device(factors, dev) -> tuple:
    return tuple(torch.as_tensor(f, device=dev) for f in factors)


def coo_mttkrp(fmt: COOFormat, factors, mode: int, *,
               device=DEFAULT_DEVICE):
    dev = resolve_device(device)
    return _coo_mttkrp(torch.as_tensor(fmt.indices, device=dev),
                       torch.as_tensor(fmt.values, device=dev),
                       _as_device(factors, dev), mode=mode,
                       out_rows=fmt.dims[mode])


# ---------------------------------------------------------------------- F-COO
@dataclasses.dataclass
class FCOOFormat:
    """One sorted copy + segment ids per mode (the paper's Fig. 4b)."""
    dims: tuple[int, ...]
    per_mode_indices: list[np.ndarray]   # N arrays (nnz, N) int32, sorted by mode
    per_mode_values: list[np.ndarray]
    per_mode_segids: list[np.ndarray]    # precomputed segment ids (from bf/sf flags)

    @staticmethod
    def build(t: SparseTensor) -> "FCOOFormat":
        idxs, vals, segs = [], [], []
        for mode in range(t.order):
            key = t.indices[:, mode]
            if t.dims[mode] <= 1 << 16:
                # numpy sorts 16-bit keys by radix: the same stable order
                # in linear time (NELL-2's three sorts: ~3x faster)
                key = key.astype(np.uint16)
            order = np.argsort(key, kind="stable")
            si = t.indices[order].astype(np.int32)
            sv = t.values[order]
            tgt = si[:, mode]
            flags = np.concatenate(([1], (tgt[1:] != tgt[:-1]).astype(np.int64)))
            segs.append(np.cumsum(flags) - 1)
            idxs.append(si)
            vals.append(sv)
        return FCOOFormat(t.dims, idxs, vals, [s.astype(np.int32) for s in segs])

    def device_bytes(self) -> int:
        b = 0
        for i, v, s in zip(self.per_mode_indices, self.per_mode_values,
                           self.per_mode_segids):
            b += i.nbytes + v.nbytes + s.nbytes
        return int(b)


def _num_segments(segids) -> int:
    """Segments of one mode; 1 when there are no segment ids."""
    return int(segids[-1]) + 1 if len(segids) else 1


def _fcoo_mttkrp(indices, values, segids, factors, *, mode: int,
                 out_rows: int, num_segments: int):
    partial = _partial(indices, values, factors, mode)
    out = torch.zeros((out_rows, partial.shape[1]), dtype=partial.dtype,
                      device=partial.device)
    if values.shape[0] == 0:
        # an empty tensor's build still holds one segment id (the
        # reference's flags start with a 1): nothing to reduce
        return out
    seg_sums = torch.zeros((num_segments, partial.shape[1]),
                           dtype=partial.dtype, device=partial.device)
    seg_sums.index_add_(0, segids, partial)
    del partial
    seg_tgt = torch.zeros(num_segments, dtype=indices.dtype,
                          device=indices.device).scatter_reduce_(
        0, segids.long(), indices[:, mode], "amax", include_self=True)
    return out.index_add_(0, seg_tgt, seg_sums)


def fcoo_mttkrp(fmt: FCOOFormat, factors, mode: int, *,
                device=DEFAULT_DEVICE):
    dev = resolve_device(device)
    segids = fmt.per_mode_segids[mode]
    return _fcoo_mttkrp(torch.as_tensor(fmt.per_mode_indices[mode],
                                        device=dev),
                        torch.as_tensor(fmt.per_mode_values[mode], device=dev),
                        torch.as_tensor(segids, device=dev),
                        _as_device(factors, dev), mode=mode,
                        out_rows=fmt.dims[mode],
                        num_segments=_num_segments(segids))


# ------------------------------------------------------------------------ CSF
def _csf_order(indices, dims, root: int) -> np.ndarray:
    """The permutation that sorts the non-zeros by (root, the other modes
    in increasing order), ties in input order: ``np.lexsort``'s.  Where the
    product of the dims fits in int64, one stable sort of the linearized
    key (root slowest) gives the same permutation for one key array in
    place of N."""
    rest = [m for m in range(len(dims)) if m != root]
    if math.prod(int(d) for d in dims) >= 1 << 63:
        key = [indices[:, m] for m in rest]
        return np.lexsort(tuple(reversed(key)) + (indices[:, root],))
    lin = indices[:, root].astype(np.int64)
    for m in rest:
        lin = lin * np.int64(dims[m]) + indices[:, m]
    return np.argsort(lin, kind="stable")


@dataclasses.dataclass
class CSFTree:
    root_mode: int
    fiber_ptr: np.ndarray     # (num_fibers+1,) int32 into sorted nnz
    fiber_root: np.ndarray    # (num_fibers,) int32 root-mode index per fiber
    indices: np.ndarray       # (nnz, N) int32 sorted by (root, others)
    values: np.ndarray


@dataclasses.dataclass
class CSFFormat:
    """One two-level CSF tree per root mode (SPLATT's N-copy strategy)."""
    dims: tuple[int, ...]
    trees: list[CSFTree]

    @staticmethod
    def build(t: SparseTensor) -> "CSFFormat":
        trees = []
        for root in range(t.order):
            order = _csf_order(t.indices, t.dims, root)
            si = t.indices[order].astype(np.int32)
            sv = t.values[order]
            roots = si[:, root]
            # an empty tensor has no fiber (the reference indexes its
            # first root and raises)
            starts = np.flatnonzero(
                np.concatenate(([True], roots[1:] != roots[:-1]))) \
                if len(roots) else np.zeros(0, np.int64)
            ptr = np.append(starts, len(roots)).astype(np.int32)
            trees.append(CSFTree(root, ptr, roots[starts].astype(np.int32), si, sv))
        return CSFFormat(t.dims, trees)

    def device_bytes(self) -> int:
        b = 0
        for tr in self.trees:
            b += tr.fiber_ptr.nbytes + tr.fiber_root.nbytes
            b += tr.indices.nbytes + tr.values.nbytes
        return int(b)


def _tree_segids(tree: CSFTree) -> np.ndarray:
    """Each leaf's fiber number (int32)."""
    return np.repeat(np.arange(len(tree.fiber_root), dtype=np.int32),
                     np.diff(tree.fiber_ptr))


def _csf_root_mttkrp(indices, values, segids, seg_root, factors, *,
                     mode: int, out_rows: int, num_segments: int):
    """Root-mode traversal: accumulate per sub-tree, ONE write per root
    index (conflict-free — the CSF family's core advantage for the root
    mode)."""
    partial = _partial(indices, values, factors, mode)
    seg_sums = torch.zeros((num_segments, partial.shape[1]),
                           dtype=partial.dtype, device=partial.device)
    seg_sums.index_add_(0, segids, partial)
    del partial
    out = torch.zeros((out_rows, seg_sums.shape[1]), dtype=seg_sums.dtype,
                      device=seg_sums.device)
    out[seg_root] = seg_sums       # set, not add: roots are unique
    return out


class DeviceCOO:
    """Device-resident COO (in-memory parity with DeviceBLCO)."""

    def __init__(self, fmt: COOFormat, *, device=DEFAULT_DEVICE):
        dev = resolve_device(device)
        self.indices = torch.as_tensor(fmt.indices, device=dev)
        self.values = torch.as_tensor(fmt.values, device=dev)
        self.dims = fmt.dims

    def mttkrp(self, factors, mode: int):
        return _coo_mttkrp(self.indices, self.values, tuple(factors),
                           mode=mode, out_rows=self.dims[mode])

    def device_bytes(self) -> int:
        return _nbytes(self.indices, self.values)


class DeviceFCOO:
    def __init__(self, fmt: FCOOFormat, *, device=DEFAULT_DEVICE):
        dev = resolve_device(device)
        self.dims = fmt.dims
        self.per_mode = []
        for m in range(len(fmt.per_mode_indices)):
            seg = fmt.per_mode_segids[m]
            self.per_mode.append((
                torch.as_tensor(fmt.per_mode_indices[m], device=dev),
                torch.as_tensor(fmt.per_mode_values[m], device=dev),
                torch.as_tensor(seg, device=dev), _num_segments(seg)))

    def mttkrp(self, factors, mode: int):
        idx, vals, seg, nseg = self.per_mode[mode]
        return _fcoo_mttkrp(idx, vals, seg, tuple(factors), mode=mode,
                            out_rows=self.dims[mode], num_segments=nseg)

    def device_bytes(self) -> int:
        return sum(_nbytes(i, v, s) for i, v, s, _ in self.per_mode)


class DeviceCSF:
    def __init__(self, fmt: CSFFormat, *, device=DEFAULT_DEVICE):
        dev = resolve_device(device)
        self.dims = fmt.dims
        self.trees = []
        for tr in fmt.trees:
            self.trees.append((torch.as_tensor(tr.indices, device=dev),
                               torch.as_tensor(tr.values, device=dev),
                               torch.as_tensor(_tree_segids(tr), device=dev),
                               torch.as_tensor(tr.fiber_root, device=dev),
                               len(tr.fiber_root)))

    def mttkrp(self, factors, mode: int, *, root: int | None = None):
        """MTTKRP from the tree rooted at ``root``: by default the target
        mode's (the conflict-free traversal); another root takes the
        scatter-add fallback over its leaves, as :func:`csf_mttkrp`."""
        root = mode if root is None else root
        idx, vals, seg, roots, nseg = self.trees[root]
        if root != mode:
            return _coo_mttkrp(idx, vals, tuple(factors), mode=mode,
                               out_rows=self.dims[mode])
        return _csf_root_mttkrp(idx, vals, seg, roots, tuple(factors),
                                mode=mode, out_rows=self.dims[mode],
                                num_segments=nseg)

    def device_bytes(self) -> int:
        return sum(_nbytes(i, v, s, r) for i, v, s, r, _ in self.trees)


def _nbytes(*tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def csf_mttkrp(fmt: CSFFormat, factors, mode: int, *, root: int | None = None,
               device=DEFAULT_DEVICE):
    """MTTKRP using the tree rooted at ``root`` (defaults to the target mode,
    i.e. the conflict-free traversal; other roots use the scatter-add
    fallback — the paper's 'top-down/bottom-up' cost asymmetry)."""
    dev = resolve_device(device)
    factors = _as_device(factors, dev)
    root = mode if root is None else root
    tree = fmt.trees[root]
    idx = torch.as_tensor(tree.indices, device=dev)
    vals = torch.as_tensor(tree.values, device=dev)
    if root == mode:
        return _csf_root_mttkrp(
            idx, vals, torch.as_tensor(_tree_segids(tree), device=dev),
            torch.as_tensor(tree.fiber_root, device=dev), factors,
            mode=mode, out_rows=fmt.dims[mode],
            num_segments=len(tree.fiber_root))
    # non-root mode on this tree: plain scatter-add over leaves
    return _coo_mttkrp(idx, vals, factors, mode=mode,
                       out_rows=fmt.dims[mode])
