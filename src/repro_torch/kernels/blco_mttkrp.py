"""The computing phase of the three-phase pipeline (paper §5.1.2, §5.2), from
pre-gathered factor rows.

The port of ``repro.kernels.blco_mttkrp``.  Both kernels multiply each value
with its N-1 gathered non-target rows (at ``promote_types(vals, rows)``) and
resolve conflicts in one of the paper's two ways:

``mttkrp_segments`` (K4, register analogue, §5.2)
    Per tile of ``tile`` non-zeros, runs of equal target are found on the
    fly in stream order and summed: ``(seg_tgt, seg_sums)`` with row k of
    tile j the k-th run of that tile, -1 / zero rows after the last run.
    The caller makes one update per run (``ref.scatter_segments_ref``).
``mttkrp_stash`` (K5, hierarchical, §5.1 steps 5-7)
    For short target modes the whole (out_rows, R) output is accumulated in
    a per-CTA shared-memory stash and merged; it must fit
    ``STASH_MAX_BYTES``, and a larger one is refused on every device.

On the card each call is exactly one launch (``csrc/phases.cu``); given CPU
tensors the wrappers run the plain versions in ``ref.py``.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .common import (DTYPE_PAIRS, MAX_ORDER, STASH_MAX_BYTES,
                     check_contiguous, check_dtype_pair, launch_counts,
                     one_device, raise_on_error)

MAX_TILE = 256      # MAX_TILE in csrc/phases.cu: one CTA per tile


def _check_rows(vals, tgt, gathered):
    """Shapes of (vals, tgt, gathered) on every device; returns (T, R)."""
    if not 1 <= len(gathered) <= MAX_ORDER - 1:
        raise ValueError(f"{len(gathered)} gathered row sets; the kernels "
                         f"take 1..{MAX_ORDER - 1}")
    t = vals.shape[0]
    rank = gathered[0].shape[1] if gathered[0].dim() == 2 else -1
    if vals.shape != (t,) or tgt.shape != (t,) or any(
            g.shape != (t, rank) for g in gathered):
        raise ValueError(f"shapes disagree: vals {tuple(vals.shape)}, tgt "
                         f"{tuple(tgt.shape)}, gathered "
                         f"{[tuple(g.shape) for g in gathered]}")
    return t, rank


def _check_kernel_inputs(vals, tgt, gathered):
    """What the card's kernels also need: types and contiguity."""
    if tgt.dtype != torch.int32:
        raise TypeError("tgt must be torch.int32")
    check_dtype_pair(vals, gathered[0])
    if any(g.dtype != gathered[0].dtype for g in gathered):
        raise TypeError("gathered rows must share one dtype")
    check_contiguous(vals, tgt, *gathered)


def _row_ptrs(gathered):
    return (ctypes.c_void_p * len(gathered))(*(g.data_ptr()
                                               for g in gathered))


def mttkrp_segments(vals, tgt, gathered, *, tile: int):
    """Hadamard + per-tile on-the-fly segmented reduction (K4).

    vals: (T,); tgt: (T,) int32 target coordinates in ALTO order (not
    sorted); gathered: N-1 (T, R) rows.  ``tile`` divides T.  Returns
    ``(seg_tgt (T,) int32, seg_sums (T, R))``.
    """
    gathered = tuple(gathered)
    device = one_device(vals, tgt, *gathered)
    t, rank = _check_rows(vals, tgt, gathered)
    if not 1 <= tile <= MAX_TILE or t % tile:
        raise ValueError(f"tile {tile} must divide the stream of {t} slots "
                         f"and lie in 1..{MAX_TILE}")
    if device.type == "cpu":
        return ref.mttkrp_segments_ref(vals, tgt, gathered, tile=tile)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    _check_kernel_inputs(vals, tgt, gathered)
    out_dtype = torch.promote_types(vals.dtype, gathered[0].dtype)
    seg_tgt = torch.empty((t,), dtype=torch.int32, device=device)
    seg_sums = torch.empty((t, rank), dtype=out_dtype, device=device)
    if t == 0:
        return seg_tgt, seg_sums
    from .build import load_library
    lib = load_library("phases").lib
    with torch.cuda.device(device):
        err = lib.phases_segments_launch(
            DTYPE_PAIRS[(vals.dtype, gathered[0].dtype)], vals.data_ptr(),
            tgt.data_ptr(), _row_ptrs(gathered), len(gathered), t, rank, tile,
            seg_tgt.data_ptr(), seg_sums.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    raise_on_error(err, lib.phases_error_string, "MTTKRP segments")
    launch_counts["segments"] += 1
    return seg_tgt, seg_sums


def mttkrp_stash(vals, tgt, gathered, *, out_rows: int):
    """Hadamard accumulated straight into an (out_rows, R) stash (K5).

    Same inputs as ``mttkrp_segments``; returns the (out_rows, R) output at
    ``promote_types(vals, rows)``.
    """
    gathered = tuple(gathered)
    device = one_device(vals, tgt, *gathered)
    t, rank = _check_rows(vals, tgt, gathered)
    out_dtype = torch.promote_types(vals.dtype, gathered[0].dtype)
    if out_rows * rank * out_dtype.itemsize > STASH_MAX_BYTES:
        raise ValueError(f"a ({out_rows}, {rank}) {out_dtype} stash exceeds "
                         f"{STASH_MAX_BYTES} B of shared memory; use "
                         f"mttkrp_segments")
    if device.type == "cpu":
        return ref.mttkrp_stash_ref(vals, tgt, gathered, out_rows=out_rows)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    _check_kernel_inputs(vals, tgt, gathered)
    out = torch.zeros((out_rows, rank), dtype=out_dtype, device=device)
    if t == 0:
        return out
    from .build import load_library
    lib = load_library("phases").lib
    with torch.cuda.device(device):
        err = lib.phases_stash_launch(
            DTYPE_PAIRS[(vals.dtype, gathered[0].dtype)], vals.data_ptr(),
            tgt.data_ptr(), _row_ptrs(gathered), len(gathered), t, rank,
            out_rows, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    raise_on_error(err, lib.phases_error_string, "MTTKRP stash")
    launch_counts["stash_phases"] += 1
    return out
