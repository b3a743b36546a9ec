"""BLCO de-linearization, phase 1 of the three-phase pipeline (paper §5.1.1).

The port of ``repro.kernels.delinearize``: every mode's coordinate is the
shift+mask field of the stored (hi, lo) uint32 index words, stitched from
both words where it straddles them, plus the element's int32 block base.
On the card this is K3, ``delinearize_kernel`` in ``csrc/phases.cu``, one
launch per call; given CPU tensors the wrapper runs ``ref.delinearize_ref``.
There is no ``tile``: the output does not depend on one.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .common import (MAX_ORDER, check_contiguous, launch_counts, one_device,
                     raise_on_error)


def _check_inputs(hi, lo, bases, field_bits, field_shifts):
    n = len(field_bits)
    t = hi.shape[0]
    if not 1 <= n <= MAX_ORDER or len(field_shifts) != n:
        raise ValueError(f"field_bits and field_shifts must name 1.."
                         f"{MAX_ORDER} modes alike")
    if hi.dtype != torch.uint32 or lo.dtype != torch.uint32:
        raise TypeError("index words must be torch.uint32")
    if bases.dtype != torch.int32:
        raise TypeError("bases must be torch.int32")
    if hi.shape != (t,) or lo.shape != (t,) or bases.shape != (t, n):
        raise ValueError(f"stream shapes disagree: hi {tuple(hi.shape)}, lo "
                         f"{tuple(lo.shape)}, bases {tuple(bases.shape)} for "
                         f"order {n}")
    check_contiguous(hi, lo, bases)


def delinearize(hi, lo, bases, *, field_bits: tuple, field_shifts: tuple):
    """(T,) uint32 hi/lo words + (T, N) int32 bases -> (T, N) int32
    coordinates.  On the card: exactly one launch of K3 (none for T = 0)."""
    device = one_device(hi, lo, bases)
    if device.type == "cpu":
        return ref.delinearize_ref(hi, lo, bases, field_bits=field_bits,
                                   field_shifts=field_shifts)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    _check_inputs(hi, lo, bases, field_bits, field_shifts)
    n = len(field_bits)
    t = hi.shape[0]
    coords = torch.empty((t, n), dtype=torch.int32, device=device)
    if t == 0:
        return coords
    from .build import load_library
    lib = load_library("phases").lib
    shifts = (ctypes.c_int * n)(*field_shifts)
    widths = (ctypes.c_int * n)(*field_bits)
    with torch.cuda.device(device):
        err = lib.phases_delinearize_launch(
            hi.data_ptr(), lo.data_ptr(), bases.data_ptr(), n, shifts, widths,
            t, coords.data_ptr(), torch.cuda.current_stream().cuda_stream)
    raise_on_error(err, lib.phases_error_string, "delinearize")
    launch_counts["delinearize"] += 1
    return coords
