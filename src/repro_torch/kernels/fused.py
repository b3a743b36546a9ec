"""Fused BLCO MTTKRP: one kernel launch per call over the flat launch stream.

The port of ``repro.kernels.fused``.  The whole per-non-zero pipeline —
shift+mask de-linearization of the (hi, lo) index words, gather of the N-1
non-target factor rows, hadamard with the value, discovery of runs of equal
target index and one update per run — is one CUDA kernel
(``csrc/fused_mttkrp.cu``).  Two conflict-resolution variants, as in the
paper:

``segment`` (K1, register analogue, §5.2): runs are reduced in registers
    and each run issues one atomic update per column into the output.
``stash`` (K2, hierarchical, §5.1 steps 5-7): for short target modes each
    CTA accumulates into a shared-memory copy of the whole (I, R) output and
    merges it once.

Inputs come straight from the device-resident launch cache
(``LaunchCache.flat()``): no per-call host work, one launch per call.  Each
launch is exactly one wave of warps (``launch_geometry``), from an
occupancy query made once per (kernel, dtype pair, order, shared memory,
device).

A wrapper given CUDA tensors launches its kernel or raises; there is no
fallback.  Given CPU tensors it runs the kernel's plain PyTorch version in
``ref.py`` (what the tests do).  ``launch_counts`` (``common.py``) counts
each variant's kernel launches, on the card only.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.core.counters import record_dispatch
from repro_torch.core.mttkrp import CONTENTION_THRESHOLD, choose_resolution

from . import ref
from .common import (DTYPE_PAIRS, MAX_ORDER, STASH_MAX_BYTES,
                     check_contiguous, check_dtype_pair, device_index,
                     launch_counts, one_device, raise_on_error)

# the C side's variant code is the index in VARIANTS: keep the order
VARIANTS = ("segment", "stash")
# the stash variant is for short target modes (§5.3); its (out_rows, R)
# stash must also fit one CTA's shared memory on Hopper (STASH_MAX_BYTES)
STASH_MAX_ROWS = 4 * CONTENTION_THRESHOLD
# pieces of the stream per warp: enough that warps on faster SMs can take
# more, few enough that a piece holds many batches at FROSTT scale
PIECES_PER_WARP = 8


def _variant_for(resolution: str, out_rows: int, *, rank: int,
                 itemsize: int) -> str:
    """``stash`` for a hierarchical mode whose (out_rows, rank) stash fits
    both the row bound and a CTA's shared memory, else ``segment``."""
    if (resolution == "hierarchical" and out_rows <= STASH_MAX_ROWS
            and out_rows * rank * itemsize <= STASH_MAX_BYTES):
        return "stash"
    return "segment"


def _check_inputs(hi, lo, vals, bases, factors, field_bits, field_shifts,
                  mode):
    n = len(field_bits)
    t = hi.shape[0]
    if not 1 <= n <= MAX_ORDER:
        raise ValueError(f"order {n} outside 1..{MAX_ORDER}")
    if len(field_shifts) != n or len(factors) != n or not 0 <= mode < n:
        raise ValueError("field_bits, field_shifts, factors and mode disagree "
                         "on the tensor order")
    if hi.dtype != torch.uint32 or lo.dtype != torch.uint32:
        raise TypeError("index words must be torch.uint32")
    if bases.dtype != torch.int32:
        raise TypeError("bases must be torch.int32")
    if hi.shape != (t,) or lo.shape != (t,) or vals.shape != (t,) \
            or bases.shape != (t, n):
        raise ValueError(f"stream shapes disagree: hi {tuple(hi.shape)}, lo "
                         f"{tuple(lo.shape)}, vals {tuple(vals.shape)}, bases "
                         f"{tuple(bases.shape)} for order {n}")
    rank = factors[0].shape[1]
    for f in factors:
        if f.dim() != 2 or f.shape[1] != rank:
            raise ValueError("factors must be (I_n, R) with one R")
        if f.dtype != factors[0].dtype:
            raise TypeError("factors must share one dtype")
    check_dtype_pair(vals, factors[0])
    check_contiguous(hi, lo, vals, bases, *factors)


def launch_geometry(t: int, sms: int, blocks_per_sm: int,
                    threads: int) -> tuple[int, int]:
    """``(blocks, chunk)`` for one wave over a stream of ``t`` slots: the
    warps take the stream's ``ceil(t / chunk)`` pieces of ``chunk`` slots (a
    multiple of 32) in turn, about ``PIECES_PER_WARP`` each, and no more
    CTAs of ``threads`` threads are launched than ``sms * blocks_per_sm``
    hold at once, nor than the pieces keep busy."""
    if t < 1 or sms < 1 or blocks_per_sm < 1 or threads < 32 or threads % 32:
        raise ValueError(f"no launch geometry for t={t}, sms={sms}, "
                         f"blocks_per_sm={blocks_per_sm}, threads={threads}")
    per_block = threads // 32
    resident = sms * blocks_per_sm
    chunk = -(-t // (resident * per_block * PIECES_PER_WARP))
    chunk = -(-chunk // 32) * 32
    pieces = -(-t // chunk)
    return min(resident, -(-pieces // per_block)), chunk


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How one launch of K1 or K2 lies on the card."""
    blocks: int             # CTAs of ``threads`` threads
    chunk: int              # slots per piece, a multiple of 32
    threads: int
    sms: int
    blocks_per_sm: int      # resident CTAs per SM, from the occupancy query
    batch: int              # the kernel's batch depth B

    @property
    def waves(self) -> int:
        return -(-self.blocks // (self.sms * self.blocks_per_sm))

    @property
    def warps_per_sm(self) -> int:
        """Resident warps per SM."""
        return self.blocks_per_sm * self.threads // 32


@functools.lru_cache(maxsize=None)
def _occupancy(variant: str, dtype_pair: int, n_modes: int, smem: int,
               device_index: int) -> tuple[int, int, int, int]:
    """(SMs, resident CTAs per SM, batch depth, threads per CTA) of the
    kernel a launch would take; asked of the card once per key."""
    from .build import load_library
    lib = load_library("fused_mttkrp").lib
    sms, per_sm, batch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        err = lib.fused_mttkrp_occupancy(
            VARIANTS.index(variant), dtype_pair, n_modes, smem,
            ctypes.byref(sms), ctypes.byref(per_sm), ctypes.byref(batch))
    raise_on_error(err, lib.fused_mttkrp_error_string,
                   f"fused MTTKRP {variant} occupancy query")
    if per_sm.value < 1:
        raise RuntimeError(f"fused MTTKRP {variant}: no CTA fits an SM "
                           f"(occupancy 0, {smem} B of shared memory)")
    return sms.value, per_sm.value, batch.value, lib.fused_mttkrp_threads()


def occupancy_key(variant: str, vals_dtype, factor_dtype, n_modes: int,
                  out_rows: int, rank: int, device: int) -> tuple:
    """The ``_occupancy`` key a launch of ``variant`` asks under: (kernel,
    dtype pair, order, shared memory, device ordinal).  No launch size
    enters it (``analysis.trace.cachekeys`` holds it to that)."""
    out_dtype = torch.promote_types(vals_dtype, factor_dtype)
    smem = out_rows * rank * out_dtype.itemsize if variant == "stash" else 0
    return (variant, DTYPE_PAIRS[(vals_dtype, factor_dtype)], n_modes, smem,
            device)


def kernel_geometry(variant: str, vals_dtype, factor_dtype, n_modes: int,
                    out_rows: int, rank: int, t: int,
                    device: torch.device) -> Geometry:
    """The one-wave geometry of a launch of ``variant`` on ``device``."""
    sms, per_sm, batch, threads = _occupancy(*occupancy_key(
        variant, vals_dtype, factor_dtype, n_modes, out_rows, rank,
        device_index(device)))
    blocks, chunk = launch_geometry(t, sms, per_sm, threads)
    return Geometry(blocks, chunk, threads, sms, per_sm, batch)


def _launch(variant, hi, lo, vals, bases, factors, *, field_bits,
            field_shifts, mode, out_rows, out_dtype, layout=None,
            events=None):
    """Launch one kernel on the tensors' card and return its output.

    ``layout`` = ``(blocks, chunk)`` replaces the one-wave geometry; the
    tests pin piece edges with it.  ``events``, a pair of timing CUDA
    events, are recorded on the launch's stream around the kernel, the
    first again by the library just before the launch, so their elapsed
    time is the kernel's and its launch latency, not the host's issue."""
    from .build import load_library
    lib = load_library("fused_mttkrp").lib
    n = len(field_bits)
    t = hi.shape[0]
    rank = factors[0].shape[1]
    geo = kernel_geometry(variant, vals.dtype, factors[0].dtype, n, out_rows,
                          rank, t, hi.device)
    blocks, chunk = layout or (geo.blocks, geo.chunk)
    # one zeroed buffer, one memset: the output, then the kernel's piece
    # counters (one per column group of 32)
    words = -(-out_rows * rank * out_dtype.itemsize // 8)
    buf = torch.zeros(words + -(-rank // 32), dtype=torch.int64,
                      device=hi.device)
    out = buf.view(out_dtype)[:out_rows * rank].view(out_rows, rank)
    pieces = buf[words:]
    ptrs = (ctypes.c_void_p * n)(*(f.data_ptr() for f in factors))
    shifts = (ctypes.c_int * n)(*field_shifts)
    widths = (ctypes.c_int * n)(*field_bits)
    with torch.cuda.device(hi.device):
        current = torch.cuda.current_stream()
        start = None
        if events is not None:
            # recording here makes the event on its first use; the library
            # records it again just before the launch
            events[0].record(current)
            start = events[0].cuda_event
        err = lib.fused_mttkrp_launch(
            VARIANTS.index(variant), DTYPE_PAIRS[(vals.dtype,
                                                 factors[0].dtype)],
            hi.data_ptr(), lo.data_ptr(), vals.data_ptr(), bases.data_ptr(),
            ptrs, n, mode, shifts, widths, t, rank, out_rows, blocks, chunk,
            pieces.data_ptr(), out.data_ptr(), current.cuda_stream, start)
        if events is not None:
            events[1].record(current)
    raise_on_error(err, lib.fused_mttkrp_error_string,
                   f"fused MTTKRP {variant}")
    launch_counts[variant] += 1
    return out


def fused_mttkrp_flat(hi, lo, vals, bases, factors, *, field_bits: tuple,
                      field_shifts: tuple, mode: int, out_rows: int,
                      resolution: str = "auto", events=None):
    """Fused MTTKRP over a flat reservation-padded non-zero stream.

    hi/lo: (T,) uint32; vals: (T,); bases: (T, N) int32; factors: N (I_n, R)
    tensors.  Returns (out_rows, R) at ``promote_types(vals, factors)``.
    On the card: exactly one kernel launch, bracketed by ``events`` where
    given (see ``_launch``).  On the CPU: the plain version, whose segment
    tile is the reference's (the largest divisor of T up to 256).
    """
    factors = tuple(factors)
    device = one_device(hi, lo, vals, bases, *factors)
    if resolution == "auto":
        resolution = choose_resolution(out_rows)
    rank = factors[0].shape[1]
    out_dtype = torch.promote_types(vals.dtype, factors[0].dtype)
    variant = _variant_for(resolution, out_rows, rank=rank,
                           itemsize=out_dtype.itemsize)
    t = int(hi.shape[0])
    if t == 0:
        return torch.zeros((out_rows, rank), dtype=out_dtype, device=device)
    record_dispatch()
    if device.type == "cuda":
        _check_inputs(hi, lo, vals, bases, factors, field_bits, field_shifts,
                      mode)
        return _launch(variant, hi, lo, vals, bases, factors,
                       field_bits=field_bits, field_shifts=field_shifts,
                       mode=mode, out_rows=out_rows, out_dtype=out_dtype,
                       events=events)
    if device.type != "cpu":
        raise ValueError(f"no kernel for device {device}")
    if variant == "stash":
        return ref.fused_stash_ref(hi, lo, vals, bases, factors,
                                   field_bits=field_bits,
                                   field_shifts=field_shifts, mode=mode,
                                   out_rows=out_rows)
    return ref.fused_segment_mttkrp_ref(
        hi, lo, vals, bases, factors, field_bits=field_bits,
        field_shifts=field_shifts, mode=mode, out_rows=out_rows,
        tile=math.gcd(t, 256))


def fused_cache_mttkrp(cache, factors, mode: int, *,
                       resolution: str = "auto", events=None):
    """Fused MTTKRP straight from a device-resident ``LaunchCache``: the
    stacked launches are one flat stream (views, no copy), one launch per
    call regardless of the launch count."""
    if cache.closed:
        raise RuntimeError("launch cache is closed")
    factors = tuple(factors)
    if cache.num_launches == 0:
        rank = factors[0].shape[1]
        return torch.zeros((cache.dims[mode], rank),
                           dtype=torch.promote_types(cache.vals.dtype,
                                                     factors[0].dtype),
                           device=cache.device)
    hi, lo, vals, bases = cache.flat()
    return fused_mttkrp_flat(hi, lo, vals, bases, factors,
                             field_bits=cache.re_fields,
                             field_shifts=cache.re_shifts, mode=mode,
                             out_rows=cache.dims[mode],
                             resolution=resolution, events=events)
