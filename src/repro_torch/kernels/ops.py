"""Public wrappers around the CUDA BLCO-MTTKRP kernels, over a BLCO tensor.

The port of ``repro.kernels.ops``.  ``cuda_mttkrp`` (the counterpart of
``pallas_mttkrp``) runs the whole pipeline as ONE fused kernel launch (K1 or
K2) over the tensor's device-resident launch cache.

``cuda_mttkrp_phases`` (the counterpart of ``pallas_mttkrp_phases``) is the
three-dispatch pipeline the fused path is measured against: the
delinearize kernel (K3) writes (T, N) coordinates to device memory, a
``torch.index_select`` gathers the N-1 non-target factor rows into (T, R)
tensors (the reference's ``jnp.take``, XLA outside any kernel), and the
compute kernel — K5 ``mttkrp_stash`` for a short hierarchical mode whose
stash fits shared memory, else K4 ``mttkrp_segments`` followed by one
update per run (``ref.scatter_segments_ref``) — makes the output.  Every
intermediate round-trips through device memory: at NELL-2 size (T = 84 M
padded slots, R = 32, f32) about 34 GB besides the cache.

Both take the launch cache attached to the tensor (``launch_cache_for``),
or ``cache=``; they run on the card unless the cache or ``device`` says
otherwise, and CPU tensors take the kernels' plain versions.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.blco import BLCOTensor
from repro_torch.core.counters import record_dispatch
from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.core.mttkrp import choose_resolution, launch_cache_for

from .blco_mttkrp import mttkrp_segments, mttkrp_stash
from .delinearize import delinearize
from .fused import _variant_for, fused_cache_mttkrp
from .ref import scatter_segments_ref

TILE = 256      # the reference's default tile; the largest divisor is taken


def cuda_mttkrp(blco: BLCOTensor, factors, mode: int, *,
                resolution: str = "auto", cache=None, device=DEFAULT_DEVICE):
    """Full mode-n MTTKRP, one fused kernel launch per call."""
    if not 0 <= mode < blco.order:
        raise ValueError(f"mode {mode} out of range for order {blco.order}")
    cache = cache if cache is not None else launch_cache_for(blco,
                                                             device=device)
    return fused_cache_mttkrp(cache, factors, mode, resolution=resolution)


def cuda_mttkrp_phases(blco: BLCOTensor, factors, mode: int, *,
                       resolution: str = "auto", cache=None,
                       device=DEFAULT_DEVICE):
    """Full mode-n MTTKRP through the three-phase pipeline: K3, a gather,
    then K5 or K4 + scatter.  Records three dispatches per call."""
    if not 0 <= mode < blco.order:
        raise ValueError(f"mode {mode} out of range for order {blco.order}")
    cache = cache if cache is not None else launch_cache_for(blco,
                                                             device=device)
    factors = tuple(factors)
    rank = factors[0].shape[1]
    out_rows = blco.dims[mode]
    out_dtype = torch.promote_types(cache.vals.dtype, factors[0].dtype)
    if resolution == "auto":
        resolution = choose_resolution(out_rows)
    if cache.num_launches == 0:
        return torch.zeros((out_rows, rank), dtype=out_dtype,
                           device=cache.device)
    hi, lo, vals, bases = cache.flat()
    t = int(hi.shape[0])
    tile = math.gcd(t, min(TILE, t))
    record_dispatch(3)          # three separate device phases per call

    coords = delinearize(hi, lo, bases, field_bits=cache.re_fields,
                         field_shifts=cache.re_shifts)
    gathered = tuple(factors[m].index_select(0, coords[:, m])
                     for m in range(blco.order) if m != mode)
    tgt = coords[:, mode].contiguous()
    del coords
    if _variant_for(resolution, out_rows, rank=rank,
                    itemsize=out_dtype.itemsize) == "stash":
        return mttkrp_stash(vals, tgt, gathered, out_rows=out_rows)
    seg_tgt, seg_sums = mttkrp_segments(vals, tgt, gathered, tile=tile)
    del gathered, tgt           # release (N-1) x (T, R) before the scatter
    return scatter_segments_ref(seg_tgt, seg_sums, out_rows)
