"""Registered hot paths: the dataflows the op audit runs.

The port's counterpart of the reference's ``hotpaths.py``.  Each
:class:`HotPath` names one dataflow the pipeline actually executes — the
plain stacked-launch MTTKRP (both conflict resolutions), the streamed
regime's per-chunk body, the fused kernel's wrapper (both variants) and
the CP-ALS sweep update — with a zero-argument callable that runs it
once over tensors made beforehand, so the audit (``op_audit``) sees the
dispatch and nothing of the set-up.  Where the reference traces abstract
shapes, the port runs real tensors: small representative ones, on the
card by default and on the CPU when asked
(``registered_hot_paths(device="cpu")``, as the tests do), or the tensors
of a real launch cache at full width (``registered_hot_paths(cache=,
factors=)``, as ``chip_smoke.py`` does for NELL-2 and Uber).

``path``/``symbol`` place findings in the lint framework's stable keying
(``pass:path:symbol``), so trace findings share the AST tier's baseline
and inline-suppression machinery unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device

# one small representative tensor: dims (8, 6, 4), re-encoded as 3+3+2-bit
# contiguous fields — the layout build_blco(dims=(8,6,4)) itself produces
_DIMS = (8, 6, 4)
_FIELDS = (3, 3, 2)
_SHIFTS = (0, 3, 6)
_RANK = 16
_RES = 256          # one LANE-multiple reservation
_LAUNCHES = 2
_SEED = 0


@dataclasses.dataclass(frozen=True)
class HotPath:
    """One auditable dataflow: identity + a runner over prepared tensors."""
    name: str            # finding symbol (function the path runs)
    path: str            # repo-relative source path the finding points at
    device: torch.device
    dims: tuple          # the tensor the path runs over
    run: object          # () -> the path's output


@dataclasses.dataclass(frozen=True)
class Stream:
    """Stacked launches (``(L, res)`` words, values, ``(L, res, N)``
    bases), their fields, dims and factors: what every path reads."""
    hi: torch.Tensor
    lo: torch.Tensor
    vals: torch.Tensor
    bases: torch.Tensor
    fields: tuple
    shifts: tuple
    dims: tuple
    factors: tuple

    def flat(self):
        t = self.hi.numel()
        return (self.hi.reshape(t), self.lo.reshape(t),
                self.vals.reshape(t), self.bases.reshape(t, len(self.dims)))


def representative_stream(device=DEFAULT_DEVICE) -> Stream:
    """The small stream: ``_LAUNCHES`` launches of ``_RES`` slots of random
    coordinates packed into ``_FIELDS``, zero bases, random values and
    rank-``_RANK`` factors, made from a seed on ``device`` (the card by
    default)."""
    device = resolve_device(device)
    rng = np.random.default_rng(_SEED)
    n = _LAUNCHES * _RES
    words = np.zeros(n, np.uint64)
    for d, width, shift in zip(_DIMS, _FIELDS, _SHIFTS):
        words |= rng.integers(0, d, n).astype(np.uint64) << np.uint64(shift)
    hi = (words >> np.uint64(32)).astype(np.uint32)
    lo = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    shape = (_LAUNCHES, _RES)
    return Stream(
        hi=torch.from_numpy(hi.reshape(shape)).to(device),
        lo=torch.from_numpy(lo.reshape(shape)).to(device),
        vals=torch.from_numpy(rng.standard_normal(n).astype(
            np.float32).reshape(shape)).to(device),
        bases=torch.zeros(shape + (len(_DIMS),), dtype=torch.int32,
                          device=device),
        fields=_FIELDS, shifts=_SHIFTS, dims=_DIMS,
        factors=tuple(torch.from_numpy(rng.standard_normal(
            (d, _RANK)).astype(np.float32)).to(device) for d in _DIMS))


def cache_stream(cache, factors) -> Stream:
    """A ``LaunchCache``'s stacked launches and the given factors."""
    return Stream(hi=cache.hi, lo=cache.lo, vals=cache.vals,
                  bases=cache.bases, fields=cache.re_fields,
                  shifts=cache.re_shifts, dims=cache.dims,
                  factors=tuple(factors))


def _modes(s: Stream):
    """(register mode, hierarchical mode, stash mode or None): the longest
    mode, the shortest, and a mode whose fused variant is K2's stash."""
    from repro_torch.core.mttkrp import choose_resolution
    from repro_torch.kernels.fused import _variant_for
    rank = s.factors[0].shape[1]
    itemsize = torch.promote_types(s.vals.dtype,
                                   s.factors[0].dtype).itemsize
    order = sorted(range(len(s.dims)), key=lambda m: s.dims[m])
    stash = next((m for m in order if _variant_for(
        choose_resolution(s.dims[m]), s.dims[m], rank=rank,
        itemsize=itemsize) == "stash"), None)
    return order[-1], order[0], stash


def _stacked(s: Stream, resolution: str, mode: int):
    from repro_torch.core.launches import stacked_mttkrp
    return lambda: stacked_mttkrp(
        s.hi, s.lo, s.vals, s.bases, s.factors, re_fields=s.fields,
        re_shifts=s.shifts, mode=mode, out_rows=s.dims[mode],
        resolution=resolution, copies=8)


def _launch_body(s: Stream, mode: int):
    # the per-chunk dataflow of the streamed regime's plain path
    # (stream_mttkrp runs exactly this, one chunk at a time)
    from repro_torch.core.mttkrp import launch_mttkrp_impl
    return lambda: launch_mttkrp_impl(
        s.hi[0], s.lo[0], s.vals[0], s.bases[0], s.factors,
        re_fields=s.fields, re_shifts=s.shifts, mode=mode,
        out_rows=s.dims[mode], resolution="register", copies=8)


def _fused(s: Stream, mode: int, resolution: str):
    from repro_torch.kernels.fused import fused_mttkrp_flat
    hi, lo, vals, bases = s.flat()
    return lambda: fused_mttkrp_flat(
        hi, lo, vals, bases, s.factors, field_bits=s.fields,
        field_shifts=s.shifts, mode=mode, out_rows=s.dims[mode],
        resolution=resolution)


def _sweep(s: Stream):
    from repro_torch.core.cp_als import sweep_mode_update
    m_mat = s.factors[0] * 2.0
    grams = [f.T @ f for f in s.factors]
    return lambda: sweep_mode_update(m_mat, grams, mode=0)


def registered_hot_paths(*, device=DEFAULT_DEVICE, cache=None,
                         factors=None) -> list[HotPath]:
    """Every audited dataflow over the representative stream on
    ``device`` (the card by default; ``"cpu"`` for the plain paths), or
    over ``cache``'s launches with ``factors``, on their device.  The fused
    stash path is registered only where a mode takes K2's stash."""
    s = cache_stream(cache, factors) if cache is not None \
        else representative_stream(device)
    dev = s.hi.device
    reg, hier, stash = _modes(s)
    launches = "src/repro_torch/core/launches.py"
    fused = "src/repro_torch/kernels/fused.py"
    paths = [
        HotPath("stacked_mttkrp[register]", launches, dev, s.dims,
                _stacked(s, "register", reg)),
        HotPath("stacked_mttkrp[hierarchical]", launches, dev, s.dims,
                _stacked(s, "hierarchical", hier)),
        HotPath("launch_mttkrp_impl[streamed]",
                "src/repro_torch/core/streaming.py", dev, s.dims,
                _launch_body(s, reg)),
        HotPath("fused_mttkrp_flat[segment]", fused, dev, s.dims,
                _fused(s, reg, "register")),
    ]
    if stash is not None:
        paths.append(HotPath("fused_mttkrp_flat[stash]", fused, dev, s.dims,
                             _fused(s, stash, "hierarchical")))
    paths.append(HotPath("sweep_mode_update", "src/repro_torch/core/cp_als.py",
                         dev, s.dims, _sweep(s)))
    return paths
