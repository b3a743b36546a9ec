"""Device-resident launch cache: padded launches prepared once, stacked.

The port of ``repro.core.launches``:

* :class:`LaunchCache` pads every launch to ONE reservation shape (with
  ``prepare_chunks``/``ReservationSpec`` from the streaming layer, so both
  regimes share the padding code and the byte accounting), stacks the
  chunks into ``(L, reservation)`` tensors and uploads them once;
* :func:`stacked_mttkrp` is the plain PyTorch path over the stacked
  launches: a loop over launches in launch order, where the JAX package has
  one ``lax.scan``;
* ``flat()`` returns ``(L * reservation,)`` views of the stacked tensors —
  the fused CUDA kernel's input stream, with no copy.
"""
from __future__ import annotations

import numpy as np
import torch

from .blco import BLCOTensor
from .counters import record_dispatch
from .device import DEFAULT_DEVICE, resolve_device
from .mttkrp import DEFAULT_COPIES, choose_resolution, launch_mttkrp_impl
from .padding import pad_bucket, pad_multiple
from .streaming import prepare_chunks


def default_reservation(max_launch: int) -> int:
    """The in-memory regime's default reservation for a given largest launch:
    size-class rounding (``pad_bucket``), at most 25% padding waste."""
    return pad_bucket(max_launch)


def stacked_mttkrp(hi, lo, vals, bases, factors, *, re_fields: tuple,
                   re_shifts: tuple, mode: int, out_rows: int,
                   resolution: str, copies: int):
    """Plain PyTorch MTTKRP over stacked launches.

    hi/lo: (L, res) uint32; vals: (L, res); bases: (L, res, N) int32;
    factors: N (I_n, R) tensors.  The launches run in order and accumulate
    into one (out_rows, R) output at the promoted precision; one dispatch
    is recorded per launch.
    """
    rank = factors[0].shape[1]
    dtype = torch.promote_types(vals.dtype, factors[0].dtype)
    out = torch.zeros((out_rows, rank), dtype=dtype, device=vals.device)
    for i in range(hi.shape[0]):
        record_dispatch()
        out += launch_mttkrp_impl(
            hi[i], lo[i], vals[i], bases[i], factors, re_fields=re_fields,
            re_shifts=re_shifts, mode=mode, out_rows=out_rows,
            resolution=resolution, copies=copies)
    return out


class LaunchCache:
    """Stacked, device-resident, reservation-padded launches of one tensor.

    Built once per plan.  The reservation defaults to the largest launch
    rounded up to a geometric size class (``default_reservation``).
    """

    def __init__(self, hi, lo, vals, bases, *, re_fields: tuple,
                 re_shifts: tuple, dims: tuple):
        self.hi = hi                    # (L, res) uint32
        self.lo = lo                    # (L, res) uint32
        self.vals = vals                # (L, res) float
        self.bases = bases              # (L, res, N) int32
        self.re_fields = tuple(re_fields)
        self.re_shifts = tuple(re_shifts)
        self.dims = tuple(dims)
        self.closed = False

    # ------------------------------------------------------------ construct
    @classmethod
    def from_blco(cls, blco: BLCOTensor, reservation_nnz: int | None = None,
                  *, device=DEFAULT_DEVICE) -> "LaunchCache":
        """Pad + stack + upload every launch of ``blco`` (host work, once)."""
        dev = resolve_device(device)
        max_launch = max((l.nnz for l in blco.launches), default=1)
        if reservation_nnz:
            if int(reservation_nnz) < max_launch:
                raise ValueError(
                    f"reservation {int(reservation_nnz)} smaller than "
                    f"largest launch ({max_launch} nnz)")
            # the byte predictor (launch_cache_bytes) assumes LANE-multiple
            # reservations; a ragged explicit one is rounded up
            res = pad_multiple(int(reservation_nnz))
        else:
            res = default_reservation(max_launch)
        chunks = prepare_chunks(blco, res)
        return cls.from_chunks(chunks, blco, reservation_nnz=res, device=dev)

    @classmethod
    def from_chunks(cls, chunks, blco: BLCOTensor, *, reservation_nnz: int,
                    device=DEFAULT_DEVICE) -> "LaunchCache":
        """Stack already reservation-padded chunks and upload them."""
        dev = resolve_device(device)
        res = int(reservation_nnz)
        if chunks:
            hi = np.stack([c[0] for c in chunks])
            lo = np.stack([c[1] for c in chunks])
            vals = np.stack([c[2] for c in chunks])
            bases = np.stack([c[3] for c in chunks])
        else:
            hi = np.zeros((0, res), np.uint32)
            lo = np.zeros((0, res), np.uint32)
            vals = np.zeros((0, res), blco.values.dtype)
            bases = np.zeros((0, res, blco.order), np.int32)
        return cls(*(torch.from_numpy(a).to(dev) for a in (hi, lo, vals, bases)),
                   re_fields=blco.re.field_bits, re_shifts=blco.re.field_shift,
                   dims=blco.dims)

    # ------------------------------------------------------------ introspect
    @property
    def num_launches(self) -> int:
        return int(self.hi.shape[0])

    @property
    def reservation(self) -> int:
        return int(self.hi.shape[1])

    @property
    def order(self) -> int:
        return len(self.dims)

    @property
    def device(self) -> torch.device:
        return self.hi.device

    def device_bytes(self) -> int:
        """Exact resident footprint: hi + lo + vals + bases (stacked)."""
        if self.closed:
            return 0
        return sum(int(a.numel() * a.element_size())
                   for a in (self.hi, self.lo, self.vals, self.bases))

    def flat(self):
        """Flat views, no copy: (T,) hi/lo/vals + (T, N) bases with
        ``T = L * reservation`` — the fused kernel's input stream."""
        if self.closed:
            raise RuntimeError("launch cache is closed")
        t = self.num_launches * self.reservation
        return (self.hi.view(t), self.lo.view(t), self.vals.view(t),
                self.bases.view(t, self.order))

    # --------------------------------------------------------------- compute
    def mttkrp(self, factors, mode: int, *, resolution: str = "auto",
               copies: int = DEFAULT_COPIES):
        """Plain PyTorch MTTKRP (``kernel="torch"``) from the cached launches."""
        if self.closed:
            raise RuntimeError("launch cache is closed")
        if not 0 <= mode < self.order:
            raise ValueError(f"mode {mode} out of range for order {self.order}")
        if resolution == "auto":
            resolution = choose_resolution(self.dims[mode])
        return stacked_mttkrp(
            self.hi, self.lo, self.vals, self.bases, tuple(factors),
            re_fields=self.re_fields, re_shifts=self.re_shifts, mode=mode,
            out_rows=self.dims[mode], resolution=resolution, copies=copies)

    # ---------------------------------------------------------------- release
    def delete(self) -> None:
        """Drop the device tensors (the cache must not be used after)."""
        self.closed = True
        self.hi = self.lo = self.vals = self.bases = None


def launch_cache_bytes(blco: BLCOTensor) -> int:
    """Predicted device footprint of a ``LaunchCache`` for ``blco``:
    L stacked launches x (hi + lo + vals + bases) at the default
    size-class reservation — what ``DeviceBLCO``/``InMemoryPlan`` hold."""
    if not blco.launches:
        return 0
    max_launch = max(l.nnz for l in blco.launches)
    res = default_reservation(max_launch)
    per_elem = 4 + 4 + blco.values.dtype.itemsize + 4 * blco.order
    return len(blco.launches) * res * per_elem
