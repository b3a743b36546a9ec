"""Out-of-memory (OOM) MTTKRP: stream BLCO launches through fixed device
reservations (the port of ``repro.core.streaming``).

The paper (§4.2, §6.4.2) streams BLCO blocks host->device through up to 8
device queues, each with a fixed memory reservation, overlapping transfers
of pending blocks with compute on active blocks.  On the card:

* a fixed per-queue **reservation** (``ReservationSpec``): every launch is
  padded to it, so each chunk is one K1/K2 launch over the same shapes;
* a **ring** of ``queues`` buffer sets (``StreamBuffers``), allocated once
  and reused: pinned host buffers that ``LaunchChunks.chunk_into`` fills in
  place, device buffers of the same size, a copy stream for the
  host-to-device copies and events that keep a buffer from being refilled
  while a copy or a kernel still reads it;
* the factor matrices and the (I_mode, R) accumulator stay on the device;
  only the non-zero stream moves.

``stream_mttkrp`` is the loop, ``OOMExecutor`` the single-tensor
convenience wrapper, ``repro_torch.engine.StreamedPlan`` the engine's way
in, and ``repro_torch.store.DiskStreamedPlan`` the same loop fed from a
``.blco`` store file.  Each copy passes the ``stream.h2d`` fault probe and
is retried on a transient failure.  ``EngineStats`` holds the unified
per-plan counters; its ``hist`` comes with the port's observability slice.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.faults import inject as faults
from repro_torch.faults.retry import retry_call

from .blco import BLCOTensor
from .counters import record_dispatch
from .device import DEFAULT_DEVICE, resolve_device
from .mttkrp import (DEFAULT_COPIES, choose_resolution, launch_mttkrp_impl,
                     validate_kernel)
from .padding import next_pow2


@dataclasses.dataclass
class EngineStats:
    """Unified per-plan execution counters (every engine backend fills one).

    Timing is split so an asynchronous launch is never mistaken for device
    compute: ``dispatch_time_s`` is the host wall time spent issuing compute
    calls; ``device_time_s`` is the fenced span from the first issue of a
    call until the device has finished it (``torch.cuda.synchronize()``).
    """
    backend: str = ""
    mttkrp_calls: int = 0
    h2d_bytes: int = 0
    disk_bytes: int = 0          # disk->host bytes fetched (disk-streamed plans)
    launches: int = 0
    put_time_s: float = 0.0
    disk_time_s: float = 0.0     # host wall time fetching chunks from the store
    dispatch_time_s: float = 0.0
    device_time_s: float = 0.0
    total_time_s: float = 0.0
    retries: int = 0             # transient failures retried successfully
    giveups: int = 0             # retry budgets exhausted (error surfaced)
    demotions: int = 0           # regime changes (plan_for's ladder)

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


# the reference's older name for the same counters
StreamStats = EngineStats


@dataclasses.dataclass(frozen=True)
class ReservationSpec:
    """A fixed device launch-buffer shape (the paper's queue reservation)."""
    nnz: int                 # padded slots per launch buffer
    order: int               # tensor order (bases array width)
    value_itemsize: int      # bytes per value

    @property
    def bytes_per_launch(self) -> int:
        """Device bytes of one launch (hi + lo + vals + bases)."""
        return self.nnz * (4 + 4 + self.value_itemsize + 4 * self.order)

    def bytes_in_flight(self, queues: int) -> int:
        return self.bytes_per_launch * queues


def reservation_for(blco: BLCOTensor,
                    reservation_nnz: int | None = None) -> ReservationSpec:
    """Reservation covering the largest launch (pow2-padded unless given)."""
    max_launch = max((l.nnz for l in blco.launches), default=1)
    nnz = int(reservation_nnz or next_pow2(max_launch))
    if nnz < max_launch:
        raise ValueError("reservation smaller than largest launch")
    return ReservationSpec(nnz=nnz, order=blco.order,
                           value_itemsize=blco.values.dtype.itemsize)


def _fill_rows(dst: np.ndarray, row) -> None:
    """Set every row of the C-contiguous (m, N) ``dst`` to ``row``: one
    short broadcast, then contiguous copies that double the filled rows
    (a broadcast of one row over millions of rows is several times
    slower)."""
    m = dst.shape[0]
    if m == 0:
        return
    dst[0] = row
    done = 1
    while done < m:
        c = min(done, m - done)
        dst[done:done + c] = dst[:c]
        done += c


class LaunchChunks:
    """Lazily padded reservation chunks of a host-resident BLCO (re-iterable).

    Each chunk is one launch padded to the reservation.  Zero padding is
    exact for MTTKRP: pad slots delinearize to coordinate 0 with value 0 and
    base 0, contributing +0.0 to row 0.  ``pads`` counts chunk
    materializations.
    """

    def __init__(self, blco: BLCOTensor, reservation_nnz: int):
        r = int(reservation_nnz)
        max_launch = max((l.nnz for l in blco.launches), default=0)
        if max_launch > r:
            raise ValueError(f"launch of {max_launch} nnz exceeds "
                             f"reservation {r}")
        self.blco = blco
        self.reservation_nnz = r
        self._bases_all = blco.block_upper_bases()
        self._block_ids = blco.element_block_ids()
        self.pads = 0

    def __len__(self) -> int:
        return len(self.blco.launches)

    def chunk(self, i: int):
        """Pad launch ``i`` to the reservation (one fresh numpy tuple)."""
        b = self.blco
        r = self.reservation_nnz
        launch = b.launches[i]
        s, e = launch.start, launch.end
        n = e - s
        hi = np.zeros(r, np.uint32); hi[:n] = b.idx_hi[s:e]
        lo = np.zeros(r, np.uint32); lo[:n] = b.idx_lo[s:e]
        vals = np.zeros(r, b.values.dtype); vals[:n] = b.values[s:e]
        bases = np.zeros((r, b.order), np.int32)
        bases[:n] = self._bases_all[self._block_ids[s:e]]
        self.pads += 1
        return (hi, lo, vals, bases, n)

    def chunk_into(self, i: int, bufs) -> int:
        """Pad launch ``i`` into caller-owned numpy buffers ``(hi, lo, vals,
        bases)`` of the reservation's shape, byte for byte what ``chunk(i)``
        returns, and return its nnz.  The tail past the launch is zeroed
        every time: a reused buffer still holds the last chunk there."""
        hi, lo, vals, bases = bufs
        b = self.blco
        r = self.reservation_nnz
        if hi.shape != (r,) or lo.shape != (r,) or vals.shape != (r,) \
                or bases.shape != (r, b.order) or vals.dtype != b.values.dtype:
            raise ValueError(f"buffers {hi.shape} {lo.shape} {vals.shape} "
                             f"{vals.dtype} {bases.shape} do not hold a "
                             f"reservation of {r} at order {b.order}")
        launch = b.launches[i]
        s, e = launch.start, launch.end
        n = e - s
        for dst, src in ((hi, b.idx_hi), (lo, b.idx_lo), (vals, b.values)):
            dst[:n] = src[s:e]
            dst[n:] = 0
        # each block of a launch is one contiguous range with one base row
        for bid in launch.block_ids:
            blk = b.blocks[bid]
            _fill_rows(bases[blk.start - s:blk.end - s], self._bases_all[bid])
        bases[n:] = 0
        self.pads += 1
        return n

    def __iter__(self):
        for i in range(len(self)):
            yield self.chunk(i)


def prepare_chunks(blco: BLCOTensor, reservation_nnz: int):
    """Pad every launch to the reservation size, materialized as a list
    (the launch cache stacks them all at once)."""
    return list(LaunchChunks(blco, reservation_nnz))


class StreamBuffers:
    """The ring a streamed MTTKRP fills and reads: ``queues`` host buffer
    sets (pinned on the card) and ``queues`` device buffer sets of
    ``spec.bytes_per_launch`` each, allocated once and reused.

    Each set is one flat byte buffer, carved into hi, lo, vals and bases,
    so one copy moves a chunk.  On the card the copies run on a copy stream
    of their own, and two events per set order the ring:

    * ``copied[k]``: the copy out of host set ``k`` has finished, so the
      host may refill it, and the compute that reads device set ``k`` may
      start;
    * ``read[k]``: the compute that read device set ``k`` has finished, so
      the next copy may overwrite it.

    On the CPU the same ring is used unpinned, without streams or events.
    """

    def __init__(self, spec: ReservationSpec, queues: int, value_dtype,
                 device=DEFAULT_DEVICE):
        dev = resolve_device(device)
        value_dtype = np.dtype(value_dtype)
        if int(queues) < 1:
            raise ValueError(f"queues must be >= 1, got {queues}")
        if value_dtype.itemsize != spec.value_itemsize:
            raise ValueError(f"values of {value_dtype} do not fit a "
                             f"reservation of {spec.value_itemsize} B values")
        self.spec = spec
        self.queues = int(queues)
        self.device = dev
        cuda = dev.type == "cuda"
        nbytes = spec.bytes_per_launch
        self._host = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)
                      for _ in range(self.queues)]
        self._dev = [torch.empty(nbytes, dtype=torch.uint8, device=dev)
                     for _ in range(self.queues)]
        self._host_views = [_carve(h.numpy(), spec, (
            np.dtype(np.uint32), np.dtype(np.uint32), value_dtype,
            np.dtype(np.int32))) for h in self._host]
        dev_types = (torch.uint32, torch.uint32,
                     torch.from_numpy(np.zeros(0, value_dtype)).dtype,
                     torch.int32)
        self._dev_views = [_carve(d, spec, dev_types) for d in self._dev]
        self.copy_stream = torch.cuda.Stream(dev) if cuda else None
        self._copied = [torch.cuda.Event() for _ in range(self.queues)] \
            if cuda else None
        self._read = [torch.cuda.Event() for _ in range(self.queues)] \
            if cuda else None

    @property
    def closed(self) -> bool:
        return self._dev is None

    def host_set(self, k: int):
        """Set ``k``'s host buffers, ``(hi, lo, vals, bases)`` numpy views,
        once its last copy has left them."""
        self._check_open()
        if self._copied is not None:
            self._copied[k].synchronize()
        return self._host_views[k]

    def upload(self, k: int) -> None:
        """Copy host set ``k`` to device set ``k``: on the card
        asynchronously, on the copy stream, after the last compute that
        read device set ``k``."""
        self._check_open()
        if self.copy_stream is None:
            self._dev[k].copy_(self._host[k])
            return
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(self._read[k])
            self._dev[k].copy_(self._host[k], non_blocking=True)
            self._copied[k].record(self.copy_stream)

    def device_set(self, k: int):
        """Device set ``k``, ``(hi, lo, vals, bases)``, for work on the
        current stream: the stream first waits for the set's copy."""
        self._check_open()
        if self._copied is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self._copied[k])
        return self._dev_views[k]

    def release(self, k: int) -> None:
        """Mark the work issued on the current stream so far as the last
        that reads device set ``k``."""
        if self._read is not None:
            self._read[k].record(torch.cuda.current_stream(self.device))

    def device_bytes(self) -> int:
        return 0 if self.closed else self.spec.bytes_in_flight(self.queues)

    def close(self) -> int:
        """Free both rings; returns the device bytes freed (0 when already
        closed)."""
        if self.closed:
            return 0
        freed = self.device_bytes()
        if self.copy_stream is not None:
            self.copy_stream.synchronize()
            torch.cuda.current_stream(self.device).synchronize()
        self._host = self._dev = self._host_views = self._dev_views = None
        return freed

    def _check_open(self) -> None:
        if self.closed:
            raise RuntimeError("stream buffers are closed")


def _carve(flat, spec: ReservationSpec, types) -> tuple:
    """``(hi, lo, vals, bases)`` views of one flat byte buffer (numpy or
    torch) of ``spec.bytes_per_launch``, in that order."""
    r, n = spec.nnz, spec.order
    views, off = [], 0
    for t, count in zip(types, (r, r, r, r * n)):
        size = count * t.itemsize
        views.append(flat[off:off + size].view(t))
        off += size
    views[3] = views[3].reshape(r, n)
    return tuple(views)


def _copy_chunk(chunk, bufs) -> int:
    """Copy one ``(hi, lo, vals, bases, n)`` tuple into the host buffers."""
    *arrays, n = chunk
    for dst, src in zip(bufs, arrays):
        src = np.asarray(src)
        if src.shape != dst.shape:
            raise ValueError(f"chunk array of shape {src.shape} does not "
                             f"fill a buffer of shape {dst.shape}")
        np.copyto(dst, src)
    return int(n)


def stream_mttkrp(chunks, blco: BLCOTensor, factors, mode: int, *,
                  queues: int, resolution: str = "auto",
                  copies: int = DEFAULT_COPIES,
                  stats: EngineStats | None = None, kernel: str = "cuda",
                  buffers: StreamBuffers | None = None):
    """Stream reservation chunks through the compute, one launch each.

    Keeps up to ``queues`` chunks in flight ahead of compute (the paper's
    queue overlap): each chunk is filled into a host buffer of the ring,
    copied to its device buffer, and consumed once ``queues`` chunks are in
    flight; the rest drain at the end.  ``chunks`` is a chunk source with
    ``chunk_into`` (a ``LaunchChunks``: the host buffer is filled in place)
    or any iterable of ``(hi, lo, vals, bases, n)`` tuples at the
    reservation's shape (copied into it); a store's ``DiskChunkSource``
    has ``chunk_into`` too, which reads the chunk from the file into the
    host buffer.  ``blco`` is a ``BLCOTensor`` or a ``StoredBLCO`` (dims,
    re-encoding and value dtype).  ``kernel="cuda"`` computes each
    chunk with one K1/K2 launch over the reservation
    (``kernels.fused.fused_mttkrp_flat``), ``"torch"`` with the plain
    dataflow.  ``buffers`` is the ring, with at least ``queues`` sets on
    the factors' device; without it one is allocated for this call.
    """
    b = blco
    validate_kernel(kernel)
    if resolution == "auto":
        resolution = choose_resolution(b.dims[mode])
    factors = tuple(factors)
    dev = factors[0].device
    # ``b`` is a BLCOTensor or a StoredBLCO, which has no ``values`` and
    # no launches: its chunks are padded to its own reservation
    val_dtype = getattr(b, "value_dtype", None)
    stored = val_dtype is not None
    if not stored:
        val_dtype = b.values.dtype
    own = buffers is None
    if own:
        spec = b.spec if stored else reservation_for(
            b, getattr(chunks, "reservation_nnz", None))
        buffers = StreamBuffers(spec, queues, val_dtype, device=dev)
    elif buffers.queues < queues:
        raise ValueError(f"{buffers.queues} buffer sets cannot keep "
                         f"{queues} chunks in flight")
    if kernel == "cuda":
        from repro_torch.kernels.fused import fused_mttkrp_flat
    rank = factors[0].shape[1]
    # accumulate at the promoted precision (f64 values vs f32 factors must
    # not downcast)
    out_dtype = torch.promote_types(
        torch.from_numpy(np.zeros(0, val_dtype)).dtype, factors[0].dtype)
    out = torch.zeros((b.dims[mode], rank), dtype=out_dtype, device=dev)
    stats = stats if stats is not None else EngineStats()
    fill = getattr(chunks, "chunk_into", None)
    items = range(len(chunks)) if fill is not None else chunks

    t_start = time.perf_counter()
    in_flight: collections.deque = collections.deque()
    t_first_dispatch: float | None = None

    def _issue(k, item):
        t0 = time.perf_counter()
        # waits until set k's last copy has left the host buffer
        bufs = buffers.host_set(k)
        n = fill(item, bufs) if fill is not None else _copy_chunk(item, bufs)

        def _put():
            faults.maybe_fail("stream.h2d")
            buffers.upload(k)

        # a transient copy failure (injected or genuine) is retried with
        # backoff; a re-issued copy reads the same pinned set, so a retry
        # has no side effect
        retry_call(_put, site="stream.h2d", stats=stats)
        put_s = time.perf_counter() - t0
        stats.put_time_s += put_s
        stats.h2d_bytes += buffers.spec.bytes_per_launch
        # obs_trace "h2d.put" and obs_ledger.record(HOST_DEVICE,
        # bytes_per_launch, put_s) take these same floats (item 8)
        in_flight.append((k, n))

    def _consume(k, n):
        nonlocal t_first_dispatch
        t0 = time.perf_counter()
        if t_first_dispatch is None:
            t_first_dispatch = t0
        hi, lo, vals, bases = buffers.device_set(k)
        if kernel == "cuda":
            # fused_mttkrp_flat records its own dispatch
            part = fused_mttkrp_flat(
                hi, lo, vals, bases, factors, field_bits=b.re.field_bits,
                field_shifts=b.re.field_shift, mode=mode,
                out_rows=b.dims[mode], resolution=resolution)
        else:
            record_dispatch()
            part = launch_mttkrp_impl(
                hi, lo, vals, bases, factors, re_fields=b.re.field_bits,
                re_shifts=b.re.field_shift, mode=mode,
                out_rows=b.dims[mode], resolution=resolution, copies=copies)
        out.add_(part)
        buffers.release(k)
        # host wall time of the (asynchronous) issue only
        dispatch_s = time.perf_counter() - t0
        stats.dispatch_time_s += dispatch_s
        stats.launches += 1
        # obs_trace "dispatch.launch" takes these same floats (item 8)

    try:
        for i, item in enumerate(items):
            # keep up to `queues` chunks in flight ahead of compute
            _issue(i % buffers.queues, item)
            if len(in_flight) >= queues:
                _consume(*in_flight.popleft())
        while in_flight:
            _consume(*in_flight.popleft())
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    finally:
        if own:
            buffers.close()
    t_end = time.perf_counter()
    if t_first_dispatch is not None:
        # fenced: first dispatch -> every launch retired on the device;
        # obs_trace "device.fence" and the obs_ledger DEVICE_HBM record
        # take this same window (item 8)
        stats.device_time_s += t_end - t_first_dispatch
    stats.mttkrp_calls += 1
    stats.total_time_s += t_end - t_start
    return out


class OOMExecutor:
    """Streams a (host-resident) BLCO tensor through fixed device
    reservations; owns its ring of buffers (``close`` frees it)."""

    def __init__(self, blco: BLCOTensor, *, queues: int = 4,
                 reservation_nnz: int | None = None, kernel: str = "cuda",
                 device=DEFAULT_DEVICE):
        validate_kernel(kernel)
        self.blco = blco
        self.queues = queues
        self.kernel = kernel
        self.spec = reservation_for(blco, reservation_nnz)
        self._prepared = LaunchChunks(blco, self.spec.nnz)
        self._buffers = StreamBuffers(self.spec, queues, blco.values.dtype,
                                      device=device)
        self.stats = EngineStats(backend="streamed")

    @property
    def reservation(self) -> int:
        return self.spec.nnz

    def mttkrp(self, factors, mode: int, *, resolution: str = "auto",
               copies: int = DEFAULT_COPIES):
        return stream_mttkrp(self._prepared, self.blco, factors, mode,
                             queues=self.queues, resolution=resolution,
                             copies=copies, stats=self.stats,
                             kernel=self.kernel, buffers=self._buffers)

    def close(self) -> int:
        """Free the ring; returns the device bytes freed."""
        return self._buffers.close()
