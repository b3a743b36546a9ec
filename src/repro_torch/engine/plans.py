"""The port's ExecutionPlan backends.

  InMemoryPlan   device-resident BLCO (absorbs ``core.mttkrp.DeviceBLCO``):
                 the paper's in-memory regime — one upload, then every
                 MTTKRP with ``kernel="cuda"`` is exactly one kernel launch.
  StreamedPlan   host-resident BLCO streamed through a ring of fixed
                 reservations (the paper's out-of-memory regime): one
                 K1/K2 launch per chunk with ``kernel="cuda"``.

The disk tier's ``DiskStreamedPlan`` lives in ``repro_torch.store``.  The
sharded and baseline plans of ``repro.engine.plans`` are later slices of
the port (ROADMAP.md, queue 1).  Each ``mttkrp`` call records a
``plan.mttkrp`` span when tracing is on (``repro_torch.obs.trace``).
"""
from __future__ import annotations

import time

import torch

from repro_torch.core.blco import BLCOTensor
from repro_torch.core.counters import dispatch_count
from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.core.mttkrp import DEFAULT_COPIES, DeviceBLCO, validate_kernel
from repro_torch.core.streaming import (EngineStats, LaunchChunks,
                                        ReservationSpec, StreamBuffers,
                                        reservation_for, stream_mttkrp)
from repro_torch.obs import trace as obs_trace


class InMemoryPlan:
    """Device-resident plan: the whole BLCO tensor lives in device memory.

    The launch cache is built and uploaded once at plan creation.  Each
    ``mttkrp`` call is then one fused kernel launch (``kernel="cuda"``) or
    the plain PyTorch dataflow, one dispatch per BLCO launch
    (``kernel="torch"``).  Calls are fenced with ``torch.cuda.synchronize()``
    on the card so ``EngineStats`` splits the host's issue time from the
    device time.  ``resident`` shares another plan's ``DeviceBLCO`` instead
    of uploading the tensor again; ``owns_resident`` says whether ``close``
    releases it.
    """

    backend = "in_memory"

    def __init__(self, blco: BLCOTensor, *, resolution: str = "auto",
                 copies: int = DEFAULT_COPIES, kernel: str = "cuda",
                 device=DEFAULT_DEVICE, resident: DeviceBLCO | None = None,
                 owns_resident: bool = True):
        validate_kernel(kernel)
        self.dims = blco.dims
        self.resolution = resolution
        self.copies = copies
        self.kernel = kernel
        self._owns = owns_resident if resident is not None else True
        self._dev: DeviceBLCO | None = resident if resident is not None \
            else DeviceBLCO(blco, kernel=kernel, device=device)
        self._stats = EngineStats(backend=self.backend)
        if resident is None:
            # the one host-to-device transfer of this regime: the upload
            self._stats.h2d_bytes += self._dev.device_bytes()

    @property
    def resident(self) -> DeviceBLCO:
        """The device-resident tensor (for plans that share it)."""
        if self._dev is None:
            raise RuntimeError("plan is closed")
        return self._dev

    def mttkrp(self, factors, mode: int, *, resolution: str | None = None,
               copies: int | None = None):
        dev = self.resident
        with obs_trace.span("plan.mttkrp", "plan", backend=self.backend,
                            mode=mode):
            c0 = dispatch_count()
            t0 = time.perf_counter()
            out = dev.mttkrp(
                factors, mode, kernel=self.kernel,
                resolution=resolution if resolution is not None
                else self.resolution,
                copies=copies if copies is not None else self.copies)
            # host wall time of the (asynchronous) issue vs the fenced span
            t1 = time.perf_counter()
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            t2 = time.perf_counter()
        self._stats.dispatch_time_s += t1 - t0
        self._stats.device_time_s += t2 - t0
        self._stats.total_time_s += t2 - t0
        self._stats.mttkrp_calls += 1
        self._stats.launches += dispatch_count() - c0
        return out

    def device_bytes(self) -> int:
        return self._dev.device_bytes() if self._dev is not None else 0

    def stats(self) -> EngineStats:
        return self._stats

    def close(self) -> int:
        if self._dev is None:
            return 0
        freed = self._dev.device_bytes()
        if self._owns:
            self._dev.delete()
        self._dev = None
        return freed


class StreamedPlan:
    """Out-of-memory plan: host-resident tensor, fixed device reservations.

    The plan owns its ring (``buffers``): ``queues`` host and ``queues``
    device buffer sets of one reservation each, allocated once here and
    reused by every call.  ``chunks`` is the chunk source, by default the
    tensor's ``LaunchChunks``, which pads one launch at a time into the
    ring's host buffers.
    """

    backend = "streamed"

    def __init__(self, blco: BLCOTensor, *, queues: int = 4,
                 reservation_nnz: int | None = None,
                 spec: ReservationSpec | None = None, chunks=None,
                 resolution: str = "auto", copies: int = DEFAULT_COPIES,
                 kernel: str = "cuda", device=DEFAULT_DEVICE):
        validate_kernel(kernel)
        self.blco = blco
        self.dims = blco.dims
        self.queues = queues
        self.resolution = resolution
        self.copies = copies
        self.kernel = kernel
        self.spec = spec if spec is not None \
            else reservation_for(blco, reservation_nnz)
        self.chunks = chunks if chunks is not None \
            else LaunchChunks(blco, self.spec.nnz)
        self.buffers: StreamBuffers | None = StreamBuffers(
            self.spec, queues, blco.values.dtype, device=device)
        self._stats = EngineStats(backend=self.backend)

    def mttkrp(self, factors, mode: int, *, resolution: str | None = None,
               copies: int | None = None):
        if self.buffers is None:
            raise RuntimeError("plan is closed")
        with obs_trace.span("plan.mttkrp", "plan", backend=self.backend,
                            mode=mode):
            return stream_mttkrp(
                self.chunks, self.blco, factors, mode, queues=self.queues,
                resolution=resolution if resolution is not None
                else self.resolution,
                copies=copies if copies is not None else self.copies,
                stats=self._stats, kernel=self.kernel,
                buffers=self.buffers)

    def device_bytes(self) -> int:
        """Reservation bytes in flight (the only device-resident state)."""
        return 0 if self.buffers is None \
            else self.spec.bytes_in_flight(self.queues)

    def host_window_bytes(self) -> int:
        """Padded host bytes the streaming loop holds at once: one
        reservation per queue, never the whole tensor's launches."""
        return 0 if self.buffers is None \
            else self.spec.bytes_per_launch * self.queues

    def stats(self) -> EngineStats:
        return self._stats

    def close(self) -> int:
        if self.buffers is None:
            return 0
        freed = self.buffers.close()
        self.buffers = None
        self.chunks = None
        return freed


__all__ = ["InMemoryPlan", "StreamedPlan"]
