"""``DiskStreamedPlan``: the disk-resident ExecutionPlan (disk -> card).

The port of ``repro.store.plan``.  The paper's out-of-memory regime
assumes the tensor fits in host RAM and streams host -> device through
fixed reservations.  This plan starts one tier lower: the tensor lives in
a ``.blco`` store file, and each reservation-padded chunk is copied from
the file's memmap into the pinned host set of the plan's ring
(``StoredBLCO.chunk_into``), copied to its device set and computed by one
K1/K2 launch — the host holds no padded chunk beyond the ring (``queues``
padded launches), so tensors larger than host RAM decompose under the same
engine API.

The store pads launches with the same power-of-two reservation the
host-streamed regime uses, so a disk-streamed plan has the same ring shape
as a ``StreamedPlan`` of the same tensor.
"""
from __future__ import annotations

import os

from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.core.mttkrp import DEFAULT_COPIES, validate_kernel
from repro_torch.core.streaming import (EngineStats, StreamBuffers,
                                        stream_mttkrp)
from repro_torch.obs import trace as obs_trace

from .format import StoredBLCO, open_blco, save_blco


class DiskStreamedPlan:
    """Disk-resident plan: store chunks are read into a ring of fixed
    reservations and streamed to the device.

    ``stored`` is a :class:`~repro_torch.store.format.StoredBLCO` or a path
    to one.  The plan owns its ring (``buffers``), allocated once here on
    ``device`` (the card by default) and reused by every call.
    ``delete_on_close`` unlinks the file when the plan closes — the right
    setting for an anonymous spill the plan itself created (:meth:`spill`).
    """

    backend = "disk_streamed"

    def __init__(self, stored: StoredBLCO | str | os.PathLike, *,
                 queues: int = 4, resolution: str = "auto",
                 copies: int = DEFAULT_COPIES, kernel: str = "cuda",
                 delete_on_close: bool = False, device=DEFAULT_DEVICE):
        validate_kernel(kernel)
        if not isinstance(stored, StoredBLCO):
            stored = open_blco(os.fspath(stored))
        self.stored = stored
        self.dims = stored.dims
        self.queues = queues
        self.resolution = resolution
        self.copies = copies
        self.kernel = kernel
        self.spec = stored.spec
        self.delete_on_close = delete_on_close
        self.buffers: StreamBuffers | None = StreamBuffers(
            self.spec, queues, stored.value_dtype, device=device)
        self._stats = EngineStats(backend=self.backend)

    @classmethod
    def spill(cls, blco, path: str, *, fingerprint: str | None = None,
              norm_x: float | None = None, reservation_nnz: int | None = None,
              delete_on_close: bool = True, **kwargs) -> "DiskStreamedPlan":
        """Write ``blco`` to ``path`` and plan disk-streaming from it.

        The host copy can be dropped afterwards; by default the spill file
        is private to this plan and unlinked on ``close()``.
        """
        save_blco(blco, path, fingerprint=fingerprint, norm_x=norm_x,
                  reservation_nnz=reservation_nnz)
        return cls(path, delete_on_close=delete_on_close, **kwargs)

    def mttkrp(self, factors, mode: int, *, resolution: str | None = None,
               copies: int | None = None):
        if self.buffers is None:
            raise RuntimeError("plan is closed")
        with obs_trace.span("plan.mttkrp", "plan", backend=self.backend,
                            mode=mode):
            return stream_mttkrp(
                self.stored.chunks(stats=self._stats), self.stored, factors,
                mode, queues=self.queues,
                resolution=resolution if resolution is not None
                else self.resolution,
                copies=copies if copies is not None else self.copies,
                stats=self._stats, kernel=self.kernel, buffers=self.buffers)

    def device_bytes(self) -> int:
        """Reservation bytes in flight (identical to the streamed regime)."""
        return 0 if self.buffers is None \
            else self.spec.bytes_in_flight(self.queues)

    def host_window_bytes(self) -> int:
        """Padded chunk bytes the host holds at once: the ring's host sets."""
        return 0 if self.buffers is None \
            else self.spec.bytes_per_launch * self.queues

    def disk_bytes(self) -> int:
        """Size of the backing store file."""
        return 0 if self.buffers is None else self.stored.file_bytes()

    def stats(self) -> EngineStats:
        return self._stats

    def close(self) -> int:
        """Free the ring and close the store (unlinking it when the plan
        owns it); returns the device bytes freed."""
        if self.buffers is None:
            return 0
        freed = self.buffers.close()
        self.buffers = None
        path = self.stored.path
        self.stored.close()
        if self.delete_on_close:
            try:
                os.unlink(path)
            except OSError:
                pass
        return freed
