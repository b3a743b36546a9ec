"""The in-memory regime's share of ``repro.core.streaming``.

``EngineStats`` (the unified per-plan counters), ``ReservationSpec`` and the
padded launch chunks that the launch cache stacks.  The out-of-memory loop
itself (``reservation_for``, ``stream_mttkrp``, ``OOMExecutor``) belongs to
the port's second slice, and ``EngineStats.hist`` to its observability
slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .blco import BLCOTensor


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
    demotions: int = 0           # regime changes (none in the port yet)

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


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

    def __iter__(self):
        for i in range(len(self)):
            yield self.chunk(i)


def prepare_chunks(blco: BLCOTensor, reservation_nnz: int):
    """Pad every launch to the reservation size, materialized as a list
    (the launch cache stacks them all at once)."""
    return list(LaunchChunks(blco, reservation_nnz))
