"""ServiceEngine: pooled ExecutionPlans for registered tensors.

The port of ``repro.service.executor``: the multi-tenant restatement of
``repro_torch.engine``'s regime decision.  Two pools back the plans it
hands out:

* **reservation pool** — jobs whose tensors pad to the same
  ``ReservationSpec`` stream through ONE ring of buffers (``StreamBuffers``:
  pinned host sets, device sets, the copy stream), held by the pool entry
  and handed to every plan of that shape, so the budget is charged once
  per pooled shape and the card holds one ring (the paper's reused queue
  reservations, shared across tenants).  Both streaming *tiers* join this
  pool: host-resident tensors (``PooledStreamedPlan``) and spilled,
  disk-resident ones (``PooledDiskStreamedPlan``) — the store pads
  launches to the same power-of-two reservations;
* **residency pool** — jobs on the same registered tensor whose BLCO fits
  the remaining budget share ONE device-resident copy (``DeviceBLCO``),
  skipping per-iteration H2D entirely — the device-resident fast path
  under the same admission accounting.

Each admitted job gets its *own* plan object (own ``EngineStats``) over the
shared pooled state; ``plan.device_bytes()`` reports the bytes that plan
newly holds against the budget: its private rank-R factor working set
(charged per job on EVERY branch — it is never pooled) plus the pooled
tensor state (charged once, when the plan created the pool entry).
``plan.close()`` returns the bytes freed (working set + the full pooled
entry when the last sharer leaves) — so summing charges and frees over any
admission order nets to zero.  Plans pin their ``TensorHandle`` for their
lifetime, which blocks registry eviction of in-use tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.mttkrp import DeviceBLCO
from repro_torch.core.streaming import ReservationSpec, StreamBuffers
from repro_torch.faults import inject as faults
from repro_torch.engine.api import factor_bytes, in_memory_bytes
from repro_torch.engine.plans import InMemoryPlan, StreamedPlan
from repro_torch.obs import ledger as obs_ledger
from repro_torch.store import DiskStreamedPlan

from .registry import TensorHandle


@dataclasses.dataclass
class PoolEntry:
    spec: ReservationSpec
    buffers: StreamBuffers       # the ring every plan of this spec streams
    refcount: int = 0            # through; closed when the last one leaves
    launches: int = 0


@dataclasses.dataclass
class ResidentEntry:
    key: str
    device: DeviceBLCO
    bytes: int
    refcount: int = 0


class PooledStreamedPlan(StreamedPlan):
    """A per-job streamed plan over a pooled reservation shape."""

    def __init__(self, engine: "ServiceEngine", handle: TensorHandle,
                 held_bytes: int, working_bytes: int = 0):
        super().__init__(handle.blco, queues=engine.queues, spec=handle.spec,
                         chunks=handle.chunks, kernel=engine.kernel,
                         device=engine.device,
                         buffers=engine._stream_pool[handle.spec].buffers)
        self._engine = engine
        self._handle = handle
        self._held = held_bytes
        self._working = working_bytes       # per-job factor set, never pooled

    def device_bytes(self) -> int:
        """Bytes this plan newly holds against the budget: its per-job
        factor working set plus the pooled reservation (0 when the
        reservation shape was already pooled by another tenant)."""
        return 0 if self.buffers is None else self._held + self._working

    def close(self) -> int:
        if self.buffers is None:
            return 0
        super().close()     # drops the pooled ring without closing it and
        self._handle.unpin()        # the chunks (the handle keeps its own)
        return self._engine._release_stream(self.spec) + self._working


class PooledDiskStreamedPlan(DiskStreamedPlan):
    """A per-job disk-streamed plan over a pooled reservation shape.

    Spilled tensors stream store chunks through the ring to the device;
    because the store pads launches to the same power-of-two reservation
    the host-streaming regime uses, the plan joins the SAME stream pool
    (and ring) as host-streamed plans of that spec.
    """

    def __init__(self, engine: "ServiceEngine", handle: TensorHandle,
                 held_bytes: int, working_bytes: int = 0):
        super().__init__(handle.open_stored(), queues=engine.queues,
                         spec=handle.spec, kernel=engine.kernel,
                         device=engine.device,
                         buffers=engine._stream_pool[handle.spec].buffers)
        self._engine = engine
        self._handle = handle
        self._held = held_bytes
        self._working = working_bytes       # per-job factor set, never pooled

    def device_bytes(self) -> int:
        return 0 if self.buffers is None else self._held + self._working

    def close(self) -> int:
        if self.buffers is None:
            return 0
        super().close()
        self._handle.unpin()
        return self._engine._release_stream(self.spec) + self._working


class PooledInMemoryPlan(InMemoryPlan):
    """A per-job device-resident plan over a pooled DeviceBLCO copy."""

    def __init__(self, engine: "ServiceEngine", handle: TensorHandle,
                 entry: ResidentEntry, held_bytes: int,
                 working_bytes: int = 0):
        super().__init__(handle.blco, resident=entry.device,
                         owns_resident=False, kernel=engine.kernel)
        self._engine = engine
        self._handle = handle
        self._entry = entry
        self._held = held_bytes
        self._working = working_bytes       # per-job factor set, never pooled
        if held_bytes:                      # this plan paid for the upload
            self._stats.h2d_bytes += held_bytes
            if obs_ledger.LEDGER.enabled:
                # mirror of the stats line above: bytes, zero seconds
                obs_ledger.record(obs_ledger.HOST_DEVICE, held_bytes, 0.0,
                                  regime=self.backend)

    def device_bytes(self) -> int:
        return 0 if self._dev is None else self._held + self._working

    def close(self) -> int:
        if self._dev is None:
            return 0
        self._dev = None
        self._handle.unpin()
        return self._engine._release_resident(self._entry.key) + self._working


class ServiceEngine:
    """Plans pooled execution for registered tensors under one device budget.

    ``device`` is where every plan puts its tensors (the card unless the
    caller asks for the CPU); ``kernel="cuda"`` runs K1/K2, ``"torch"``
    the plain path.
    """

    def __init__(self, *, queues: int = 4, kernel: str = "cuda",
                 device=DEFAULT_DEVICE):
        self.queues = queues
        self.kernel = kernel
        self.device = resolve_device(device)
        self._stream_pool: dict[ReservationSpec, PoolEntry] = {}
        self._resident_pool: dict[str, ResidentEntry] = {}

    # --------------------------------------------------------------- costs
    def streamed_cost(self, handle: TensorHandle) -> int:
        """Bytes a streamed plan for this handle would newly hold."""
        if handle.spec in self._stream_pool:
            return 0
        return handle.spec.bytes_in_flight(self.queues)

    def resident_cost(self, handle: TensorHandle) -> int:
        """Bytes a device-resident plan for this handle would newly hold."""
        if handle.key in self._resident_pool:
            return 0
        return in_memory_bytes(handle.blco)

    def min_cost(self, handle: TensorHandle, rank: int,
                 dtype=torch.float32) -> int:
        """Cheapest unpooled device need (the can-never-fit check).

        Every regime keeps the rank-R factor working set resident alongside
        the tensor state, so it is part of the need either way.  A spilled
        handle's only regime is (disk-)streaming, and both streaming tiers
        share the reservation cost.
        """
        working = factor_bytes(handle.dims, rank, dtype)
        stream = handle.spec.bytes_in_flight(self.queues)
        if not handle.resident:
            return working + stream
        return working + min(stream, in_memory_bytes(handle.blco))

    # ---------------------------------------------------------------- plans
    def try_plan(self, handle: TensorHandle, *, rank: int,
                 dtype=torch.float32, budget_remaining: int):
        """The pooled regime decision: an ExecutionPlan, or None to wait.

        Every branch charges the per-job rank-R factor working set: it is
        private to the job (factors + accumulator live on device for the
        job's whole run) and is NEVER pooled, so joining an existing
        resident copy or a pooled reservation still costs ``working`` bytes.
        Device-resident when the pooled residency cost plus the working set
        fits what is left of the budget (joining an existing copy makes the
        pooled part free and strictly better than streaming); streamed when
        the (pooled) reservation plus the working set fits; None when
        neither does.  A SPILLED handle admits straight from the store —
        disk-streamed through the same pooled reservation shapes, without
        ever reloading the tensor into host memory.

        Degradation ladder: a device-allocation failure while
        materializing the resident copy demotes the job to the streamed
        tier, and a failure there demotes to disk-streaming when the
        handle has a persistent copy — each demotion recorded in the
        plan's ``EngineStats.demotions`` (the scheduler rolls it up into
        ``demotions_total`` at admission).  Non-allocation errors
        propagate; the pool joins below are exception-safe, so a failed
        rung never leaks a pin or a pool refcount.
        """
        from ..analysis.sanitize import wrap_plan
        working = factor_bytes(handle.dims, rank, dtype)
        if not handle.resident:
            if self.streamed_cost(handle) + working <= budget_remaining:
                return wrap_plan(self._plan_disk(handle, working))
            return None
        demotions = 0
        rc = self.resident_cost(handle)
        if rc + working <= budget_remaining:
            try:
                return wrap_plan(self._plan_resident(handle, working))
            except Exception as exc:    # noqa: BLE001 — classified below
                if not faults.is_alloc_failure(exc):
                    raise
                demotions += 1
        sc = self.streamed_cost(handle)
        if sc + working <= budget_remaining:
            try:
                plan = self._plan_streamed(handle, working)
            except Exception as exc:    # noqa: BLE001 — classified below
                if not (faults.is_alloc_failure(exc)
                        and handle.store_path is not None):
                    raise
                demotions += 1
                plan = self._plan_disk(handle, working)
            plan.stats().demotions += demotions
            return wrap_plan(plan)
        return None

    def _plan_resident(self, handle: TensorHandle,
                       working: int = 0) -> PooledInMemoryPlan:
        # the DeviceBLCO upload happens BEFORE the pool entry exists, so a
        # failed allocation (the ladder's demotion trigger) leaves both the
        # pool and the handle's pin count untouched
        entry = self._resident_pool.get(handle.key)
        held = 0
        if entry is None:
            device = DeviceBLCO(handle.blco, kernel=self.kernel,
                                device=self.device)
            entry = ResidentEntry(key=handle.key, device=device,
                                  bytes=device.device_bytes())
            self._resident_pool[handle.key] = entry
            held = entry.bytes
        entry.refcount += 1
        handle.pin()
        try:
            return PooledInMemoryPlan(self, handle, entry, held, working)
        except BaseException:
            handle.unpin()
            self._release_resident(handle.key)
            raise

    def _join_stream_pool(self, handle: TensorHandle) -> int:
        """Join (or create) the pooled reservation entry for ``handle``;
        pins the handle and returns the bytes newly charged (0 on join).

        The entry holds the ring: the first joiner allocates it (before
        the entry exists, so a failed allocation leaves the pool as it
        was), every later joiner streams through the same one.  Two plans
        on one spec never use the ring at once: the scheduler runs one
        quantum (one plan's sweep, fenced) at a time, and a one-shot
        query runs between quanta.
        """
        entry = self._stream_pool.get(handle.spec)
        held = 0
        if entry is None:
            buffers = StreamBuffers(handle.spec, self.queues,
                                    _value_dtype(handle), device=self.device)
            entry = self._stream_pool[handle.spec] = PoolEntry(
                spec=handle.spec, buffers=buffers)
            held = handle.spec.bytes_in_flight(self.queues)
        entry.refcount += 1
        handle.pin()
        return held

    def _abort_stream_join(self, handle: TensorHandle) -> None:
        """Undo a ``_join_stream_pool`` whose plan construction failed."""
        handle.unpin()
        self._release_stream(handle.spec)

    def _plan_streamed(self, handle: TensorHandle,
                       working: int = 0) -> PooledStreamedPlan:
        faults.maybe_fail("plan.alloc")
        held = self._join_stream_pool(handle)
        try:
            return PooledStreamedPlan(self, handle, held, working)
        except BaseException:
            self._abort_stream_join(handle)
            raise

    def _plan_disk(self, handle: TensorHandle,
                   working: int = 0) -> PooledDiskStreamedPlan:
        """Disk-streamed plan joining the same reservation pool as streamed.

        ``open_stored`` in the plan constructor touches the store file; a
        corrupt or missing file must not strand the pool refcount/pin it
        just took — the join is rolled back before the error propagates.
        """
        held = self._join_stream_pool(handle)
        try:
            return PooledDiskStreamedPlan(self, handle, held, working)
        except BaseException:
            self._abort_stream_join(handle)
            raise

    # ------------------------------------------------------------- releases
    def _release_stream(self, spec: ReservationSpec) -> int:
        entry = self._stream_pool[spec]
        entry.refcount -= 1
        if entry.refcount == 0:
            del self._stream_pool[spec]
            entry.buffers.close()
            return spec.bytes_in_flight(self.queues)
        return 0

    def _release_resident(self, key: str) -> int:
        entry = self._resident_pool[key]
        entry.refcount -= 1
        if entry.refcount == 0:
            del self._resident_pool[key]
            entry.device.delete()
            return entry.bytes
        return 0

    # ------------------------------------------------------------ introspect
    def pooled_bytes(self) -> int:
        """Device bytes currently held across both pools."""
        return sum(spec.bytes_in_flight(self.queues)
                   for spec in self._stream_pool) \
            + sum(e.bytes for e in self._resident_pool.values())

    @property
    def pool_size(self) -> int:
        """Number of pooled streaming reservation shapes."""
        return len(self._stream_pool)

    @property
    def resident_count(self) -> int:
        """Number of pooled device-resident tensor copies."""
        return len(self._resident_pool)


def _value_dtype(handle: TensorHandle):
    """The numpy dtype of a handle's values, resident or spilled."""
    if handle.blco is not None:
        return handle.blco.values.dtype
    with handle.open_stored() as stored:
        return stored.value_dtype


# Deprecated name from PR 1; the pooled executor grew into the service's
# MTTKRPEngine.  Kept so external callers keep importing.
PooledExecutor = ServiceEngine
