"""Tensor registry: a two-tier BLCO cache keyed by content fingerprint.

The port of ``repro.service.registry``; ``fingerprint`` gives the JAX
package's key for the same tensor and build, and the store files are
byte-identical, so a store directory written by either package is
adopted by the other.

BLCO's defining property (paper §4.2) is that ONE tensor copy serves every
mode and every decomposition run. In a multi-tenant service that property
compounds: any number of jobs on the same tensor share one BLCO build, one
reservation shape, and (via the pooled executor) one ring of buffers per
shape. The cache key is a content fingerprint (dims + coordinates +
values) combined with the build parameters, so a re-submitted tensor —
even a different ``SparseTensor`` object with identical content — is a
hit, while changing ``target_bits`` or the blocking budget correctly
misses.

The registry is **two-tier** (host ⊃ disk).  With a ``store_dir``, handles
can be *spilled*: the BLCO is written to the persistent store
(``repro_torch.store``) and the host arrays dropped, leaving a stub handle that
jobs disk-stream from (or explicitly ``load`` back).  With a
``host_budget_bytes``, spilling is automatic: an LRU policy (least
recently ``get``/registered first, pin-refcount-aware) keeps resident
host bytes under the budget.  Because store files are named by
fingerprint, a RESTARTED process re-registers the same tensor as a cache
hit straight off disk — no BLCO rebuild — which is what makes service
snapshots restart-safe.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import weakref

import numpy as np

from repro_torch.core.blco import BLCOTensor, build_blco, format_bytes
from repro_torch.core.streaming import (LaunchChunks, ReservationSpec,
                                  reservation_for)
from repro_torch.core.tensor import SparseTensor
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class BuildParams:
    """BLCO construction parameters (see ``core.build_blco``)."""
    target_bits: int = 64
    max_nnz_per_block: int = 1 << 27
    launch_nnz_budget: int | None = None


def fingerprint(t: SparseTensor, build: BuildParams,
                reservation_nnz: int | None = None) -> str:
    """Content hash of (dims, coordinates, values) + build params."""
    h = hashlib.sha256()
    h.update(np.asarray(t.dims, np.int64).tobytes())
    h.update(np.ascontiguousarray(t.indices).tobytes())
    h.update(np.ascontiguousarray(t.values).tobytes())
    h.update(str(t.values.dtype).encode())
    h.update(repr((build.target_bits, build.max_nnz_per_block,
                   build.launch_nnz_budget, reservation_nnz)).encode())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class TensorHandle:
    """A registered tensor: the single shared copy every job streams from.

    Either host-resident (``blco``/``chunks`` set) or spilled to the store
    (``store_path`` set, ``blco is None``) — a stub that keeps only the
    O(1) metadata admission control needs.  ``chunks`` is a lazily padding
    :class:`~repro_torch.core.streaming.LaunchChunks`; nothing is padded until a
    streaming plan actually pulls a launch.
    """
    key: str
    dims: tuple
    nnz: int
    norm_x: float                # Frobenius norm (CP-ALS fit denominator)
    blco: BLCOTensor | None
    spec: ReservationSpec        # padded launch-buffer shape
    chunks: LaunchChunks | None  # lazy reservation-padded launch source
    pins: int = 0                # live plans referencing blco/chunks/store
    store_path: str | None = None   # persistent copy (spill tier)
    last_used: int = 0           # registry LRU clock at last touch
    build: BuildParams | None = None    # rebuild recipe (self-heal)
    source_ref: weakref.ref | None = None  # weakref to the source COO
    quarantined: bool = False    # store copy corrupt + unrebuildable
    quarantine_reason: str | None = None

    def pin(self) -> None:
        """A plan now references this handle (blocks evict/spill)."""
        self.pins += 1

    def unpin(self) -> None:
        if self.pins <= 0:
            raise RuntimeError(f"unbalanced unpin of tensor {self.key}")
        self.pins -= 1

    @property
    def order(self) -> int:
        return len(self.dims)

    @property
    def resident(self) -> bool:
        """True when the BLCO is host-resident (not just a disk stub)."""
        return self.blco is not None

    @property
    def host_bytes(self) -> int:
        """Host-resident bytes of this handle's tensor copy (0 if spilled)."""
        return format_bytes(self.blco) if self.blco is not None else 0

    @property
    def format_bytes(self) -> int:
        """True device footprint of the format (hi + lo + vals + bases).

        Computed from the metadata (nnz x per-element words) so it is
        available for spilled stubs too; equals
        ``core.format_bytes(self.blco)`` when resident.
        """
        return self.nnz * (4 + 4 + self.spec.value_itemsize + 4 * self.order)

    @property
    def in_memory_bytes(self) -> int:
        """Predicted device bytes of a resident (InMemoryPlan) copy."""
        if self.blco is None:
            raise RuntimeError(
                f"tensor {self.key} is spilled to disk; load() it before "
                f"planning a device-resident copy")
        from ..engine.api import in_memory_bytes
        return in_memory_bytes(self.blco)

    def open_stored(self):
        """Open the persistent copy for disk-streaming (caller closes)."""
        if self.store_path is None:
            raise RuntimeError(f"tensor {self.key} has no persistent copy")
        from ..store import open_blco
        return open_blco(self.store_path)


class TensorRegistry:
    """Fingerprint-keyed two-tier cache of BLCO builds.

    ``store_dir``: directory of the persistent spill tier (files are
    ``<fingerprint>.blco``); enables ``spill``/``persist``/``adopt`` and
    restart-safe re-registration.  ``host_budget_bytes``: automatic LRU
    spilling — after every operation that grows the resident set, the
    least-recently-used unpinned handles are spilled until resident
    ``host_bytes()`` fits the budget.

    Thread-safe: the service runtime's worker thread and caller threads
    (submit paths, snapshot queries) reach the registry concurrently, so
    every method serializes on one internal re-entrant lock — re-entrant
    because the operations compose (``register`` → ``adopt`` /
    ``_maybe_spill`` → ``spill`` → ``persist``).  Lock ordering with the
    runtime is strictly runtime → registry; the registry never calls out.
    """

    def __init__(self, *, store_dir: str | None = None,
                 host_budget_bytes: int | None = None):
        self.store_dir = store_dir
        self.host_budget_bytes = host_budget_bytes
        self._lock = threading.RLock()
        self._cache: dict[str, TensorHandle] = {}
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0           # registrations served from the store
        self.spills = 0
        self.spill_bytes = 0         # host bytes freed by spilling
        self.loads = 0               # un-spills (store -> host reloads)
        self.rebuilds = 0            # corrupt store files healed from COO

    # ---------------------------------------------------------------- paths
    def _store_file(self, key: str) -> str:
        if self.store_dir is None:
            raise RuntimeError("registry has no store_dir; construct "
                               "TensorRegistry(store_dir=...) to enable "
                               "the spill tier")
        os.makedirs(self.store_dir, exist_ok=True)
        return os.path.join(self.store_dir, f"{key}.blco")

    def _touch(self, handle: TensorHandle) -> None:
        with self._lock:
            self._clock += 1
            handle.last_used = self._clock

    # ------------------------------------------------------------- register
    def register(self, t: SparseTensor, *,
                 build: BuildParams | None = None,
                 reservation_nnz: int | None = None) -> TensorHandle:
        build = build or BuildParams()
        key = fingerprint(t, build, reservation_nnz)
        with self._lock:
            handle = self._cache.get(key)
            if handle is not None:
                self.hits += 1
                self._touch(handle)
                return handle
            # restart path: the fingerprint names a store file written by a
            # previous process — adopt the stub instead of rebuilding the
            # BLCO.  A damaged file (crash mid-write on an old layout, bit
            # rot) must not brick registration while we hold the COO: fall
            # through to a rebuild, which re-persists over it on the next
            # spill.
            if self.store_dir is not None:
                path = os.path.join(self.store_dir, f"{key}.blco")
                if os.path.exists(path):
                    from ..store import StoreError
                    try:
                        handle = self.adopt(key, path)
                    except StoreError:
                        pass
                    else:
                        self.hits += 1
                        self.disk_hits += 1
                        handle.build = build
                        handle.source_ref = weakref.ref(t)
                        return handle
            self.misses += 1
            blco = build_blco(t, target_bits=build.target_bits,
                              max_nnz_per_block=build.max_nnz_per_block,
                              launch_nnz_budget=build.launch_nnz_budget)
            spec = reservation_for(blco, reservation_nnz)
            handle = TensorHandle(
                key=key, dims=t.dims, nnz=t.nnz,
                norm_x=float(np.linalg.norm(t.values.astype(np.float64))),
                blco=blco, spec=spec, chunks=LaunchChunks(blco, spec.nnz),
                build=build, source_ref=weakref.ref(t))
            self._cache[key] = handle
            self._touch(handle)
            self._maybe_spill()
            return handle

    def adopt(self, key: str, path: str) -> TensorHandle:
        """Register a spilled stub straight from a store file (no COO, no
        build) — the restart/snapshot entry point.

        The file's section checksums are verified here, once, at adoption
        (plans opening it later skip the re-read): silently streaming
        bit-rotted values into every job on this tensor would be far
        worse than the one sequential read.  Corruption raises the typed
        ``StoreCorruptionError`` — which ``register`` turns into a
        rebuild when it still holds the COO.
        """
        with self._lock:
            handle = self._cache.get(key)
            if handle is not None:
                self._touch(handle)
                return handle
            from ..store import open_blco
            with open_blco(path, verify=True) as stored:
                if stored.fingerprint is not None \
                        and stored.fingerprint != key:
                    from ..store import StoreCorruptionError
                    raise StoreCorruptionError(
                        f"{path}: stored fingerprint {stored.fingerprint!r} "
                        f"does not match registry key {key!r}")
                handle = TensorHandle(
                    key=key, dims=stored.dims, nnz=stored.nnz,
                    norm_x=float(stored.norm_x or 0.0),
                    blco=None, spec=stored.spec, chunks=None,
                    store_path=path)
            self._cache[key] = handle
            self._touch(handle)
            return handle

    # ------------------------------------------------------------ spill tier
    def persist(self, key: str) -> str:
        """Ensure ``key`` has an up-to-date store file; returns its path.

        Keeps the host copy (unlike ``spill``) — this is the snapshot
        write path, safe to call on pinned handles.
        """
        with self._lock:
            handle = self._require(key)
            if handle.store_path is not None:
                return handle.store_path
            path = self._store_file(key)
            from ..store import save_blco
            save_blco(handle.blco, path, reservation_nnz=handle.spec.nnz,
                      fingerprint=key, norm_x=handle.norm_x)
            handle.store_path = path
            return path

    def spill(self, key: str) -> int:
        """Write ``key``'s BLCO to the store and drop its host arrays.

        Returns the host bytes freed.  Refuses pinned handles (live plans
        hold the blco/chunks); a no-op (0) for already-spilled handles.
        """
        with self._lock:
            handle = self._require(key)
            if not handle.resident:
                return 0
            if handle.pins > 0:
                raise RuntimeError(
                    f"tensor {key} is pinned by {handle.pins} live plan(s); "
                    f"close them before spilling")
            with obs_trace.span("registry.spill", "registry", key=key,
                                nnz=handle.nnz) as sp:
                self.persist(key)
                freed = handle.host_bytes
                handle.blco = None
                handle.chunks = None
                self.spills += 1
                self.spill_bytes += freed
                sp.set(bytes=freed)
            return freed

    def maybe_load(self, key: str) -> TensorHandle:
        """Reload a spilled handle only when the host tier has room.

        The submit-path policy: a stub whose reload would fit the host
        budget comes back resident (so jobs regain the in-memory /
        host-streamed fast paths after a restart or an eviction), while
        a registry under genuine host pressure keeps the stub and lets
        jobs disk-stream — reloading there would just thrash the LRU.
        """
        with self._lock:
            handle = self._require(key)
            if handle.resident:
                return handle
            if self.host_budget_bytes is not None and \
                    self.host_bytes() + handle.format_bytes \
                    > self.host_budget_bytes:
                return handle
            return self.load(key)

    def load(self, key: str) -> TensorHandle:
        """Reload a spilled handle's BLCO from the store (un-spill).

        The reload reuses the stored build verbatim — same fingerprint,
        same blocks/launches/reservation, no re-construction — so a
        load-after-spill (or after a process restart) is bit-identical to
        the original registration.

        Self-heal: the reload verifies section checksums.  On corruption,
        when the source COO is still alive (``source_ref``), the BLCO is
        rebuilt from it with the recorded build params and re-persisted
        over the damaged file — bit-identical to the original build
        because ``build_blco`` is deterministic.  Without a live source
        the handle is *quarantined* (new jobs are refused with the
        reason) and the corruption error propagates.
        """
        with self._lock:
            handle = self._require(key)
            self._touch(handle)
            if handle.resident:
                return handle
            from ..store import StoreCorruptionError, open_blco
            with obs_trace.span("registry.load", "registry", key=key,
                                nnz=handle.nnz):
                try:
                    with open_blco(handle.store_path, verify=True) as stored:
                        handle.blco = stored.to_blco()
                except StoreCorruptionError as exc:
                    self._self_heal(handle, exc)
                handle.chunks = LaunchChunks(handle.blco, handle.spec.nnz)
            self.loads += 1
            self._touch(handle)           # the reload makes it MRU
            self._maybe_spill(keep=handle)
            return handle

    def _self_heal(self, handle: TensorHandle,
                   exc: BaseException) -> None:
        """Corrupt store file: rebuild from the live COO or quarantine."""
        source = handle.source_ref() if handle.source_ref is not None \
            else None
        if source is None or handle.build is None:
            handle.quarantined = True
            handle.quarantine_reason = (
                f"store file {handle.store_path} failed verification and "
                f"no source tensor survives to rebuild from: {exc}")
            raise exc
        with obs_trace.span("registry.rebuild", "registry", key=handle.key,
                            nnz=handle.nnz, error=repr(exc)):
            build = handle.build
            blco = build_blco(source, target_bits=build.target_bits,
                              max_nnz_per_block=build.max_nnz_per_block,
                              launch_nnz_budget=build.launch_nnz_budget)
            from ..store import save_blco
            save_blco(blco, handle.store_path,
                      reservation_nnz=handle.spec.nnz,
                      fingerprint=handle.key, norm_x=handle.norm_x)
            handle.blco = blco
            handle.quarantined = False
            handle.quarantine_reason = None
            self.rebuilds += 1

    def _maybe_spill(self, keep: TensorHandle | None = None) -> None:
        """LRU: spill least-recently-used unpinned handles over the budget.

        ``keep`` exempts a handle the caller just made resident on
        purpose (``load``): spilling it straight back would turn an
        explicit reload into wasted I/O — like the pinned case, the
        registry stays over budget instead.
        """
        if self.host_budget_bytes is None or self.store_dir is None:
            return
        with self._lock:
            while self.host_bytes() > self.host_budget_bytes:
                victims = sorted(
                    (h for h in self._cache.values()
                     if h.resident and h.pins == 0 and h is not keep),
                    key=lambda h: h.last_used)
                if not victims:
                    return       # everything resident is pinned; over-budget
                self.spill(victims[0].key)

    # ---------------------------------------------------------------- lookup
    def get(self, key: str) -> TensorHandle | None:
        with self._lock:
            handle = self._cache.get(key)
            if handle is not None:
                self._touch(handle)
            return handle

    def evict(self, key: str) -> bool:
        """Drop a cached handle entirely; refuses while any plan holds it.

        Streaming plans hold the handle's ``chunks`` (or store file) for
        their whole lifetime, so evicting a pinned handle would corrupt
        running jobs — the refcount turns that silent corruption into an
        error.  The store file, if any, is left on disk (it is the
        durable tier; delete it through the filesystem if truly unwanted).
        """
        with self._lock:
            handle = self._cache.get(key)
            if handle is None:
                return False
            if handle.pins > 0:
                raise RuntimeError(
                    f"tensor {key} is pinned by {handle.pins} live plan(s); "
                    f"close them before evicting")
            del self._cache[key]
            return True

    def _require(self, key: str) -> TensorHandle:
        with self._lock:
            handle = self._cache.get(key)
            if handle is None:
                raise KeyError(f"unknown tensor key {key!r}")
            return handle

    def __len__(self) -> int:
        with self._lock:
            return len(self._cache)

    def host_bytes(self) -> int:
        """Host-resident tensor bytes across all cached handles.

        Counts the BLCO's per-element footprint (hi + lo + vals + bases
        words) for resident handles; spilled stubs count 0 — their bytes
        live on disk.  Padded launch chunks are no longer materialized up
        front (``LaunchChunks`` pads lazily), so they do not appear here.
        """
        with self._lock:
            return sum(h.host_bytes for h in self._cache.values())

    def store_bytes(self) -> int:
        """Bytes of this registry's handles resident in the disk tier."""
        with self._lock:
            total = 0
            for h in self._cache.values():
                if h.store_path is not None and os.path.exists(h.store_path):
                    total += os.path.getsize(h.store_path)
            return total
