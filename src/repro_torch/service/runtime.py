"""Asynchronous service runtime: a threaded driver over the job scheduler
(the port of ``repro.service.runtime``).  The card's work runs on the
worker thread; a caller's ``snapshot()`` reads the factors under the
lock, at a quantum boundary, after the plans' fence of the last sweep.

``DecompositionService`` is synchronous — callers block in ``run()`` until
every tenant finishes.  ``ServiceRuntime`` turns it into a *live* service:
a worker thread executes one scheduling quantum (one weighted-fair-share
ALS sweep, see ``scheduler.step``) at a time while callers submit, cancel,
re-weight, and observe jobs concurrently.  Control actions synchronise on
the quantum boundary — the lock is held exactly for one sweep — so
**preemption is between ALS sweeps by construction**: a cancel or weight
change never interrupts a sweep mid-flight and never corrupts ``CPState``.

Status is *streamed*, not polled: every lifecycle edge (queued, admitted,
done, failed, cancelled, weight change) and every completed iteration
publishes a :class:`JobEvent` snapshot (state, fit trajectory, per-job
metrics) to all subscribed feeds.  A :class:`StatusFeed` is a thread-safe
blocking iterator; :meth:`ServiceRuntime.stream` wraps one as an **async
iterator** for asyncio front-ends (e.g. a web gateway pushing server-sent
events per tenant).

    with ServiceRuntime(device_budget_bytes=...) as rt:
        a = rt.submit(SubmitDecomposition(...), )        # weight via request
        async for ev in rt.stream(a):                    # live fit trajectory
            ...
        rt.cancel(b)                                     # frees pooled bytes
        rt.drain()                                       # wait until idle
"""
from __future__ import annotations

import asyncio
import dataclasses
import os
import queue
import threading
import time

from repro_torch.core.cp_als import cp_als_init

from . import scheduler as sched
from .api import (CancelJob, CancelResult, DecompositionResult,
                  DecompositionService, GetMetrics, GetTrace, JobStatus,
                  SetWeight, SubmitDecomposition, WeightUpdate)

_IDLE_POLL_S = 0.05         # worker re-check period while the queue is empty
_YIELD_S = 0.0005           # unlocked window between quanta (see _drive)


@dataclasses.dataclass(frozen=True)
class JobEvent:
    """One streamed status snapshot of one job.

    ``kind`` is the edge that produced it: ``queued`` / ``admitted`` /
    ``demoted`` (the plan took a degradation-ladder rung) / ``iteration``
    (one completed ALS sweep) / ``weight`` / ``rollback`` (the watchdog
    rewound a mid-sweep job after a worker crash) / ``done`` / ``failed``
    / ``cancelled``.  ``fits`` is the fit trajectory up to and
    including this event, so a late subscriber's first iteration event
    still carries the whole history (note this makes publishing a job's
    full event stream O(iterations^2) in copied floats — fine at ALS
    iteration counts; events are only built while feeds are subscribed).
    """
    seq: int
    kind: str
    job_id: int
    tenant: str
    state: str
    iteration: int
    fit: float | None
    fits: tuple
    weight: float
    backend: str
    metrics: dict
    timestamp_s: float

    @property
    def terminal(self) -> bool:
        return self.state in sched.TERMINAL_STATES


class StatusFeed:
    """Thread-safe stream of :class:`JobEvent`; iterable until closed.

    ``job_id=None`` subscribes to every job.  A job-scoped feed closes
    itself after delivering that job's terminal event; iterating a feed
    yields events until it closes.
    """

    _CLOSE = object()

    def __init__(self, job_id: int | None = None):
        self.job_id = job_id
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._closed = False

    def publish(self, event: JobEvent) -> None:
        if self._closed:
            return
        if self.job_id is not None and event.job_id != self.job_id:
            return
        self._q.put(event)
        if self.job_id is not None and event.terminal:
            self.close()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._q.put(self._CLOSE)

    def get(self, timeout: float | None = None) -> JobEvent | None:
        """Next event, or None when the feed is closed (or timed out)."""
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        return None if item is self._CLOSE else item

    def __iter__(self):
        while True:
            ev = self.get()
            if ev is None:
                return
            yield ev


class ServiceRuntime:
    """Threaded asynchronous driver around a :class:`DecompositionService`.

    One worker thread owns execution; all public methods are thread-safe
    and may be called from any thread (or, via the ``async`` helpers, any
    asyncio event loop).  Constructor kwargs other than ``service`` are
    forwarded to ``DecompositionService`` when no service is given.

    **Watchdog** (``watchdog=True``): a crash that escapes the worker
    (observer bugs, injected ``runtime.quantum:crash`` worker death) is
    *recovered* instead of hanging the service — the in-flight job's
    ``CPState`` is rolled back to the last completed sweep (the
    auto-snapshot checkpoint, else the deterministic fresh init) and a
    replacement worker thread is started, up to ``max_restarts`` times.
    Beyond the cap — a persistently failing worker — the legacy fail-stop
    path runs: the error is recorded, feeds close, and every
    ``drain()``/``wait()`` caller gets ``RuntimeError('service runtime
    worker failed')`` instead of a hang.  ``auto_snapshot_dir`` (with
    ``auto_snapshot_every`` quanta) enables periodic snapshots at quantum
    boundaries, bounding how many sweeps a rollback can lose.
    """

    def __init__(self, service: DecompositionService | None = None, *,
                 watchdog: bool = True, max_restarts: int = 3,
                 auto_snapshot_dir: str | None = None,
                 auto_snapshot_every: int = 8,
                 **service_kwargs):
        self.service = service if service is not None \
            else DecompositionService(**service_kwargs)
        self.scheduler = self.service.scheduler
        self._watchdog = watchdog
        self._max_restarts = max_restarts
        self._restarts = 0
        self._auto_snapshot_dir = auto_snapshot_dir
        self._auto_snapshot_every = max(1, auto_snapshot_every)
        self._quanta_since_snapshot = 0
        self._auto_snapshot_failures = 0
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)    # new work / stop
        self._idle = threading.Condition(self._lock)    # queue fully drained
        self._feeds: list[StatusFeed] = []
        self._seq = 0
        self._stop = False
        self._error: BaseException | None = None
        self._thread: threading.Thread | None = None
        self.scheduler.observers.append(self._on_event)
        # the sanitizer's lock-order assertion: every scheduler mutation on
        # a runtime-owned scheduler must hold the runtime lock
        self.scheduler.guard_lock = self._lock

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "ServiceRuntime":
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("runtime already started")
            thread = threading.Thread(target=self._drive,
                                      name="service-runtime", daemon=True)
            self._thread = thread
        thread.start()
        return self

    def stop(self) -> None:
        """Stop the worker after the in-flight sweep; close all feeds.

        Unfinished jobs stay in the scheduler (their plans remain held);
        call ``drain()`` first for a graceful shutdown.  The thread handle
        is swapped out under the lock (so concurrent ``stop`` calls each
        join a private reference, never a half-cleared attribute) but
        joined OUTSIDE it — the worker needs the lock to finish its sweep.
        """
        with self._lock:
            self._stop = True
            self._work.notify_all()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        with self._lock:
            for feed in self._feeds:
                feed.close()
            self._feeds.clear()

    def __enter__(self) -> "ServiceRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _drive(self) -> None:
        try:
            while True:
                with self._lock:
                    if self._stop:
                        return
                    if not (self.scheduler.active or self.scheduler.pending):
                        self._idle.notify_all()
                        self._work.wait(timeout=_IDLE_POLL_S)
                        continue
                    # ONE quantum under the lock: control actions (submit /
                    # cancel / set_weight) interleave only between ALS sweeps
                    self.scheduler.step()
                    self._maybe_auto_snapshot()
                # lock released: sleep a moment so blocked control threads
                # can actually acquire it (releasing and immediately
                # re-acquiring would convoy them out for many sweeps)
                time.sleep(_YIELD_S)
        except BaseException as exc:      # noqa: BLE001 — job isolation is
            # step()'s business; anything escaping it (admission failures,
            # observer bugs) kills this worker thread — the watchdog rolls
            # the in-flight job back and starts a replacement.  A disabled
            # or exhausted watchdog must not silently hang every
            # drain()/wait() caller — record the error and close the feeds
            if self._recover(exc):
                return
            with self._lock:
                self._error = exc
                self._idle.notify_all()
                for feed in self._feeds:
                    feed.close()
                self._feeds.clear()

    # ------------------------------------------------------------- watchdog
    def _recover(self, exc: BaseException) -> bool:
        """Restart the worker after a crash; False means stay dead.

        Runs on the dying worker thread.  The in-flight job (if any) is
        rolled back to its last completed sweep, then a replacement
        thread takes over the drive loop.  Refuses when the watchdog is
        off, the restart budget is spent, or ``stop()`` already swapped
        the thread handle out (a racing shutdown wins).
        """
        with self._lock:
            if not self._watchdog or self._stop \
                    or self._restarts >= self._max_restarts:
                return False
            if self._thread is not threading.current_thread():
                return False              # stop() owns the handle now
            self._restarts += 1
            self.service.metrics.watchdog_restarts += 1
            self._rollback_inflight()
            thread = threading.Thread(target=self._drive,
                                      name="service-runtime", daemon=True)
            self._thread = thread
        thread.start()
        return True

    def _rollback_inflight(self) -> None:
        """Rewind the job whose quantum the crash interrupted (lock held).

        ``scheduler.stepping``/``in_sweep`` say whether a ``cp_als_step``
        was mid-flight — its in-place factor mutations may be partial, so
        the ``CPState`` is replaced by the last auto-snapshot checkpoint
        when one exists, else by the deterministic fresh init.  Either
        way the replay is bit-identical to an uninterrupted run at every
        completed sweep; only wasted sweeps differ.  A crash *between*
        sweeps (``in_sweep`` False) needs no rollback — the state is a
        complete iteration already.
        """
        jid, mid_sweep = self.scheduler.stepping, self.scheduler.in_sweep
        self.scheduler.stepping = None
        self.scheduler.in_sweep = False
        if jid is None:
            return
        job = self.scheduler.jobs.get(jid)
        if job is None or job.state != sched.RUNNING or job.cp is None:
            return
        if mid_sweep:
            job.cp = self._checkpointed_cp(job) or cp_als_init(
                job.handle.dims, job.rank, norm_x=job.handle.norm_x,
                tol=job.tol, seed=job.seed,
                device=self.service.engine.device)
            job.metrics.iterations = job.cp.iteration
            self.scheduler._publish(job, "rollback")

    def _checkpointed_cp(self, job: sched.Job):
        """The job's CPState from the latest auto-snapshot, or None."""
        if self._auto_snapshot_dir is None:
            return None
        path = os.path.join(self._auto_snapshot_dir,
                            f"job_{job.job_id}.npz")
        if not os.path.exists(path):
            return None
        from ..store.snapshot import _load_cp
        try:
            return _load_cp(path, job.handle.dims, job.rank,
                            device=self.service.engine.device)
        except Exception:     # noqa: BLE001 — a damaged checkpoint (crash
            return None       # mid-write) degrades to the fresh-init path

    def _maybe_auto_snapshot(self) -> None:
        """Periodic snapshot at the quantum boundary.

        Failures are counted, not raised — a full disk must not kill the
        worker the watchdog exists to protect.  The caller (``_drive``)
        already holds the lock; the re-entrant re-acquire makes that
        lexical.
        """
        if self._auto_snapshot_dir is None:
            return
        with self._lock:
            self._quanta_since_snapshot += 1
            if self._quanta_since_snapshot < self._auto_snapshot_every:
                return
            self._quanta_since_snapshot = 0
            try:
                self.service.snapshot(self._auto_snapshot_dir)
            except Exception:   # noqa: BLE001 — snapshot is best-effort here
                self._auto_snapshot_failures += 1

    def _check_worker(self) -> None:
        # callers reach here from outside the lock too (wait/stream error
        # paths); the re-entrant lock makes the guarded read safe both ways
        with self._lock:
            if self._error is not None:
                raise RuntimeError("service runtime worker failed") \
                    from self._error

    # ------------------------------------------------------------- control
    def submit(self, req: SubmitDecomposition) -> int:
        with self._lock:
            self._check_worker()
            job_id = self.service.submit(req)
            self._work.notify_all()
            return job_id

    def cancel(self, req: CancelJob | int) -> CancelResult:
        job_id = req.job_id if isinstance(req, CancelJob) else int(req)
        with self._lock:
            result = self.service.cancel(job_id)
            self._work.notify_all()
            return result

    def set_weight(self, req: SetWeight) -> WeightUpdate:
        with self._lock:
            update = self.service.set_weight(req)
            self._work.notify_all()
            return update

    # --------------------------------------------------------- persistence
    def snapshot(self, path: str) -> dict:
        """Snapshot the service at a quantum boundary (lock held, so no
        sweep is mid-flight: every checkpointed ``CPState`` is a complete
        ALS iteration a restarted service can resume from)."""
        with self._lock:
            return self.service.snapshot(path)

    @classmethod
    def restore(cls, path: str, **service_kwargs) -> "ServiceRuntime":
        """A (not yet started) runtime over a service restored from
        ``path`` — every snapshotted job re-enters admission under its
        original id with its checkpointed state."""
        return cls(DecompositionService.restore(path, **service_kwargs))

    # -------------------------------------------------------------- status
    def status(self, job_id: int) -> JobStatus:
        with self._lock:
            return self.service.status(job_id)

    def result(self, job_id: int) -> DecompositionResult:
        with self._lock:
            return self.service.result(job_id)

    def service_metrics(self) -> dict:
        with self._lock:
            return self.service.service_metrics()

    def get_metrics(self, req: GetMetrics | None = None):
        """Service metrics (JSON dict or Prometheus text; see GetMetrics)."""
        with self._lock:
            return self.service.get_metrics(req)

    def get_roofline(self, req=None) -> dict:
        """Roofline attribution from the bandwidth ledger (see GetRoofline).

        Taken outside the runtime lock: the ledger synchronizes its own
        accounts, and a mid-sweep report never blocks an in-flight
        quantum (same reasoning as ``trace``).
        """
        return self.service.get_roofline(req)  # repro-lint: disable=lock-discipline

    def get_slo(self, req=None) -> dict:
        """Per-tenant SLO evaluation + burn rates (see GetSLO)."""
        with self._lock:
            return self.service.get_slo(req)

    def trace(self, req: GetTrace | None = None) -> dict:
        """Recorded spans as Chrome trace-event JSON (see GetTrace).

        Taken outside the runtime lock: the tracer's ring buffer has its
        own lock, and the worker thread's spans are complete objects by
        the time they are recorded, so a mid-sweep export never blocks on
        (or is blocked by) an in-flight quantum.
        """
        return self.service.trace(req)  # repro-lint: disable=lock-discipline

    def subscribe(self, job_id: int | None = None) -> StatusFeed:
        """A feed of subsequent events (all jobs, or one job).

        Subscribing to a job already in a terminal state returns a closed
        feed, so iterating it terminates instead of hanging.
        """
        feed = StatusFeed(job_id)
        with self._lock:
            if job_id is not None:
                self.service.status(job_id)   # typed error on unknown ids
                if self.scheduler.jobs[job_id].state in \
                        sched.TERMINAL_STATES:
                    feed.close()
                    return feed
            self._feeds.append(feed)
        return feed

    def unsubscribe(self, feed: StatusFeed) -> None:
        with self._lock:
            if feed in self._feeds:
                self._feeds.remove(feed)
        feed.close()

    def _on_event(self, job: sched.Job, kind: str) -> None:
        # called by the scheduler with the runtime lock already held
        # (worker thread during sweeps, caller threads during control
        # actions); the re-entrant acquire makes the guarantee lexical
        # instead of by-convention — a future caller that forgets the lock
        # synchronizes here instead of racing on _seq/_feeds
        with self._lock:
            if not self._feeds:
                return  # snapshotting fits/metrics for nobody is O(iters^2)
            self._seq += 1
            event = JobEvent(
                seq=self._seq, kind=kind, job_id=job.job_id,
                tenant=job.tenant, state=job.state,
                iteration=job.cp.iteration if job.cp is not None else 0,
                fit=job.fit,
                fits=tuple(job.cp.fits) if job.cp is not None else (),
                weight=job.weight, backend=job.metrics.backend,
                metrics=job.metrics.snapshot(),
                timestamp_s=time.perf_counter())
            closed = []
            for feed in self._feeds:
                feed.publish(event)
                if feed._closed:
                    closed.append(feed)
            for feed in closed:
                self._feeds.remove(feed)

    # -------------------------------------------------------------- waiting
    def wait(self, job_id: int, timeout: float | None = None) -> JobStatus:
        """Block until the job reaches a terminal state; returns its status."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            job = self.scheduler.jobs.get(job_id)
            if job is None:
                return self.service.status(job_id)    # raises the typed error
            if job.state in sched.TERMINAL_STATES:
                return self.service.status(job_id)
            feed = self.subscribe(job_id)             # atomic with the check
        try:
            while True:
                remaining = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                ev = feed.get(timeout=remaining)
                if ev is None:
                    status = self.status(job_id)
                    if status.state in sched.TERMINAL_STATES:
                        return status
                    self._check_worker()
                    if feed._closed:
                        raise RuntimeError(f"runtime stopped while job "
                                           f"{job_id} was {status.state}")
                    raise TimeoutError(
                        f"job {job_id} still {status.state} after {timeout}s")
        finally:
            self.unsubscribe(feed)

    def drain(self, timeout: float | None = None) -> bool:
        """Block until no job is active or queued; False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self.scheduler.active or self.scheduler.pending:
                self._check_worker()
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._idle.wait(timeout=remaining)
            return True

    # --------------------------------------------------------------- asyncio
    async def stream(self, job_id: int | None = None):
        """Async iterator of :class:`JobEvent` (one job, or every job).

        Bridges the thread-side feed into the calling event loop; yields
        until the job completes (job-scoped) or the runtime stops.
        """
        feed = self.subscribe(job_id)
        loop = asyncio.get_running_loop()
        try:
            while True:
                ev = await loop.run_in_executor(None, feed.get)
                if ev is None:
                    # a worker crash closes feeds without a terminal event;
                    # it must not look like a clean end-of-stream
                    self._check_worker()
                    return
                yield ev
        finally:
            self.unsubscribe(feed)

    async def wait_async(self, job_id: int,
                         timeout: float | None = None) -> JobStatus:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, lambda: self.wait(job_id, timeout=timeout))

    async def result_async(self, job_id: int,
                           timeout: float | None = None) -> DecompositionResult:
        """Await a job's completion and return its decomposition result."""
        await self.wait_async(job_id, timeout=timeout)
        return self.result(job_id)
