"""Job scheduler: admission by measured plan bytes + weighted fair share.

The port of ``repro.service.scheduler``; every job's ``CPState`` is made
on the service engine's device.

Admission control is the service restatement of the paper's §4.2 memory
constraint, now in terms of the unified engine API: each admitted job holds
an ``ExecutionPlan`` and is charged exactly ``plan.device_bytes()`` — the
bytes the plan *measurably* holds resident: its per-job factor working set
plus the pooled tensor state (a shared pool entry is charged once, by
whichever tenant created it) — instead of a padded worst-case reservation
sum.  The engine picks the regime per job under the remaining budget: small
tensors get the device-resident fast path, larger ones stream through
pooled reservations, and jobs that fit neither wait in a FIFO queue.
Completions (and cancellations) close their plans — releasing pool
references and the working set — and re-run admission.

Fair share is **stride scheduling** at CP-ALS *iteration* granularity
(Waldspurger's deterministic lottery): every job carries a per-tenant
``weight``; each scheduling quantum runs ONE full ALS sweep
(``cp_als_step``) of the active job with the lowest virtual time
(``pass_value``), then advances that job's pass by ``STRIDE1 / weight``.
Over any window, iterations divide in proportion to the weights — the
load-balance behaviour heterogeneous MTTKRP workloads need (Nisa et al.),
generalising the old equal round-robin (all weights 1 reproduce it
exactly, including the admission-order tie-break).  Because the quantum is
a whole sweep, preemption is natural: ``set_weight`` takes effect at the
next quantum and a demoted tenant keeps its ``CPState`` intact.

``cancel`` retires a queued or running job immediately: the plan is
closed, its pooled bytes and working set are released, and admission
re-runs so a waiting job can take the freed budget.

Observers (``observers``: callables ``(job, kind)``) are notified on every
lifecycle edge and every completed iteration — the hook the async runtime
uses to stream per-iteration status without polling.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

from repro_torch.analysis import sanitize as _san
from repro_torch.core.cp_als import CPState, cp_als_init, cp_als_step
from repro_torch.faults import inject as faults
from repro_torch.faults.retry import is_transient
from repro_torch.obs import ledger as obs_ledger
from repro_torch.obs import trace as obs_trace

from .executor import ServiceEngine
from .metrics import JobMetrics, ServiceMetrics
from .registry import TensorHandle

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"

TERMINAL_STATES = (DONE, FAILED, CANCELLED)

# Stride-scheduling precision constant (pass advances in STRIDE1/weight
# steps); large so integer-ish weights stay exact in float arithmetic.
STRIDE1 = float(1 << 20)


class FactorPoisonError(RuntimeError):
    """The always-on quantum-boundary guard: a sweep produced a non-finite
    fit, meaning the job's factor matrices are poisoned (NaN/Inf).  The
    job quarantines FAILED; other tenants are unaffected."""


def _poison_factors(job: "Job") -> None:
    """The ``factors.nan`` injection: corrupt a factor matrix the way a
    buggy kernel or bad input data would.

    Poisons a factor the coming sweep *reads* before overwriting (factor 1
    when the tensor has one: mode 0's MTTKRP consumes factors 1..N-1), so
    the NaN propagates through the sweep into the fit that the always-on
    quantum-boundary guard checks.
    """
    i = 1 if len(job.cp.factors) > 1 else 0
    # a copy, as the reference's functional update makes one: no other
    # reference to the factor (a snapshot, a result) may see the NaN
    f = job.cp.factors[i].clone()
    f[0, 0] = float("nan")
    job.cp.factors[i] = f
    job.cp.grams[i] = f.T @ f


def _error_payload(exc: BaseException, *, where: str) -> dict:
    """The explanatory payload a quarantined (FAILED) job carries."""
    return {
        "type": type(exc).__name__,
        "message": str(exc),
        "where": where,
        "transient": is_transient(exc),
        "injected": str(exc).startswith("[fault-injection]"),
    }


@dataclasses.dataclass
class Job:
    job_id: int
    handle: TensorHandle
    rank: int
    iters: int
    tol: float
    seed: int
    tenant: str = "default"
    weight: float = 1.0
    pass_value: float = 0.0               # stride-scheduling virtual time
    state: str = QUEUED
    cp: CPState | None = None
    metrics: JobMetrics = dataclasses.field(default_factory=JobMetrics)
    error: str | None = None
    error_payload: dict | None = None     # quarantine explanation (FAILED)
    plan: object | None = None            # ExecutionPlan once admitted
    mttkrp_fn: Callable | None = None     # test/override hook; default = plan

    @property
    def stride(self) -> float:
        """Virtual-time advance per executed sweep (inverse weight)."""
        return STRIDE1 / self.weight

    @property
    def fit(self) -> float | None:
        if self.cp is None or not self.cp.fits:
            return None
        return self.cp.fits[-1]


class JobScheduler:
    """FIFO admission by measured plan bytes; weighted stride stepping."""

    def __init__(self, engine: ServiceEngine, *,
                 device_budget_bytes: int,
                 max_active: int | None = None,
                 metrics: ServiceMetrics | None = None):
        self.engine = engine
        self.device_budget_bytes = int(device_budget_bytes)
        self.max_active = max_active
        self.metrics = metrics if metrics is not None else ServiceMetrics()
        self._next_id = 0
        self._global_pass = 0.0           # virtual time of the last quantum
        self.jobs: dict[int, Job] = {}
        self.pending: list[int] = []          # FIFO admission queue
        self.active: list[int] = []           # admission order
        self.trace: list[int] = []            # job id per executed iteration
        self.observers: list[Callable[[Job, str], None]] = []
        # watchdog bookkeeping: the job whose quantum is in flight, and
        # whether its CPState may be mid-sweep (partially mutated) — read
        # by the runtime's crash-recovery path to decide on a rollback
        self.stepping: int | None = None
        self.in_sweep: bool = False

    # -------------------------------------------------------------- events
    def _publish(self, job: Job, kind: str) -> None:
        for fn in list(self.observers):
            fn(job, kind)

    def _sync_gauges(self) -> None:
        """Refresh the live scheduler gauges after a lifecycle edge."""
        self.metrics.queue_depth = len(self.pending)
        self.metrics.running_jobs = len(self.active)

    # ------------------------------------------------------------ lifecycle
    def submit(self, handle: TensorHandle, *, rank: int, iters: int = 25,
               tol: float = 1e-5, seed: int = 0, weight: float = 1.0,
               tenant: str = "default", cp_state: CPState | None = None,
               job_id: int | None = None) -> int:
        """Enqueue a CP-ALS job; returns its id.

        ``cp_state``/``job_id`` are the snapshot-restore hooks: a restored
        job keeps its original id and resumes from its checkpointed sweep
        instead of a fresh ``cp_als_init``.
        """
        _san.assert_scheduler_guard(self, "scheduler.submit")
        if not weight > 0:
            raise ValueError(f"tenant weight must be > 0, got {weight!r}")
        need = self.engine.min_cost(handle, rank)
        if need > self.device_budget_bytes:
            raise ValueError(
                f"job needs at least {need} B of device memory in its "
                f"cheapest regime, which exceeds the device budget "
                f"({self.device_budget_bytes} B): it can never be admitted")
        if job_id is None:
            job_id = self._next_id
        elif job_id in self.jobs:
            raise ValueError(f"job id {job_id} already exists")
        self._next_id = max(self._next_id, job_id + 1)
        job = Job(job_id=job_id, handle=handle, rank=rank,
                  iters=iters, tol=tol, seed=seed, weight=float(weight),
                  tenant=tenant, cp=cp_state)
        self.jobs[job.job_id] = job
        self.pending.append(job.job_id)
        self.metrics.jobs_submitted += 1
        self._sync_gauges()
        self._publish(job, QUEUED)
        self._admit()
        return job.job_id

    def adopt_finished(self, handle: TensorHandle, *, rank: int, iters: int,
                       tol: float, seed: int, tenant: str, weight: float,
                       cp_state: CPState | None, job_id: int,
                       state: str = DONE, error: str | None = None,
                       error_payload: dict | None = None) -> int:
        """Install a terminal job record under its original id.

        The snapshot-restore hook for DONE/FAILED jobs: no admission, no
        plan, no events — the record only serves ``status()``/``result()``
        for job ids that finished before the restart.
        """
        _san.assert_scheduler_guard(self, "scheduler.adopt_finished")
        if state not in TERMINAL_STATES:
            raise ValueError(f"adopt_finished takes a terminal state, "
                             f"got {state!r}")
        if job_id in self.jobs:
            raise ValueError(f"job id {job_id} already exists")
        job = Job(job_id=job_id, handle=handle, rank=rank, iters=iters,
                  tol=tol, seed=seed, tenant=tenant, weight=float(weight),
                  cp=cp_state, state=state, error=error)
        job.error_payload = error_payload
        job.metrics.completed_s = time.perf_counter()
        self._next_id = max(self._next_id, job_id + 1)
        self.jobs[job_id] = job
        return job_id

    def _admit(self) -> None:
        """Admit queued jobs FIFO while the measured byte budget allows.

        Fault paths quarantine instead of crash: a planning exception
        (corrupt store, unrecoverable alloc failure) fails THAT job and
        moves on, and any exception between the ledger charge and a fully
        registered running job releases the charged bytes first — the
        ledger audit holds on every exit.
        """
        try:
            while self.pending:
                if self.max_active is not None and \
                        len(self.active) >= self.max_active:
                    return
                job = self.jobs[self.pending[0]]
                if job.handle.quarantined:
                    self.pending.pop(0)
                    self._fail_queued(job, RuntimeError(
                        f"tensor {job.handle.key} is quarantined: "
                        f"{job.handle.quarantine_reason}"))
                    continue
                remaining = self.device_budget_bytes \
                    - self.metrics.admitted_reservation_bytes
                try:
                    # admission-time H2D uploads (resident-pool entry
                    # creation) attribute to this tenant/job in the ledger
                    with obs_ledger.job_scope(job.tenant, job.job_id):
                        plan = self.engine.try_plan(
                            job.handle, rank=job.rank,
                            budget_remaining=remaining)
                except Exception as exc:   # noqa: BLE001 — job isolation:
                    # planning failures are this job's problem, not the
                    # worker's; nothing was charged yet (try_plan's pool
                    # joins are exception-safe)
                    self.pending.pop(0)
                    self._fail_queued(job, exc)
                    continue
                if plan is None:
                    return                   # head-of-line waits; keep FIFO
                self.pending.pop(0)
                self.metrics.hold_bytes(plan.device_bytes())
                try:
                    job.plan = plan
                    job.state = RUNNING
                    # a newly admitted job enters one quantum past the
                    # current virtual time: it cannot starve tenants
                    # already in flight
                    job.pass_value = self._global_pass + job.stride
                    job.metrics.admitted_s = time.perf_counter()
                    job.metrics.backend = plan.backend
                    job.metrics.stats = plan.stats()
                    self.metrics.hist.record_queue_wait(
                        job.tenant, job.metrics.queue_wait_s)
                    if job.cp is None:  # restored jobs carry their CPState
                        job.cp = cp_als_init(job.handle.dims, job.rank,
                                             norm_x=job.handle.norm_x,
                                             tol=job.tol, seed=job.seed,
                                             device=self.engine.device)
                    self.active.append(job.job_id)
                    self.metrics.jobs_admitted += 1
                    if plan.stats().demotions:
                        self.metrics.demotions_total += \
                            plan.stats().demotions
                    self._sync_gauges()
                    self._publish(job, "admitted")
                    if plan.stats().demotions:
                        self._publish(job, "demoted")
                except BaseException as exc:
                    # the PR-8 reservation-leak fix: the bytes charged two
                    # lines up must not outlive a failed registration
                    self.metrics.hold_bytes(-plan.close())
                    job.plan = None
                    if job.job_id in self.active:
                        self.active.remove(job.job_id)
                    self._fail_queued(job, exc)
                    continue
        finally:
            _san.audit_scheduler(self, "scheduler._admit")

    def _fail_queued(self, job: Job, exc: BaseException,
                     where: str = "scheduler.admit") -> None:
        """Quarantine a job that failed before (or during) admission."""
        job.state = FAILED
        job.error = repr(exc)
        job.error_payload = _error_payload(exc, where=where)
        job.metrics.completed_s = time.perf_counter()
        self.metrics.jobs_failed += 1
        self._sync_gauges()
        self._publish(job, FAILED)

    def _retire(self, job: Job, state: str, error: str | None = None,
                payload: dict | None = None) -> None:
        job.state = state
        job.error = error
        job.error_payload = payload
        job.metrics.completed_s = time.perf_counter()
        self.active.remove(job.job_id)
        freed = job.plan.close() if job.plan is not None else 0
        job.metrics.released_bytes = freed
        self.metrics.hold_bytes(-freed)
        if state == FAILED:
            self.metrics.jobs_failed += 1
        elif state == CANCELLED:
            self.metrics.jobs_cancelled += 1
            self.metrics.cancel_freed_bytes_total += freed
        else:
            self.metrics.jobs_completed += 1
        self.metrics.h2d_bytes_total += job.metrics.stats.h2d_bytes
        self.metrics.disk_bytes_total += job.metrics.stats.disk_bytes
        self.metrics.disk_time_s_total += job.metrics.stats.disk_time_s
        self.metrics.launches_total += job.metrics.stats.launches
        self.metrics.retries_total += job.metrics.stats.retries
        self.metrics.giveups_total += job.metrics.stats.giveups
        # per-job engine distributions roll up losslessly at retirement
        self.metrics.hist.merge_engine(job.metrics.stats.hist)
        self._sync_gauges()
        self._publish(job, state)
        _san.audit_scheduler(self, "scheduler._retire")
        self._admit()

    # ------------------------------------------------------------- control
    def cancel(self, job_id: int) -> bool:
        """Cancel a queued or running job; returns False if already final.

        A running job's plan is closed (pooled bytes + working set
        released) and admission re-runs immediately, so a waiting job can
        be admitted in the same call.  The job's ``CPState`` (partial
        factors, fit trajectory) survives for inspection.
        """
        _san.assert_scheduler_guard(self, "scheduler.cancel")
        job = self._get(job_id)
        if job.state == QUEUED:
            self.pending.remove(job.job_id)
            job.state = CANCELLED
            job.error = None
            job.metrics.completed_s = time.perf_counter()
            self.metrics.jobs_cancelled += 1
            self._sync_gauges()
            self._publish(job, CANCELLED)
            self._admit()                 # unblock jobs queued behind it
            return True
        if job.state == RUNNING:
            self._retire(job, CANCELLED)
            return True
        return False

    def set_weight(self, job_id: int, weight: float) -> Job:
        """Re-weight a tenant's job; effective at the next scheduling quantum.

        Preemption between ALS sweeps: the quantum is a whole sweep, so a
        demotion never interrupts (or loses) the job's ``CPState`` — the
        job simply gets scheduled less often from the next pick on.
        """
        _san.assert_scheduler_guard(self, "scheduler.set_weight")
        if not weight > 0:
            raise ValueError(f"tenant weight must be > 0, got {weight!r}")
        job = self._get(job_id)
        if job.state in TERMINAL_STATES:
            raise ValueError(f"job {job_id} is {job.state}; weight is final")
        demoted = weight < job.weight
        job.weight = float(weight)
        if job.state == RUNNING and demoted:
            self.metrics.preemptions += 1
        self._publish(job, "weight")
        return job

    def _get(self, job_id: int) -> Job:
        job = self.jobs.get(job_id)
        if job is None:
            raise ValueError(f"unknown job id {job_id!r}")
        return job

    # ------------------------------------------------------------- stepping
    def _pick(self) -> Job | None:
        """Stride scheduling: the active job with the lowest virtual time.

        Ties break by job id (= admission order), which makes equal
        weights reproduce the old round-robin trace exactly.
        """
        if not self.active:
            return None
        job = min((self.jobs[j] for j in self.active),
                  key=lambda j: (j.pass_value, j.job_id))
        self._global_pass = job.pass_value
        return job

    def step(self) -> bool:
        """One scheduling quantum: one ALS sweep of the min-pass job.

        Returns True while any job is active or queued.  Weighted fair
        share emerges across quanta: a weight-2 tenant's pass advances half
        as fast, so it is picked twice as often as a weight-1 tenant.
        """
        _san.assert_scheduler_guard(self, "scheduler.step")
        job = self._pick()
        if job is not None:
            self.stepping = job.job_id       # watchdog: quantum in flight
            self.in_sweep = False
            job.pass_value += job.stride
            backend = job.mttkrp_fn if job.mttkrp_fn is not None else job.plan
            t0 = time.perf_counter()
            with obs_trace.span("scheduler.quantum", "scheduler",
                                job=job.job_id, tenant=job.tenant,
                                sweep=job.cp.iteration + 1 if job.cp else 0):
                try:
                    kind = faults.fire("runtime.quantum")
                    if kind is not None:
                        # "exception" (RuntimeError) is caught right below
                        # -> job quarantined; "crash" (WorkerCrashError, a
                        # BaseException) escapes job isolation by design
                        # -> worker death -> watchdog restart
                        raise faults.exception_for("runtime.quantum", kind)
                    if faults.fire("factors.nan") is not None:
                        _poison_factors(job)
                    self.in_sweep = True     # factors mutate in place from
                    # ledger: every byte the sweep moves belongs to this
                    # tenant/job (context-local, so concurrent workers in
                    # other sessions cannot cross-attribute)
                    with obs_ledger.job_scope(job.tenant, job.job_id):
                        cp_als_step(backend, job.cp)    # here to sweep end
                    self.in_sweep = False
                    # always-on quantum-boundary NaN guard: the fit is a
                    # host float the sweep already synchronized on, so the
                    # check costs one math.isfinite — poisoned factors
                    # quarantine the job instead of corrupting its result
                    if job.cp.fits and not math.isfinite(job.cp.fits[-1]):
                        raise FactorPoisonError(
                            f"non-finite fit after sweep "
                            f"{job.cp.iteration}: job {job.job_id}'s factor "
                            f"matrices are poisoned (NaN/Inf)")
                    # the sanitizer's deeper (full-matrix) check rides the
                    # same quarantine path when enabled
                    _san.check_factors(job.cp.factors,
                                       f"job {job.job_id} after sweep "
                                       f"{job.cp.iteration}")
                except Exception as exc:      # noqa: BLE001 — job isolation:
                    self.metrics.busy_time_s += time.perf_counter() - t0
                    self._retire(job, FAILED, error=repr(exc),
                                 payload=_error_payload(
                                     exc, where="runtime.quantum"))
                    self.stepping = None
                    return bool(self.active or self.pending)
            dt = time.perf_counter() - t0
            self.metrics.busy_time_s += dt
            self.metrics.hist.record_quantum(job.tenant, dt)
            self.trace.append(job.job_id)     # one bad tensor must not take
            job.metrics.iterations = job.cp.iteration  # down other tenants
            self.metrics.iterations_total += 1
            self.metrics.record_iteration(job.tenant)
            self._publish(job, "iteration")
            if job.cp.converged or job.cp.iteration >= job.iters:
                self._retire(job, DONE)
            self.stepping = None
        return bool(self.active or self.pending)

    def run(self) -> None:
        """Synchronous driver: step until every submitted job retires."""
        while self.step():
            pass
