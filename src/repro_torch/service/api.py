"""Typed request/response surface + the synchronous service facade
(the port of ``repro.service.api``).

``DecompositionService`` wires registry -> scheduler -> service engine into
one front door: submit decomposition jobs (CP-ALS to convergence), issue
one-shot MTTKRP queries against registered tensors, drive everything to
completion, and read per-job / service-wide metrics.  Every MTTKRP — job
iteration or one-shot query — executes through an ``ExecutionPlan`` from
the pooled ``ServiceEngine``: small tensors transparently run
device-resident, larger ones stream, all under one measured byte budget.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.cp_als import CPResult
from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.core.tensor import SparseTensor
from repro_torch.obs import roofline as obs_roofline
from repro_torch.obs import slo as obs_slo
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.export import chrome_trace, render_prometheus

from . import scheduler as sched
from .executor import ServiceEngine
from .metrics import ServiceMetrics
from .registry import BuildParams, TensorRegistry

DEFAULT_DEVICE_BUDGET = 256 << 20           # 256 MiB of admitted plan bytes


@dataclasses.dataclass
class SubmitDecomposition:
    """Request: decompose ``tensor`` at rank R (CP-ALS until converged/iters).

    ``tenant`` labels the job for per-tenant share accounting; ``weight``
    is its fair-share weight (a weight-2 tenant receives twice the ALS
    sweeps of a weight-1 tenant while both are active).
    """
    tensor: SparseTensor
    rank: int
    iters: int = 25
    tol: float = 1e-5
    seed: int = 0
    tenant: str = "default"
    weight: float = 1.0
    build: BuildParams = dataclasses.field(default_factory=BuildParams)
    reservation_nnz: int | None = None


@dataclasses.dataclass
class CancelJob:
    """Request: cancel a queued or running job (idempotent on final jobs)."""
    job_id: int


@dataclasses.dataclass
class CancelResult:
    """Response: what cancelling freed.  ``freed_bytes`` is the measured
    budget release (pooled share + per-job working set); 0 when the job was
    still queued or already final."""
    job_id: int
    cancelled: bool
    state: str
    freed_bytes: int


@dataclasses.dataclass
class SetWeight:
    """Request: re-weight one job, or every non-final job of a tenant."""
    weight: float
    job_id: int | None = None
    tenant: str | None = None


@dataclasses.dataclass
class WeightUpdate:
    """Response: which jobs now carry the new weight."""
    weight: float
    job_ids: tuple


@dataclasses.dataclass
class MTTKRPQuery:
    """Request: one mode-n MTTKRP against a (cached) tensor."""
    tensor: SparseTensor
    factors: list
    mode: int
    build: BuildParams = dataclasses.field(default_factory=BuildParams)
    reservation_nnz: int | None = None


@dataclasses.dataclass
class GetMetrics:
    """Request: the service-wide metrics snapshot.

    ``format="json"`` returns the ``ServiceMetrics.snapshot()`` dict;
    ``format="prometheus"`` returns the text exposition
    (:func:`repro_torch.obs.export.render_prometheus`) an off-the-shelf
    Prometheus can scrape.
    """
    format: str = "json"          # "json" | "prometheus"


@dataclasses.dataclass
class GetTrace:
    """Request: the recorded span timeline as Chrome trace-event JSON.

    ``drain=True`` removes the returned spans from the ring buffer, so
    successive calls stream disjoint windows of the timeline.
    """
    drain: bool = False


@dataclasses.dataclass
class GetRoofline:
    """Request: the roofline attribution report over the bandwidth ledger.

    ``peaks`` maps tier-edge name (``disk_host`` / ``host_device`` /
    ``device_hbm``) to a measured peak GB/s; with ``peak_flops`` it turns
    achieved GB/s into achieved fractions and classifies each regime
    memory- vs compute-bound.  Without ceilings the report still carries
    bytes / seconds / GB/s per edge (classification ``"unknown"``).  The
    ledger must be enabled (``repro_torch.obs.ledger.enable()``) for accounts
    to accumulate.
    """
    peaks: dict | None = None
    peak_flops: float | None = None


@dataclasses.dataclass
class GetSLO:
    """Request: per-tenant latency-SLO evaluation + burn rates.

    Evaluated over the scheduler's ``queue_wait_s``/``quantum_s``
    histograms, globally and per tenant.  ``slos`` overrides the
    objectives (a tuple of :class:`repro_torch.obs.slo.SLO`); empty means
    :data:`repro_torch.obs.slo.DEFAULT_SLOS`.
    """
    slos: tuple = ()


@dataclasses.dataclass
class JobStatus:
    """Response: where one job is in its lifecycle."""
    job_id: int
    state: str            # queued | running | done | failed | cancelled
    tensor_key: str
    iteration: int
    fit: float | None
    converged: bool
    queue_wait_s: float
    cache_hit: bool
    backend: str = ""            # engine regime ("in_memory" | "streamed" | "")
    tenant: str = "default"
    weight: float = 1.0
    error: str | None = None
    # quarantine explanation for FAILED jobs: type / message / where /
    # transient / injected (see scheduler._error_payload)
    error_payload: dict | None = None


@dataclasses.dataclass
class DecompositionResult:
    """Response: a finished decomposition + its cost accounting."""
    job_id: int
    tensor_key: str
    result: CPResult
    metrics: dict


class DecompositionService:
    """Multi-tenant decomposition service over pooled execution plans.

    ``device`` is where every job's plan and state live: the card unless
    the caller asks for the CPU (``device="cpu"`` with ``kernel="torch"``
    runs the plain path).
    """

    def __init__(self, *, device_budget_bytes: int = DEFAULT_DEVICE_BUDGET,
                 queues: int = 4, max_active: int | None = None,
                 kernel: str = "cuda", store_dir: str | None = None,
                 host_budget_bytes: int | None = None,
                 device=DEFAULT_DEVICE):
        self.registry = TensorRegistry(store_dir=store_dir,
                                       host_budget_bytes=host_budget_bytes)
        self.engine = ServiceEngine(queues=queues, kernel=kernel,
                                    device=device)
        self.metrics = ServiceMetrics()
        self.scheduler = sched.JobScheduler(
            self.engine, device_budget_bytes=device_budget_bytes,
            max_active=max_active, metrics=self.metrics)

    @property
    def executor(self) -> ServiceEngine:
        """Deprecated PR-1 name for the service engine."""
        return self.engine

    # ------------------------------------------------------------- requests
    def submit(self, req: SubmitDecomposition) -> int:
        """Register (or cache-hit) the tensor and enqueue a CP-ALS job.

        A spilled/adopted tensor is reloaded to the host tier when the
        registry's host budget has room (restoring the in-memory fast
        path after restarts and evictions); under host pressure the stub
        stays and the job disk-streams from the store.
        """
        hits_before = self.registry.hits
        handle = self.registry.register(req.tensor, build=req.build,
                                        reservation_nnz=req.reservation_nnz)
        handle = self.registry.maybe_load(handle.key)
        self._sync_cache_counters()
        job_id = self.scheduler.submit(handle, rank=req.rank,
                                       iters=req.iters, tol=req.tol,
                                       seed=req.seed, weight=req.weight,
                                       tenant=req.tenant)
        self.scheduler.jobs[job_id].metrics.cache_hit = \
            self.registry.hits > hits_before
        return job_id

    def cancel(self, req: CancelJob | int) -> CancelResult:
        """Cancel a queued/running job; release its plan bytes immediately.

        Idempotent: cancelling a done/failed/cancelled job reports
        ``cancelled=False`` instead of raising.  Freed bytes re-run
        admission, so a waiting job can be admitted in the same call.
        """
        job_id = req.job_id if isinstance(req, CancelJob) else int(req)
        job = self._get_job(job_id)
        cancelled = self.scheduler.cancel(job_id)
        return CancelResult(job_id=job_id, cancelled=cancelled,
                            state=job.state,
                            freed_bytes=job.metrics.released_bytes
                            if cancelled else 0)

    def set_weight(self, req: SetWeight) -> WeightUpdate:
        """Apply a fair-share weight to one job or a whole tenant.

        Takes effect at the next scheduling quantum (between ALS sweeps):
        a demoted tenant keeps its resumable ``CPState``, it is simply
        picked less often from now on.
        """
        if (req.job_id is None) == (req.tenant is None):
            raise ValueError("SetWeight targets exactly one of job_id or "
                             "tenant")
        if req.job_id is not None:
            ids = [self._get_job(req.job_id).job_id]
        else:
            # a tenant whose jobs all finished between the caller's decision
            # and this call is a no-op, not an error: under the async
            # runtime the caller cannot win that race from outside the lock
            ids = [j.job_id for j in self.scheduler.jobs.values()
                   if j.tenant == req.tenant
                   and j.state not in sched.TERMINAL_STATES]
        for job_id in ids:
            self.scheduler.set_weight(job_id, req.weight)
        return WeightUpdate(weight=float(req.weight), job_ids=tuple(ids))

    def mttkrp(self, query: MTTKRPQuery):
        """One-shot MTTKRP (registers/caches the tensor first).

        Runs through an engine plan under the same measured admission
        budget as jobs: the engine picks device-resident or streamed for
        the query, and the plan is closed (its bytes released) afterwards.
        """
        if not 0 <= query.mode < query.tensor.order:
            raise ValueError(f"mode {query.mode} out of range for "
                             f"order-{query.tensor.order} tensor")
        handle = self.registry.register(query.tensor, build=query.build,
                                        reservation_nnz=query.reservation_nnz)
        handle = self.registry.maybe_load(handle.key)
        self._sync_cache_counters()
        # numpy or torch factors, on the service's device: the result is a
        # tensor there
        factors = [torch.as_tensor(f, device=self.engine.device)
                   for f in query.factors]
        rank = factors[0].shape[1]
        remaining = self.scheduler.device_budget_bytes \
            - self.metrics.admitted_reservation_bytes
        plan = self.engine.try_plan(handle, rank=rank,
                                    dtype=factors[0].dtype,
                                    budget_remaining=remaining)
        if plan is None:
            raise ValueError(
                f"query does not fit the device budget: needs "
                f"{self.engine.min_cost(handle, rank)} B but only "
                f"{remaining} B of {self.scheduler.device_budget_bytes} B "
                f"remain unadmitted")
        self.metrics.hold_bytes(plan.device_bytes())
        try:
            return plan.mttkrp(factors, query.mode)
        finally:
            self.metrics.hold_bytes(-plan.close())

    # --------------------------------------------------------------- driving
    def step(self) -> bool:
        """One weighted fair-share quantum; True while work remains."""
        return self.scheduler.step()

    def run(self) -> dict[int, DecompositionResult]:
        """Drive every submitted job to completion; return finished results."""
        self.scheduler.run()
        return {job_id: self.result(job_id)
                for job_id, job in self.scheduler.jobs.items()
                if job.state == sched.DONE}

    # ---------------------------------------------------------------- status
    def _get_job(self, job_id: int) -> sched.Job:
        job = self.scheduler.jobs.get(job_id)
        if job is None:
            known = sorted(self.scheduler.jobs)
            known_desc = f"known ids: {known[0]}..{known[-1]}" if known \
                else "no jobs submitted yet"
            raise ValueError(f"unknown job id {job_id!r}; {known_desc}")
        return job

    def status(self, job_id: int) -> JobStatus:
        job = self._get_job(job_id)
        return JobStatus(
            job_id=job.job_id, state=job.state, tensor_key=job.handle.key,
            iteration=job.cp.iteration if job.cp is not None else 0,
            fit=job.fit,
            converged=bool(job.cp is not None and job.cp.converged),
            queue_wait_s=job.metrics.queue_wait_s,
            cache_hit=job.metrics.cache_hit,
            backend=job.metrics.backend, tenant=job.tenant,
            weight=job.weight, error=job.error,
            error_payload=job.error_payload)

    def result(self, job_id: int) -> DecompositionResult:
        job = self._get_job(job_id)
        if job.state != sched.DONE:
            raise ValueError(f"job {job_id} is {job.state}, not done")
        return DecompositionResult(
            job_id=job_id, tensor_key=job.handle.key,
            result=job.cp.as_result(), metrics=job.metrics.snapshot())

    def service_metrics(self) -> dict[str, Any]:
        self._sync_cache_counters()
        return self.metrics.snapshot()

    def get_metrics(self, req: GetMetrics | None = None):
        """Service metrics in the requested format (see ``GetMetrics``)."""
        req = req if req is not None else GetMetrics()
        self._sync_cache_counters()
        if req.format == "prometheus":
            return render_prometheus(self.metrics)
        if req.format == "json":
            return self.metrics.snapshot()
        raise ValueError(f"unknown metrics format {req.format!r}; "
                         f"expected 'json' or 'prometheus'")

    def get_roofline(self, req: GetRoofline | None = None) -> dict:
        """Roofline attribution from the bandwidth ledger (``GetRoofline``):
        achieved GB/s per tier edge, arithmetic intensity and bound
        classification per regime, saturated edge per regime."""
        req = req if req is not None else GetRoofline()
        return obs_roofline.roofline_report(peaks=req.peaks,
                                            peak_flops=req.peak_flops)

    def get_slo(self, req: GetSLO | None = None) -> dict:
        """Latency-SLO evaluation over the scheduler hists (``GetSLO``):
        good fraction, met/violated, and burn rate — globally and per
        tenant."""
        req = req if req is not None else GetSLO()
        slos = req.slos if req.slos else obs_slo.DEFAULT_SLOS
        return obs_slo.slo_report(self.metrics.hist, slos=slos)

    def trace(self, req: GetTrace | None = None) -> dict:
        """Recorded spans as Chrome trace-event JSON (see ``GetTrace``).

        Load the returned dict (or its ``json.dump``) in
        https://ui.perfetto.dev to see the service's pipeline timeline —
        one track per stage (scheduler / plan / store / h2d / dispatch /
        device / registry).  Tracing must be enabled (``repro_torch.obs.enable``
        or ``ServiceRuntime(tracing=True)``) for spans to be recorded.
        """
        req = req if req is not None else GetTrace()
        spans = obs_trace.drain() if req.drain else None
        return chrome_trace(spans)

    # ------------------------------------------------------------ persistence
    def snapshot(self, path: str) -> dict:
        """Write a restartable snapshot (registry + job CPState) to ``path``.

        Requires ``store_dir`` (the registry's spill store holds the
        tensors; the snapshot holds only the manifest and checkpoints).
        """
        from ..store import snapshot_service
        manifest = snapshot_service(self, path)
        self._sync_cache_counters()
        return manifest

    @classmethod
    def restore(cls, path: str, **service_kwargs) -> "DecompositionService":
        """A fresh service resuming every snapshotted job under its
        original id (tensors adopt from the spill store, no BLCO rebuild)."""
        from ..store import restore_service
        service = cls(**service_kwargs)
        restore_service(path, service)
        service._sync_cache_counters()
        return service

    def _sync_cache_counters(self) -> None:
        self.metrics.blco_cache_hits = self.registry.hits
        self.metrics.blco_cache_misses = self.registry.misses
        self.metrics.blco_disk_hits = self.registry.disk_hits
        self.metrics.spills = self.registry.spills
        self.metrics.spill_bytes_total = self.registry.spill_bytes
        self.metrics.loads = self.registry.loads
        self.metrics.store_rebuilds = self.registry.rebuilds
        self.metrics.host_budget_used_bytes = self.registry.host_bytes()
