"""Per-job and service-wide counters (the port of
``repro.service.metrics``).

Every admitted job references its plan's ``EngineStats`` (the unified
engine counters: H2D bytes, launches, dispatch vs fenced device time), plus
queue timestamps; the service aggregates across jobs and tracks the
measured plan bytes the scheduler holds against the device budget.

Beyond the scalar totals, ``ServiceMetrics`` carries a
:class:`~repro_torch.obs.hist.ServiceHists` bundle: scheduler distributions
(queue wait, quantum duration) recorded live, and the engine
distributions of retired jobs rolled up losslessly at retirement.
Throughput is reported over **busy time** (the summed duration of
executed scheduler quanta), not wall-clock since construction — an idle
service does not decay its measured rate.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.core.streaming import EngineStats
from repro_torch.obs.hist import ServiceHists


@dataclasses.dataclass
class JobMetrics:
    submitted_s: float = dataclasses.field(default_factory=time.perf_counter)
    admitted_s: float | None = None
    completed_s: float | None = None
    iterations: int = 0
    cache_hit: bool = False
    backend: str = ""                    # which regime the engine chose
    released_bytes: int = 0              # budget bytes freed at retirement
    stats: EngineStats = dataclasses.field(default_factory=EngineStats)

    @property
    def queue_wait_s(self) -> float:
        """Time from submission until admission — or until the job left the
        queue for a terminal state without ever being admitted (cancelled
        while queued), so the value freezes at retirement."""
        if self.admitted_s is not None:
            end = self.admitted_s
        elif self.completed_s is not None:
            end = self.completed_s
        else:
            end = time.perf_counter()
        return end - self.submitted_s

    @property
    def run_time_s(self) -> float | None:
        if self.admitted_s is None or self.completed_s is None:
            return None
        return self.completed_s - self.admitted_s

    def snapshot(self) -> dict:
        return {
            "iterations": self.iterations,
            "queue_wait_s": self.queue_wait_s,
            "run_time_s": self.run_time_s,
            "cache_hit": self.cache_hit,
            "backend": self.backend,
            "released_bytes": self.released_bytes,
            "h2d_bytes": self.stats.h2d_bytes,
            "disk_bytes": self.stats.disk_bytes,
            "mttkrp_calls": self.stats.mttkrp_calls,
            "launches": self.stats.launches,
            "put_time_s": self.stats.put_time_s,
            "disk_time_s": self.stats.disk_time_s,
            "dispatch_time_s": self.stats.dispatch_time_s,
            "device_time_s": self.stats.device_time_s,
            "retries": self.stats.retries,
            "giveups": self.stats.giveups,
            "demotions": self.stats.demotions,
            "hist": self.stats.hist.snapshot(),
        }


@dataclasses.dataclass
class ServiceMetrics:
    started_s: float = dataclasses.field(default_factory=time.perf_counter)
    jobs_submitted: int = 0
    jobs_admitted: int = 0
    jobs_completed: int = 0
    jobs_failed: int = 0
    jobs_cancelled: int = 0
    preemptions: int = 0                 # weight demotions of running jobs
    cancel_freed_bytes_total: int = 0    # budget bytes freed by cancel()
    blco_cache_hits: int = 0
    blco_cache_misses: int = 0
    blco_disk_hits: int = 0              # registrations served off the store
    spills: int = 0                      # host -> disk evictions (LRU/manual)
    spill_bytes_total: int = 0           # host bytes freed by spilling
    loads: int = 0                       # disk -> host reloads (un-spills)
    store_rebuilds: int = 0              # corrupt store files self-healed
    jobs_restored: int = 0               # jobs resumed from a snapshot
    retries_total: int = 0               # transient faults absorbed by retry
    giveups_total: int = 0               # retry budgets exhausted
    demotions_total: int = 0             # degradation-ladder rungs taken
    watchdog_restarts: int = 0           # worker threads revived after crash
    iterations_total: int = 0
    h2d_bytes_total: int = 0
    disk_bytes_total: int = 0            # store->host traffic of retired jobs
    disk_time_s_total: float = 0.0
    launches_total: int = 0
    # summed duration of executed scheduler quanta — the throughput
    # denominator (wall-clock minus idle/queue-empty time)
    busy_time_s: float = 0.0
    # live scheduler gauges, synced on every lifecycle edge
    queue_depth: int = 0
    running_jobs: int = 0
    host_budget_used_bytes: int = 0      # registry host-tier residency
    # executed ALS sweeps per tenant: the observable the weighted fair
    # share is measured by (share_i ~ weight_i / sum(weights))
    tenant_iterations: dict = dataclasses.field(default_factory=dict)
    # measured plan bytes currently held vs the budget (the name predates
    # the engine API, when only reservations were charged; kept for compat)
    admitted_reservation_bytes: int = 0
    peak_admitted_reservation_bytes: int = 0
    hist: ServiceHists = dataclasses.field(default_factory=ServiceHists)

    def hold_bytes(self, delta: int) -> None:
        self.admitted_reservation_bytes += delta
        self.peak_admitted_reservation_bytes = max(
            self.peak_admitted_reservation_bytes,
            self.admitted_reservation_bytes)

    def record_iteration(self, tenant: str) -> None:
        self.tenant_iterations[tenant] = \
            self.tenant_iterations.get(tenant, 0) + 1

    def tenant_shares(self) -> dict:
        """Fraction of all executed iterations each tenant received."""
        total = sum(self.tenant_iterations.values())
        if not total:
            return {}
        return {t: n / total for t, n in self.tenant_iterations.items()}

    @property
    def uptime_s(self) -> float:
        """Wall-clock seconds since the metrics object was constructed."""
        return time.perf_counter() - self.started_s

    def iterations_per_sec(self) -> float:
        """Executed ALS sweeps per second of *busy* time.

        The denominator is the summed duration of executed scheduler
        quanta, not wall-clock since construction, so the rate measures
        the service's actual sweep throughput and does not decay while
        the queue is empty.  (The old wall-clock version made an idle
        service look progressively slower.)
        """
        if self.busy_time_s > 0:
            return self.iterations_total / self.busy_time_s
        return 0.0

    def snapshot(self) -> dict:
        return {
            "jobs_submitted": self.jobs_submitted,
            "jobs_admitted": self.jobs_admitted,
            "jobs_completed": self.jobs_completed,
            "jobs_failed": self.jobs_failed,
            "jobs_cancelled": self.jobs_cancelled,
            "preemptions": self.preemptions,
            "cancel_freed_bytes_total": self.cancel_freed_bytes_total,
            "blco_cache_hits": self.blco_cache_hits,
            "blco_cache_misses": self.blco_cache_misses,
            "blco_disk_hits": self.blco_disk_hits,
            "spills": self.spills,
            "spill_bytes_total": self.spill_bytes_total,
            "loads": self.loads,
            "store_rebuilds": self.store_rebuilds,
            "jobs_restored": self.jobs_restored,
            "retries_total": self.retries_total,
            "giveups_total": self.giveups_total,
            "demotions_total": self.demotions_total,
            "watchdog_restarts": self.watchdog_restarts,
            "iterations_total": self.iterations_total,
            "iterations_per_sec": self.iterations_per_sec(),
            "h2d_bytes_total": self.h2d_bytes_total,
            "disk_bytes_total": self.disk_bytes_total,
            "disk_time_s_total": self.disk_time_s_total,
            "launches_total": self.launches_total,
            "busy_time_s": self.busy_time_s,
            "uptime_s": self.uptime_s,
            "queue_depth": self.queue_depth,
            "running_jobs": self.running_jobs,
            "host_budget_used_bytes": self.host_budget_used_bytes,
            "tenant_iterations": dict(self.tenant_iterations),
            "tenant_shares": self.tenant_shares(),
            "admitted_reservation_bytes": self.admitted_reservation_bytes,
            "peak_admitted_reservation_bytes":
                self.peak_admitted_reservation_bytes,
            "hist": self.hist.snapshot(),
            "tenant_hist": self.hist.tenant_snapshot(),
        }
