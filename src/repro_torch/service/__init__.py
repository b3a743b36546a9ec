"""Multi-tenant decomposition service over pooled execution plans.

The port of ``repro.service`` (same exports).  ``DecompositionService``
and ``ServiceRuntime`` take ``device=`` (the card by default; ``"cpu"``
with ``kernel="torch"`` runs the plain path) and ``kernel=`` (``"cuda"``
by default: K1/K2 on every sweep).

Turns the paper's single-copy BLCO + unified engine API into a serving
layer: many concurrent CP-ALS / MTTKRP jobs share one accelerator under a
measured device-byte admission budget, each executing through an
``ExecutionPlan`` — device-resident for small tensors, streamed through
pooled reservations for large ones.

    registry   two-tier (host/disk) BLCO cache keyed by content
               fingerprint, with LRU spilling to the persistent store
    executor   ServiceEngine: pooled plans (reservations + device
               residency + disk streaming for spilled tensors)
    scheduler  FIFO admission by plan.device_bytes() + weighted stride
               fair share with cancellation
    api        typed requests/responses + the DecompositionService facade
               (incl. snapshot()/restore() persistence)
    metrics    per-job and service-wide counters (unified EngineStats)
    runtime    ServiceRuntime: threaded async driver with job cancellation
               and streaming per-iteration status feeds
"""
from .api import (CancelJob, CancelResult, DecompositionResult,
                  DecompositionService, GetMetrics, GetRoofline, GetSLO,
                  GetTrace, JobStatus, MTTKRPQuery, SetWeight,
                  SubmitDecomposition, WeightUpdate, DEFAULT_DEVICE_BUDGET)
from .executor import (PooledDiskStreamedPlan, PooledExecutor,
                       PooledInMemoryPlan, PooledStreamedPlan, ServiceEngine)
from .metrics import JobMetrics, ServiceMetrics
from .registry import BuildParams, TensorHandle, TensorRegistry, fingerprint
from .runtime import JobEvent, ServiceRuntime, StatusFeed
from .scheduler import (Job, JobScheduler, QUEUED, RUNNING, DONE, FAILED,
                        CANCELLED, TERMINAL_STATES)

__all__ = [
    "CancelJob", "CancelResult", "DecompositionResult",
    "DecompositionService", "GetMetrics", "GetRoofline", "GetSLO",
    "GetTrace", "JobStatus",
    "MTTKRPQuery", "SetWeight", "SubmitDecomposition", "WeightUpdate",
    "DEFAULT_DEVICE_BUDGET",
    "ServiceEngine", "PooledExecutor", "PooledInMemoryPlan",
    "PooledStreamedPlan", "PooledDiskStreamedPlan",
    "JobMetrics", "ServiceMetrics",
    "BuildParams", "TensorHandle", "TensorRegistry", "fingerprint",
    "JobEvent", "ServiceRuntime", "StatusFeed",
    "Job", "JobScheduler", "QUEUED", "RUNNING", "DONE", "FAILED",
    "CANCELLED", "TERMINAL_STATES",
]
