"""Unified MTTKRP engine of the port: one ExecutionPlan API.

    from repro_torch.engine import plan_for
    plan = plan_for(build_blco(t), device_budget_bytes=1 << 30, rank=16)
    out = plan.mttkrp(factors, mode)        # one kernel launch on the card
                                            # (one per chunk when streamed)
    plan.device_bytes(); plan.stats(); plan.close()

Backends: InMemoryPlan (device-resident), StreamedPlan (host-resident,
fixed reservations), DiskStreamedPlan (a ``.blco`` store file streamed
through the same ring — ``repro_torch.store``).  ``plan_for`` implements
the paper's regime decision (give it ``host_budget_bytes`` to extend it to
the disk tier) and, in auto mode, falls a memory tier on an allocation
failure; ``DefaultEngine`` wraps it behind the ``MTTKRPEngine`` protocol.
"""
from repro_torch.core.streaming import EngineStats
from repro_torch.store import DiskStreamedPlan

from .api import ExecutionPlan, MTTKRPEngine, factor_bytes, in_memory_bytes
from .plans import InMemoryPlan, StreamedPlan
from .select import AUTO_BACKENDS, UNPORTED_BACKENDS, DefaultEngine, plan_for

__all__ = ["EngineStats", "ExecutionPlan", "MTTKRPEngine", "factor_bytes",
           "in_memory_bytes", "InMemoryPlan", "StreamedPlan",
           "DiskStreamedPlan", "AUTO_BACKENDS", "UNPORTED_BACKENDS",
           "DefaultEngine", "plan_for"]
