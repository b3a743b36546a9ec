"""Unified MTTKRP engine of the port: one ExecutionPlan API.

    from repro_torch.engine import plan_for
    plan = plan_for(build_blco(t), device_budget_bytes=1 << 30, rank=16)
    out = plan.mttkrp(factors, mode)        # one kernel launch on the card
                                            # (one per chunk when streamed)
    plan.device_bytes(); plan.stats(); plan.close()
"""
from repro_torch.core.streaming import EngineStats

from .api import ExecutionPlan, factor_bytes, in_memory_bytes
from .plans import InMemoryPlan, StreamedPlan
from .select import AUTO_BACKENDS, UNPORTED_BACKENDS, plan_for

__all__ = ["EngineStats", "ExecutionPlan", "factor_bytes", "in_memory_bytes",
           "InMemoryPlan", "StreamedPlan", "AUTO_BACKENDS",
           "UNPORTED_BACKENDS", "plan_for"]
