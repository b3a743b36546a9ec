"""Unified MTTKRP engine of the port: one ExecutionPlan API.

    from repro_torch.engine import plan_for
    plan = plan_for(build_blco(t), device_budget_bytes=1 << 30, rank=16)
    out = plan.mttkrp(factors, mode)        # one kernel launch on the card
                                            # (one per chunk when streamed)
    plan.device_bytes(); plan.stats(); plan.close()

Backends: InMemoryPlan (device-resident), StreamedPlan (host-resident,
fixed reservations), DiskStreamedPlan (a ``.blco`` store file streamed
through the same ring — ``repro_torch.store``), ShardedPlan (the nnz
stream over the data axis and the rank over the model axis of a mesh of
``torch.distributed`` ranks), BaselinePlan (COO / F-COO / CSF in plain
PyTorch: ``plan_for(backend="coo", kernel="torch")``).
``plan_for`` implements the paper's regime decision (give it
``host_budget_bytes`` to extend it to the disk tier, a ``mesh`` or
``repro_torch.dist.set_mesh`` to shard it) and, in auto mode,
falls a memory tier on an allocation failure; ``DefaultEngine`` wraps it
behind the ``MTTKRPEngine`` protocol.
"""
from repro_torch.core.streaming import EngineStats
from repro_torch.store import DiskStreamedPlan

from .api import ExecutionPlan, MTTKRPEngine, factor_bytes, in_memory_bytes
from .plans import (BASELINE_KINDS, BaselinePlan, InMemoryPlan, ShardedPlan,
                    StreamedPlan, sharded_bytes)
from .select import AUTO_BACKENDS, DefaultEngine, plan_for

__all__ = ["EngineStats", "ExecutionPlan", "MTTKRPEngine", "factor_bytes",
           "in_memory_bytes", "sharded_bytes", "InMemoryPlan",
           "StreamedPlan", "DiskStreamedPlan", "ShardedPlan", "BaselinePlan",
           "BASELINE_KINDS", "AUTO_BACKENDS", "DefaultEngine", "plan_for"]
