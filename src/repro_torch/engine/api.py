"""The unified MTTKRP engine API: one ``ExecutionPlan`` for every regime.

The port of ``repro.engine.api``.  Every way to execute an MTTKRP is an
``ExecutionPlan`` with the same four methods:

    plan.mttkrp(factors, mode)   -> (I_mode, R) result
    plan.device_bytes()          -> exact bytes the plan holds resident
                                    (hi + lo + vals + bases, padded)
    plan.stats()                 -> unified EngineStats
    plan.close()                 -> release device buffers; returns bytes freed

The port has one backend so far, ``InMemoryPlan``.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.blco import BLCOTensor
from repro_torch.core.launches import launch_cache_bytes
from repro_torch.core.streaming import EngineStats


@runtime_checkable
class ExecutionPlan(Protocol):
    """A concrete, introspectable way to execute MTTKRPs for one tensor."""

    backend: str          # "in_memory" (the only port backend so far)

    def mttkrp(self, factors, mode: int):
        """Mode-``mode`` MTTKRP of the planned tensor with ``factors``."""
        ...

    def device_bytes(self) -> int:
        """Exact device bytes this plan holds resident (incl. bases arrays)."""
        ...

    def stats(self) -> EngineStats:
        """Execution counters accumulated by this plan."""
        ...

    def close(self) -> int:
        """Release device buffers; returns the bytes freed."""
        ...


def _itemsize(dtype) -> int:
    """Bytes per element of a torch or numpy dtype."""
    size = getattr(dtype, "itemsize", None)
    return int(size) if isinstance(size, int) else np.dtype(dtype).itemsize


def factor_bytes(dims, rank: int, dtype) -> int:
    """Device working-set bytes of a rank-R MTTKRP around the tensor itself:
    the N factor matrices plus the largest-mode output accumulator."""
    return (sum(int(d) for d in dims) + max(int(d) for d in dims)) \
        * rank * _itemsize(dtype)


def in_memory_bytes(blco: BLCOTensor) -> int:
    """Predicted device footprint of an ``InMemoryPlan`` for ``blco``: the
    stacked launch cache's hi + lo + vals + bases."""
    return launch_cache_bytes(blco)
