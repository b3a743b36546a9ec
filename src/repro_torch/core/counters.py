"""Process-wide dispatch accounting for the port's MTTKRP paths.

A *dispatch* is one host-side invocation of a compute path for one launch
cache: the fused CUDA wrapper records exactly ONE per ``mttkrp`` call; the
plain PyTorch path, which runs eagerly launch by launch, records one per
BLCO launch.  Tests assert launch-count claims through it.

The counter is monotonic; callers snapshot it before and after
(``dispatch_count()``) rather than resetting it.
"""
from __future__ import annotations

_dispatches = 0


def record_dispatch(n: int = 1) -> None:
    """Record ``n`` compute dispatches."""
    global _dispatches
    _dispatches += int(n)


def dispatch_count() -> int:
    """Monotonic count of compute dispatches recorded so far."""
    return _dispatches
