"""Process-wide dispatch accounting for the port's MTTKRP paths.

A *dispatch* is one host-side invocation of a compute path for one launch
cache: the fused CUDA wrapper records exactly ONE per ``mttkrp`` call; the
plain PyTorch path, which runs eagerly launch by launch, records one per
BLCO launch.  Tests assert launch-count claims through it.

A *host sync* is one place where the in-memory CP-ALS path blocks the host
until the card has drained, counted by site: ``plan.fence`` (the in-memory
plan's ``synchronize`` after each MTTKRP on a card), ``cp_als.pinv``
(``torch.linalg.pinv`` on a card: its SVD's copy to the host and its status
read, two waits) and ``cp_als.fit`` (the fit's readback from a card).
Always on; the streamed, disk and sharded paths' waits are not counted.

Both counters are monotonic; callers snapshot them before and after
(``dispatch_count()``, ``host_sync_counts()``) rather than resetting them.
"""
from __future__ import annotations

_dispatches = 0
_host_syncs: dict[str, int] = {}


def record_dispatch(n: int = 1) -> None:
    """Record ``n`` compute dispatches."""
    global _dispatches
    _dispatches += int(n)


def dispatch_count() -> int:
    """Monotonic count of compute dispatches recorded so far."""
    return _dispatches


def record_host_sync(site: str, n: int = 1) -> None:
    """Record ``n`` host syncs at ``site``."""
    _host_syncs[site] = _host_syncs.get(site, 0) + int(n)


def host_sync_counts() -> dict:
    """Monotonic host syncs recorded so far, by site (a copy)."""
    return dict(_host_syncs)
