"""The benchmark's spans, and the reading of a ``torch.profiler`` trace.

``Spans`` wraps the plan handed to ``cp_als_step``: it times each
``plan.mttkrp`` call by the host clock and, inside a profiled slice,
opens a ``record_function`` annotation ``mttkrp.mode<n>`` around it, so
that kernels are attributed by the span that launched them, not by name.

``summarize`` reads the profiled slice (``sweep`` annotations around each
sweep): the device's busy time (the union of every kernel, copy and set on
the card, without synchronisations and annotations), the device time of
the kernels launched inside the ``mttkrp`` spans (matched to their launch
by the profiler's correlation id), the device operations that took most
time, and the device's idle time by what the host was doing then.
"""
from __future__ import annotations

import time
from contextlib import nullcontext

SWEEP = "sweep"
MTTKRP = "mttkrp.mode"
TOP = 10


class Spans:
    """``plan`` with each ``mttkrp`` call timed (and annotated when
    ``annotate``); ``mttkrp_s`` sums the calls' host seconds."""

    def __init__(self, plan, annotate: bool = False):
        self.plan, self.annotate, self.mttkrp_s = plan, annotate, 0.0

    def mttkrp(self, factors, mode):
        if self.annotate:
            from torch.profiler import record_function
            ctx = record_function(f"{MTTKRP}{mode}")
        else:
            ctx = nullcontext()
        t0 = time.perf_counter()
        with ctx:
            out = self.plan.mttkrp(factors, mode)
        self.mttkrp_s += time.perf_counter() - t0
        return out


def _is_device_work(e) -> bool:
    return not (getattr(e, "is_user_annotation", False)
                or "Sync" in e.name or "Wait" in e.name
                or e.name.startswith((SWEEP, MTTKRP)))


def _union(spans, lo, hi):
    """Merged intervals of ``spans`` clipped to [lo, hi]."""
    out = []
    for a, z in sorted(spans):
        a, z = max(a, lo), min(z, hi)
        if z <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], z)
        else:
            out.append([a, z])
    return out


def _where(t, sweeps, calls) -> str:
    """What the host was doing at time ``t``: in an ``mttkrp`` call, in the
    solve after mode n's call, or between sweeps."""
    for a, z, name in calls:
        if a <= t <= z:
            return name
    inside = [s for s in sweeps if s[0] <= t <= s[1]]
    if not inside:
        return "between sweeps"
    before = [c for c in calls if inside[0][0] <= c[1] <= t]
    if not before:
        return "sweep start"
    mode = max(before, key=lambda c: c[1])[2][len(MTTKRP):]
    return f"solve.mode{mode}"


def summarize(events) -> dict | None:
    """Read ``prof.events()``; None where the trace holds no device work."""
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    sweeps = sorted((e.time_range.start, e.time_range.end) for e in cpu
                    if e.name == SWEEP)
    calls = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in cpu if e.name.startswith(MTTKRP))
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and _is_device_work(e)]
    if not sweeps or not device:
        return None
    lo, hi = sweeps[0][0], sweeps[-1][1]
    # correlation id -> launch time of the runtime call that issued it
    launched = {e.id: e.time_range.start for e in cpu
                if e.name.startswith("cu") and e.id}
    in_mttkrp, matched, by_name = 0.0, 0, {}
    for e in device:
        a, z = e.time_range.start, e.time_range.end
        by_name[e.name] = by_name.get(e.name, 0.0) + (z - a)
        at = launched.get(e.id)
        if at is None:
            continue
        matched += 1
        if any(c0 <= at <= c1 for c0, c1, _ in calls):
            in_mttkrp += z - a
    busy = _union([(e.time_range.start, e.time_range.end) for e in device],
                  lo, hi)
    gaps, end = {}, lo
    for a, z in busy + [[hi, hi]]:
        if a > end:
            where = _where((a + end) / 2, sweeps, calls)
            gaps[where] = gaps.get(where, 0.0) + (a - end) / 1e6
        end = max(end, z)
    us = 1e-6
    return {
        "sweeps": len(sweeps),
        "window_s": (hi - lo) * us,
        "busy_s": sum(z - a for a, z in busy) * us,
        "mttkrp_device_s": in_mttkrp * us,
        "device_events": len(device),
        "matched_events": matched,
        "device_ops": sorted(([n, s * us] for n, s in by_name.items()),
                             key=lambda p: -p[1])[:TOP],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                            key=lambda p: -p[1])[:TOP],
    }
