"""The program's own spans and host-sync counter, read over two slices of
sweeps after the window.

Slice A (``traced_slice``) runs sweeps with the program's tracer on and no
profiler: the host durations of its ``cp_als.*`` spans, the device time
each ``plan.mttkrp`` span carries as ``device_ms`` (CUDA events around the
kernel), and the growth of the program's host-sync counter.  Slice B
(``profiled_program_slice``) runs sweeps with the tracer on under
``torch.profiler``: the program mirrors each span it opens into the
profiler's trace, so ``summarize_program`` can put every idle gap of the
card down to the innermost program span the host was in, split by overlap,
and every kernel to the innermost span whose host code launched it
(matched by correlation id).  ``cp_als.sweep`` bounds the sweeps; idle in
its own time, or in no span, is ``unattributed``.

``program_metrics`` turns both slices into seven figures per sweep, each
``None`` where its slice is missing.  This module imports nothing of the
program: the caller hands in the tracer module (``repro_torch.obs.trace``)
and the counter (``repro_torch.core.counters.host_sync_counts``).
``run.py`` does not run these slices; a caller that does reads them here.
"""
from __future__ import annotations

import bisect
import time

from tdbench import tracing

SWEEP = "cp_als.sweep"
# the spans idle time is put down to (innermost first is the timeline's
# business: ``cp_als.pinv`` lies inside ``cp_als.update``)
ATTRIBUTED = ("plan.mttkrp", "cp_als.pinv", "cp_als.update", "cp_als.fit")
PROGRAM = (SWEEP,) + ATTRIBUTED
UNATTRIBUTED = "unattributed"
# runtime calls that block the host on the card
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
# per-sweep figure -> the span whose idle it reads
IDLE_METRICS = {"plan_idle_ms": "plan.mttkrp", "pinv_idle_ms": "cp_als.pinv",
                "update_idle_ms": "cp_als.update",
                "fit_idle_ms": "cp_als.fit"}
METRICS = ("host_syncs", "cp_als_solve_ms", "mttkrp_device_ms",
           *IDLE_METRICS)


def traced_slice(step, plan, state, sweeps: int, tracer,
                 host_sync_counts) -> dict:
    """Slice A: ``sweeps`` sweeps of ``step(plan, state)`` with the tracer
    on, cleared before and turned off after."""
    tracer.clear()
    tracer.enable()
    before = host_sync_counts()
    t0 = time.perf_counter()
    try:
        for _ in range(sweeps):
            step(plan, state)
    finally:
        wall = time.perf_counter() - t0
        tracer.disable()
    after = host_sync_counts()
    span_s, device_ms, device_calls = {}, 0.0, 0
    for s in tracer.spans():
        if s.name not in PROGRAM:
            continue
        span_s[s.name] = span_s.get(s.name, 0.0) + s.duration_s
        if s.name == "plan.mttkrp" and "device_ms" in s.attrs:
            device_ms += s.attrs["device_ms"]
            device_calls += 1
    return {"sweeps": sweeps, "wall_s": wall, "span_s": span_s,
            "device_ms": device_ms, "device_calls": device_calls,
            "host_syncs": {k: after.get(k, 0) - before.get(k, 0)
                           for k in after}}


def profiled_program_slice(step, plan, state, sweeps: int, dev,
                           tracer) -> dict | None:
    """Slice B: ``sweeps`` sweeps with the tracer on under
    ``torch.profiler``; the trace's ``summarize_program``.  None off a
    card."""
    if dev.type != "cuda":
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile
    tracer.clear()
    tracer.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(sweeps):
                step(plan, state)
            torch.cuda.synchronize(dev)
    finally:
        tracer.disable()
    return summarize_program(prof.events())


def innermost(spans) -> list:
    """``(start, end, name)`` pieces of the timeline, each in the innermost
    of the properly nested ``spans`` open there; time in none is left out."""
    pieces, stack, cursor = [], [], None

    def close_until(t):
        nonlocal cursor
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > cursor:
                pieces.append((cursor, end, name))
                cursor = end

    for a, z, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        if cursor is not None:
            close_until(a)
            if stack and a > cursor:
                pieces.append((cursor, a, stack[-1][1]))
        stack.append((z, name))
        cursor = a
    close_until(float("inf"))
    return pieces


def _gaps(busy, lo, hi) -> list:
    """The parts of [lo, hi] outside the merged intervals ``busy``."""
    out, end = [], lo
    for a, z in busy:
        if a > end:
            out.append((end, a))
        end = max(end, z)
    if hi > end:
        out.append((end, hi))
    return out


def split_idle(gaps, pieces) -> dict:
    """Each gap's time by the piece it overlaps, in proportion to the
    overlap; time in no piece, or in a ``cp_als.sweep`` of its own, is
    ``unattributed``."""
    out = dict.fromkeys(ATTRIBUTED + (UNATTRIBUTED,), 0.0)
    ends = [p[1] for p in pieces]
    for a, z in gaps:
        covered, k = 0.0, bisect.bisect_right(ends, a)
        while k < len(pieces) and pieces[k][0] < z:
            p0, p1, name = pieces[k]
            part = min(z, p1) - max(a, p0)
            covered += part
            out[name if name in ATTRIBUTED else UNATTRIBUTED] += part
            k += 1
        out[UNATTRIBUTED] += (z - a) - covered
    return out


def _device_work(e) -> bool:
    return tracing._is_device_work(e) and e.name not in PROGRAM


def summarize_program(events) -> dict | None:
    """Read slice B's ``prof.events()``; None where the trace holds no
    program sweep or no device work.  Times in seconds."""
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in cpu
             if e.name in PROGRAM]
    sweeps = sorted((a, z) for a, z, name in spans if name == SWEEP)
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and _device_work(e)]
    if not sweeps or not device:
        return None
    lo, hi = sweeps[0][0], sweeps[-1][1]
    pieces = innermost(spans)
    busy = tracing._union([(e.time_range.start, e.time_range.end)
                           for e in device], lo, hi)
    idle = split_idle(_gaps(busy, lo, hi), pieces)
    # each kernel, copy or set by the innermost span of its launch
    launched = {e.id: e.time_range.start for e in cpu
                if e.name.startswith("cu") and e.id}
    starts = [p[0] for p in pieces]
    by_span, matched = {}, 0
    for e in device:
        at = launched.get(e.id)
        if at is None:
            continue
        matched += 1
        k = bisect.bisect_right(starts, at) - 1
        name = pieces[k][2] if k >= 0 and at <= pieces[k][1] else None
        key = name if name in ATTRIBUTED else UNATTRIBUTED
        by_span[key] = by_span.get(key, 0.0) + \
            (e.time_range.end - e.time_range.start)
    syncs = {}
    for e in cpu:
        if e.name in SYNC_CALLS and lo <= e.time_range.start <= hi:
            syncs[e.name] = syncs.get(e.name, 0) + 1
    us = 1e-6
    return {
        "sweeps": len(sweeps),
        "window_s": (hi - lo) * us,
        "busy_s": sum(z - a for a, z in busy) * us,
        "idle_s": (hi - lo - sum(z - a for a, z in busy)) * us,
        "idle_by_span": {k: v * us for k, v in idle.items()},
        "device_by_span": {k: v * us for k, v in by_span.items()},
        "device_events": len(device),
        "matched_events": matched,
        "sync_calls": syncs,
    }


def program_metrics(traced: dict | None, profiled: dict | None) -> dict:
    """The seven per-sweep figures: ``host_syncs`` (count),
    ``cp_als_solve_ms`` (``cp_als.update`` + ``cp_als.fit``),
    ``mttkrp_device_ms`` (the ``device_ms`` of ``plan.mttkrp``) from slice
    A; the card's idle ms under each attributed span from slice B."""
    out = dict.fromkeys(METRICS)
    if traced and traced["sweeps"]:
        n = traced["sweeps"]
        span_s = traced["span_s"]
        out["host_syncs"] = sum(traced["host_syncs"].values()) / n
        out["cp_als_solve_ms"] = (span_s.get("cp_als.update", 0.0)
                                  + span_s.get("cp_als.fit", 0.0)) / n * 1e3
        if traced["device_calls"]:
            out["mttkrp_device_ms"] = traced["device_ms"] / n
    if profiled and profiled["sweeps"]:
        n = profiled["sweeps"]
        for key, name in IDLE_METRICS.items():
            out[key] = profiled["idle_by_span"][name] / n * 1e3
    return out
