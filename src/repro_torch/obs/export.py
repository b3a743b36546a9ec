"""Exporters: Chrome trace-event JSON (Perfetto) + Prometheus text (the
port's copy of ``repro.obs.export``).

* :func:`chrome_trace` turns recorded spans into the Chrome trace-event
  format (Perfetto loads it directly).  Each pipeline stage gets its own
  named track (``store`` / ``h2d`` / ``dispatch`` / ``device`` /
  ``plan`` / ...), so H2D-vs-compute overlap in the streamed regimes is
  visible: a healthy pipeline shows the ``h2d`` track's puts running
  under the ``device`` track's fenced span.

* :func:`render_prometheus` renders a service's metrics object in the
  Prometheus text exposition format (v0.0.4): counters and gauges become
  ``repro_*`` samples, per-tenant iteration counts a labelled counter,
  and every :class:`~repro_torch.obs.hist.Hist` a native Prometheus
  histogram (cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``).
"""
from __future__ import annotations

import json
import math

from . import ledger as _ledger
from . import trace as _trace

# Stable track ordering for the Perfetto view: pipeline order, top-down.
_TRACK_ORDER = ("scheduler", "plan", "store", "h2d", "dispatch", "device",
                "registry", "main")


def _json_safe(v):
    if isinstance(v, (bool, int, str)) or v is None:
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else repr(v)
    return repr(v)


def chrome_trace(spans=None) -> dict:
    """Chrome trace-event JSON dict of ``spans`` (default: the ring buffer).

    One track (= trace "thread") per pipeline stage, named via metadata
    events; spans become complete ("X") events with microsecond
    timestamps relative to the tracer epoch and their attributes under
    ``args``.
    """
    if spans is None:
        spans = _trace.spans()
    epoch = _trace.TRACING.epoch_s
    tracks: dict[str, int] = {}

    def tid(track: str) -> int:
        if track not in tracks:
            # deterministic ids: known pipeline stages first, then arrival
            if track in _TRACK_ORDER:
                tracks[track] = _TRACK_ORDER.index(track) + 1
            else:
                tracks[track] = len(_TRACK_ORDER) + 1 + len(
                    [t for t in tracks if t not in _TRACK_ORDER])
        return tracks[track]

    events = []
    for s in spans:
        ev = {
            "ph": "X",
            "name": s.name,
            "cat": s.track,
            "pid": 1,
            "tid": tid(s.track),
            "ts": (s.start_s - epoch) * 1e6,
            "dur": s.duration_s * 1e6,
        }
        args = {k: _json_safe(v) for k, v in s.attrs.items()}
        if s.parent is not None:
            args["parent"] = s.parent
        if args:
            ev["args"] = args
        events.append(ev)

    meta = [{"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "repro-blco"}}]
    for track, t in sorted(tracks.items(), key=lambda kv: kv[1]):
        meta.append({"ph": "M", "pid": 1, "tid": t, "name": "thread_name",
                     "args": {"name": track}})
        meta.append({"ph": "M", "pid": 1, "tid": t,
                     "name": "thread_sort_index",
                     "args": {"sort_index": t}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "otherData": {"dropped_spans": _trace.TRACING.dropped}}


def write_chrome_trace(path: str, spans=None) -> dict:
    """Write :func:`chrome_trace` to ``path``; returns the trace dict."""
    doc = chrome_trace(spans)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return doc


def track_totals(spans=None) -> dict:
    """Summed span duration (seconds) per track — the cross-check against
    ``EngineStats``/histogram totals (span sums must agree with the stats
    the same timestamps fed)."""
    if spans is None:
        spans = _trace.spans()
    totals: dict[str, float] = {}
    for s in spans:
        totals[s.track] = totals.get(s.track, 0.0) + s.duration_s
    return totals


# ----------------------------------------------------------------- prometheus
def _prom_num(v) -> str:
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v)) if isinstance(v, float) else str(int(v))


def _prom_hist_samples(name: str, hist, out: list,
                       labels: str = "") -> None:
    """Bucket/sum/count sample lines only (HELP/TYPE emitted by caller —
    labelled series share one metadata block per metric name)."""
    sep = f"{labels}," if labels else ""
    for le, cum in hist.cumulative():
        out.append(f'{name}_bucket{{{sep}le="{_prom_num(le)}"}} {cum}')
    suffix = f"{{{labels}}}" if labels else ""
    out.append(f"{name}_sum{suffix} {_prom_num(hist.sum)}")
    out.append(f"{name}_count{suffix} {hist.count}")


def _prom_hist(name: str, hist, help_text: str, out: list) -> None:
    out.append(f"# HELP {name} {help_text}")
    out.append(f"# TYPE {name} histogram")
    _prom_hist_samples(name, hist, out)


_COUNTER_KEYS = (
    "jobs_submitted", "jobs_admitted", "jobs_completed", "jobs_failed",
    "jobs_cancelled", "preemptions", "cancel_freed_bytes_total",
    "blco_cache_hits", "blco_cache_misses", "blco_disk_hits",
    "spills", "spill_bytes_total", "loads", "store_rebuilds",
    "jobs_restored", "retries_total", "giveups_total", "demotions_total",
    "watchdog_restarts", "iterations_total", "h2d_bytes_total",
    "disk_bytes_total", "disk_time_s_total", "launches_total",
)

_GAUGE_KEYS = (
    "queue_depth", "running_jobs", "host_budget_used_bytes",
    "admitted_reservation_bytes", "peak_admitted_reservation_bytes",
    "uptime_s", "busy_time_s",
)

_HIST_HELP = {
    "queue_wait_s": "Job wait from submission to admission (seconds)",
    "quantum_s": "Scheduler quantum duration: one ALS sweep (seconds)",
    "dispatch_s": "Per-launch host dispatch latency (seconds)",
    "put_chunk_s": "Per-chunk H2D transfer issue time (seconds)",
    "disk_read_s": "Per-chunk store fetch time (seconds)",
    "launch_nnz": "True nnz per executed launch",
}


def render_prometheus(metrics, *, prefix: str = "repro") -> str:
    """Prometheus text exposition of a ``ServiceMetrics``.

    ``metrics`` is the live ``ServiceMetrics`` object (histograms need
    their bucket arrays, which the JSON ``snapshot()`` flattens).
    """
    out: list[str] = []
    for key in _COUNTER_KEYS:
        out.append(f"# TYPE {prefix}_{key} counter")
        out.append(f"{prefix}_{key} {_prom_num(getattr(metrics, key))}")
    out.append(f"# TYPE {prefix}_tenant_iterations_total counter")
    for tenant, n in sorted(metrics.tenant_iterations.items()):
        out.append(f'{prefix}_tenant_iterations_total'
                   f'{{tenant="{tenant}"}} {n}')
    for key in _GAUGE_KEYS:
        value = getattr(metrics, key)
        out.append(f"# TYPE {prefix}_{key} gauge")
        out.append(f"{prefix}_{key} {_prom_num(value)}")
    out.append(f"# TYPE {prefix}_iterations_per_busy_sec gauge")
    out.append(f"{prefix}_iterations_per_busy_sec "
               f"{_prom_num(metrics.iterations_per_sec())}")
    for name, hist_obj in (("queue_wait_s", metrics.hist.queue_wait_s),
                           ("quantum_s", metrics.hist.quantum_s),
                           ("dispatch_s", metrics.hist.dispatch_s),
                           ("put_chunk_s", metrics.hist.put_chunk_s),
                           ("disk_read_s", metrics.hist.disk_read_s),
                           ("launch_nnz", metrics.hist.launch_nnz)):
        _prom_hist(f"{prefix}_{name}", hist_obj, _HIST_HELP[name], out)
    # per-tenant scheduler latency hists (bounded label cardinality; the
    # unlabelled series above are the lossless rollup)
    for name in ("queue_wait_s", "quantum_s"):
        tenants = sorted(metrics.hist.tenant)
        if not tenants:
            continue
        full = f"{prefix}_tenant_{name}"
        out.append(f"# HELP {full} {_HIST_HELP[name]}, per tenant")
        out.append(f"# TYPE {full} histogram")
        for tenant in tenants:
            _prom_hist_samples(full, getattr(metrics.hist.tenant[tenant],
                                             name),
                               out, labels=f'tenant="{tenant}"')
    # tracer ring-buffer state: drops were previously visible only on the
    # Python object; a scrape now sees buffer pressure and whether the
    # tracer (and its overhead) is live at all
    out.append(f"# TYPE {prefix}_trace_dropped_spans_total counter")
    out.append(f"{prefix}_trace_dropped_spans_total "
               f"{_trace.TRACING.dropped}")
    out.append(f"# TYPE {prefix}_trace_enabled gauge")
    out.append(f"{prefix}_trace_enabled "
               f"{1 if _trace.TRACING.enabled else 0}")
    out.append(f"# TYPE {prefix}_trace_buffered_spans gauge")
    out.append(f"{prefix}_trace_buffered_spans {len(_trace.TRACING.buf)}")
    out.append(f"# TYPE {prefix}_trace_capacity_spans gauge")
    out.append(f"{prefix}_trace_capacity_spans "
               f"{_trace.TRACING.buf.maxlen}")
    # bandwidth-ledger state + per-edge totals (labelled by tier edge)
    ledger_snap = _ledger.snapshot()
    out.append(f"# TYPE {prefix}_ledger_enabled gauge")
    out.append(f"{prefix}_ledger_enabled "
               f"{1 if ledger_snap['enabled'] else 0}")
    for metric, kind in (("bytes_total", "counter"),
                         ("seconds_total", "counter"),
                         ("ops_total", "counter"),
                         ("gb_per_s", "gauge")):
        field = metric.replace("_total", "")
        out.append(f"# TYPE {prefix}_ledger_{metric} {kind}")
        for edge in _ledger.EDGES:
            acct = ledger_snap["edges"].get(edge)
            if acct is None:
                continue
            out.append(f'{prefix}_ledger_{metric}{{edge="{edge}"}} '
                       f'{_prom_num(acct[field])}')
    return "\n".join(out) + "\n"


_ANALYSIS_COUNTER_KEYS = (
    "hot_paths_traced", "jaxpr_eqns_walked", "encodings_verified",
    "launches_analyzed", "findings_total", "findings_jaxpr_audit",
    "findings_cache_churn", "findings_encoding", "findings_conflicts",
)

_ANALYSIS_GAUGE_KEYS = (
    "runtime_jaxpr_audit_s", "runtime_cache_churn_s", "runtime_encoding_s",
    "runtime_conflicts_s", "runtime_total_s",
)


def render_prometheus_analysis(metrics, *,
                               prefix: str = "repro_analysis") -> str:
    """Prometheus text exposition of a trace-tier run's
    :class:`repro.analysis.trace.TraceVerifyMetrics` — per-family finding
    counts as counters, verifier runtimes as gauges, so CI scrapes give
    the static-analysis tier the same trend lines the service has.
    """
    out: list[str] = []
    for key in _ANALYSIS_COUNTER_KEYS:
        out.append(f"# TYPE {prefix}_{key} counter")
        out.append(f"{prefix}_{key} {_prom_num(getattr(metrics, key))}")
    for key in _ANALYSIS_GAUGE_KEYS:
        out.append(f"# TYPE {prefix}_{key} gauge")
        out.append(f"{prefix}_{key} {_prom_num(getattr(metrics, key))}")
    return "\n".join(out) + "\n"
