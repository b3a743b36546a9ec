"""Observability of the port: spans, histograms, bandwidth ledger,
roofline, SLOs and exporters (the port's copy of ``repro.obs``).

    trace    context-manager spans + already-measured events into a
             thread-safe bounded ring buffer; zero-cost when disabled
    hist     fixed log2-bucket histograms (dispatch latency, H2D copy
             time, disk read time, per-launch nnz) in ``EngineStats.hist``
    ledger   memory-hierarchy bandwidth accounting: (bytes, seconds,
             ops, flops) per tier edge (disk->host, host->device,
             device HBM), per regime, and per (tenant, job); exact
             conservation against ``EngineStats`` by construction
    roofline achieved GB/s per edge + arithmetic intensity and
             memory/compute-bound classification per regime
    slo      latency objectives + burn rates over the scheduler hists,
             and the background ``TelemetryExporter``
    export   Chrome trace-event JSON (one track per pipeline stage) and
             Prometheus text exposition (``render_prometheus``)

Quick use::

    from repro_torch import obs
    obs.enable()                       # or: with obs.trace.enabled(): ...
    obs.ledger.enable()
    ... run a plan ...
    obs.write_chrome_trace("trace.json")
    report = obs.roofline_report(peaks={...}, peak_flops=...)
"""
from . import ledger, roofline, slo, trace
from .export import (chrome_trace, render_prometheus, track_totals,
                     write_chrome_trace)
from .hist import EngineHists, Hist, ServiceHists, TenantHists
from .ledger import (DEVICE_HBM, DISK_HOST, EDGES, HOST_DEVICE, LEDGER,
                     hbm_model_bytes, job_scope, mttkrp_flops,
                     verify_conservation)
from .roofline import roofline_report
from .slo import DEFAULT_SLOS, SLO, TelemetryExporter, slo_report
from .trace import (TRACING, add_event, clear, disable, drain, enable,
                    is_enabled, span, spans)

__all__ = [
    "trace", "TRACING", "span", "add_event", "enable", "disable",
    "is_enabled", "clear", "spans", "drain",
    "Hist", "EngineHists", "ServiceHists", "TenantHists",
    "chrome_trace", "write_chrome_trace", "track_totals",
    "render_prometheus",
    "ledger", "LEDGER", "EDGES", "DISK_HOST", "HOST_DEVICE", "DEVICE_HBM",
    "job_scope", "hbm_model_bytes", "mttkrp_flops", "verify_conservation",
    "roofline", "roofline_report",
    "slo", "SLO", "DEFAULT_SLOS", "slo_report", "TelemetryExporter",
]
