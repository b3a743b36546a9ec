"""Per-tenant latency SLOs + a background telemetry exporter (the port's
copy of ``repro.obs.slo``).

An SLO here is "fraction of samples at or under a latency threshold
must be >= target", evaluated over the scheduler's ``queue_wait_s`` /
``quantum_s`` histograms, globally and per tenant.  Evaluation is
*conservative*: the log2 histograms only know bucket upper bounds, so a
sample counts as good only when its whole bucket sits at or under the
threshold (``min``/``max`` shortcuts recover exactness at the extremes).
The burn rate is the error-budget ratio ``bad_fraction / (1 - target)``.

:class:`TelemetryExporter` is the push half: a daemon thread that
periodically appends a JSONL snapshot (metrics + SLO report + ledger)
and/or atomically rewrites a Prometheus textfile.  Nothing runs until
``start()``; ``stop()`` joins the thread.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

from . import ledger as _ledger
from .hist import Hist, bucket_le


@dataclasses.dataclass(frozen=True)
class SLO:
    """One latency objective over a named scheduler histogram."""
    name: str
    hist: str                 # "queue_wait_s" | "quantum_s"
    threshold_s: float
    target: float             # required good fraction, e.g. 0.99

    def config(self) -> dict:
        return dataclasses.asdict(self)


DEFAULT_SLOS = (
    SLO(name="queue_wait_under_1s", hist="queue_wait_s",
        threshold_s=1.0, target=0.99),
    SLO(name="quantum_under_4s", hist="quantum_s",
        threshold_s=4.0, target=0.95),
)


def fraction_le(hist: Hist, threshold_s: float) -> float:
    """Conservative fraction of samples <= threshold (1.0 on empty)."""
    if hist.count == 0:
        return 1.0
    if hist.max <= threshold_s:
        return 1.0
    if hist.min > threshold_s:
        return 0.0
    good = 0
    for i, c in enumerate(hist.counts):
        if c and bucket_le(i) <= threshold_s:
            good += c
    return good / hist.count


def evaluate(slo: SLO, hist: Hist) -> dict:
    """Evaluate one objective against one histogram (JSON-safe)."""
    good = fraction_le(hist, slo.threshold_s)
    bad = 1.0 - good
    budget = max(1.0 - slo.target, 1e-9)
    return {
        "name": slo.name,
        "hist": slo.hist,
        "threshold_s": slo.threshold_s,
        "target": slo.target,
        "samples": hist.count,
        "good_fraction": good,
        "met": good >= slo.target,
        "burn_rate": bad / budget,
    }


def slo_report(service_hists, slos=DEFAULT_SLOS) -> dict:
    """Evaluate every objective globally and per tenant.

    ``service_hists`` is a ``ServiceHists`` (global ``queue_wait_s`` /
    ``quantum_s`` plus the ``tenant`` slices).  Tenants beyond the label
    bound appear under ``"other"``, same as the histograms themselves.
    """
    out = {
        "slos": [s.config() for s in slos],
        "global": {s.name: evaluate(s, getattr(service_hists, s.hist))
                   for s in slos},
        "tenants": {},
    }
    for tenant, th in sorted(service_hists.tenant.items()):
        out["tenants"][tenant] = {s.name: evaluate(s, getattr(th, s.hist))
                                  for s in slos}
    return out


class TelemetryExporter:
    """Periodic background export of metrics/SLO/ledger snapshots.

    ``target`` is a ``DecompositionService`` or ``ServiceRuntime`` —
    anything with ``service_metrics()`` and ``get_slo()``.  At each tick
    the exporter appends one JSON line to ``jsonl_path`` (if set) and
    atomically replaces ``prom_path`` (if set) with the Prometheus
    exposition.  Export failures are counted, never raised into the
    timer thread.  Independent of the service worker thread by design.
    """

    def __init__(self, target, *, interval_s: float = 5.0,
                 jsonl_path: str | None = None,
                 prom_path: str | None = None,
                 slos=DEFAULT_SLOS):
        self._target = target
        self._interval_s = float(interval_s)
        self._jsonl_path = jsonl_path
        self._prom_path = prom_path
        self._slos = tuple(slos)
        self._lock = threading.Lock()
        self._stop_ev = threading.Event()
        self._thread = None
        self._exports = 0
        self._failures = 0

    # ------------------------------------------------------------ control
    def start(self) -> "TelemetryExporter":
        self._stop_ev.clear()
        with self._lock:
            if self._thread is not None:
                return self
            t = threading.Thread(target=self._loop,
                                 name="repro-telemetry", daemon=True)
            self._thread = t
        t.start()
        return self

    def stop(self, *, final_export: bool = True) -> None:
        self._stop_ev.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)
        if final_export:
            self.export_once()

    def __enter__(self) -> "TelemetryExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    def counters(self) -> dict:
        with self._lock:
            return {"exports": self._exports, "failures": self._failures}

    # ------------------------------------------------------------ export
    def _loop(self) -> None:
        while not self._stop_ev.wait(self._interval_s):
            self.export_once()

    def export_once(self) -> bool:
        """One synchronous export tick; returns success."""
        try:
            record = self._build_record()
            if self._jsonl_path:
                with open(self._jsonl_path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(record) + "\n")
            if self._prom_path:
                self._write_prom_textfile()
        except Exception:
            with self._lock:
                self._failures += 1
            return False
        with self._lock:
            self._exports += 1
        return True

    def _build_record(self) -> dict:
        return {
            "ts": time.time(),
            "metrics": self._target.service_metrics(),
            "slo": self._target.get_slo(),
            "ledger": _ledger.snapshot(),
        }

    def _write_prom_textfile(self) -> None:
        # imported here to avoid an export<->slo module cycle
        from .export import render_prometheus
        metrics = getattr(self._target, "metrics", None)
        if metrics is None:                      # runtime wraps a service
            metrics = self._target.service.metrics
        text = render_prometheus(metrics)
        tmp = f"{self._prom_path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(text)
        os.replace(tmp, self._prom_path)
