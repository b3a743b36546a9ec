"""Trace-tier verifier metrics: runtime + finding counters for trends.

The reference's ``TraceVerifyMetrics``, copied, with its key names: one
per tier run, filled by ``run_trace_tier`` and exported as ``snapshot()``
(a JSON-safe dict with the reference's keys) and by
:func:`repro_torch.obs.export.render_prometheus_analysis`.  The port has
no jaxprs: its ``jaxpr_audit`` family is the op audit of the registered
hot paths (``trace.op_audit``), ``hot_paths_traced`` counts the paths it
ran and ``jaxpr_eqns_walked`` the torch calls its recorder saw.
"""
from __future__ import annotations

import dataclasses

#: family key per pass id — how findings are bucketed into counters
FAMILY_OF_PASS = {
    "trace-host-callback": "jaxpr_audit",
    "trace-dtype-narrowing": "jaxpr_audit",
    "trace-cache-churn": "cache_churn",
    "trace-encoding": "encoding",
    "trace-write-conflict": "conflicts",
}


@dataclasses.dataclass
class TraceVerifyMetrics:
    """Counters/gauges of one trace-tier run (grow-only snapshot keys)."""
    hot_paths_traced: int = 0
    jaxpr_eqns_walked: int = 0
    encodings_verified: int = 0
    launches_analyzed: int = 0
    findings_total: int = 0
    findings_jaxpr_audit: int = 0
    findings_cache_churn: int = 0
    findings_encoding: int = 0
    findings_conflicts: int = 0
    runtime_jaxpr_audit_s: float = 0.0
    runtime_cache_churn_s: float = 0.0
    runtime_encoding_s: float = 0.0
    runtime_conflicts_s: float = 0.0
    runtime_total_s: float = 0.0

    def count_findings(self, findings) -> None:
        for f in findings:
            self.findings_total += 1
            family = FAMILY_OF_PASS.get(f.pass_id)
            if family is not None:
                attr = f"findings_{family}"
                setattr(self, attr, getattr(self, attr) + 1)

    def snapshot(self) -> dict:
        return {
            "hot_paths_traced": self.hot_paths_traced,
            "jaxpr_eqns_walked": self.jaxpr_eqns_walked,
            "encodings_verified": self.encodings_verified,
            "launches_analyzed": self.launches_analyzed,
            "findings_total": self.findings_total,
            "findings_jaxpr_audit": self.findings_jaxpr_audit,
            "findings_cache_churn": self.findings_cache_churn,
            "findings_encoding": self.findings_encoding,
            "findings_conflicts": self.findings_conflicts,
            "runtime_jaxpr_audit_s": self.runtime_jaxpr_audit_s,
            "runtime_cache_churn_s": self.runtime_cache_churn_s,
            "runtime_encoding_s": self.runtime_encoding_s,
            "runtime_conflicts_s": self.runtime_conflicts_s,
            "runtime_total_s": self.runtime_total_s,
        }
