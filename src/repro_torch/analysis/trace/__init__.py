"""Trace-tier analysis: verification of what executes and what the format
encodes.

The port's counterpart of ``repro.analysis.trace``.  The AST tier
(``repro_torch.analysis.linter`` + ``passes``) checks Python source; this
tier checks what actually executes and what the format actually encodes:

* :mod:`.op_audit`   — host transfers, dtype narrowing on accumulation
  edges and duplicate-index writes, recorded while the registered hot
  paths (:mod:`.hotpaths`) run (the port has no jaxpr to walk); on the
  card also under ``torch.cuda.set_sync_debug_mode("error")``;
* :mod:`.cachekeys`  — reservation roundings bounded and tenant-invariant,
  and the kernels' per-process occupancy keys independent of launch nnz
  and tenant count;
* :mod:`.encoding`   — symbolic proofs that the BLCO bit layout is
  lossless, u64-safe, int32-safe, gather-in-bounds and padded-lane-
  no-op for any ``BuildParams`` (the reference's, copied);
* :mod:`.conflicts`  — the plain fused variants' write structure plus
  the per-launch machine-readable conflict report that K4 is held to.

Findings are plain :class:`repro_torch.analysis.Finding` objects, so the
AST tier's baseline and suppression machinery applies unchanged.  Run it
with ``run_trace_tier()`` (the small paths on the card by default,
``device="cpu"`` for the plain paths on the host, or ``hot_paths=`` built
over a real launch cache).
"""
from __future__ import annotations

import time

from repro_torch.core.device import DEFAULT_DEVICE

from .cachekeys import (PASS_CHURN, audit_occupancy_keys,  # noqa: F401
                        audit_reservation_churn, audit_tenant_invariance,
                        churn_bound, enumerate_reservations, launch_keys,
                        shipped_roundings)
from .conflicts import (audit_conflicts, check_scatter_claims,  # noqa: F401
                        check_write_structure, conflict_report, k4_runs,
                        prove_variant, report_runs, write_facts)
from .encoding import (DEFAULT_CONFIGS, PASS_ENCODING,  # noqa: F401
                       EncodingProof, audit_encodings, prove_encoding,
                       verify_layout)
from .hotpaths import HotPath, registered_hot_paths  # noqa: F401
from .metrics import TraceVerifyMetrics  # noqa: F401
from .op_audit import (PASS_CALLBACK, PASS_CONFLICT,  # noqa: F401
                       PASS_NARROWING, OpRecorder, audit_hot_path)

TRACE_PASS_IDS = (PASS_CALLBACK, PASS_NARROWING, PASS_CHURN, PASS_ENCODING,
                  PASS_CONFLICT)


def run_trace_tier(*, metrics: TraceVerifyMetrics | None = None,
                   hot_paths=None, device=DEFAULT_DEVICE):
    """Run every verifier family; returns ``(findings, report, metrics)``.

    ``hot_paths`` defaults to ``registered_hot_paths(device=device)``:
    the small paths on the card, which raises where there is none, or on
    the CPU with ``device="cpu"``.  ``report`` is the artifact bundle:
    the write-conflict report (the per-launch conflict structure K4 is
    held to) plus the encoding
    proofs, the verifier metrics snapshot and, per hot path, what its
    audit saw (torch calls, indexed writes, findings, refusals under an
    inline disable, seconds).
    """
    m = metrics if metrics is not None else TraceVerifyMetrics()
    findings = []
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    audited = []
    for hp in (hot_paths if hot_paths is not None
               else registered_hot_paths(device=device)):
        rec = OpRecorder(path=hp.path, symbol=hp.name)
        t1 = time.perf_counter()
        found = audit_hot_path(hp, recorder=rec)
        findings.extend(found)
        m.hot_paths_traced += 1
        m.jaxpr_eqns_walked += rec.calls
        audited.append({"name": hp.name, "path": hp.path,
                        "device": str(hp.device), "dims": list(hp.dims),
                        "calls": rec.calls, "writes": len(rec.writes),
                        "findings": len(found), "suppressed": rec.suppressed,
                        "seconds": time.perf_counter() - t1})
    m.runtime_jaxpr_audit_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    findings.extend(audit_reservation_churn())
    findings.extend(audit_tenant_invariance())
    findings.extend(audit_occupancy_keys())
    m.runtime_cache_churn_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    proofs, enc_findings = audit_encodings()
    m.encodings_verified = len(proofs)
    findings.extend(enc_findings)
    m.runtime_encoding_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    conflict_findings, report = audit_conflicts()
    findings.extend(conflict_findings)
    m.launches_analyzed = len(report["launches"])
    m.runtime_conflicts_s = time.perf_counter() - t0

    m.runtime_total_s = time.perf_counter() - t_start
    m.count_findings(findings)
    bundle = {
        "conflict_report": report,
        "encoding_proofs": [p.snapshot() for p in proofs],
        "metrics": m.snapshot(),
        "hot_paths": audited,
    }
    return findings, bundle, m
