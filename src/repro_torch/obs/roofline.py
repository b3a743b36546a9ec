"""Roofline attribution over the bandwidth ledger (the port's copy of
``repro.obs.roofline``).

Turns :mod:`repro_torch.obs.ledger` accounts into achieved GB/s per tier
edge, arithmetic intensity per regime (flops from the rank/nnz model,
bytes from the ledger's HBM attribution), and a memory-vs-compute-bound
classification.

Classification needs machine ceilings.  ``peaks`` maps edge name ->
peak GB/s (measured on the machine, not a datasheet number) and
``peak_flops`` the device flop ceiling; without them the report still
carries bytes/seconds/GB/s but classifies ``"unknown"``.  The
``saturated_edge`` of a regime is the edge running closest to its
ceiling when fractions are available, else the edge where the regime
spends the most time.

Everything returned is a plain JSON-safe dict (no Inf/NaN).
"""
from __future__ import annotations

from . import ledger as _ledger

_GB = 1e9


def arithmetic_intensity(flops: float, hbm_bytes: float) -> float:
    """Flops per byte of device-HBM traffic (0 when nothing moved)."""
    if hbm_bytes <= 0.0:
        return 0.0
    return flops / hbm_bytes


def classify(ai: float, *, peak_flops: float | None,
             peak_hbm_gb_per_s: float | None) -> str:
    """Roofline side of the ridge: memory-bound iff the arithmetic
    intensity sits left of the machine balance point."""
    if not peak_flops or not peak_hbm_gb_per_s:
        return "unknown"
    balance = peak_flops / (peak_hbm_gb_per_s * _GB)
    return "memory_bound" if ai < balance else "compute_bound"


def _edge_report(acct: dict, peak: float | None) -> dict:
    out = {
        "bytes": acct.get("bytes", 0),
        "seconds": acct.get("seconds", 0.0),
        "ops": acct.get("ops", 0),
        "gb_per_s": acct.get("gb_per_s", 0.0),
    }
    if peak:
        out["peak_gb_per_s"] = peak
        out["achieved_fraction"] = out["gb_per_s"] / peak
    return out


def _saturated_edge(edges: dict) -> str | None:
    """Edge nearest its ceiling; falls back to largest time share when no
    fractions are present.  Only edges with measured seconds count."""
    best, best_frac = None, -1.0
    for edge, rep in edges.items():
        if rep.get("seconds", 0.0) <= 0.0:
            continue
        frac = rep.get("achieved_fraction")
        if frac is None:
            continue
        if frac > best_frac:
            best, best_frac = edge, frac
    if best is not None:
        return best
    for edge, rep in sorted(edges.items(),
                            key=lambda kv: kv[1].get("seconds", 0.0),
                            reverse=True):
        if rep.get("seconds", 0.0) > 0.0:
            return edge
    return None


def roofline_report(snap: dict | None = None, *,
                    peaks: dict | None = None,
                    peak_flops: float | None = None) -> dict:
    """Build the machine-readable roofline from a ledger snapshot.

    ``snap`` defaults to ``ledger.snapshot()``.  Returns::

        {"edges":   {edge: {bytes, seconds, ops, gb_per_s,
                            [peak_gb_per_s, achieved_fraction]}},
         "regimes": {regime: {"edges": {...}, "flops",
                              "arithmetic_intensity", "gflops_per_s",
                              "bound", "saturated_edge"}},
         "peaks":   {...}, "peak_flops": ...}

    ``arithmetic_intensity`` divides the regime's flops by its
    *model-attributed* device_hbm bytes (see ``ledger.hbm_model_bytes``);
    ``bound`` applies :func:`classify` against the supplied ceilings.
    """
    if snap is None:
        snap = _ledger.snapshot()
    peaks = peaks or {}
    hbm_peak = peaks.get(_ledger.DEVICE_HBM)

    edges = {e: _edge_report(a, peaks.get(e))
             for e, a in snap.get("edges", {}).items()}

    regimes = {}
    for regime, per_edge in snap.get("regimes", {}).items():
        redges = {e: _edge_report(a, peaks.get(e))
                  for e, a in per_edge.items()}
        hbm = per_edge.get(_ledger.DEVICE_HBM, {})
        flops = hbm.get("flops", 0.0)
        hbm_bytes = float(hbm.get("bytes", 0))
        hbm_seconds = hbm.get("seconds", 0.0)
        ai = arithmetic_intensity(flops, hbm_bytes)
        regimes[regime] = {
            "edges": redges,
            "flops": flops,
            "arithmetic_intensity": ai,
            "gflops_per_s": (flops / hbm_seconds / _GB)
            if hbm_seconds > 0.0 else 0.0,
            "bound": classify(ai, peak_flops=peak_flops,
                              peak_hbm_gb_per_s=hbm_peak),
            "saturated_edge": _saturated_edge(redges),
        }

    return {"edges": edges, "regimes": regimes,
            "peaks": dict(peaks), "peak_flops": peak_flops}
