"""Static analysis + runtime sanitizer of the port.

``repro_torch.analysis`` mechanizes the invariants the port's code must
keep, as ``repro.analysis`` does for the reference:

* :mod:`repro_torch.analysis.linter` — the AST lint framework (a copy of
  the reference's) with the reference's six pass ids: copies of
  ``span-hygiene``, ``lock-discipline`` and ``fault-site-hygiene``, torch
  twins of ``dtype-promotion``, ``host-sync-in-hot-path`` and
  ``unfenced-timing``.  ``lint_paths`` over ``src/repro_torch/`` and
  ``chip_smoke.py`` against ``analysis/lint_baseline.json``
  (``tests/test_torch_lint.py``).
* :mod:`repro_torch.analysis.sanitize` — the runtime sanitizer
  (``REPRO_SANITIZE=1`` or ``plan_for(..., sanitize=True)``) wrapping any
  ExecutionPlan with shape, dtype and finiteness contracts, and auditing
  the service's admission ledger and lock discipline.
* :mod:`repro_torch.analysis.trace` — the trace tier: the op audit of the
  registered hot paths (host transfers, dtype narrowing, duplicate-index
  writes; the card's sync debug mode), cache-key bounds, symbolic BLCO
  encoding proofs, and the write structure of the fused variants with
  the per-launch conflict report.  ``run_trace_tier()``.
"""
import os

from .linter import (Baseline, Finding, LintPass, ParsedModule,  # noqa: F401
                     all_passes, lint_paths, lint_sources)
from .sanitize import (SanitizedPlan, SanitizerError, check_factors,
                       sanitize_enabled, sanitized, set_sanitize, wrap_plan)

#: the port's committed lint baseline, beside this package
BASELINE_PATH = os.path.join(os.path.dirname(__file__), "lint_baseline.json")


def run_trace_tier(**kwargs):
    """Lazy entry to :func:`repro_torch.analysis.trace.run_trace_tier`."""
    from .trace import run_trace_tier as _run
    return _run(**kwargs)


__all__ = ["BASELINE_PATH", "Baseline", "Finding", "LintPass",
           "ParsedModule", "SanitizedPlan", "SanitizerError",
           "all_passes", "check_factors", "lint_paths", "lint_sources",
           "run_trace_tier", "sanitize_enabled", "sanitized",
           "set_sanitize", "wrap_plan"]
