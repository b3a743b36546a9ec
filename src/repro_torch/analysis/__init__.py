"""Runtime analysis of the port: the plan sanitizer.

:mod:`repro_torch.analysis.sanitize` wraps any ExecutionPlan with shape,
dtype and finiteness contracts (``REPRO_SANITIZE=1`` or
``plan_for(..., sanitize=True)``).  The JAX package's static linter and
trace tier (``repro.analysis``) are not ported yet.
"""
from .sanitize import (SanitizedPlan, SanitizerError, check_factors,
                       sanitize_enabled, sanitized, set_sanitize, wrap_plan)

__all__ = ["SanitizedPlan", "SanitizerError", "check_factors",
           "sanitize_enabled", "sanitized", "set_sanitize", "wrap_plan"]
