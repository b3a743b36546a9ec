"""Fault injection + typed retry (the port's copy of ``repro.faults``).

``inject`` produces deterministic, seeded faults at named pipeline sites
(``REPRO_FAULTS=<seed>:<spec>`` or a programmatic :class:`FaultPlan`);
``retry`` is the hardening that makes the transient ones survivable.
Both are zero-cost when disabled (one flag check, mirroring
``repro_torch.obs.trace``).
"""
from .inject import (ENV_VAR, FAULTS, SITES, AllocationError, FaultPlan,
                     FaultRule, FaultSpecError, FaultState, KernelFailure,
                     WorkerCrashError, active, exception_for, fire, install,
                     is_alloc_failure, maybe_fail, reload_from_env, uninstall)
from .retry import (DEFAULT_POLICY, TRANSIENT_TYPES, Permanent, RetryPolicy,
                    Transient, is_transient, retry_call)

__all__ = [
    "ENV_VAR", "FAULTS", "SITES", "AllocationError", "FaultPlan",
    "FaultRule", "FaultSpecError", "FaultState", "KernelFailure",
    "WorkerCrashError", "active", "exception_for", "fire", "install",
    "is_alloc_failure", "maybe_fail", "reload_from_env", "uninstall",
    "DEFAULT_POLICY", "TRANSIENT_TYPES", "Permanent", "RetryPolicy",
    "Transient", "is_transient", "retry_call",
]
