"""Runtime sanitizer: contract checks over any ExecutionPlan + the service.

The port of ``repro.analysis.sanitize``.  Enabled via ``REPRO_SANITIZE=1``
(read dynamically, so tests can flip it per case) or programmatically
(``plan_for(..., sanitize=True)``, or the ``sanitized()`` context
manager).  When enabled:

* every plan handed out by ``plan_for`` / the service engine is wrapped in
  a :class:`SanitizedPlan` enforcing the mttkrp boundary contract —
  factor shapes against the tensor dims, output shape ``(dims[mode],
  rank)``, no silent dtype downcast below the promoted input dtype, and a
  NaN/Inf guard on the result;
* the scheduler audits its admission ledger on every admit/retire edge:
  the byte total it charged must equal the engine's live pooled bytes
  plus the active jobs' factor working sets;
* scheduler mutations assert the runtime lock is held by the calling
  thread whenever a :class:`~repro_torch.service.runtime.ServiceRuntime`
  owns the scheduler (``guard_lock``);
* factor updates are checked finite after every ALS sweep.

All checks raise :class:`SanitizerError` (an ``AssertionError`` subclass,
so ``pytest.raises(AssertionError)`` also catches it).  The wrapper only
*reads* plan outputs — a sanitized plan is bit-identical to a plain one.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

_ENV_VAR = "REPRO_SANITIZE"
_FALSY = ("", "0", "false", "False", "no")

# tri-state programmatic override: None -> follow the environment
_override: bool | None = None
_override_lock = threading.Lock()


class SanitizerError(AssertionError):
    """A runtime contract the sanitizer enforces was violated."""


def sanitize_enabled() -> bool:
    """True when sanitizer checks should run (override beats environment)."""
    if _override is not None:
        return _override
    return os.environ.get(_ENV_VAR, "") not in _FALSY


def set_sanitize(value: bool | None) -> None:
    """Force the sanitizer on/off; ``None`` returns control to the env."""
    global _override
    with _override_lock:
        _override = value


class sanitized:
    """``with sanitized(): ...`` — scoped sanitizer enable for tests."""

    def __init__(self, value: bool = True):
        self.value = value
        self._prev: bool | None = None

    def __enter__(self) -> "sanitized":
        self._prev = _override
        set_sanitize(self.value)
        return self

    def __exit__(self, *exc) -> bool:
        set_sanitize(self._prev)
        return False


# ------------------------------------------------------------------ plans
def _torch_dtype(dtype) -> torch.dtype:
    """A numpy or torch dtype as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _plan_value_dtype(plan):
    """Best-effort tensor value dtype of a plan (None when unknowable)."""
    stored = getattr(plan, "stored", None)
    if stored is not None and getattr(stored, "value_dtype", None) is not None:
        return stored.value_dtype
    blco = getattr(plan, "blco", None)
    if blco is not None and getattr(blco, "values", None) is not None:
        return blco.values.dtype
    return None


class SanitizedPlan:
    """Transparent ExecutionPlan wrapper enforcing the mttkrp contract.

    Everything except ``mttkrp`` passes straight through, and ``mttkrp``
    only *inspects* inputs and output — the returned tensor is the inner
    plan's result object itself, so sanitized and plain execution are
    bit-identical.
    """

    def __init__(self, plan):
        if type(plan) is SanitizedPlan:
            plan = plan._plan       # idempotent: never double-wrap
        object.__setattr__(self, "_plan", plan)

    def __getattr__(self, name):
        return getattr(self._plan, name)

    @property
    def __class__(self):  # noqa: D401 — transparent-proxy identity
        # ``isinstance(plan, DiskStreamedPlan)`` must see through the
        # wrapper (callers branch on the plan's regime); ``type(plan)``
        # still reports SanitizedPlan for tests asserting the wrap itself
        return type(self._plan)

    def __repr__(self) -> str:
        return f"SanitizedPlan({self._plan!r})"

    @property
    def plan(self):
        """The wrapped plan (for tests asserting on the inner object)."""
        return self._plan

    def mttkrp(self, factors, mode: int, *args, **kwargs):
        dims = tuple(self._plan.dims)
        factors = tuple(factors)
        if len(factors) != len(dims):
            raise SanitizerError(
                f"mttkrp contract: {len(factors)} factor matrices for an "
                f"order-{len(dims)} tensor (dims {dims})")
        if not 0 <= int(mode) < len(dims):
            raise SanitizerError(
                f"mttkrp contract: mode {mode} out of range for dims {dims}")
        rank = int(factors[0].shape[1])
        for i, f in enumerate(factors):
            shape = tuple(f.shape)
            if shape != (dims[i], rank):
                raise SanitizerError(
                    f"mttkrp contract: factor {i} has shape {shape}, "
                    f"expected ({dims[i]}, {rank}) for dims {dims}")
        out = self._plan.mttkrp(factors, mode, *args, **kwargs)
        if tuple(out.shape) != (dims[mode], rank):
            raise SanitizerError(
                f"mttkrp contract: output shape {tuple(out.shape)} != "
                f"({dims[mode]}, {rank}) for mode {mode}")
        expected = _torch_dtype(factors[0].dtype)
        for f in factors[1:]:
            expected = torch.promote_types(expected, _torch_dtype(f.dtype))
        val_dtype = _plan_value_dtype(self._plan)
        if val_dtype is not None:
            expected = torch.promote_types(expected, _torch_dtype(val_dtype))
        if torch.promote_types(out.dtype, expected) != out.dtype:
            raise SanitizerError(
                f"mttkrp contract: output dtype {out.dtype} is narrower "
                f"than the promoted input dtype {expected} — silent "
                f"downcast")
        if not bool(torch.isfinite(out).all()):
            raise SanitizerError(
                f"mttkrp contract: non-finite values in the mode-{mode} "
                f"output")
        return out


def wrap_plan(plan, enable: bool | None = None):
    """Wrap ``plan`` when the sanitizer is (or is forced) on."""
    if plan is None:
        return None
    on = sanitize_enabled() if enable is None else enable
    if not on or type(plan) is SanitizedPlan:
        return plan
    return SanitizedPlan(plan)


# ---------------------------------------------------------------- service
def check_factors(arrays, where: str) -> None:
    """NaN/Inf guard over factor matrices (no-op when disabled)."""
    if not sanitize_enabled():
        return
    for i, arr in enumerate(arrays):
        if not bool(torch.isfinite(torch.as_tensor(arr)).all()):
            raise SanitizerError(f"non-finite factor matrix {i} ({where})")


def audit_scheduler(scheduler, where: str) -> None:
    """Ledger audit: charged bytes == measured resident bytes.

    Pooled accounting: a pool entry is charged by whichever plan created
    it and released by whichever closes last, so between those events the
    entry's bytes live in the ledger but in no single active plan's
    ``device_bytes()``.  The measured quantity is therefore the engine's
    live pool footprint plus every active job's private factor working
    set (``_working`` on pooled plans; unpooled plans fall back to their
    full ``device_bytes()``).
    """
    if not sanitize_enabled():
        return
    held = 0
    for job_id in scheduler.active:
        plan = scheduler.jobs[job_id].plan
        if plan is None:
            continue
        working = getattr(plan, "_working", None)
        held += working if working is not None else plan.device_bytes()
    pooled_fn = getattr(scheduler.engine, "pooled_bytes", None)
    pooled = pooled_fn() if pooled_fn is not None else 0
    ledger = scheduler.metrics.admitted_reservation_bytes
    if held + pooled != ledger:
        raise SanitizerError(
            f"admission ledger out of sync at {where}: ledger holds "
            f"{ledger} B but pools measure {pooled} B + active working "
            f"sets {held} B (PR-4 overcommit bug class)")


def assert_owned(lock, what: str) -> None:
    """Assert the calling thread holds ``lock`` (RLock ownership check)."""
    if lock is None:
        return
    is_owned = getattr(lock, "_is_owned", None)
    if is_owned is not None and not is_owned():
        raise SanitizerError(
            f"{what} requires the runtime lock, but the calling thread "
            f"does not hold it — unsynchronized scheduler access")


def assert_scheduler_guard(scheduler, what: str) -> None:
    """Lock-order assertion for runtime-owned schedulers (no-op when the
    scheduler is driven synchronously without a runtime)."""
    if not sanitize_enabled():
        return
    assert_owned(getattr(scheduler, "guard_lock", None), what)
