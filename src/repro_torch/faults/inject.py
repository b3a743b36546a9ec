"""Deterministic, seeded fault injection at named pipeline sites.

The port's copy of ``repro.faults.inject``: the same ``REPRO_FAULTS``
grammar, the same five sites and the same exception types, so a spec
that drives the JAX package drives the port.  Hardened code paths call
:func:`fire`/:func:`maybe_fail` with a site name, and an installed
:class:`FaultPlan` decides — deterministically, from a seed — whether
that particular call fails and how.

Zero-cost when disabled, like ``repro_torch.obs.trace``: the
module-level :data:`FAULTS` singleton carries one ``enabled`` flag; with
no plan installed every probe is a single attribute check and no
allocation.

Enable via the environment::

    REPRO_FAULTS="<seed>:<rule>(;<rule>)*"
    rule  = <site>[@<qual>(,<qual>)*][:<kind>]
    qual  = p=<float>   probabilistic: each call fails with probability p
          | n=<int>     nth-call: the n-th probe at this site fails (1-based)
          | times=<int> at most this many firings for the rule

    REPRO_FAULTS="7:store.read@p=0.3:transient;plan.alloc@n=1"

or programmatically (tests)::

    plan = FaultPlan(seed=7, rules=[FaultRule("stream.h2d", nth=2)])
    with active(plan):
        ...

Sites and their fault kinds, and where the port probes them:

    store.read       transient (OSError, retried) | corrupt | truncate
                     (StoreCorruptionError, permanent); every chunk read
                     of ``store.format.DiskChunkSource``
    plan.alloc       alloc (AllocationError -> the degradation ladder of
                     ``engine.plan_for``) | kernel (KernelFailure, which
                     propagates: the port has no fallback from the
                     kernel); ``LaunchCache.from_blco`` and the streamed
                     rung of ``plan_for``
    stream.h2d       transient (OSError on the host-to-device copy,
                     retried); every chunk of ``stream_mttkrp``
    runtime.quantum  exception | crash (WorkerCrashError, a
                     BaseException) — sites of the service, not ported
    factors.nan      nan — a site of the service, not ported
"""
from __future__ import annotations

import dataclasses
import os
import random
import threading

ENV_VAR = "REPRO_FAULTS"

# site -> allowed kinds; the FIRST kind is the default when a rule names
# none.
SITES: dict[str, tuple[str, ...]] = {
    "store.read": ("transient", "corrupt", "truncate"),
    "plan.alloc": ("alloc", "kernel"),
    "stream.h2d": ("transient",),
    "runtime.quantum": ("exception", "crash"),
    "factors.nan": ("nan",),
}


class AllocationError(RuntimeError):
    """Simulated device-memory allocation failure (``plan.alloc``)."""


class KernelFailure(RuntimeError):
    """Simulated kernel build/launch failure (``plan.alloc:kernel``)."""


class WorkerCrashError(BaseException):
    """Simulated worker-thread death (``runtime.quantum:crash``).

    Deliberately a ``BaseException``: the scheduler's job-isolation
    ``except Exception`` must NOT catch it — it models the whole worker
    dying mid-quantum (segfault, OOM-kill), the scenario the runtime
    watchdog exists for.
    """


class FaultSpecError(ValueError):
    """A ``REPRO_FAULTS`` spec (or FaultRule) failed validation."""


def is_alloc_failure(exc: BaseException) -> bool:
    """Device-memory exhaustion, injected or genuine.

    A genuine ``torch.cuda.OutOfMemoryError`` says "CUDA out of memory".
    The predicate ``plan_for``'s degradation ladder demotes on: only
    allocation failures fall a memory tier; anything else propagates.
    """
    if isinstance(exc, AllocationError):
        return True
    text = str(exc)
    return "RESOURCE_EXHAUSTED" in text or "out of memory" in text.lower()


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One injection rule: when probes at ``site`` fail, and how.

    Exactly one of ``p`` (probabilistic) or ``nth`` (the nth probe at the
    site, 1-based) selects calls; ``times`` caps total firings (defaults:
    1 for nth rules — fail once, let the retry succeed — unlimited for
    probabilistic rules).
    """
    site: str
    kind: str | None = None
    p: float | None = None
    nth: int | None = None
    times: int | None = None

    def __post_init__(self):
        if self.site not in SITES:
            raise FaultSpecError(
                f"unknown fault site {self.site!r}; declared sites: "
                f"{sorted(SITES)}")
        kind = self.kind if self.kind is not None else SITES[self.site][0]
        if kind not in SITES[self.site]:
            raise FaultSpecError(
                f"site {self.site!r} has no fault kind {kind!r}; "
                f"expected one of {SITES[self.site]}")
        object.__setattr__(self, "kind", kind)
        if (self.p is None) == (self.nth is None):
            raise FaultSpecError(
                f"rule for {self.site!r} must set exactly one of p= "
                f"(probabilistic) or n= (nth call)")
        if self.p is not None and not 0.0 < self.p <= 1.0:
            raise FaultSpecError(f"p must be in (0, 1], got {self.p!r}")
        if self.nth is not None and self.nth < 1:
            raise FaultSpecError(f"n must be >= 1, got {self.nth!r}")
        if self.times is None:
            object.__setattr__(self, "times",
                               1 if self.nth is not None else None)


class FaultPlan:
    """A seeded set of rules; thread-safe per-site call counting.

    Determinism: nth-call rules are exact regardless of threading; with
    probabilistic rules the *sequence* of random draws is fixed by the
    seed, so a single-threaded replay is exact and a threaded one varies
    only in which call receives each (fixed) draw.
    """

    def __init__(self, seed: int, rules=()):
        self.seed = int(seed)
        self.rules = tuple(rules)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._calls: dict[str, int] = {}
        self._fired: dict[int, int] = {}      # rule index -> firing count
        self.fired_log: list[tuple[str, str, int]] = []  # (site, kind, call#)
        self._by_site: dict[str, list[tuple[int, FaultRule]]] = {}
        for idx, rule in enumerate(self.rules):
            self._by_site.setdefault(rule.site, []).append((idx, rule))

    @classmethod
    def from_spec(cls, text: str) -> "FaultPlan":
        """Parse the ``REPRO_FAULTS`` grammar (see module docstring)."""
        seed_text, sep, spec = text.partition(":")
        if not sep:
            raise FaultSpecError(
                f"fault spec {text!r} missing '<seed>:' prefix")
        try:
            seed = int(seed_text)
        except ValueError as exc:
            raise FaultSpecError(
                f"fault spec seed {seed_text!r} is not an int") from exc
        rules = [_parse_rule(part) for part in spec.split(";") if part.strip()]
        if not rules:
            raise FaultSpecError(f"fault spec {text!r} declares no rules")
        return cls(seed, rules)

    def fire(self, site: str) -> str | None:
        """Count one probe at ``site``; the fault kind to inject, or None."""
        if site not in SITES:
            raise FaultSpecError(
                f"probe at undeclared fault site {site!r}; declared "
                f"sites: {sorted(SITES)}")
        with self._lock:
            call = self._calls.get(site, 0) + 1
            self._calls[site] = call
            for idx, rule in self._by_site.get(site, ()):
                fired = self._fired.get(idx, 0)
                if rule.times is not None and fired >= rule.times:
                    continue
                hit = (call == rule.nth) if rule.nth is not None \
                    else (self._rng.random() < rule.p)
                if hit:
                    self._fired[idx] = fired + 1
                    self.fired_log.append((site, rule.kind, call))
                    return rule.kind
        return None

    def calls(self, site: str) -> int:
        """Probes seen at ``site`` so far."""
        with self._lock:
            return self._calls.get(site, 0)

    def __repr__(self) -> str:
        return f"FaultPlan(seed={self.seed}, rules={list(self.rules)!r})"


def _parse_rule(text: str) -> FaultRule:
    head, sep, kind = text.strip().partition(":")
    site, qsep, quals = head.partition("@")
    kwargs: dict = {"site": site.strip(),
                    "kind": kind.strip() if sep else None}
    if qsep:
        for qual in quals.split(","):
            key, eq, value = qual.partition("=")
            key = key.strip()
            if not eq:
                raise FaultSpecError(f"malformed qualifier {qual!r} in "
                                     f"fault rule {text!r}")
            if key not in ("p", "n", "times"):
                raise FaultSpecError(
                    f"unknown qualifier {key!r} in fault rule {text!r}; "
                    f"expected p=, n=, or times=")
            try:
                if key == "p":
                    kwargs["p"] = float(value)
                elif key == "n":
                    kwargs["nth"] = int(value)
                else:
                    kwargs["times"] = int(value)
            except ValueError as exc:
                raise FaultSpecError(
                    f"bad value {value!r} for {key}= in fault rule "
                    f"{text!r}") from exc
    return FaultRule(**kwargs)


# --------------------------------------------------------------- singleton
class FaultState:
    """Module-level switch: hot paths read ``FAULTS.enabled`` once."""

    def __init__(self):
        self.enabled = False
        self.plan: FaultPlan | None = None
        self.lock = threading.Lock()


FAULTS = FaultState()


def install(plan: FaultPlan | str | None) -> FaultPlan | None:
    """Install a plan (or spec string) as THE active fault plan."""
    if isinstance(plan, str):
        plan = FaultPlan.from_spec(plan)
    with FAULTS.lock:
        FAULTS.plan = plan
        FAULTS.enabled = plan is not None
    return plan


def uninstall() -> None:
    install(None)


def reload_from_env() -> FaultPlan | None:
    """(Re-)install from ``REPRO_FAULTS``; uninstalls when unset/empty."""
    text = os.environ.get(ENV_VAR, "").strip()
    return install(text if text else None)


class active:
    """``with active(plan): ...`` — scoped installation for tests."""

    def __init__(self, plan: FaultPlan | str | None):
        self.plan = plan
        self._prev: FaultPlan | None = None

    def __enter__(self) -> FaultPlan | None:
        self._prev = FAULTS.plan
        return install(self.plan)

    def __exit__(self, *exc) -> bool:
        install(self._prev)
        return False


# ------------------------------------------------------------------ probes
def fire(site: str) -> str | None:
    """Probe ``site``: the fault kind to inject at this call, or None.

    The disabled path is one flag read — no locks, no allocation.
    """
    if not FAULTS.enabled:
        return None
    plan = FAULTS.plan
    return plan.fire(site) if plan is not None else None


def maybe_fail(site: str) -> None:
    """Probe ``site`` and raise the mapped exception when a rule fires."""
    if not FAULTS.enabled:
        return
    kind = fire(site)
    if kind is not None:
        raise exception_for(site, kind)


def exception_for(site: str, kind: str) -> BaseException:
    """The concrete exception an injected (site, kind) fault raises.

    Types are the REAL ones the hardened code paths classify on —
    ``OSError`` for transients (so the retry layer treats injected and
    genuine I/O failures identically), the store's typed corruption
    error for permanent damage, and so on.
    """
    msg = f"[fault-injection] {kind} fault at {site}"
    if site == "store.read":
        if kind == "transient":
            return OSError(msg)
        from repro_torch.store import StoreCorruptionError   # lazy: no import cycle
        return StoreCorruptionError(msg)
    if site == "plan.alloc":
        if kind == "kernel":
            return KernelFailure(msg)
        return AllocationError(msg)
    if site == "stream.h2d":
        return OSError(msg)
    if site == "runtime.quantum":
        if kind == "crash":
            return WorkerCrashError(msg)
        return RuntimeError(msg)
    raise FaultSpecError(f"no exception mapping for site {site!r} "
                         f"kind {kind!r} (probe with fire() instead)")


# Honour REPRO_FAULTS from process start, matching REPRO_SANITIZE's
# behaviour of being active without code changes.
reload_from_env()
