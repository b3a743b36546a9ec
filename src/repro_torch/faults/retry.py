"""Typed retry with exponential backoff + jitter.

The hardening counterpart of ``inject``: pipeline stages that touch
unreliable media (disk reads feeding the stream, H2D puts) wrap their
fallible call in :func:`retry_call`.  Errors are classified by a small
taxonomy:

* **transient** — worth retrying: ``OSError`` / ``ConnectionError`` /
  ``TimeoutError`` (real or injected I/O flake) and anything raised as
  :class:`Transient`;
* **permanent** — re-raised immediately: everything else, including the
  store's typed ``StoreCorruptionError`` (corrupt bytes do not get better
  on re-read) and anything raised as :class:`Permanent`.

Every retry increments ``stats.retries`` (an ``EngineStats`` field) and
records a ``retry.attempt`` obs span; exhausting the policy increments
``stats.giveups`` and re-raises the last error.  The port's copy of
``repro.faults.retry``.
"""
from __future__ import annotations

import dataclasses
import random
import time

from repro_torch.obs import trace as obs_trace


class Transient(Exception):
    """An explicitly-retryable failure (wrap a cause to force retries)."""


class Permanent(Exception):
    """An explicitly-permanent failure (never retried, even if it wraps
    an otherwise-transient type)."""


TRANSIENT_TYPES = (Transient, OSError, ConnectionError, TimeoutError)


def is_transient(exc: BaseException) -> bool:
    """True when ``exc`` is worth retrying under the taxonomy above."""
    if isinstance(exc, Permanent):
        return False
    return isinstance(exc, TRANSIENT_TYPES)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff: base * 2^(attempt-1), capped, jittered.

    ``attempts`` counts TOTAL tries (first call included).  Delays are
    deliberately tiny — the media being retried (page cache, PCIe put)
    recovers in microseconds, and the streaming hot loop must not stall
    a quantum for human-scale seconds.
    """
    attempts: int = 4
    base_delay_s: float = 0.002
    max_delay_s: float = 0.05
    jitter: float = 0.5        # delay *= 1 + jitter * U[0,1)

    def delay_s(self, attempt: int) -> float:
        delay = min(self.max_delay_s,
                    self.base_delay_s * (2 ** (attempt - 1)))
        return delay * (1.0 + self.jitter * random.random())


DEFAULT_POLICY = RetryPolicy()


def retry_call(fn, *, site: str, policy: RetryPolicy = DEFAULT_POLICY,
               stats=None, sleep=time.sleep):
    """Call ``fn()`` until it succeeds, a permanent error is raised, or
    the policy is exhausted.

    ``site`` labels the ``retry.attempt`` spans and error messages (use
    the fault-site name of the operation being retried).  ``stats`` is an
    ``EngineStats`` (or anything with ``retries``/``giveups`` ints).
    """
    attempt = 1
    while True:
        try:
            if attempt == 1:
                return fn()
            with obs_trace.span("retry.attempt", "retry",
                                site=site, attempt=attempt):
                return fn()
        except Exception as exc:        # noqa: BLE001 — classified below
            if not is_transient(exc):
                raise
            if attempt >= policy.attempts:
                if stats is not None:
                    stats.giveups += 1
                raise
            if stats is not None:
                stats.retries += 1
            sleep(policy.delay_s(attempt))
            attempt += 1
