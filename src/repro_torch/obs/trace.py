"""Lightweight span tracer: where the time goes, per pipeline stage.

The paper's claims are about *attribution* — kernel-launch overhead vs
memory-access irregularity vs streaming overlap — so flat time totals are
not enough: the streamed regimes interleave disk reads, H2D puts, and
device dispatches, and only a timeline shows whether they overlap.  This
module records that timeline as **spans**: named intervals on a *track*
(one track per pipeline stage, such as ``store`` / ``h2d`` / ``dispatch``
/ ``device`` / ``plan``), each carrying attributes like ``nnz``,
``launch``, ``bytes``.  The port's copy of ``repro.obs.trace``; the port
records ``plan.mttkrp``, ``engine.plan_for``, ``engine.demote``,
``store.read``, ``retry.attempt`` and the CP-ALS sweep's ``cp_als.sweep``,
``cp_als.update``, ``cp_als.pinv`` and ``cp_als.fit``.

Two recording APIs:

* :func:`span` — a context manager for code whose interval the tracer
  itself measures (plan ``mttkrp`` calls, ``plan_for``, the CP-ALS
  sweep's ``cp_als.*`` spans).  Nesting is tracked through a
  :mod:`contextvars` variable, so a child span records its parent's name;
  contexts are per-thread, so spans emitted on one thread nest only under
  spans that thread opened.  While a ``torch.profiler`` is recording, such
  a span also enters a ``record_function`` of its name, so the profiler's
  trace holds the program's spans on its own clock: a kernel is matched to
  the span whose host code launched it (by correlation id), an idle gap of
  the card to the span the host was in.
* :func:`add_event` — records an interval the caller ALREADY measured
  (the streaming hot loop times every put/dispatch for ``EngineStats``
  anyway; tracing reuses those exact timestamps, so span sums and stats
  totals agree by construction).  They are measured after the fact, so
  they never reach the profiler's trace (``device.fence``, ``h2d.put``,
  ``dispatch.launch``, ``store.read`` are on this module's clock only).

Zero-cost when disabled: recording is gated on one module-level flag
(``TRACING.enabled``), :func:`span` returns a shared no-op singleton, and
hot paths guard ``add_event`` calls on the same flag so the disabled fast
path allocates nothing.  Completed spans land in a thread-safe bounded
ring buffer (oldest evicted first, ``TRACING.dropped`` counts evictions);
read them with :func:`spans` or :func:`drain`.
"""
from __future__ import annotations

import contextvars
import threading
import time
from collections import deque

DEFAULT_CAPACITY = 65536        # spans held in the ring buffer


class TracerState:
    """The module-level tracer: enable flag + bounded span ring buffer."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = False
        self.lock = threading.Lock()
        self.buf: deque = deque(maxlen=int(capacity))
        self.dropped = 0             # spans evicted by the bounded ring
        self.epoch_s = time.perf_counter()   # trace time zero (export origin)


# THE module-level state; hot paths read ``TRACING.enabled`` once per span.
TRACING = TracerState()

# Current span of this thread/context (contextvars are per-thread, so the
# runtime worker's quantum span parents only spans opened on that thread).
_current: contextvars.ContextVar = contextvars.ContextVar(
    "repro_obs_current_span", default=None)


class Span:
    """One named interval on a track, with attributes and a parent name."""

    __slots__ = ("name", "track", "attrs", "start_s", "end_s", "parent",
                 "_token")

    def __init__(self, name: str, track: str, attrs: dict):
        self.name = name
        self.track = track
        self.attrs = attrs
        self.start_s = 0.0
        self.end_s = 0.0
        self.parent: str | None = None
        self._token = None

    @property
    def duration_s(self) -> float:
        return max(0.0, self.end_s - self.start_s)

    def set(self, **attrs) -> "Span":
        """Attach attributes discovered mid-span (e.g. the chosen backend)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        parent = _current.get()
        self.parent = parent.name if parent is not None else None
        self._token = _current.set(self)
        self.start_s = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_s = time.perf_counter()
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        _record(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, track={self.track!r}, "
                f"dur={self.duration_s * 1e6:.1f}us, attrs={self.attrs})")


class _NullSpan:
    """The shared disabled-path span: every operation is a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs):
        return self


_NULL = _NullSpan()


def _record(s: Span) -> None:
    with TRACING.lock:
        if len(TRACING.buf) == TRACING.buf.maxlen:
            TRACING.dropped += 1
        TRACING.buf.append(s)


# ------------------------------------------------------------------ recording
def span(name: str, track: str = "main", **attrs):
    """Context manager recording ``name`` on ``track`` while entered.

    Returns the shared no-op singleton when tracing is disabled — one flag
    check, no allocation beyond the call's own kwargs, no ``torch`` call.
    While tracing is on and a ``torch.profiler`` records, the span is
    mirrored into the profiler's trace (:class:`_ProfiledSpan`).
    """
    if not TRACING.enabled:
        return _NULL
    import torch
    if torch._C._autograd._profiler_enabled():
        return _ProfiledSpan(Span(name, track, attrs),
                             torch.profiler.record_function(name))
    return Span(name, track, attrs)


class _ProfiledSpan:
    """A span that also enters ``mirror``, a ``torch.profiler``
    ``record_function`` of its name, while it is entered; ``with`` yields
    the span itself."""

    __slots__ = ("span", "mirror")

    def __init__(self, s: Span, mirror):
        self.span = s
        self.mirror = mirror

    def __enter__(self) -> Span:
        self.span.__enter__()
        self.mirror.__enter__()
        return self.span

    def __exit__(self, *exc) -> bool:
        self.mirror.__exit__(*exc)
        return self.span.__exit__(*exc)


def add_event(name: str, track: str, start_s: float, end_s: float,
              **attrs) -> None:
    """Record an interval the caller already measured (hot-loop path).

    The streaming loop times every chunk put / launch dispatch for
    ``EngineStats``; passing those timestamps here makes the trace agree
    with the stats *exactly*.  Hot paths should guard the call on
    ``TRACING.enabled`` so the disabled path does not even build kwargs.
    """
    if not TRACING.enabled:
        return
    s = Span(name, track, attrs)
    s.start_s = start_s
    s.end_s = end_s
    parent = _current.get()
    s.parent = parent.name if parent is not None else None
    _record(s)


def current_span():
    """The innermost entered span of this thread/context (or None)."""
    return _current.get()


# ------------------------------------------------------------------- control
def enable(capacity: int | None = None) -> None:
    """Turn span recording on (optionally resizing the ring buffer)."""
    with TRACING.lock:
        if capacity is not None and int(capacity) != TRACING.buf.maxlen:
            TRACING.buf = deque(TRACING.buf, maxlen=int(capacity))
        TRACING.enabled = True


def disable() -> None:
    # writes to the singleton go under its lock (hot-path READS of
    # ``TRACING.enabled`` stay lock-free by design: a stale read is a
    # dropped span, a torn enable/resize sequence would be corruption)
    with TRACING.lock:
        TRACING.enabled = False


def is_enabled() -> bool:
    return TRACING.enabled


def clear() -> None:
    """Drop all recorded spans and reset the export time origin."""
    with TRACING.lock:
        TRACING.buf.clear()
        TRACING.dropped = 0
        TRACING.epoch_s = time.perf_counter()


def spans() -> list:
    """Snapshot of the recorded spans (oldest first); buffer unchanged."""
    with TRACING.lock:
        return list(TRACING.buf)


def drain() -> list:
    """Remove and return all recorded spans (oldest first)."""
    with TRACING.lock:
        out = list(TRACING.buf)
        TRACING.buf.clear()
        return out


class enabled:
    """``with obs.trace.enabled(): ...`` — scoped tracing for tests/benches."""

    def __init__(self, capacity: int | None = None):
        self.capacity = capacity
        self._was = False

    def __enter__(self):
        self._was = TRACING.enabled
        enable(self.capacity)
        return self

    def __exit__(self, *exc) -> bool:
        with TRACING.lock:
            TRACING.enabled = self._was
        return False
