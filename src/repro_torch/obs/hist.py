"""Fixed-bucket log2 histograms for latency / bytes / nnz distributions
(the port's copy of ``repro.obs.hist``).

Scalar time totals (``dispatch_time_s``, ``put_time_s``) answer "how much"
but not "how": a streamed MTTKRP whose dispatch total is dominated by one
straggler launch needs a different fix (nnz balancing) than one whose
launches are uniformly slow (per-launch overhead).  A :class:`Hist` keeps
the whole distribution at O(64) ints: power-of-two buckets (value ``v``
lands in the bucket whose upper bound is the smallest ``2^k >= v``), plus
exact ``count`` / ``sum`` / ``min`` / ``max``.  Recording is a
``math.frexp`` + two adds, cheap enough for per-launch loops, and
histograms merge losslessly.

Bucket range: ``2^-31`` (~0.5 ns) through ``2^31`` (~2 Gi), values above
fall into a final +Inf bucket; non-positive values land in the lowest
bucket.  This one fixed layout serves seconds, bytes, and nnz counts, and
makes any two histograms mergeable by construction.

``EngineHists`` is the bundle each ``EngineStats`` carries (``hist``);
``ServiceHists`` / ``TenantHists`` are the service's, kept for the port's
service.  Their ``snapshot()`` dicts are JSON-serializable (sparse: only
non-empty buckets are emitted).
"""
from __future__ import annotations

import dataclasses
import math

_LO_EXP = -31                 # lowest bucket upper bound: 2^-31
NBUCKETS = 64                 # last bucket is +Inf


def bucket_index(v: float) -> int:
    """Index of the bucket whose range contains ``v``.

    Bucket ``i < NBUCKETS - 1`` holds ``2^(i-1+_LO_EXP) < v <= 2^(i+_LO_EXP)``;
    the final bucket holds everything larger (+Inf upper bound).
    """
    if v <= 0.0:
        return 0
    # frexp: v = m * 2^e with 0.5 <= m < 1, so 2^(e-1) <= v < 2^e; exact
    # powers of two (m == 0.5) belong in the *lower* bucket (le is inclusive)
    m, e = math.frexp(v)
    ub = e - 1 if m == 0.5 else e
    return min(NBUCKETS - 1, max(0, ub - _LO_EXP))


def bucket_le(i: int) -> float:
    """Upper bound of bucket ``i`` (``math.inf`` for the final bucket)."""
    if i >= NBUCKETS - 1:
        return math.inf
    return 2.0 ** (i + _LO_EXP)


class Hist:
    """Log2-bucket histogram: 64 fixed buckets + count/sum/min/max."""

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self):
        self.counts = [0] * NBUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, v) -> None:
        v = float(v)
        self.counts[bucket_index(v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def merge(self, other: "Hist") -> "Hist":
        """Add ``other``'s samples into this histogram (lossless)."""
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Upper bucket bound below which a fraction ``q`` of samples lie
        (a conservative log2-resolution estimate; 0.0 on empty)."""
        if not self.count:
            return 0.0
        need = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= need:
                return min(bucket_le(i), self.max)
        return self.max

    def cumulative(self) -> list:
        """Prometheus-style cumulative buckets: [(le, cumulative_count)].

        Only buckets at or after the first sample are emitted (plus the
        mandatory +Inf bucket), keeping the exposition compact.
        """
        out = []
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if c:
                out.append((bucket_le(i), cum))
        if not out or out[-1][0] != math.inf:
            out.append((math.inf, cum))
        return out

    def snapshot(self) -> dict:
        """JSON-serializable summary (sparse non-empty buckets, by le)."""
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "buckets": {("+Inf" if math.isinf(le) else repr(le)): c
                        for le, c in zip(
                            (bucket_le(i) for i in range(NBUCKETS)),
                            self.counts) if c},
        }

    def __repr__(self) -> str:
        return (f"Hist(count={self.count}, sum={self.sum:.6g}, "
                f"mean={self.mean:.6g})")


def _hist_field():
    return dataclasses.field(default_factory=Hist)


@dataclasses.dataclass
class EngineHists:
    """Per-plan execution distributions (one bundle per ``EngineStats``).

    ``dispatch_s``   host latency of each (async) compute dispatch — one
                     sample per launch on streamed paths, one per call on
                     the single-dispatch in-memory path;
    ``put_chunk_s``  time of each host-to-device chunk copy (on the card
                     by CUDA events on the copy stream);
    ``disk_read_s``  host time of each store chunk fetch (disk tier only);
    ``launch_nnz``   true nnz per launch — the imbalance observable.
    """
    dispatch_s: Hist = _hist_field()
    put_chunk_s: Hist = _hist_field()
    disk_read_s: Hist = _hist_field()
    launch_nnz: Hist = _hist_field()

    def merge(self, other: "EngineHists") -> "EngineHists":
        self.dispatch_s.merge(other.dispatch_s)
        self.put_chunk_s.merge(other.put_chunk_s)
        self.disk_read_s.merge(other.disk_read_s)
        self.launch_nnz.merge(other.launch_nnz)
        return self

    def snapshot(self) -> dict:
        return {f.name: getattr(self, f.name).snapshot()
                for f in dataclasses.fields(self)}


#: distinct tenant labels each scheduler histogram tracks before new
#: tenants collapse into the overflow label — Prometheus label
#: cardinality must stay bounded no matter how many tenants submit.
MAX_TENANT_LABELS = 32
OVERFLOW_LABEL = "other"


@dataclasses.dataclass
class TenantHists:
    """One tenant's slice of the scheduler distributions."""
    queue_wait_s: Hist = _hist_field()
    quantum_s: Hist = _hist_field()

    def snapshot(self) -> dict:
        return {f.name: getattr(self, f.name).snapshot()
                for f in dataclasses.fields(self)}


@dataclasses.dataclass
class ServiceHists:
    """Service-wide distributions: scheduler behaviour + rolled-up engine
    hists of retired jobs (merged at retirement, lossless).

    ``queue_wait_s``/``quantum_s`` are additionally keyed per tenant via
    :meth:`record_queue_wait`/:meth:`record_quantum`, which record the
    same sample into the global hist and the tenant's — the global hist
    IS the lossless rollup of the tenant slices, by construction, not by
    a merge step that could drift.  Label cardinality is bounded at
    :data:`MAX_TENANT_LABELS`; later tenants share ``"other"``.
    """
    queue_wait_s: Hist = _hist_field()     # submission -> admission, per job
    quantum_s: Hist = _hist_field()        # one ALS sweep, per quantum
    dispatch_s: Hist = _hist_field()
    put_chunk_s: Hist = _hist_field()
    disk_read_s: Hist = _hist_field()
    launch_nnz: Hist = _hist_field()
    tenant: dict = dataclasses.field(default_factory=dict)

    def _tenant(self, tenant: str) -> TenantHists:
        label = str(tenant)
        th = self.tenant.get(label)
        if th is None:
            if len(self.tenant) >= MAX_TENANT_LABELS:
                label = OVERFLOW_LABEL
                th = self.tenant.get(label)
            if th is None:
                th = self.tenant.setdefault(label, TenantHists())
        return th

    def record_queue_wait(self, tenant: str, v: float) -> None:
        self.queue_wait_s.record(v)
        self._tenant(tenant).queue_wait_s.record(v)

    def record_quantum(self, tenant: str, v: float) -> None:
        self.quantum_s.record(v)
        self._tenant(tenant).quantum_s.record(v)

    def merge_engine(self, eh: EngineHists) -> "ServiceHists":
        """Roll a retired job's per-plan distributions into the service."""
        self.dispatch_s.merge(eh.dispatch_s)
        self.put_chunk_s.merge(eh.put_chunk_s)
        self.disk_read_s.merge(eh.disk_read_s)
        self.launch_nnz.merge(eh.launch_nnz)
        return self

    def snapshot(self) -> dict:
        # the tenant dict is not a Hist; it snapshots separately (the
        # schema test pins every value under "hist" to Hist shape)
        return {f.name: getattr(self, f.name).snapshot()
                for f in dataclasses.fields(self) if f.name != "tenant"}

    def tenant_snapshot(self) -> dict:
        return {t: th.snapshot() for t, th in sorted(self.tenant.items())}
