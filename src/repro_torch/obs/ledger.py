"""Memory-hierarchy bandwidth ledger: bytes/seconds/ops per tier edge
(the port's copy of ``repro.obs.ledger``).

Three edges model the hierarchy::

    disk_host    -- DiskChunkSource reads (page cache / disk -> the
                    pinned host ring)
    host_device  -- the ring's host-to-device copies, each timed by a
                    pair of CUDA events on the copy stream (the host
                    clock around a synchronous copy on the CPU)
    device_hbm   -- kernel-side HBM traffic (analytic model; see below)

Each :func:`record` accrues ``(bytes, seconds, ops, flops)`` into three
account families: per edge, per ``(regime, edge)`` (regime = the memory
tier the plan runs in: ``in_memory`` / ``streamed`` / ``disk_streamed``
/ a baseline kind), and per ``(tenant, job, edge)`` when a
:class:`job_scope` is active.

**Conservation by construction**: instrumentation sites pass the ledger
the *same* local ``nbytes``/seconds values they add to ``EngineStats``,
never a separately measured quantity.  Per ``(regime, edge)`` account,
the accumulation order is identical to the plan's own stats counters, so
:func:`verify_conservation` asserts equality with **zero** relative
error.  Retries keep the property: ``retry_call`` sites record once,
after success; a giveup raises before either side records.

Device HBM traffic cannot be measured from the host, so it is
*attributed* from an analytic per-kernel model (:func:`hbm_model_bytes`),
keyed by the port's kernel names: ``"cuda"`` (K1/K2, which keep the
coordinates and the Hadamard product on chip and whose factor gathers
hit L2) and ``"torch"`` (the plain dataflow, which materializes them).
The fenced device seconds are real; the bytes are the model.

Zero-cost-disabled discipline (as ``obs.trace``): the module-level
:data:`LEDGER` singleton carries one ``enabled`` flag; hot paths guard
with ``if LEDGER.enabled:`` and pay a single attribute check when
disabled.  All mutation happens under ``LEDGER.lock``.
"""
from __future__ import annotations

import contextvars
import threading

# ----------------------------------------------------------------- edges
DISK_HOST = "disk_host"
HOST_DEVICE = "host_device"
DEVICE_HBM = "device_hbm"
EDGES = (DISK_HOST, HOST_DEVICE, DEVICE_HBM)
_EDGE_SET = frozenset(EDGES)

#: distinct tenant labels tracked per-job before overflowing into
#: :data:`OVERFLOW_TENANT` (bounded label cardinality, same bound the
#: tenant histograms use).
MAX_TENANT_KEYS = 32
OVERFLOW_TENANT = "other"

_GB = 1e9


class EdgeAccount:
    """One accumulator cell: bytes moved, seconds spent, ops, flops."""

    __slots__ = ("bytes", "seconds", "ops", "flops")

    def __init__(self):
        self.bytes = 0
        self.seconds = 0.0
        self.ops = 0
        self.flops = 0.0

    def add(self, nbytes, seconds, ops, flops):
        self.bytes += nbytes
        self.seconds += seconds
        self.ops += ops
        self.flops += flops

    def gb_per_s(self) -> float:
        if self.seconds <= 0.0:
            return 0.0
        return self.bytes / self.seconds / _GB

    def snapshot(self) -> dict:
        return {
            "bytes": int(self.bytes),
            "seconds": self.seconds,
            "ops": self.ops,
            "flops": self.flops,
            "gb_per_s": self.gb_per_s(),
        }


class LedgerState:
    """Module-level singleton state (see :data:`LEDGER`).

    ``enabled`` is read lock-free on hot paths; every write to the
    account dicts happens under ``lock``.  Account keys: ``edges`` by
    edge name, ``regimes`` by ``(regime, edge)``, ``jobs`` by
    ``(tenant, job, edge)``.
    """

    def __init__(self):
        self.enabled = False
        self.lock = threading.Lock()
        self.edges: dict[str, EdgeAccount] = {}
        self.regimes: dict[tuple, EdgeAccount] = {}
        self.jobs: dict[tuple, EdgeAccount] = {}
        self.tenants: set[str] = set()


LEDGER = LedgerState()

#: (tenant, job_id) attribution scope; set by :class:`job_scope`.
_scope: contextvars.ContextVar = contextvars.ContextVar(
    "repro_obs_ledger_scope", default=None)


def _acct(accounts: dict, key) -> EdgeAccount:
    acct = accounts.get(key)
    if acct is None:
        acct = EdgeAccount()
        accounts[key] = acct
    return acct


def record(edge: str, nbytes, seconds, *, regime: str = "",
           flops: float = 0.0, ops: int = 1) -> None:
    """Accrue one transfer/kernel into the ledger (no-op when disabled).

    Call sites MUST pass the exact ``nbytes``/``seconds`` locals they
    feed ``EngineStats`` — conservation is checked with 0 tolerance.
    ``regime`` is the plan's memory tier (``stats.backend``); empty
    skips the per-regime account but still accrues the edge total.
    """
    if not LEDGER.enabled:
        return
    if edge not in _EDGE_SET:
        raise ValueError(f"unknown ledger edge {edge!r}; one of {EDGES}")
    scope = _scope.get()
    with LEDGER.lock:
        _acct(LEDGER.edges, edge).add(nbytes, seconds, ops, flops)
        if regime:
            _acct(LEDGER.regimes, (regime, edge)).add(
                nbytes, seconds, ops, flops)
        if scope is not None:
            tenant, job = scope
            if tenant not in LEDGER.tenants:
                if len(LEDGER.tenants) >= MAX_TENANT_KEYS:
                    tenant = OVERFLOW_TENANT
                LEDGER.tenants.add(tenant)
            _acct(LEDGER.jobs, (tenant, job, edge)).add(
                nbytes, seconds, ops, flops)


class job_scope:
    """Attribute records inside the block to ``(tenant, job_id)``.

    Context-local (``contextvars``), so concurrent worker threads each
    carry their own attribution; cheap enough to set unconditionally.
    """

    __slots__ = ("_tenant", "_job", "_token")

    def __init__(self, tenant: str, job_id: str):
        self._tenant = str(tenant)
        self._job = str(job_id)
        self._token = None

    def __enter__(self):
        self._token = _scope.set((self._tenant, self._job))
        return self

    def __exit__(self, *exc):
        _scope.reset(self._token)
        return False


# ------------------------------------------------------------- lifecycle
def enable() -> None:
    with LEDGER.lock:
        LEDGER.enabled = True


def disable() -> None:
    with LEDGER.lock:
        LEDGER.enabled = False


def is_enabled() -> bool:
    return LEDGER.enabled


def clear() -> None:
    """Drop all accounts (the enabled flag is untouched)."""
    with LEDGER.lock:
        LEDGER.edges.clear()
        LEDGER.regimes.clear()
        LEDGER.jobs.clear()
        LEDGER.tenants.clear()


class enabled:
    """Scoped enable: ``with ledger.enabled(): ...`` restores the prior
    state on exit (mirrors ``obs.trace.enabled``)."""

    def __enter__(self):
        self._was = LEDGER.enabled
        enable()
        return self

    def __exit__(self, *exc):
        with LEDGER.lock:
            LEDGER.enabled = self._was
        return False


def snapshot() -> dict:
    """JSON-safe view: edge totals, per-regime, per-tenant (aggregated),
    and per-(tenant, job) accounts."""
    with LEDGER.lock:
        edges = {e: a.snapshot() for e, a in LEDGER.edges.items()}
        regimes: dict[str, dict] = {}
        for (regime, edge), acct in LEDGER.regimes.items():
            regimes.setdefault(regime, {})[edge] = acct.snapshot()
        jobs: dict[str, dict] = {}
        tenants: dict[str, dict] = {}
        for (tenant, job, edge), acct in LEDGER.jobs.items():
            jobs.setdefault(tenant, {}).setdefault(job, {})[edge] = \
                acct.snapshot()
            agg = tenants.setdefault(tenant, {}).setdefault(
                edge, {"bytes": 0, "seconds": 0.0, "ops": 0, "flops": 0.0})
            agg["bytes"] += acct.bytes
            agg["seconds"] += acct.seconds
            agg["ops"] += acct.ops
            agg["flops"] += acct.flops
        enabled_flag = LEDGER.enabled
    for per_edge in tenants.values():
        for agg in per_edge.values():
            s = agg["seconds"]
            agg["gb_per_s"] = (agg["bytes"] / s / _GB) if s > 0.0 else 0.0
    return {"enabled": enabled_flag, "edges": edges, "regimes": regimes,
            "tenants": tenants, "jobs": jobs}


# ------------------------------------------------------- analytic models
def hbm_model_bytes(nnz: int, *, order: int, rank: int,
                    value_itemsize: int, factor_itemsize: int = 4,
                    kernel: str = "cuda", dims=None,
                    mode: int | None = None) -> float:
    """Analytic device-HBM traffic for one MTTKRP pass over ``nnz``
    elements of an order-``order`` BLCO tensor at rank ``rank``, keyed by
    the port's kernel names.

    ``"cuda"`` (K1/K2, the fused kernel): what it must move from HBM,
    each input read once and the output written once: ``nnz * (hi + lo +
    value + order int32 bases)``, each of the ``order - 1`` non-target
    factor matrices once and the ``(dims[mode], rank)`` output once
    (``dims`` and ``mode`` are required).  The per-element factor gathers
    and row updates stay out: the factor matrices are L2-resident (NELL-2's
    three come to 6.4 MB), so that traffic goes through L2, not HBM.
    ``chip_smoke.py``'s kernel bound counts these same bytes.

    ``"torch"`` (the plain dataflow): the stream ``nnz * (hi + lo +
    vals)``, ``order - 1`` gathered rows of ``rank`` floats per element,
    a read + write of an output row per element, and the materialized
    decoded coordinates (write + read, 4 bytes x ``order``) and Hadamard
    intermediate (write + read, ``rank`` floats).

    A model, not a measurement — reported as such.
    """
    n = float(nnz)
    f = float(factor_itemsize)
    if kernel == "cuda":
        if dims is None or mode is None:
            raise ValueError("the 'cuda' model needs dims and mode")
        stream = n * (4.0 + 4.0 + float(value_itemsize) + 4.0 * order)
        facs = sum(float(d) * rank * f for m, d in enumerate(dims)
                   if m != mode)
        return stream + facs + float(dims[mode]) * rank * f
    if kernel != "torch":
        raise ValueError(f"no HBM model for kernel {kernel!r}; "
                         f"one of ('cuda', 'torch')")
    stream = n * (4.0 + 4.0 + float(value_itemsize))
    gathers = n * (order - 1) * rank * f
    scatter = n * 2.0 * rank * f
    total = stream + gathers + scatter
    total += n * order * 4.0 * 2.0        # decoded coords, out + in
    total += n * rank * f * 2.0           # Hadamard intermediate
    return total


def mttkrp_flops(nnz: int, *, order: int, rank: int) -> float:
    """Flops for one MTTKRP pass: per element and rank lane, ``order-1``
    Hadamard multiplies plus one scatter-accumulate add."""
    return float(nnz) * rank * order


# ----------------------------------------------------------- conservation
#: edge -> (ledger field, EngineStats counter) pairs that must agree
#: exactly.  device_hbm bytes are model-attributed (no stats mirror), so
#: only its seconds are conservation-checked, against the fenced
#: ``device_time_s``.
CONSERVATION_FIELDS = {
    DISK_HOST: (("bytes", "disk_bytes"), ("seconds", "disk_time_s")),
    HOST_DEVICE: (("bytes", "h2d_bytes"), ("seconds", "put_time_s")),
    DEVICE_HBM: (("seconds", "device_time_s"),),
}


def _rel_err(a: float, b: float) -> float:
    if a == b:
        return 0.0
    denom = max(abs(a), abs(b))
    return abs(a - b) / denom


def verify_conservation(pairs) -> dict:
    """Check per-(regime, edge) ledger totals against EngineStats.

    ``pairs``: iterable of ``(regime, stats)`` where ``stats`` is an
    ``EngineStats`` (or its ``snapshot()`` dict); each regime must map
    to exactly one stats object — within one, ledger and stats
    accumulate the identical float sequence, so the expected relative
    error is exactly 0.0, not "small".
    """
    snap = snapshot()
    checks = []
    max_err = 0.0
    for regime, stats in pairs:
        stats_snap = stats if isinstance(stats, dict) else stats.snapshot()
        per_edge = snap["regimes"].get(regime, {})
        for edge, fields in CONSERVATION_FIELDS.items():
            acct = per_edge.get(edge, {"bytes": 0, "seconds": 0.0})
            for ledger_field, stats_field in fields:
                lv = acct.get(ledger_field, 0)
                sv = stats_snap.get(stats_field, 0)
                err = _rel_err(float(lv), float(sv))
                max_err = max(max_err, err)
                checks.append({
                    "regime": regime, "edge": edge,
                    "field": ledger_field, "stats_field": stats_field,
                    "ledger": lv, "stats": sv, "rel_err": err,
                })
    return {"checks": checks, "max_rel_err": max_err}
