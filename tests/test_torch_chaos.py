"""The seeded chaos soak through the port's async runtime on the CPU: the
JAX package's scenarios (``tests/test_chaos.py``) with the port's fault
layer.  Each job either completes **bit-identical** to the port's own
fault-free run or fails with an explanatory payload — never a hang, never
a dead worker, the admission ledger released — and every scenario ends in
the reference's states and payload types.

Every port runtime runs ``kernel="torch", device="cpu"``; every wait has
its own timeout."""
import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro import faults as rfaults  # noqa: E402
from repro import service as rservice  # noqa: E402
from repro.analysis.sanitize import set_sanitize as rset_sanitize  # noqa
from repro_torch import core, faults, service  # noqa: E402
from repro_torch.analysis.sanitize import set_sanitize  # noqa: E402
from repro_torch.faults import (FaultPlan, FaultRule,  # noqa: E402
                                WorkerCrashError, inject)
from repro_torch.service import (ServiceRuntime,  # noqa: E402
                                 SubmitDecomposition)

CPU = {"kernel": "torch", "device": "cpu"}
RANK = 4
ITERS = 5
BUDGET = 64 << 20
DRAIN_S = 60

# (tensor seed, ALS seed, tenant, weight); jobs 0 and 2 share a tensor
WORKLOAD = ((0, 1, "acme", 1.0), (1, 2, "umbrella", 2.0),
            (0, 3, "umbrella", 1.0))


def _tensor(seed, nnz=200, dim=8, pkg=core):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(nnz, 3)).astype(np.int64)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return pkg.SparseTensor(indices=idx, values=vals, dims=(dim, dim, dim))


def _config(kind, tmp_path):
    if kind == "mem":
        return {"device_budget_bytes": BUDGET}
    # a 1-byte host budget spills every registration: jobs disk-stream
    # through store.read and stream.h2d
    return {"device_budget_bytes": BUDGET,
            "store_dir": str(tmp_path / "store"), "host_budget_bytes": 1}


def _run_workload(tmp_path, kind, *, pkg=service, tensor_pkg=core, kw=CPU):
    out = {}
    with pkg.ServiceRuntime(**_config(kind, tmp_path), **kw) as rt:
        ids = [rt.submit(pkg.SubmitDecomposition(
            tensor=_tensor(ts, pkg=tensor_pkg), rank=RANK, iters=ITERS,
            tol=0.0, seed=ss, tenant=tenant, weight=weight))
            for ts, ss, tenant, weight in WORKLOAD]
        assert rt.drain(timeout=DRAIN_S), "chaos workload failed to drain"
        for n, jid in enumerate(ids):
            st = rt.status(jid)
            if st.state == "done":
                res = rt.result(jid).result
                out[n] = ("done", tuple(res.fits),
                          [f.numpy() if isinstance(f, torch.Tensor)
                           else np.asarray(f) for f in res.factors],
                          None, st.backend)
            else:
                out[n] = (st.state, None, None, st.error_payload, st.backend)
        metrics = rt.service_metrics()
        worker_dead = rt._error is not None
    return out, metrics, worker_dead


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """The port's fault-free outcomes per config kind."""
    assert not inject.FAULTS.enabled
    refs = {}
    for kind in ("mem", "disk"):
        out, _, dead = _run_workload(tmp_path_factory.mktemp(f"ref-{kind}"),
                                     kind)
        assert not dead
        assert all(v[0] == "done" for v in out.values())
        refs[kind] = out
    return refs


@pytest.fixture(autouse=True)
def _sanitized():
    """Ledger audit + factor checks on every scenario; no leftover plan."""
    set_sanitize(True)
    rset_sanitize(True)
    yield
    set_sanitize(None)
    rset_sanitize(None)
    inject.uninstall()
    rfaults.inject.uninstall()


def _check_invariants(out, ref, metrics, worker_dead):
    assert not worker_dead, "worker died and stayed dead"
    for n, (state, fits, factors, payload, _) in out.items():
        if state == "done":
            assert fits == ref[n][1], f"job {n} diverged from its fault-free run"
            assert all(np.array_equal(a, b)
                       for a, b in zip(factors, ref[n][2]))
        else:
            assert state == "failed", f"job {n} ended {state!r}"
            assert payload is not None
            assert {"type", "message", "where", "transient",
                    "injected"} <= set(payload)
    assert metrics["admitted_reservation_bytes"] == 0
    assert sum(v[0] == "done" for v in out.values()) == \
        metrics["jobs_completed"]
    assert sum(v[0] == "failed" for v in out.values()) == \
        metrics["jobs_failed"]


SCENARIOS = {
    "store-corruption": ("disk", [("store.read", "corrupt", None, 1.0)]),
    "transient-io": ("disk", [("store.read", "transient", n, None)
                              for n in (1, 5, 9)]),
    "alloc-failure": ("mem", [("plan.alloc", None, 1, None)]),
    "h2d-failure": ("disk", [("stream.h2d", None, n, None) for n in (2, 6)]),
    "quantum-exception": ("mem", [("runtime.quantum", "exception", 2, None)]),
    "nan-poison": ("mem", [("factors.nan", None, 3, None)]),
    "worker-death": ("mem", [("runtime.quantum", "crash", 3, None)]),
    "mixed": ("disk", [("store.read", "transient", 2, None),
                       ("plan.alloc", None, 1, None),
                       ("stream.h2d", None, 4, None),
                       ("factors.nan", None, 6, None),
                       ("runtime.quantum", "exception", 9, None)]),
}


def _plan(mod, rules):
    return mod.FaultPlan(seed=1234, rules=tuple(
        mod.FaultRule(site, kind=kind, nth=nth, p=p)
        for site, kind, nth, p in rules))


def _outline(out):
    """The jobs' (state, backend, payload type) as a multiset: which job
    a quantum fault strikes depends on how the worker's quanta interleave
    with the submissions."""
    return sorted((v[0], v[4], v[3]["type"] if v[3] else "")
                  for v in out.values())


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_chaos_scenario(name, references, tmp_path):
    kind, rules = SCENARIOS[name]
    plan = _plan(faults, rules)
    with inject.active(plan):
        out, metrics, dead = _run_workload(tmp_path / "port", kind)
    _check_invariants(out, references[kind], metrics, dead)
    with rfaults.inject.active(_plan(rfaults, rules)):
        r_out, r_metrics, r_dead = _run_workload(
            tmp_path / "ref", kind, pkg=rservice, tensor_pkg=rcore, kw={})
    assert not r_dead
    assert _outline(out) == _outline(r_out)
    for key in ("jobs_completed", "jobs_failed", "demotions_total",
                "watchdog_restarts", "giveups_total"):
        assert metrics[key] == r_metrics[key], key

    failed = sum(v[0] == "failed" for v in out.values())
    if name == "store-corruption":
        assert failed == len(WORKLOAD)
    elif name == "transient-io":
        assert failed == 0 and metrics["retries_total"] >= 3
    elif name == "alloc-failure":
        assert failed == 0 and metrics["demotions_total"] >= 1
    elif name == "h2d-failure":
        assert failed == 0 and metrics["retries_total"] >= 2
    elif name in ("quantum-exception", "nan-poison"):
        assert failed == 1
        payload = next(v[3] for v in out.values() if v[0] == "failed")
        if name == "quantum-exception":
            assert payload["injected"] is True
        else:
            assert payload["type"] in ("FactorPoisonError", "SanitizerError")
    elif name == "worker-death":
        assert failed == 0 and metrics["watchdog_restarts"] == 1
    elif name == "mixed":
        assert failed >= 1 and plan.fired_log
    assert metrics["giveups_total"] == 0


def _bomb_after(rt, jid, sweep):
    """Make the job's plan raise a worker crash in mode 1 of ``sweep``
    (the job's factors are then half updated)."""
    with rt._lock:
        job = rt.scheduler.jobs[jid]
        plan, bombed = job.plan, {"done": False}

        def bomb(factors, mode):
            if job.cp.iteration >= sweep and mode == 1 and not bombed["done"]:
                bombed["done"] = True
                raise WorkerCrashError("simulated segfault mid-sweep")
            return plan.mttkrp(factors, mode)

        job.mttkrp_fn = bomb
    return bombed


def test_worker_crash_mid_sweep_resumes_exactly(references, tmp_path):
    """A worker killed inside a sweep: the watchdog rolls the job back to
    its last complete sweep and the final trajectory is bit-identical to
    the fault-free run."""
    ref = references["mem"]
    with ServiceRuntime(**_config("mem", tmp_path), **CPU) as rt:
        feed = rt.subscribe()
        jid = rt.submit(SubmitDecomposition(
            tensor=_tensor(0), rank=RANK, iters=ITERS, tol=0.0, seed=1,
            tenant="acme"))
        bombed = _bomb_after(rt, jid, 2)
        assert rt.wait(jid, timeout=DRAIN_S).state == "done"
        res = rt.result(jid).result
        m = rt.service_metrics()
        kinds = []
        while (ev := feed.get(timeout=0.1)) is not None:
            kinds.append(ev.kind)
    assert bombed["done"] and m["watchdog_restarts"] == 1
    assert "rollback" in kinds
    assert tuple(res.fits) == ref[0][1]
    assert np.array_equal(res.factors[0].numpy(), ref[0][2][0])


def test_worker_crash_resumes_from_auto_snapshot(tmp_path):
    """With auto-snapshots on, a mid-sweep crash rolls back to the
    checkpoint (loaded onto the service's device) and still finishes
    bit-identically."""
    store, snap = str(tmp_path / "store"), str(tmp_path / "autosnap")
    with ServiceRuntime(device_budget_bytes=BUDGET, store_dir=store,
                        **CPU) as rt:
        jid = rt.submit(SubmitDecomposition(
            tensor=_tensor(0), rank=RANK, iters=ITERS, tol=0.0, seed=1))
        rt.wait(jid, timeout=DRAIN_S)
        ref_fits = tuple(rt.result(jid).result.fits)
    with ServiceRuntime(device_budget_bytes=BUDGET, store_dir=store,
                        auto_snapshot_dir=snap, auto_snapshot_every=1,
                        **CPU) as rt:
        jid = rt.submit(SubmitDecomposition(
            tensor=_tensor(0), rank=RANK, iters=ITERS, tol=0.0, seed=1))
        bombed = _bomb_after(rt, jid, 3)
        assert rt.wait(jid, timeout=DRAIN_S).state == "done"
        fits = tuple(rt.result(jid).result.fits)
        m = rt.service_metrics()
        cp = rt.scheduler.jobs[jid].cp
    assert bombed["done"] and m["watchdog_restarts"] == 1
    assert fits == ref_fits
    assert cp.iteration == ITERS and cp.factors[0].device.type == "cpu"


def test_watchdog_cap_surfaces_persistent_failure():
    plan = FaultPlan(seed=0, rules=(
        FaultRule("runtime.quantum", kind="crash", p=1.0),))
    with inject.active(plan):
        with ServiceRuntime(device_budget_bytes=BUDGET, max_restarts=2,
                            **CPU) as rt:
            rt.submit(SubmitDecomposition(
                tensor=_tensor(0), rank=RANK, iters=ITERS, tol=0.0, seed=1))
            with pytest.raises(RuntimeError, match="worker failed"):
                rt.drain(timeout=DRAIN_S)
            assert rt.service.metrics.watchdog_restarts == 2
