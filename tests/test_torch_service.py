"""The port's multi-tenant decomposition service (``repro_torch.service``)
against the JAX package's (``repro.service``) on the CPU: the copies'
code, the same scenarios through both packages, the fingerprint and the
store shared by both, and the port's own contracts — one ring per pooled
reservation shape, exception-safe pool joins, no fallback from a failing
kernel, a ``DiskStreamedPlan`` padding to a larger ``spec``.

Every port service here runs ``kernel="torch", device="cpu"``; data
passes between the packages only as numpy arrays."""
import ast
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro import engine as rengine  # noqa: E402
from repro import faults as rfaults  # noqa: E402
from repro import service as rservice  # noqa: E402
from repro import store as rstore  # noqa: E402
from repro.core.streaming import ReservationSpec as RSpec  # noqa: E402
from repro_torch import core, engine, faults, service, store  # noqa: E402
from repro_torch.core.streaming import StreamBuffers  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# per-sweep fit, port vs reference, both plain f32 on the CPU (the
# tolerance of tests/test_torch_cp_als.py)
FIT_TOL = 1e-4
QUERY_TOL = 5e-4
CPU = {"kernel": "torch", "device": "cpu"}
BLOCK = 256                                    # many launches per tensor

REF = types.SimpleNamespace(name="ref", core=rcore, service=rservice,
                            engine=rengine, faults=rfaults, kw={})
PORT = types.SimpleNamespace(name="port", core=core, service=service,
                             engine=engine, faults=faults, kw=CPU)


# ------------------------------------------------------------ the copies
def _strip(tree, drop):
    """Remove docstrings and imports everywhere, and the functions,
    methods (``Class.method``) and classes named in ``drop``."""
    def keep(node, prefix):
        name = getattr(node, "name", None)
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            return False
        return name is None or f"{prefix}{name}" not in drop

    def walk(node, prefix=""):
        for field in ("body", "orelse", "finalbody", "handlers"):
            body = getattr(node, field, None)
            if not isinstance(body, list):
                continue
            if field == "body" and body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                body = body[1:]
            body = [n for n in body if keep(n, prefix)]
            setattr(node, field, body or [ast.Pass()])
            for child in body:
                inner = f"{child.name}." if isinstance(child,
                                                        ast.ClassDef) else ""
                walk(child, prefix + inner)
    walk(tree)
    return tree


def _code(path: Path, drop=()) -> str:
    return ast.dump(_strip(ast.parse(path.read_text()), set(drop)))


def _defs(path: Path) -> dict:
    """``name`` / ``Class.method`` -> AST dump without docstrings."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(_strip(node, set()))
        if isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, ast.FunctionDef):
                    out[f"{node.name}.{m.name}"] = ast.dump(_strip(m, set()))
    return out


# module -> {name: why the port's differs}; everything else is the
# reference's code statement for statement (imports and docstrings aside)
DIFFERENCES = {
    "service/__init__.py": {},
    "service/registry.py": {},
    "service/metrics.py": {},
    "service/executor.py": {
        "PoolEntry": "the entry holds the shared ring",
        "PooledStreamedPlan.__init__": "device, and the pool's ring",
        "PooledStreamedPlan.device_bytes": "closed = ring released",
        "PooledStreamedPlan.close": "the plan releases, never closes, "
                                    "the ring",
        "PooledDiskStreamedPlan.__init__": "device, and the pool's ring",
        "PooledDiskStreamedPlan.device_bytes": "closed = ring released",
        "PooledDiskStreamedPlan.close": "closed = ring released",
        "PooledInMemoryPlan.__init__": "resident=/owns_resident=",
        "ServiceEngine.__init__": "kernel default cuda, device=",
        "ServiceEngine.min_cost": "torch.float32",
        "ServiceEngine.try_plan": "torch.float32",
        "ServiceEngine._plan_resident": "device=",
        "ServiceEngine._join_stream_pool": "allocates the shared ring",
        "ServiceEngine._release_stream": "closes the ring with the entry",
        "_value_dtype": "the ring's value dtype (port only)",
    },
    "service/scheduler.py": {
        "_poison_factors": "clone before the NaN is written",
        "JobScheduler._admit": "init on the service's device",
    },
    "service/api.py": {
        "DecompositionService.__init__": "kernel default cuda, device=",
        "DecompositionService.mttkrp": "factors to the service's device",
    },
    "service/runtime.py": {
        "ServiceRuntime._rollback_inflight": "init on the service's device",
        "ServiceRuntime._checkpointed_cp": "load onto the service's device",
    },
    "store/snapshot.py": {
        "_save_cp": "factors to numpy through .cpu()",
        "_load_cp": "torch tensors on a device",
        "restore_service": "load onto the service's device",
    },
    "analysis/sanitize.py": {
        "_canonical": "JAX's dtype canonicalisation (reference only)",
        "_torch_dtype": "torch's dtype of a numpy dtype (port only)",
        "SanitizedPlan.mttkrp": "torch dtype promotion",
        "check_factors": "torch.isfinite",
    },
}


@pytest.mark.parametrize("module", DIFFERENCES)
def test_copies_identical_to_reference_but_named_differences(module):
    """Each ported service module is the reference's code: the same
    statements but for imports, docstrings and the named definitions,
    each of which does differ (or exists in one package only)."""
    port = ROOT / "src" / "repro_torch" / module
    ref = ROOT / "src" / "repro" / module
    drop = DIFFERENCES[module]
    assert _code(port, drop) == _code(ref, drop)
    pdefs, rdefs = _defs(port), _defs(ref)
    for name in drop:
        assert name in pdefs or name in rdefs, name
        assert pdefs.get(name) != rdefs.get(name), name


def test_copy_check_sees_a_changed_statement(tmp_path):
    ref = ROOT / "src" / "repro" / "service" / "scheduler.py"
    bad = tmp_path / "scheduler.py"
    text = ref.read_text()
    assert "self.metrics.iterations_total += 1" in text
    bad.write_text(text.replace("self.metrics.iterations_total += 1",
                                "self.metrics.iterations_total += 2"))
    assert _code(bad) != _code(ref)


def test_service_and_store_exports_match_reference():
    assert service.__all__ == rservice.__all__
    assert set(rstore.__all__) <= set(store.__all__)


# --------------------------------------------------------------- tensors
def _pair(dims, nnz, seed, dist="powerlaw"):
    """The same tensor for both packages (numpy arrays in between)."""
    r = rcore.random_tensor(dims, nnz, seed=seed, dist=dist)
    p = core.SparseTensor(dims=tuple(r.dims), indices=np.array(r.indices),
                          values=np.array(r.values))
    return {"ref": r, "port": p}


def _t1(seed=6):
    return _pair((30, 22, 14), 1500, seed)


def _t2():
    return _pair((40, 25, 30), 2000, 3)


# ------------------------------------------------- scenarios, both packages
def _summary(svc, ids) -> dict:
    """What both packages must agree on exactly."""
    m = svc.service_metrics()
    jobs = [svc.scheduler.jobs[j] for j in ids]
    return {
        "states": [j.state for j in jobs],
        "iterations": [j.cp.iteration if j.cp is not None else 0
                       for j in jobs],
        "backends": [j.metrics.backend for j in jobs],
        "payloads": [j.error_payload["type"] if j.error_payload else None
                     for j in jobs],
        "registry": (svc.registry.hits, svc.registry.misses,
                     svc.registry.spills, svc.registry.disk_hits,
                     svc.registry.loads),
        "admitted": (m["admitted_reservation_bytes"],
                     m["peak_admitted_reservation_bytes"]),
        "pools": (svc.engine.pool_size, svc.engine.resident_count,
                  svc.engine.pooled_bytes()),
        "counts": (m["jobs_admitted"], m["jobs_completed"],
                   m["jobs_failed"], m["jobs_cancelled"],
                   m["demotions_total"], m["iterations_total"]),
        "tenant_iterations": m["tenant_iterations"],
        "trace": list(svc.scheduler.trace),
        "keys": sorted(m),
    }


def _fits(svc, ids):
    return [list(svc.scheduler.jobs[j].cp.fits)
            if svc.scheduler.jobs[j].cp is not None else [] for j in ids]


def _req(ns, t, *, rank=4, iters=3, seed=0, build=None, **kw):
    return ns.service.SubmitDecomposition(
        tensor=t, rank=rank, iters=iters, seed=seed, tol=kw.pop("tol", 0.0),
        build=build or ns.service.BuildParams(max_nnz_per_block=BLOCK), **kw)


def _svc(ns, **kw):
    return ns.service.DecompositionService(**kw, **ns.kw)


def _probe(ns, t, build=None):
    return ns.service.TensorRegistry().register(
        t, build=build or ns.service.BuildParams(max_nnz_per_block=BLOCK))


def sc_three_jobs_two_tensors(ns, log, tmp):
    t1, t2, t1b = _t1()[ns.name], _t2()[ns.name], _t1()[ns.name]
    svc = _svc(ns, device_budget_bytes=64 << 20, queues=3)
    ids = [svc.submit(_req(ns, t1, rank=6, iters=5, seed=7)),
           svc.submit(_req(ns, t2, rank=8, iters=5, seed=1)),
           svc.submit(_req(ns, t1b, rank=6, iters=5, seed=7))]
    log.append(_summary(svc, ids))
    svc.run()
    return svc, ids


def sc_fast_path_and_streaming(ns, log, tmp):
    small, big = _t1()[ns.name], _t2()[ns.name]
    hs, hb = _probe(ns, small), _probe(ns, big)
    fb = ns.engine.factor_bytes
    budget = hs.in_memory_bytes + fb(small.dims, 4, np.float32) \
        + hb.spec.bytes_in_flight(2) + fb(big.dims, 4, np.float32)
    svc = _svc(ns, device_budget_bytes=budget, queues=2)
    ids = [svc.submit(_req(ns, small)), svc.submit(_req(ns, big))]
    log.append(_summary(svc, ids))
    svc.run()
    return svc, ids


def sc_admission_queues(ns, log, tmp):
    t1, t2 = _t1()[ns.name], _t2()[ns.name]
    b512 = ns.service.BuildParams(max_nnz_per_block=512)
    big = _probe(ns, t2, b512).spec.bytes_in_flight(2)
    budget = big + ns.engine.factor_bytes(t2.dims, 4, np.float32)
    svc = _svc(ns, device_budget_bytes=budget, queues=2)
    ids = [svc.submit(_req(ns, t1)), svc.submit(_req(ns, t2, build=b512))]
    log.append(_summary(svc, ids))
    svc.run()
    return svc, ids


def sc_resident_pool(ns, log, tmp):
    svc = _svc(ns, device_budget_bytes=64 << 20, queues=2)
    ids = [svc.submit(_req(ns, _t1()[ns.name], iters=2, seed=s))
           for s in range(3)]
    log.append(_summary(svc, ids))
    svc.run()
    return svc, ids


def sc_stream_pool(ns, log, tmp):
    t = _t1()[ns.name]
    h = _probe(ns, t)
    fb = ns.engine.factor_bytes(h.dims, 4, np.float32)
    svc = _svc(ns, device_budget_bytes=h.spec.bytes_in_flight(2) + 3 * fb
               + 1024, queues=2)
    ids = [svc.submit(_req(ns, _t1()[ns.name], iters=2, seed=s))
           for s in range(3)]
    log.append(_summary(svc, ids))
    svc.run()
    return svc, ids


def sc_working_set_budget(ns, log, tmp):
    t = _t1()[ns.name]
    h = _probe(ns, t)
    budget = h.in_memory_bytes + 2 * ns.engine.factor_bytes(h.dims, 4,
                                                            np.float32)
    svc = _svc(ns, device_budget_bytes=budget, queues=2)
    ids = [svc.submit(_req(ns, t, iters=2, seed=s)) for s in range(3)]
    log.append(_summary(svc, ids))
    svc.run()
    return svc, ids


def sc_failed_job_isolated(ns, log, tmp):
    svc = _svc(ns, device_budget_bytes=64 << 20, queues=2)
    ids = [svc.submit(_req(ns, _t1()[ns.name])),
           svc.submit(_req(ns, _t2()[ns.name]))]
    svc.scheduler.jobs[ids[1]].mttkrp_fn = \
        lambda f, m: (_ for _ in ()).throw(RuntimeError("boom"))
    svc.run()
    return svc, ids


def sc_cancel_running(ns, log, tmp):
    t = _t1()[ns.name]
    h = _probe(ns, t)
    budget = h.in_memory_bytes + ns.engine.factor_bytes(h.dims, 4,
                                                        np.float32)
    svc = _svc(ns, device_budget_bytes=budget, queues=2)
    ids = [svc.submit(_req(ns, t, iters=50, seed=0)),
           svc.submit(_req(ns, t, iters=2, seed=1)),
           svc.submit(_req(ns, t, iters=2, seed=2))]
    svc.cancel(ids[2])
    for _ in range(3):
        svc.step()
    log.append(_summary(svc, ids))
    log.append(svc.cancel(ids[0]).freed_bytes)
    log.append(_summary(svc, ids))
    svc.run()
    return svc, ids


def sc_weighted_shares(ns, log, tmp):
    t = _t1()[ns.name]
    svc = _svc(ns, device_budget_bytes=64 << 20, queues=2)
    ids = [svc.submit(_req(ns, t, seed=0, iters=8, tenant="A", weight=2.0)),
           svc.submit(_req(ns, t, seed=1, iters=4, tenant="B")),
           svc.submit(_req(ns, t, seed=2, iters=4, tenant="C"))]
    for _ in range(5):
        svc.step()
    svc.set_weight(ns.service.SetWeight(weight=1.0, tenant="A"))
    svc.run()
    return svc, ids


def sc_spill_tier(ns, log, tmp):
    """A 1-byte host budget spills every registration: jobs disk-stream
    from the store through the pooled ring."""
    svc = _svc(ns, device_budget_bytes=64 << 20, queues=2,
               store_dir=str(tmp / "store"), host_budget_bytes=1)
    ids = [svc.submit(_req(ns, _t1()[ns.name], seed=s)) for s in range(2)]
    ids.append(svc.submit(_req(ns, _t2()[ns.name], seed=3)))
    log.append(_summary(svc, ids))
    svc.run()
    return svc, ids


def sc_kernel_failure(ns, log, tmp):
    """A kernel failure at the resident upload fails that job (no rung
    takes it) and leaves the next job alone."""
    rule = ns.faults.FaultRule("plan.alloc", kind="kernel", nth=1)
    svc = _svc(ns, device_budget_bytes=64 << 20, queues=2)
    with ns.faults.inject.active(ns.faults.FaultPlan(seed=0, rules=(rule,))):
        ids = [svc.submit(_req(ns, _t1()[ns.name])),
               svc.submit(_req(ns, _t2()[ns.name]))]
    svc.run()
    return svc, ids


def sc_quantum_faults(ns, log, tmp):
    rules = (ns.faults.FaultRule("runtime.quantum", kind="exception", nth=2),
             ns.faults.FaultRule("factors.nan", nth=4))
    svc = _svc(ns, device_budget_bytes=64 << 20, queues=2)
    with ns.faults.inject.active(ns.faults.FaultPlan(seed=0, rules=rules)):
        ids = [svc.submit(_req(ns, _t1()[ns.name], seed=s, iters=4))
               for s in range(3)]
        svc.run()
    return svc, ids


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_three_jobs_two_tensors, sc_fast_path_and_streaming,
    sc_admission_queues, sc_resident_pool, sc_stream_pool,
    sc_working_set_budget, sc_failed_job_isolated, sc_cancel_running,
    sc_weighted_shares, sc_spill_tier, sc_kernel_failure,
    sc_quantum_faults)}


def _play(ns, scenario):
    """Run one scenario; returns what it logged (summaries and numbers)
    ending with the final summary, the jobs' fits and the service."""
    log = []
    with tempfile.TemporaryDirectory() as tmp:
        svc, ids = SCENARIOS[scenario](ns, log, Path(tmp))
        log.append(_summary(svc, ids))
        return log, _fits(svc, ids), svc


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_matches_reference(scenario):
    """States, iterations, backends, payload types, registry and
    admission counts, pools, traces and metric keys equal the
    reference's at every recorded point; fits within FIT_TOL."""
    r_log, r_fits, _ = _play(REF, scenario)
    p_log, p_fits, svc = _play(PORT, scenario)
    assert p_log == r_log
    for rf, pf in zip(r_fits, p_fits):
        assert len(rf) == len(pf)
        if rf:
            np.testing.assert_allclose(pf, rf, rtol=0, atol=FIT_TOL)
    assert svc.service_metrics()["admitted_reservation_bytes"] == 0


def test_scenarios_exercise_every_regime_and_failure():
    """The scenarios above really cover the three backends, queueing,
    cancellation and the failure payloads they compare."""
    seen_backends, seen_payloads = set(), set()
    for name in ("fast_path_and_streaming", "spill_tier", "kernel_failure",
                 "quantum_faults", "failed_job_isolated"):
        snaps, _, _ = _play(PORT, name)
        seen_backends |= set(snaps[-1]["backends"])
        seen_payloads |= set(snaps[-1]["payloads"])
    assert {"in_memory", "streamed", "disk_streamed"} <= seen_backends
    assert {"KernelFailure", "FactorPoisonError",
            "RuntimeError"} <= seen_payloads


def test_three_jobs_match_a_solo_plan_and_each_other():
    """The acceptance scenario: per-job fits match a solo plan run on
    the same seeds, and identical submissions give identical factors
    (one shared resident copy)."""
    snaps, fits, svc = _play(PORT, "three_jobs_two_tensors")
    assert snaps[-1]["registry"][:2] == (1, 2)
    t = _t1()["port"]
    b = core.build_blco(t, max_nnz_per_block=BLOCK)
    plan = engine.plan_for(b, 64 << 20, rank=6, backend="in_memory", **CPU)
    ref = core.cp_als(plan, t.dims, 6, norm_x=float(np.linalg.norm(
        t.values.astype(np.float64))), iters=5, seed=7, tol=0.0,
        device="cpu")
    plan.close()
    np.testing.assert_allclose(fits[0], ref.fits, rtol=0, atol=FIT_TOL)
    a, c = (svc.result(j).result.factors for j in (0, 2))
    assert all(torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("scenario", ["three_jobs_two_tensors", "spill_tier",
                                      "stream_pool"])
def test_port_cpu_service_is_deterministic(scenario):
    """Two runs of one scenario give bit-identical fits and factors: the
    plain CPU path is deterministic, so the bitwise contracts hold."""
    _, fits_a, a = _play(PORT, scenario)
    _, fits_b, b = _play(PORT, scenario)
    assert fits_a == fits_b
    for j in a.scheduler.jobs:
        fa, fb = a.scheduler.jobs[j].cp.factors, b.scheduler.jobs[j].cp.factors
        assert all(torch.equal(x, y) for x, y in zip(fa, fb))


def test_plain_hierarchical_mttkrp_is_deterministic():
    """The plain path's hierarchical resolution adds into its copies in a
    fixed order: repeated calls on one input are bit-identical also where
    the CPU splits the work over threads (``index_put_(accumulate=True)``
    reordered the additions run to run)."""
    from repro_torch.core.mttkrp import launch_mttkrp_impl
    dims = (30, 20, 40)
    t = core.random_tensor(dims, 3000, seed=0, dist="powerlaw")
    b = core.build_blco(t)
    chunk = core.LaunchChunks(b, b.launches[0].nnz).chunk(0)
    args = [torch.from_numpy(a) for a in chunk[:4]]
    fs = core.init_factors(dims, 32, seed=1, device="cpu")

    def call():
        return launch_mttkrp_impl(*args, fs, re_fields=b.re.field_bits,
                                  re_shifts=b.re.field_shift, mode=0,
                                  out_rows=dims[0],
                                  resolution="hierarchical", copies=4)
    first = call()
    assert all(torch.equal(first, call()) for _ in range(10))


def test_a_job_is_bit_identical_whatever_runs_beside_it():
    """At rank 32 (where the plain path splits over threads) one job's
    fits are bit-identical alone, beside a job on the same tensor, and
    beside jobs on another tensor: the CPU service is deterministic."""
    t = core.random_tensor((30, 20, 40), 3000, seed=0, dist="powerlaw")
    u = core.random_tensor((18, 24, 11, 17), 2000, seed=0, dist="powerlaw")

    def fits(jobs):
        svc = _svc(PORT, device_budget_bytes=1 << 30)
        ids = [svc.submit(service.SubmitDecomposition(
            tensor=x, rank=32, iters=2, tol=0.0, seed=s)) for x, s in jobs]
        svc.run()
        return svc.result(ids[0]).result.fits
    alone = fits([(t, 1)])
    assert fits([(t, 1)]) == alone
    assert fits([(t, 1), (t, 2), (u, 3)]) == alone


def test_oversized_job_rejected_at_submit_by_both():
    for ns in (REF, PORT):
        svc = _svc(ns, device_budget_bytes=1024, queues=4)
        with pytest.raises(ValueError, match="can never be admitted"):
            svc.submit(_req(ns, _t1()[ns.name]))


def test_mttkrp_query_matches_reference_on_the_service_device():
    t = _t1()
    rng = np.random.default_rng(0)
    factors = [rng.standard_normal((d, 8)).astype(np.float32)
               for d in t["ref"].dims]
    rsvc = _svc(REF, device_budget_bytes=64 << 20, queues=3)
    psvc = _svc(PORT, device_budget_bytes=64 << 20, queues=3)
    for mode in range(3):
        want = np.asarray(rsvc.mttkrp(rservice.MTTKRPQuery(
            tensor=t["ref"], factors=factors, mode=mode,
            build=rservice.BuildParams(max_nnz_per_block=BLOCK))))
        got = psvc.mttkrp(service.MTTKRPQuery(
            tensor=t["port"], factors=[torch.from_numpy(f) for f in factors],
            mode=mode, build=service.BuildParams(max_nnz_per_block=BLOCK)))
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert rel < QUERY_TOL
    assert (psvc.registry.misses, psvc.registry.hits) == (1, 2)
    assert psvc.service_metrics()["admitted_reservation_bytes"] == 0
    assert psvc.engine.resident_count == psvc.engine.pool_size == 0
    tiny = _svc(PORT, device_budget_bytes=1024)
    with pytest.raises(ValueError, match="does not fit the device budget"):
        tiny.mttkrp(service.MTTKRPQuery(tensor=t["port"], factors=factors,
                                        mode=0))
    assert tiny.engine.pool_size == tiny.engine.resident_count == 0


# ------------------------------------------------- the fingerprint, the store
@pytest.mark.parametrize("build", [{}, {"max_nnz_per_block": BLOCK},
                                   {"target_bits": 32}])
def test_fingerprint_equals_reference(build):
    t = _t1()
    for reservation in (None, 4096):
        assert service.fingerprint(t["port"], service.BuildParams(**build),
                                   reservation) == \
            rservice.fingerprint(t["ref"], rservice.BuildParams(**build),
                                 reservation)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_store_written_by_one_package_is_adopted_by_the_other(writer,
                                                              tmp_path):
    """A registration persisted by either package's registry is a disk
    hit in the other's (no build), and reloads to the same BLCO."""
    t = _t1()
    ns_w, ns_r = (REF, PORT) if writer == "ref" else (PORT, REF)
    wreg = ns_w.service.TensorRegistry(store_dir=str(tmp_path))
    wh = wreg.register(t[ns_w.name], build=ns_w.service.BuildParams(
        max_nnz_per_block=BLOCK))
    wreg.persist(wh.key)
    rreg = ns_r.service.TensorRegistry(store_dir=str(tmp_path))
    rh = rreg.register(t[ns_r.name], build=ns_r.service.BuildParams(
        max_nnz_per_block=BLOCK))
    assert (rreg.hits, rreg.disk_hits, rreg.misses) == (1, 1, 0)
    assert rh.key == wh.key and not rh.resident
    assert rh.spec.nnz == wh.spec.nnz and rh.norm_x == wh.norm_x
    rreg.load(rh.key)
    for name in ("idx_hi", "idx_lo", "values"):
        assert np.array_equal(np.asarray(getattr(rh.blco, name)),
                              np.asarray(getattr(wh.blco, name)))


# ---------------------------------------------------------- the shared ring
def _streamed_service(t, jobs, **kw):
    h = _probe(PORT, t)
    fb = engine.factor_bytes(h.dims, 4, np.float32)
    svc = _svc(PORT, device_budget_bytes=h.spec.bytes_in_flight(2)
               + jobs * fb + 1024, queues=2, **kw)
    return svc, h


@pytest.mark.parametrize("tier", ["streamed", "disk_streamed"])
def test_pooled_streamed_jobs_share_one_ring(tier, tmp_path):
    """Two streamed jobs on one reservation spec hold ONE StreamBuffers:
    the pool entry's.  Closing the first keeps the ring open; closing
    the second closes it and empties the pool.  Admission's bytes equal
    the ring's plus the two working sets."""
    t = _t1()["port"]
    kw = {} if tier == "streamed" else {
        "store_dir": str(tmp_path), "host_budget_bytes": 1}
    svc, h = _streamed_service(t, 2, **kw)
    ids = [svc.submit(_req(PORT, _t1()["port"], seed=s, iters=50))
           for s in range(2)]
    plans = [svc.scheduler.jobs[j].plan for j in ids]
    assert [p.backend for p in plans] == [tier, tier]
    [entry] = svc.engine._stream_pool.values()
    ring = entry.buffers
    assert isinstance(ring, StreamBuffers) and entry.refcount == 2
    assert plans[0].buffers is ring and plans[1].buffers is ring
    fb = engine.factor_bytes(h.dims, 4, np.float32)
    assert svc.engine.pooled_bytes() == ring.device_bytes() == \
        h.spec.bytes_in_flight(2)
    assert svc.service_metrics()["admitted_reservation_bytes"] == \
        ring.device_bytes() + 2 * fb
    svc.step()
    svc.step()
    assert svc.cancel(ids[0]).freed_bytes == fb
    assert not ring.closed and svc.engine.pool_size == 1
    svc.step()                                     # the survivor still runs
    assert svc.cancel(ids[1]).freed_bytes == ring.spec.bytes_in_flight(2) \
        + fb
    assert ring.closed and svc.engine.pool_size == 0
    assert svc.scheduler.jobs[ids[0]].handle.pins == 0


def test_a_failed_plan_construction_leaves_pool_and_pins_as_they_were(
        tmp_path, monkeypatch):
    """The pool joins are exception-safe: a plan that fails to construct
    (here: its store file is gone) neither strands a refcount, a pin nor
    an open ring — for the joiner that creates the entry and for one that
    joins it."""
    svc, h = _streamed_service(_t1()["port"], 3, store_dir=str(tmp_path),
                               host_budget_bytes=1)
    first = svc.submit(_req(PORT, _t1()["port"], seed=0, iters=50))
    handle = svc.scheduler.jobs[first].handle
    [entry] = svc.engine._stream_pool.values()
    assert (entry.refcount, handle.pins) == (1, 1)
    monkeypatch.setattr(type(handle), "open_stored", lambda self: (
        _ for _ in ()).throw(store.StoreError("store file gone")))
    joiner = svc.submit(_req(PORT, _t1()["port"], seed=1))
    assert svc.status(joiner).state == "failed"
    assert svc.status(joiner).error_payload["type"] == "StoreError"
    assert (entry.refcount, handle.pins) == (1, 1)
    assert not entry.buffers.closed
    svc.cancel(first)
    assert entry.buffers.closed and svc.engine.pool_size == 0
    creator = svc.submit(_req(PORT, _t1()["port"], seed=2))
    assert svc.status(creator).state == "failed"
    assert svc.engine.pool_size == 0 and handle.pins == 0
    assert svc.service_metrics()["admitted_reservation_bytes"] == 0


def test_kernel_failure_fails_the_job_and_never_falls_back():
    """An injected kernel failure at a job's plan fails that job with a
    KernelFailure payload: the service demotes only on allocation
    failures, so the job is not re-planned in another regime."""
    snaps, _, svc = _play(PORT, "kernel_failure")
    assert snaps[-1]["states"] == ["failed", "done"]
    payload = svc.status(0).error_payload
    assert payload["type"] == "KernelFailure" and payload["injected"]
    assert snaps[-1]["counts"][4] == 0             # no demotion
    assert svc.scheduler.jobs[0].cp is None        # never swept


def test_poisoned_factor_is_a_copy():
    """The factors.nan injection writes into a copy: a tensor handed out
    before the quantum keeps its values."""
    svc = _svc(PORT, device_budget_bytes=64 << 20)
    jid = svc.submit(_req(PORT, _t1()["port"], iters=4))
    svc.step()
    held = svc.scheduler.jobs[jid].cp.factors[1]
    before = held.clone()
    rule = faults.FaultRule("factors.nan", nth=1)
    with faults.inject.active(faults.FaultPlan(seed=0, rules=(rule,))):
        svc.step()
    assert svc.status(jid).error_payload["type"] == "FactorPoisonError"
    assert torch.equal(held, before)


# -------------------------------------------------- DiskStreamedPlan spec=
def test_disk_streamed_plan_pads_to_a_larger_spec(tmp_path):
    """``DiskStreamedPlan(spec=...)`` with a reservation larger than the
    store's pads each chunk into the larger ring, as the reference's
    accounts for it: the same device bytes as the reference's plan and
    the same result as the store's own reservation."""
    t = _t1()
    b = core.build_blco(t["port"], max_nnz_per_block=BLOCK)
    path = str(tmp_path / "t.blco")
    store.save_blco(b, path)
    rb = rcore.build_blco(t["ref"], max_nnz_per_block=BLOCK)
    rpath = str(tmp_path / "r.blco")
    rstore.save_blco(rb, rpath)
    plain = store.DiskStreamedPlan(path, queues=2, **CPU)
    spec = core.ReservationSpec(nnz=4 * plain.spec.nnz, order=3,
                                value_itemsize=4)
    big = store.DiskStreamedPlan(path, queues=2, spec=spec, **CPU)
    ref = rstore.DiskStreamedPlan(rpath, queues=2, spec=RSpec(
        nnz=spec.nnz, order=3, value_itemsize=4))
    assert big.spec == spec and big.buffers.spec == spec
    assert big.device_bytes() == ref.device_bytes() == \
        spec.bytes_in_flight(2)
    assert big.host_window_bytes() == ref.host_window_bytes()
    fs = core.init_factors(b.dims, 4, seed=1, device="cpu")
    for mode in range(3):
        assert torch.equal(big.mttkrp(fs, mode), plain.mttkrp(fs, mode))
    small = core.ReservationSpec(nnz=plain.spec.nnz // 2, order=3,
                                 value_itemsize=4)
    with pytest.raises(ValueError, match="cannot hold"):
        store.DiskStreamedPlan(path, spec=small, **CPU)
    assert big.close() == ref.close() == spec.bytes_in_flight(2)
    plain.close()


@pytest.mark.parametrize("cls", ["streamed", "disk_streamed"])
def test_a_plan_given_a_ring_does_not_close_it(cls, tmp_path):
    b = core.build_blco(_t1()["port"], max_nnz_per_block=BLOCK)
    spec = core.reservation_for(b)
    ring = StreamBuffers(spec, 2, np.float32, device="cpu")
    if cls == "streamed":
        plan = engine.StreamedPlan(b, queues=2, buffers=ring, **CPU)
    else:
        path = str(tmp_path / "t.blco")
        store.save_blco(b, path)
        plan = store.DiskStreamedPlan(path, queues=2, buffers=ring, **CPU)
    fs = core.init_factors(b.dims, 4, seed=1, device="cpu")
    own = engine.StreamedPlan(b, queues=2, **CPU)
    assert torch.equal(plan.mttkrp(fs, 0), own.mttkrp(fs, 0))
    assert plan.close() == own.close() == spec.bytes_in_flight(2)
    assert not ring.closed and own.buffers is None
    assert plan.device_bytes() == 0
    with pytest.raises(RuntimeError, match="closed"):
        plan.mttkrp(fs, 0)
    ring.close()
