"""The port's asynchronous service runtime (``repro_torch.service.runtime``)
against the JAX package's on the CPU: the worker thread, cancellation,
streamed status events, weighted shares, waits that time out, the
worker-failure surface and a threaded race under the sanitizer.

Every port runtime runs ``kernel="torch", device="cpu"``; every wait on
the worker thread carries its own timeout, so a hang fails in seconds."""
import asyncio
import sys
import threading

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro import service as rservice  # noqa: E402
from repro_torch import core, service  # noqa: E402
from repro_torch.analysis.sanitize import sanitized  # noqa: E402
from repro_torch.engine import factor_bytes  # noqa: E402
from repro_torch.service import (BuildParams, CancelJob,  # noqa: E402
                                 DecompositionService, ServiceRuntime,
                                 SetWeight, SubmitDecomposition)

CPU = {"kernel": "torch", "device": "cpu"}
FIT_TOL = 1e-4
WAIT_S = 60
BUDGET = 64 << 20
BUILD = {"max_nnz_per_block": 256}


def _tensors(seed=6):
    r = rcore.random_tensor((30, 22, 14), 1500, seed=seed, dist="powerlaw")
    p = core.SparseTensor(dims=tuple(r.dims), indices=np.array(r.indices),
                          values=np.array(r.values))
    return r, p


def _req(t, pkg=service, *, seed=0, iters=4, tenant="default", weight=1.0):
    return pkg.SubmitDecomposition(
        tensor=t, rank=4, iters=iters, seed=seed, tol=0.0, tenant=tenant,
        weight=weight, build=pkg.BuildParams(**BUILD))


def _runtime(**kw):
    return ServiceRuntime(device_budget_bytes=BUDGET, queues=2, **CPU, **kw)


def _events(rt_cls, t, pkg, kw):
    """Submit one job with a feed subscribed first; its event kinds,
    iterations and final fits."""
    with rt_cls(device_budget_bytes=BUDGET, queues=2, **kw) as rt:
        feed = rt.subscribe()
        j = rt.submit(_req(t, pkg, seed=0, iters=4, tenant="streaming"))
        events = []
        while True:
            ev = feed.get(timeout=WAIT_S)
            assert ev is not None, "feed closed or timed out"
            if ev.job_id == j:
                events.append(ev)
                if ev.terminal:
                    break
        rt.unsubscribe(feed)
        fits = rt.result(j).result.fits
    return events, fits


def test_status_feed_matches_reference():
    """Every sweep publishes a JobEvent carrying the fit trajectory; the
    port's event stream has the reference's kinds, iterations, states and
    backends, with fits within FIT_TOL."""
    r, p = _tensors()
    r_ev, r_fits = _events(rservice.ServiceRuntime, r, rservice, {})
    p_ev, p_fits = _events(ServiceRuntime, p, service, CPU)

    def shape(evs):
        return [(e.kind, e.state, e.iteration, len(e.fits), e.backend,
                 e.tenant, e.weight, sorted(e.metrics)) for e in evs]
    assert shape(p_ev) == shape(r_ev)
    assert [e.kind for e in p_ev][:2] == ["queued", "admitted"]
    assert [e.seq for e in p_ev] == sorted(e.seq for e in p_ev)
    np.testing.assert_allclose(p_fits, r_fits, rtol=0, atol=FIT_TOL)
    iters = [e for e in p_ev if e.kind == "iteration"]
    assert iters[-1].fits[:3] == iters[2].fits


def test_runtime_matches_sync_service_bitwise():
    _, t = _tensors()
    sync = DecompositionService(device_budget_bytes=BUDGET, queues=2, **CPU)
    sj = sync.submit(_req(t, seed=3))
    ref = sync.run()[sj]
    with _runtime() as rt:
        j = rt.submit(_req(t, seed=3))
        status = rt.wait(j, timeout=WAIT_S)
        assert status.state == "done" and status.iteration == 4
        got = rt.result(j)
        assert rt.drain(timeout=WAIT_S)
    assert got.result.fits == ref.result.fits
    for a, b in zip(got.result.factors, ref.result.factors):
        assert torch.equal(a, b)


def test_weighted_tenants_end_to_end_match_reference():
    """Weights (2, 1, 1) through the worker thread: the same per-tenant
    iterations as the reference, shares within 10% of 2:1:1."""
    r, p = _tensors()
    out = []
    for rt_cls, t, pkg, kw in ((rservice.ServiceRuntime, r, rservice, {}),
                               (ServiceRuntime, p, service, CPU)):
        with rt_cls(device_budget_bytes=BUDGET, queues=2, **kw) as rt:
            rt.submit(_req(t, pkg, seed=0, iters=8, tenant="A", weight=2.0))
            rt.submit(_req(t, pkg, seed=1, iters=4, tenant="B"))
            rt.submit(_req(t, pkg, seed=2, iters=4, tenant="C"))
            assert rt.drain(timeout=WAIT_S)
            out.append(rt.service_metrics())
    assert out[1]["tenant_iterations"] == out[0]["tenant_iterations"] == \
        {"A": 8, "B": 4, "C": 4}
    for tenant, expected in (("A", 0.5), ("B", 0.25), ("C", 0.25)):
        assert abs(out[1]["tenant_shares"][tenant] - expected) \
            <= 0.1 * expected
    assert sorted(out[1]) == sorted(out[0])


def test_async_stream_and_result():
    _, t = _tensors()

    async def drive(rt):
        agen = rt.stream(None)
        first = asyncio.ensure_future(anext(agen))
        await asyncio.sleep(0)
        j = rt.submit(_req(t, seed=1, iters=3, tenant="aio"))
        kinds = []
        ev = await asyncio.wait_for(first, WAIT_S)
        while True:
            if ev.job_id == j:
                kinds.append(ev.kind)
                if ev.terminal:
                    break
            ev = await asyncio.wait_for(anext(agen), WAIT_S)
        await agen.aclose()
        return kinds, await rt.result_async(j, timeout=WAIT_S)

    with _runtime() as rt:
        kinds, result = asyncio.run(drive(rt))
    assert kinds[:2] == ["queued", "admitted"]
    assert kinds.count("iteration") == 3 and kinds[-1] == "done"
    assert result.metrics["iterations"] == 3


def test_cancel_mid_run_frees_pooled_bytes():
    _, t = _tensors()
    with _runtime() as rt:
        j = rt.submit(_req(t, seed=0, iters=10_000, tenant="victim"))
        feed = rt.subscribe(j)
        ev = feed.get(timeout=WAIT_S)
        assert ev is not None and ev.job_id == j
        res = rt.cancel(CancelJob(job_id=j))
        assert res.cancelled and res.freed_bytes > 0
        assert rt.status(j).state == "cancelled"
        assert rt.service.engine.pooled_bytes() == 0
        assert rt.service_metrics()["admitted_reservation_bytes"] == 0
        assert rt.drain(timeout=WAIT_S)


def test_cancel_running_job_admits_the_waiter_with_reference_bytes():
    """Cancel frees the measured pooled bytes and admits the waiter in
    the same call — the same freed bytes as the reference's."""
    freed = []
    r, p = _tensors()
    for pkg, t, kw in ((rservice, r, {}), (service, p, CPU)):
        h = pkg.TensorRegistry().register(t, build=pkg.BuildParams(**BUILD))
        budget = h.in_memory_bytes + factor_bytes(h.dims, 4, np.float32)
        svc = pkg.DecompositionService(device_budget_bytes=budget, queues=2,
                                       **kw)
        j0 = svc.submit(_req(t, pkg, seed=0, iters=50))
        j1 = svc.submit(_req(t, pkg, seed=1, iters=2))
        for _ in range(3):
            svc.step()
        assert svc.status(j1).state == "queued"
        res = svc.cancel(j0)
        assert svc.status(j1).state == "running"
        assert svc.scheduler.jobs[j0].cp.iteration == 3
        freed.append((res.freed_bytes, svc.engine.pooled_bytes()))
        svc.run()
        assert svc.engine.pooled_bytes() == 0
    assert freed[1] == freed[0]


def test_wait_on_finished_job_and_subscribe_after_terminal():
    _, t = _tensors()
    with _runtime() as rt:
        j = rt.submit(_req(t, seed=0, iters=2))
        rt.wait(j, timeout=WAIT_S)
        assert rt.wait(j, timeout=1).state == "done"
        assert list(rt.subscribe(j)) == []
        with pytest.raises(ValueError, match="unknown job id"):
            rt.wait(j + 99, timeout=1)


def test_wait_and_drain_time_out_instead_of_hanging():
    """A job that cannot finish within the wait: ``wait`` raises
    TimeoutError and ``drain`` returns False, both within their timeout."""
    _, t = _tensors()
    with _runtime() as rt:
        j = rt.submit(_req(t, seed=0, iters=10_000))
        with pytest.raises(TimeoutError, match="still running"):
            rt.wait(j, timeout=0.2)
        assert rt.drain(timeout=0.2) is False
        rt.cancel(j)
        assert rt.drain(timeout=WAIT_S)


def test_worker_failure_surfaces_instead_of_hanging():
    _, t = _tensors()
    with _runtime(watchdog=False) as rt:
        def bomb(job, kind):
            if kind == "iteration":
                raise RuntimeError("observer boom")
        rt.scheduler.observers.append(bomb)
        rt.submit(_req(t, seed=0, iters=5))
        with pytest.raises(RuntimeError, match="worker failed"):
            rt.drain(timeout=WAIT_S)
        with pytest.raises(RuntimeError, match="worker failed"):
            rt.submit(_req(t, seed=1, iters=1))


def test_stop_is_idempotent_and_restart_rejected():
    rt = _runtime().start()
    with pytest.raises(RuntimeError, match="already started"):
        rt.start()
    rt.stop()
    rt.stop()


def test_runtime_race_stress_under_sanitizer():
    """Threaded submit/cancel/set_weight/status against a live runtime
    with every sanitizer check armed (ledger audit, lock ownership,
    factor checks) and a short switch interval: no SanitizerError, no
    lost job, the ledger drained to zero."""
    tensors = [core.random_tensor((10, 8, 6), nnz=100, seed=s)
               for s in range(3)]
    errors, ids = [], []
    ids_lock = threading.Lock()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with sanitized(), _runtime() as rt:
            def submitter(seed):
                try:
                    for i in range(3):
                        jid = rt.submit(SubmitDecomposition(
                            tensor=tensors[(seed + i) % 3], rank=4, iters=3,
                            tol=0.0, seed=seed, tenant=f"t{seed}",
                            weight=1.0 + seed, build=BuildParams()))
                        with ids_lock:
                            ids.append(jid)
                except BaseException as exc:      # noqa: BLE001
                    errors.append(exc)

            def meddler():
                try:
                    for _ in range(20):
                        with ids_lock:
                            seen = list(ids)
                        for jid in seen:
                            if rt.status(jid).state == "running":
                                try:
                                    rt.set_weight(SetWeight(weight=2.0,
                                                            job_id=jid))
                                except ValueError:
                                    pass      # finished in between: fine
                        rt.service_metrics()
                except BaseException as exc:      # noqa: BLE001
                    errors.append(exc)

            def canceller():
                try:
                    for _ in range(10):
                        with ids_lock:
                            seen = list(ids)
                        if seen:
                            rt.cancel(CancelJob(job_id=seen[0]))
                except BaseException as exc:      # noqa: BLE001
                    errors.append(exc)

            threads = [threading.Thread(target=submitter, args=(s,))
                       for s in range(3)]
            threads += [threading.Thread(target=meddler),
                        threading.Thread(target=canceller)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=WAIT_S)
            assert not any(th.is_alive() for th in threads)
            assert rt.drain(timeout=WAIT_S)
            assert not errors, errors
            states = {jid: rt.status(jid).state for jid in ids}
            assert len(states) == 9
            assert set(states.values()) <= {"done", "cancelled"}
            assert rt.scheduler.metrics.admitted_reservation_bytes == 0
    finally:
        sys.setswitchinterval(interval)


def test_scheduler_mutation_without_the_runtime_lock_is_caught():
    """With the sanitizer on, a scheduler owned by a runtime refuses a
    mutation from a thread that does not hold the runtime's lock."""
    from repro_torch.analysis.sanitize import SanitizerError
    _, t = _tensors()
    rt = _runtime()
    try:
        with sanitized():
            with pytest.raises(SanitizerError, match="runtime lock"):
                rt.service.submit(_req(t, seed=0, iters=1))
            with rt._lock:
                rt.service.submit(_req(t, seed=0, iters=1))
    finally:
        rt.stop()
