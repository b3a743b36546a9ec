"""The multi-tenant service on the card: K1/K2 under every job, one pooled
ring for two streamed jobs (by ``memory_allocated`` and pinned bytes), a
snapshot from the caller's thread while the worker sweeps, a genuine
``torch.cuda.OutOfMemoryError`` demoting a job inside the service, and
the spread of two identical runs (printed: K1's atomics reorder float
additions).

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips where no card is present.  This file imports only the port:

    PYTHONPATH=src python -m pytest -m gpu -s tests/test_torch_service_gpu.py
"""
import os

import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.core.streaming import StreamBuffers
from repro_torch.engine import InMemoryPlan, StreamedPlan, factor_bytes
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.service import (BuildParams, DecompositionService,
                                 ServiceRuntime, SubmitDecomposition,
                                 TensorRegistry)

pytestmark = pytest.mark.gpu

RANK = 32
# per-sweep fit, K1/K2 on the card vs the plain path on the card (f32;
# the pseudo-inverse amplifies the atomics' reordered additions)
FIT_TOL = 1e-3
WAIT_S = 120
# order 4 with a stash mode (24 rows, K2), many launches
DIMS, NNZ, BLOCK = (183, 24, 1140, 1717), 60_000, 3_000
# the OOM test: launches of up to 2^17 non-zeros, so the resident launch
# cache is tens of MB beside a ring of a few
BIG_NNZ, BIG_BLOCK = 1_500_000, 1 << 17


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _tensor(nnz=NNZ, seed=2, dist="powerlaw"):
    return core.random_tensor(DIMS, nnz, seed=seed, dist=dist)


def _req(t, *, seed=1, iters=3, block=BLOCK, **kw):
    return SubmitDecomposition(tensor=t, rank=RANK, iters=iters, tol=0.0,
                               seed=seed, build=BuildParams(
                                   max_nnz_per_block=block), **kw)


def _state_bytes(cp) -> int:
    return sum(x.numel() * x.element_size()
               for x in list(cp.factors) + list(cp.grams) + [cp.lam])


def test_service_jobs_run_k1_k2_and_match_the_plain_path(cuda):
    """Three jobs (two sharing one resident copy) run every sweep through
    K1/K2: one launch per mode per sweep, fits within FIT_TOL of the
    plain path on the card."""
    t = _tensor()
    svc = DecompositionService(device_budget_bytes=1 << 30, device=cuda)
    ids = [svc.submit(_req(t, seed=s)) for s in (1, 2)]
    ids.append(svc.submit(_req(_tensor(seed=3), seed=3)))
    assert svc.engine.resident_count == 2
    reset_launch_counts()
    svc.run()
    launched = launch_counts["segment"] + launch_counts["stash"]
    assert launched == 3 * 3 * len(DIMS)
    plain = DecompositionService(device_budget_bytes=1 << 30, device=cuda,
                                 kernel="torch")
    pid = plain.submit(_req(t, seed=1))
    plain.run()
    got, want = svc.result(ids[0]).result, plain.result(pid).result
    assert all(f.is_cuda for f in got.factors)
    assert max(abs(a - b) for a, b in zip(got.fits, want.fits)) < FIT_TOL


def test_two_streamed_jobs_hold_one_ring(cuda):
    """Two jobs on one reservation spec, admitted streamed: the device
    memory rises by ONE ring plus the jobs' state, and so does the pinned
    host memory of the open rings; the ring is freed with the last job."""
    t = _tensor(BIG_NNZ, dist="uniform")
    probe = StreamedPlan(core.build_blco(t, max_nnz_per_block=BIG_BLOCK),
                         queues=2, device=cuda)
    ring = probe.device_bytes()
    probe.close()
    in_mem = InMemoryPlan(core.build_blco(t, max_nnz_per_block=BIG_BLOCK),
                          device=cuda)
    resident = in_mem.device_bytes()
    in_mem.close()
    del in_mem
    fb = factor_bytes(DIMS, RANK, torch.float32)
    budget = ring + 2 * fb + (1 << 20)
    assert budget < resident + fb
    svc = DecompositionService(device_budget_bytes=budget, queues=2,
                               device=cuda)
    # cuBLAS and cuSOLVER keep their workspaces in the caching allocator:
    # make them before the count starts
    w = torch.randn(RANK, RANK, device=cuda)
    torch.linalg.pinv(w.T @ w)
    torch.cuda.synchronize()
    mem0, pinned0 = torch.cuda.memory_allocated(cuda), \
        StreamBuffers.pinned_bytes()
    ids = [svc.submit(_req(t, seed=s, iters=2, block=BIG_BLOCK))
           for s in (1, 2)]
    jobs = [svc.scheduler.jobs[j] for j in ids]
    assert [j.metrics.backend for j in jobs] == ["streamed", "streamed"]
    assert jobs[0].plan.buffers is jobs[1].plan.buffers
    assert svc.engine.pool_size == 1 and svc.engine.pooled_bytes() == ring
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated(cuda) - mem0
    want = ring + sum(_state_bytes(j.cp) for j in jobs)
    print(f"\n[service gpu] one ring {ring} B; memory_allocated rose "
          f"{rise} B (ring + states {want} B); pinned "
          f"{StreamBuffers.pinned_bytes() - pinned0} B")
    assert abs(rise - want) <= 1 << 20
    assert StreamBuffers.pinned_bytes() - pinned0 == ring
    svc.run()
    assert all(svc.status(j).state == "done" for j in ids)
    assert svc.engine.pool_size == 0
    assert StreamBuffers.pinned_bytes() == pinned0


def test_snapshot_from_the_caller_thread_while_the_worker_sweeps(cuda,
                                                                 tmp_path):
    """The worker sweeps on the card; the caller's ``snapshot`` takes the
    runtime lock, so it reads the factors at a quantum boundary, after
    the last sweep's kernels: the checkpoint equals the factors the job
    holds at that moment, and a restored runtime finishes the job within
    FIT_TOL of an uninterrupted run."""
    t = _tensor()
    store, snap = str(tmp_path / "store"), str(tmp_path / "snap")
    ref = DecompositionService(device_budget_bytes=1 << 30, device=cuda)
    rj = ref.submit(_req(t, iters=8))
    ref.run()
    ref_fits = ref.result(rj).result.fits
    with ServiceRuntime(device_budget_bytes=1 << 30, store_dir=store,
                        device=cuda) as rt:
        jid = rt.submit(_req(t, iters=8))
        feed = rt.subscribe(jid)
        while True:
            ev = feed.get(timeout=WAIT_S)
            assert ev is not None
            if ev.kind == "iteration" and ev.iteration >= 2:
                break
        rt.unsubscribe(feed)
        with rt._lock:
            manifest = rt.snapshot(snap)
            held = [f.cpu() for f in rt.scheduler.jobs[jid].cp.factors]
    [rec] = manifest["jobs"]
    with np.load(os.path.join(snap, f"job_{jid}.npz")) as z:
        for n, f in enumerate(held):
            assert np.array_equal(z[f"factor_{n}"], f.numpy())
        assert len(z["fits"]) == rec["iteration"] >= 2
    with ServiceRuntime.restore(snap, device_budget_bytes=1 << 30,
                                store_dir=store, device=cuda) as rt2:
        assert rt2.wait(jid, timeout=WAIT_S).state == "done"
        assert rt2.status(jid).backend == "disk_streamed"
        fits = rt2.result(jid).result.fits
    assert len(fits) == 8
    assert max(abs(a - b) for a, b in zip(fits, ref_fits)) < FIT_TOL


def _reserved_need(budget, t, cuda):
    """The allocator's reserved bytes at the peak of one job's admission
    and run under ``budget``, from an emptied cache; the job's backend
    and fits."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    svc = DecompositionService(device_budget_bytes=budget, queues=2,
                               device=cuda)
    j = svc.submit(_req(t, block=BIG_BLOCK))
    backend = svc.status(j).backend
    svc.run()
    torch.cuda.synchronize()
    need = torch.cuda.max_memory_reserved(cuda) - base
    fits = svc.result(j).result.fits
    del svc
    torch.cuda.empty_cache()
    return need, backend, fits


def test_a_real_oom_demotes_a_job_to_streamed_inside_the_service(cuda):
    """The caching allocator capped between what a streamed and a
    resident job reserve (each measured from an emptied cache): under an
    ample budget the resident upload raises a genuine OutOfMemoryError,
    the service's ladder takes the streamed rung, and the job finishes
    within FIT_TOL of an uncapped run."""
    t = _tensor(BIG_NNZ, dist="uniform")
    spec = TensorRegistry().register(
        t, build=BuildParams(max_nnz_per_block=BIG_BLOCK)).spec
    fb = factor_bytes(DIMS, RANK, torch.float32)
    in_need, in_backend, want = _reserved_need(1 << 34, t, cuda)
    st_need, st_backend, _ = _reserved_need(
        spec.bytes_in_flight(2) + fb + (1 << 20), t, cuda)
    assert (in_backend, st_backend) == ("in_memory", "streamed")
    assert st_need + (8 << 20) < in_need, (st_need, in_need)
    svc = DecompositionService(device_budget_bytes=1 << 34, queues=2,
                               device=cuda)
    total = torch.cuda.get_device_properties(cuda).total_memory
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cap = torch.cuda.memory_reserved(cuda) + (in_need + st_need) // 2
    torch.cuda.set_per_process_memory_fraction(cap / total, cuda)
    try:
        jid = svc.submit(_req(t, block=BIG_BLOCK))
        st = svc.status(jid)
        assert (st.state, st.backend) == ("running", "streamed")
        assert svc.service_metrics()["demotions_total"] == 1
        svc.run()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, cuda)
        torch.cuda.empty_cache()
    got = svc.result(jid).result.fits
    assert max(abs(a - c) for a, c in zip(got, want)) < FIT_TOL


def test_rerun_spread_of_one_job(cuda):
    """The same job on two fresh services: printed, not gated (K1's
    atomics reorder float additions, so the runs need not agree bit for
    bit) — the evidence a deterministic plan option would rest on."""
    t = _tensor()
    runs = []
    for _ in range(2):
        svc = DecompositionService(device_budget_bytes=1 << 30, device=cuda)
        j = svc.submit(_req(t, iters=5))
        svc.run()
        runs.append(svc.result(j).result)
    a, b = runs
    dfit = max(abs(x - y) for x, y in zip(a.fits, b.fits))
    dfac = max(float((x - y).abs().max()) for x, y in zip(a.factors,
                                                          b.factors))
    same = a.fits == b.fits and all(torch.equal(x, y) for x, y in
                                    zip(a.factors, b.factors))
    print(f"\n[service gpu] rerun of one job: bit-identical {same}, max "
          f"|dfit| {dfit:.3e}, max |dfactor| {dfac:.3e}")
    assert dfit < FIT_TOL
