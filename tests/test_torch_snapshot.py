"""The port's service persistence (``repro_torch.store.snapshot``) on the
CPU: snapshot mid-run, restore in a fresh service, resume; manifests that
equal the JAX package's; and snapshot directories that restore across
the two packages in both directions.

Every port service runs ``kernel="torch", device="cpu"``; data passes
between the packages only as numpy arrays (tensors) and files."""
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro import service as rservice  # noqa: E402
from repro_torch import core, service  # noqa: E402
from repro_torch.store import (StoreError, restore_service,  # noqa: E402
                               snapshot_service)

CPU = {"kernel": "torch", "device": "cpu"}
BUDGET = 64 << 20
BLOCK = 1 << 10
WAIT_S = 60
# a resumed run against an uninterrupted one when the two ran in different
# regimes (the restored job disk-streams from the store, the uninterrupted
# one ran in memory): the JAX package itself misses this comparison
# bitwise (tests/test_snapshot.py::test_snapshot_restore_resumes_exactly),
# so both packages are held at the port's fit tolerance across regimes
FIT_TOL = 1e-4

PKGS = {"ref": (rservice, {}), "port": (service, CPU)}


def _tensors(seed=0):
    r = rcore.paper_like("uber-like", seed=seed)
    p = core.SparseTensor(dims=tuple(r.dims), indices=np.array(r.indices),
                          values=np.array(r.values))
    return {"ref": r, "port": p}


def _svc(name, **kw):
    pkg, extra = PKGS[name]
    return pkg.DecompositionService(device_budget_bytes=BUDGET, **kw,
                                    **extra)


def _submit(name, svc, t, *, iters=6, seed=1, tenant="acme", weight=2.0,
            rank=8):
    pkg, _ = PKGS[name]
    return svc.submit(pkg.SubmitDecomposition(
        tensor=t, rank=rank, iters=iters, tol=0.0, seed=seed,
        build=pkg.BuildParams(max_nnz_per_block=BLOCK), tenant=tenant,
        weight=weight))


def _uninterrupted(name, t, store):
    svc = _svc(name, store_dir=store)
    jid = _submit(name, svc, t)
    svc.run()
    return svc.result(jid).result.fits


def _snapshot_after(name, t, store, snap, sweeps=3):
    svc = _svc(name, store_dir=store)
    jid = _submit(name, svc, t)
    for _ in range(sweeps):
        svc.step()
    return jid, svc.snapshot(snap)


def test_snapshot_requires_store_dir(tmp_path):
    svc = _svc("port")
    _submit("port", svc, _tensors()["port"])
    with pytest.raises(StoreError, match="store_dir"):
        svc.snapshot(str(tmp_path / "snap"))


def test_restore_missing_manifest_raises(tmp_path):
    with pytest.raises(StoreError, match="manifest"):
        restore_service(str(tmp_path / "nope"), _svc("port"))


def test_snapshot_restore_resumes(tmp_path):
    """Kill the service mid-decomposition, restore from the store: the
    original id, tenant and weight survive, no BLCO is rebuilt, the job
    disk-streams, and its fits follow the uninterrupted run's."""
    t = _tensors()["port"]
    store, snap = str(tmp_path / "store"), str(tmp_path / "snap")
    ref_fits = _uninterrupted("port", t, store)
    jid, manifest = _snapshot_after("port", t, store, snap)
    assert [j["job_id"] for j in manifest["jobs"]] == [jid]
    assert manifest["jobs"][0]["iteration"] == 3
    svc2 = service.DecompositionService.restore(
        snap, device_budget_bytes=BUDGET, store_dir=store, **CPU)
    st = svc2.status(jid)
    assert (st.state, st.iteration, st.tenant, st.weight) == \
        ("running", 3, "acme", 2.0)
    assert svc2.registry.misses == 0
    assert st.backend == "disk_streamed"
    cp = svc2.scheduler.jobs[jid].cp
    assert all(f.device.type == "cpu" and f.dtype == torch.float32
               for f in cp.factors)
    svc2.run()
    fits = svc2.result(jid).result.fits
    assert fits[:3] == ref_fits[:3]           # the checkpointed prefix
    np.testing.assert_allclose(fits, ref_fits, rtol=0, atol=FIT_TOL)
    m = svc2.service_metrics()
    assert m["jobs_restored"] == 1 and m["disk_bytes_total"] > 0


def test_manifest_and_checkpoint_equal_the_reference(tmp_path):
    """Both packages write the same manifest (but for absolute paths) and
    the same ``.npz`` keys, shapes and dtypes, with factors within the
    fit tolerance."""
    t = _tensors()
    out = {}
    for name in PKGS:
        store, snap = str(tmp_path / name / "store"), \
            str(tmp_path / name / "snap")
        jid, manifest = _snapshot_after(name, t[name], store, snap)
        for rec in manifest["tensors"].values():
            assert os.path.exists(rec["file"])
            rec["file"] = os.path.basename(rec["file"])
        with np.load(os.path.join(snap, f"job_{jid}.npz")) as z:
            arrays = {k: np.array(z[k]) for k in z.files}
        with open(os.path.join(snap, "manifest.json")) as f:
            assert json.load(f)["version"] == manifest["version"]
        out[name] = manifest, arrays
    (rm, ra), (pm, pa) = out["ref"], out["port"]
    assert pm == rm
    assert sorted(pa) == sorted(ra)
    for k in ra:
        assert pa[k].shape == ra[k].shape and pa[k].dtype == ra[k].dtype, k
        np.testing.assert_allclose(pa[k], ra[k], rtol=0, atol=FIT_TOL
                                   if k.startswith(("factor", "fits"))
                                   else 1e-3 * np.abs(ra[k]).max(), err_msg=k)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_snapshot_restores_across_packages(writer, reader, tmp_path):
    """A snapshot directory (and its store) written by one package
    restores in the other, which adopts the tensor without a build and
    finishes within the fit tolerance of the writer's own restore."""
    t = _tensors()
    store, snap = str(tmp_path / "store"), str(tmp_path / "snap")
    jid, _ = _snapshot_after(writer, t[writer], store, snap)
    fits = {}
    for name in (writer, reader):
        pkg, extra = PKGS[name]
        svc = pkg.DecompositionService.restore(
            snap, device_budget_bytes=BUDGET, store_dir=store, **extra)
        assert svc.registry.misses == 0
        assert svc.status(jid).iteration == 3
        svc.run()
        fits[name] = svc.result(jid).result.fits
    assert fits[reader][:3] == fits[writer][:3]
    np.testing.assert_allclose(fits[reader], fits[writer], rtol=0,
                               atol=FIT_TOL)


def test_snapshot_keeps_terminal_jobs_and_queued(tmp_path):
    store, snap = str(tmp_path / "store"), str(tmp_path / "snap")
    svc = _svc("port", store_dir=store, max_active=1)
    t0, t1 = _tensors()["port"], _tensors(seed=1)["port"]
    done = _submit("port", svc, t0, iters=1)
    while svc.status(done).state == "running":
        svc.step()
    running = _submit("port", svc, t0, iters=5, seed=2)
    queued = _submit("port", svc, t1, iters=5, seed=3)
    svc.step()
    assert [svc.status(j).state for j in (done, running, queued)] == \
        ["done", "running", "queued"]
    done_factors = svc.result(done).result.factors[0].clone()
    manifest = svc.snapshot(snap)
    assert {j["job_id"] for j in manifest["jobs"]} == {done, running, queued}
    svc2 = service.DecompositionService.restore(
        snap, device_budget_bytes=BUDGET, store_dir=store, **CPU)
    assert svc2.status(done).state == "done"
    assert done not in svc2.scheduler.pending + svc2.scheduler.active
    assert torch.equal(svc2.result(done).result.factors[0], done_factors)
    svc2.run()
    assert svc2.status(running).state == svc2.status(queued).state == "done"
    new = _submit("port", svc2, _tensors(seed=2)["port"], iters=1)
    assert new > queued


def test_snapshot_is_nonintrusive(tmp_path):
    """Snapshotting persists tensors but keeps the host copy and leaves
    the running decomposition bit-identical (one regime throughout)."""
    t = _tensors()["port"]
    store, snap = str(tmp_path / "store"), str(tmp_path / "snap")
    ref_fits = _uninterrupted("port", t, store)
    svc = _svc("port", store_dir=store)
    jid = _submit("port", svc, t)
    svc.step()
    handle = svc.scheduler.jobs[jid].handle
    was_resident = handle.resident
    svc.snapshot(snap)
    assert handle.resident == was_resident
    svc.run()
    assert svc.result(jid).result.fits == ref_fits


def test_runtime_snapshot_from_the_caller_thread_mid_flight(tmp_path):
    """``ServiceRuntime.snapshot`` from the caller's thread while the
    worker sweeps: taken at a quantum boundary, so the checkpoint is a
    complete sweep; a restarted runtime resumes it to the end and the
    checkpointed prefix is exactly what the first process computed."""
    t = _tensors()["port"]
    store, snap = str(tmp_path / "store"), str(tmp_path / "snap")
    with service.ServiceRuntime(device_budget_bytes=BUDGET, store_dir=store,
                                **CPU) as rt:
        jid = rt.submit(service.SubmitDecomposition(
            tensor=t, rank=8, iters=30, tol=0.0, seed=1, tenant="acme",
            build=service.BuildParams(max_nnz_per_block=BLOCK)))
        feed = rt.subscribe(jid)
        while True:
            ev = feed.get(timeout=WAIT_S)
            assert ev is not None
            if ev.kind == "iteration" and ev.iteration >= 2:
                prefix = list(ev.fits)
                break
        rt.unsubscribe(feed)
        manifest = rt.snapshot(snap)
    [rec] = manifest["jobs"]
    assert rec["state"] == "running" and rec["iteration"] >= 2
    with np.load(os.path.join(snap, f"job_{jid}.npz")) as z:
        assert len(z["fits"]) == int(z["iteration"]) == rec["iteration"]
    rt2 = service.ServiceRuntime.restore(snap, device_budget_bytes=BUDGET,
                                         store_dir=store, **CPU)
    with rt2:
        status = rt2.wait(jid, timeout=WAIT_S)
    assert status.state == "done" and status.iteration == 30
    assert rt2.service.registry.misses == 0
    fits = rt2.result(jid).result.fits
    k = min(len(prefix), rec["iteration"])
    assert k >= 2 and fits[:k] == prefix[:k]


def test_snapshot_service_and_restore_service_direct(tmp_path):
    """The store-level entry points, as the service calls them."""
    t = _tensors()["port"]
    store, snap = str(tmp_path / "store"), str(tmp_path / "snap")
    svc = _svc("port", store_dir=store)
    jid = _submit("port", svc, t, iters=2)
    svc.step()
    manifest = snapshot_service(svc, snap)
    fresh = _svc("port", store_dir=store)
    assert restore_service(snap, fresh) == [jid]
    assert fresh.status(jid).iteration == manifest["jobs"][0]["iteration"]
