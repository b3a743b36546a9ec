"""Service persistence: snapshot/restore registry contents + job CPState.

The port of ``repro.store.snapshot``: the same manifest and ``.npz`` keys,
so a snapshot written by either package restores in the other; restored
state is put on the service's device.

A snapshot is a directory::

    manifest.json     registry entries (fingerprint key -> store file) and
                      job records (tenant, weight, rank, iters, ...)
    job_<id>.npz      the job's resumable CPState (factors, lam, fits, ...)

Tensors are NOT copied into the snapshot — they live in the registry's
spill store (``store_dir/<key>.blco``), written once and addressed by
content fingerprint, so any number of snapshots share one tensor file and
a restarted service re-admits jobs without rebuilding a single BLCO.

``restore_service`` replays non-terminal jobs into a fresh service under
their ORIGINAL job ids: each job re-enters the admission queue (plans are
re-planned against the new budget — the restarted process may have a
different one) and resumes CP-ALS from its checkpointed sweep, numerically
continuing where the killed process stopped.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.core.cp_als import CPState
from repro_torch.core.device import DEFAULT_DEVICE

from .format import StoreError

SNAPSHOT_VERSION = 1
MANIFEST = "manifest.json"

# job states that resume after a restart; terminal states (done/failed)
# are persisted too — as finished *records* whose results a restarted
# service keeps serving — but never re-enter admission
_RESUMABLE = ("queued", "running")
_PERSISTED = _RESUMABLE + ("done", "failed")


def _save_cp(path: str, cp: CPState) -> None:
    # atomic: write the full npz to a tmp file, then rename over the
    # destination, so a crash mid-write (or a reader racing an
    # auto-snapshot) never sees a truncated checkpoint.  The open file
    # handle matters: np.savez appends ".npz" to suffix-less *paths* but
    # writes file objects verbatim.
    # .cpu() on the current stream is ordered after the last sweep's
    # kernels (the plans fence every call anyway)
    arrays = {f"factor_{n}": f.cpu().numpy()
              for n, f in enumerate(cp.factors)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, lam=cp.lam.cpu().numpy(), fits=np.asarray(cp.fits),
                 prev_fit=np.float64(cp.prev_fit),
                 iteration=np.int64(cp.iteration),
                 converged=np.bool_(cp.converged),
                 norm_x=np.float64(cp.norm_x), tol=np.float64(cp.tol),
                 **arrays)
    os.replace(tmp, path)


def _load_cp(path: str, dims, rank: int, device=DEFAULT_DEVICE) -> CPState:
    with np.load(path) as z:
        factors = [torch.from_numpy(z[f"factor_{n}"]).to(device)
                   for n in range(len(dims))]
        lam = torch.from_numpy(z["lam"]).to(device)
        fits = [float(f) for f in z["fits"]]
        prev_fit = float(z["prev_fit"])
        iteration = int(z["iteration"])
        converged = bool(z["converged"])
        norm_x = float(z["norm_x"])
        tol = float(z["tol"])
    # grams are pure functions of the factors — recomputed, not stored,
    # exactly as cp_als_init derives them, so the resumed sweep is
    # numerically identical to the uninterrupted one
    grams = [f.T @ f for f in factors]
    return CPState(dims=tuple(dims), rank=rank, norm_x=norm_x, tol=tol,
                   factors=factors, lam=lam, grams=grams, fits=fits,
                   prev_fit=prev_fit, iteration=iteration,
                   converged=converged)


def snapshot_service(service, path: str) -> dict:
    """Write a restartable snapshot of ``service`` into directory ``path``.

    Persists every registered tensor to the registry's spill store (host
    copies stay resident — snapshotting never slows the running service
    down) and checkpoints each non-terminal job's ``CPState``.  Returns
    the manifest dict.  Raises :class:`StoreError` when the service's
    registry has no ``store_dir`` to persist tensors into.
    """
    registry = service.registry
    if registry.store_dir is None:
        raise StoreError("snapshot requires a registry spill store; "
                         "construct the service with store_dir=...")
    os.makedirs(path, exist_ok=True)
    jobs = []
    needed_keys = set()
    for job in service.scheduler.jobs.values():
        if job.state not in _PERSISTED:
            continue
        needed_keys.add(job.handle.key)
        if job.cp is not None:
            _save_cp(os.path.join(path, f"job_{job.job_id}.npz"), job.cp)
        jobs.append({
            "job_id": job.job_id, "tensor_key": job.handle.key,
            "rank": job.rank, "iters": job.iters, "tol": job.tol,
            "seed": job.seed, "tenant": job.tenant, "weight": job.weight,
            "state": job.state, "iteration":
                job.cp.iteration if job.cp is not None else 0,
            "has_cp": job.cp is not None,
            "error": job.error, "error_payload": job.error_payload,
        })
    tensors = {}
    for key in sorted(needed_keys):
        tensors[key] = {"file": os.path.abspath(registry.persist(key))}
    manifest = {"version": SNAPSHOT_VERSION, "tensors": tensors,
                "jobs": jobs}
    tmp = os.path.join(path, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, os.path.join(path, MANIFEST))
    return manifest


def restore_service(path: str, service) -> list[int]:
    """Replay a snapshot into a (fresh) ``service``; returns resumed ids.

    Registry entries are adopted straight from their store files (stub
    handles — no BLCO rebuild, no host reload; jobs disk-stream or the
    registry reloads on demand), and every snapshotted job re-enters the
    admission queue under its original id with its checkpointed
    ``CPState``.
    """
    manifest_path = os.path.join(path, MANIFEST)
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except OSError as exc:
        raise StoreError(f"cannot read snapshot manifest "
                         f"{manifest_path}: {exc}") from exc
    if manifest.get("version") != SNAPSHOT_VERSION:
        raise StoreError(f"snapshot version {manifest.get('version')!r} "
                         f"unsupported (expected {SNAPSHOT_VERSION})")
    registry = service.registry
    for key, rec in manifest["tensors"].items():
        registry.adopt(key, rec["file"])
    restored = []
    for rec in sorted(manifest["jobs"], key=lambda r: r["job_id"]):
        handle = registry.get(rec["tensor_key"])
        cp = None
        if rec["has_cp"]:
            cp = _load_cp(os.path.join(path, f"job_{rec['job_id']}.npz"),
                          handle.dims, rec["rank"],
                          device=service.engine.device)
        if rec.get("state") in _RESUMABLE or "state" not in rec:
            job_id = service.scheduler.submit(
                handle, rank=rec["rank"], iters=rec["iters"],
                tol=rec["tol"], seed=rec["seed"], weight=rec["weight"],
                tenant=rec["tenant"], cp_state=cp, job_id=rec["job_id"])
        else:
            # terminal record: install it directly (no admission) so the
            # restarted service keeps serving status()/result() for jobs
            # that finished before the snapshot
            job_id = service.scheduler.adopt_finished(
                handle, rank=rec["rank"], iters=rec["iters"],
                tol=rec["tol"], seed=rec["seed"], weight=rec["weight"],
                tenant=rec["tenant"], cp_state=cp, job_id=rec["job_id"],
                state=rec["state"], error=rec.get("error"),
                error_payload=rec.get("error_payload"))
        restored.append(job_id)
    if hasattr(service, "metrics"):
        service.metrics.jobs_restored += len(restored)
    return restored
