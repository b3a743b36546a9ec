"""Distributed CP-ALS over a mesh of ``torch.distributed`` ranks
(beyond-paper scale-out).

The port's counterpart of ``examples/distributed_cpals.py``, with its
tensor, mesh, rank and sweeps.  nnz shard over the ``data`` axis (one
``all_reduce`` per mode), rank shards over the ``model`` axis (an
``all_gather``, no communication inside the MTTKRP).  Eight ranks form a
(4, 2) mesh: this process spawns them, each a process of its own that
meets the others through a ``FileStore`` in a temporary directory.

With a mesh installed by ``repro_torch.dist.set_mesh``, ``plan_for``
routes MTTKRP execution through the sharded backend: it returns a
``ShardedPlan`` (K1/K2 on each rank's shard on the card) and CP-ALS runs
on it unchanged.  The process group is NCCL where every rank has a card
of its own, and gloo otherwise (NCCL refuses two ranks on one GPU), with
every rank on ``cuda:0`` — or on the host with ``--device cpu``.  Every
rank returns the same factors; this process checks them bitwise.

The reference's factors are sharded ``NamedSharding(P(None, "model"))``
arrays; the port's factors are whole on every rank (``ShardedPlan`` takes
the model axis's column block), so each rank prints its factors' device
and shape.

    PYTHONPATH=src python -m repro_torch.examples.distributed_cpals \
        [--device cpu]
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.examples import device_parser, kernel_for, require

MESH = (4, 2)
WORLD = MESH[0] * MESH[1]
RANK, ITERS = 16, 10
# each rank imports torch, builds the tensor's BLCO and runs ten sweeps:
# tens of seconds on a loaded host, far inside this limit
RANK_TIMEOUT_S = 600
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def backend_for(device) -> str:
    """NCCL where each of the ``WORLD`` ranks has a card of its own, gloo
    on the host or on fewer cards."""
    if torch.device(device).type == "cuda" \
            and torch.cuda.device_count() >= WORLD:
        return "nccl"
    return "gloo"


def rank_main(rank, backend, device, store, out_dir) -> int:
    """One rank: the reference script's body on this rank's device; saves
    its factors under ``out_dir`` and prints, as one JSON line last, its
    fits, the bytes it uploaded (its shard), its plan's dispatches and its
    kernel launches."""
    import torch.distributed as dist

    from repro_torch import core
    from repro_torch.dist import make_mesh, set_mesh
    from repro_torch.engine import plan_for
    from repro_torch.kernels import launch_counts

    rank = int(rank)
    kernel = kernel_for(device)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_mesh(MESH, ("data", "model"), device=dev.type)
        set_mesh(mesh)         # active mesh -> plan_for routes to sharded
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
              f"{dist.get_world_size()} {backend} ranks; rank {rank} on "
              f"{dev}")

        t = core.random_tensor((300, 200, 150), 300_000, seed=0,
                               dist="powerlaw")
        b = core.build_blco(t)
        print(f"tensor dims={t.dims} nnz={t.nnz:,}; BLCO "
              f"blocks={len(b.blocks)}")

        plan = plan_for(b, 1 << 30, rank=RANK, kernel=kernel, device=dev)
        require(plan.backend == "sharded", plan.backend)
        print(f"engine chose backend={plan.backend!r} "
              f"({plan.device_bytes()/1e6:.1f} MB sharded over the mesh)")

        init = core.init_factors(t.dims, RANK, seed=1, device=dev)
        res = core.cp_als(plan, t.dims, RANK,
                          norm_x=float(np.linalg.norm(t.values)),
                          iters=ITERS, factors=init, device=dev)
        print("fits:", [f"{f:.4f}" for f in res.fits])
        print(f"factor placement: whole on every rank, "
              f"{res.factors[0].device} {tuple(res.factors[0].shape)}")
        stats = plan.stats().snapshot()
        print("engine stats:", stats)
        plan.close()
        set_mesh(None)
        np.savez(os.path.join(out_dir, f"factors_r{rank}.npz"),
                 *[f.detach().cpu().numpy() for f in res.factors])
        print(json.dumps({"rank": rank, "device": str(dev),
                          "fits": [float(f) for f in res.fits],
                          "h2d_bytes": stats["h2d_bytes"],
                          "dispatches": stats["launches"],
                          "launches": dict(launch_counts)}))
    finally:
        dist.destroy_process_group()
    return 0


def _run_ranks(argvs, env, logs) -> list[tuple[int, str, str]]:
    """Start every rank at once, its output and errors into files under
    ``logs``; wait until all have exited, one has failed (the others would
    wait for it in a collective) or ``RANK_TIMEOUT_S`` has passed, and
    kill whatever is left.  Returns ``(returncode, stdout, stderr)`` per
    rank."""
    deadline = time.monotonic() + RANK_TIMEOUT_S
    names = [(os.path.join(logs, f"rank{r}.out"),
              os.path.join(logs, f"rank{r}.err")) for r in range(len(argvs))]
    procs = []
    try:
        for argv, (out, err) in zip(argvs, names):
            with open(out, "w") as fo, open(err, "w") as fe:
                procs.append(subprocess.Popen(argv, env=env, stdout=fo,
                                              stderr=fe, text=True))
        while any(p.poll() is None for p in procs) \
                and not any(p.returncode for p in procs) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for p, (out, err) in zip(procs, names):
        with open(out) as fo, open(err) as fe:
            results.append((p.returncode, fo.read(), fe.read()))
    return results


def main(argv=None) -> int:
    args = device_parser(__doc__).parse_args(argv)
    backend = backend_for(args.device)
    if kernel_for(args.device) == "cuda":
        # the ranks load the kernel library by the sources' hash: build it
        # here once rather than in eight processes at the same time
        from repro_torch.kernels.build import load_libraries
        load_libraries()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (SRC, env.get("PYTHONPATH")) if p)
    env.setdefault("OMP_NUM_THREADS", "1")
    print(f"spawning {WORLD} ranks on a {MESH} ('data', 'model') mesh, "
          f"{backend} on {args.device}")
    with tempfile.TemporaryDirectory() as tmp:
        code = ("import sys; from repro_torch.examples.distributed_cpals "
                "import rank_main; sys.exit(rank_main(*sys.argv[1:]))")
        results = _run_ranks(
            [[sys.executable, "-c", code, str(r), backend, args.device,
              os.path.join(tmp, "store"), tmp] for r in range(WORLD)],
            env, tmp)
        for r, (rc, out, err) in enumerate(results):
            # rank 0's whole output, every other rank's JSON line
            for line in out.splitlines()[0 if r == 0 else -1:]:
                print(f"[rank {r}] {line}")
            if rc != 0:
                print(f"[rank {r}] exited {rc}:\n{err}", file=sys.stderr)
        if any(rc != 0 for rc, _, _ in results):
            return 1
        reports = [json.loads(out.splitlines()[-1]) for _, out, _ in results]
        factors = [np.load(os.path.join(tmp, f"factors_r{r}.npz"))
                   for r in range(WORLD)]
        for r in range(1, WORLD):
            for key in factors[0].files:
                require(np.array_equal(factors[r][key], factors[0][key]),
                        f"rank {r}'s factor {key} differs from rank 0's")
    require(all(rep["fits"] == reports[0]["fits"] for rep in reports),
            "the ranks' fits differ")
    print(f"factors bitwise equal across the {WORLD} ranks; fits "
          f"{[f'{f:.4f}' for f in reports[0]['fits']]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
