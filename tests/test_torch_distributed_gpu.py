"""The sharded MTTKRP on the card: NCCL at world size 1, and gloo at world
size 2 on the one card (NCCL refuses two ranks on one GPU), with K1/K2 on
each rank's shard.

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips where no card is present.  This file imports only the port:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_distributed_gpu.py
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import core
from repro_torch.dist import make_mesh
from repro_torch.engine import InMemoryPlan, plan_for
from repro_torch.kernels import launch_counts, reset_launch_counts

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# max |a - b| / max |b| in f32: K1's atomics reorder additions
F32_TOL = 5e-4
RANK = 32
# order 4 with a stash mode (24 rows, K2) and K1 on the others; the nnz
# left after the draw's duplicates are merged (40,134) is no multiple of
# 32, so the shards' streams end inside a piece
DIMS, NNZ = (183, 24, 1140, 1717), 60_011
CALLS = 2
# two workers each start torch on the card: seconds
PROC_TIMEOUT = 300


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _blco():
    t = core.random_tensor(DIMS, NNZ, seed=2, dist="powerlaw")
    return core.build_blco(t, max_nnz_per_block=3_000)


def test_nccl_world1_launches_and_agreement(cuda, tmp_path):
    """One K1 or K2 launch per call on the card, every mode within f32
    tolerance of the in-memory fused output; the shard's device bytes are
    what ``memory_allocated`` rises by."""
    b = _blco()
    assert b.nnz % 32
    fs = core.init_factors(DIMS, RANK, seed=1, device=cuda)
    in_mem = InMemoryPlan(b, device=cuda)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        plan = plan_for(b, 1 << 30, rank=RANK, mesh=mesh, device=cuda)
        torch.cuda.synchronize()
        assert plan.backend == "sharded"
        assert torch.cuda.memory_allocated() - before \
            == pytest.approx(plan.device_bytes(), abs=4 * 512)
        wants = [in_mem.mttkrp(fs, mode) for mode in range(len(DIMS))]
        reset_launch_counts()
        for mode, want in enumerate(wants):
            for _ in range(CALLS):
                assert _rel(plan.mttkrp(fs, mode), want) < F32_TOL
        torch.cuda.synchronize()
        stash = sum(d < 128 for d in DIMS)
        assert launch_counts["stash"] == stash * CALLS
        assert launch_counts["segment"] == (len(DIMS) - stash) * CALLS
        assert plan.stats().launches == len(DIMS) * CALLS
        plan.close()
    finally:
        dist.destroy_process_group()


_WORKER = """
import json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import core
from repro_torch.core import cp_als_init, cp_als_step
from repro_torch.dist import make_mesh
from repro_torch.engine import InMemoryPlan, plan_for
from repro_torch.kernels import launch_counts, reset_launch_counts

rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
cfg = json.loads(sys.argv[4])
dims = tuple(cfg["dims"])
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
t = core.random_tensor(dims, cfg["nnz"], seed=2, dist="powerlaw")
b = core.build_blco(t, max_nnz_per_block=3_000)
norm_x = float(np.sqrt(np.sum(t.values.astype(np.float64) ** 2)))
fs = core.init_factors(dims, cfg["rank"], seed=1, device=dev)
in_mem = InMemoryPlan(b, device=dev)
wants = [in_mem.mttkrp(fs, mode) for mode in range(len(dims))]
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=2)
report = {}
for shape in cfg["meshes"]:
    mesh = make_mesh(tuple(shape))
    plan = plan_for(b, 1 << 30, rank=cfg["rank"], mesh=mesh, device=dev)
    assert plan.backend == "sharded", plan.backend
    reset_launch_counts()
    rels = []
    for mode, want in enumerate(wants):
        got = plan.mttkrp(fs, mode)
        rels.append(float((got - want).abs().max() / want.abs().max()))
    launches = dict(launch_counts)
    state = cp_als_init(dims, cfg["rank"], norm_x=norm_x, tol=0.0, seed=1,
                        device=dev)
    for _ in range(2):
        cp_als_step(plan, state)
    tag = f"{shape[0]}x{shape[1]}"
    for m, f in enumerate(state.factors):
        np.save(f"{out}/{tag}_factor{m}_r{rank}.npy", f.cpu().numpy())
    report[tag] = {"rels": rels, "launches": launches, "fits": state.fits}
    plan.close()
dist.destroy_process_group()
json.dump(report, open(f"{out}/report_r{rank}.json", "w"))
"""


def test_gloo_world2_on_one_card(cuda, tmp_path):
    """Two gloo ranks on the card, on the (2, 1) and (1, 2) meshes: gloo
    takes the CUDA tensors of both collectives, every mode agrees with the
    in-memory fused output, each rank makes one launch per call, and the
    CP-ALS factors are bitwise equal across the ranks."""
    from repro_torch.kernels.build import load_libraries
    load_libraries()            # build here; the workers load the library
    meshes = ((2, 1), (1, 2))
    cfg = json.dumps({"dims": DIMS, "nnz": NNZ, "rank": RANK,
                      "meshes": meshes})
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_WORKER), str(r),
         str(tmp_path / "store"), str(tmp_path), cfg], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        errs = [p.communicate(timeout=PROC_TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    reports = [json.loads((tmp_path / f"report_r{r}.json").read_text())
               for r in range(2)]
    stash = sum(d < 128 for d in DIMS)
    for shape in meshes:
        tag = f"{shape[0]}x{shape[1]}"
        for rep in reports:
            assert max(rep[tag]["rels"]) < F32_TOL, rep[tag]
            assert rep[tag]["launches"]["stash"] == stash
            assert rep[tag]["launches"]["segment"] == len(DIMS) - stash
        assert reports[0][tag]["fits"] == reports[1][tag]["fits"]
        for m in range(len(DIMS)):
            a, b = (np.load(tmp_path / f"{tag}_factor{m}_r{r}.npy")
                    for r in range(2))
            np.testing.assert_array_equal(a, b)
