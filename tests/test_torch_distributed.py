"""The sharded MTTKRP of the port (``core.distributed``, ``ShardedPlan``,
``repro_torch.dist``) against the JAX package's, on the CPU over gloo.

World size 1 runs in this process, its group rendezvousing through a
``FileStore`` in ``tmp_path`` (a TCP port would collide between the
workers of pytest-xdist); four ranks run as subprocesses of one test, and
the reference at four devices in one more (its device count is fixed
before JAX starts).  Inputs are made from a seed with numpy and pass
between the packages as numpy arrays.
"""
import json
import os
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro import engine as rengine  # noqa: E402
from repro.core.distributed import (  # noqa: E402
    make_distributed_mttkrp as ref_make_distributed_mttkrp,
    shard_launch_arrays as ref_shard_launch_arrays)
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch import core, obs  # noqa: E402
from repro_torch.analysis.sanitize import SanitizedPlan  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.dist import get_mesh, make_mesh, set_mesh  # noqa: E402
from repro_torch.engine import (DefaultEngine, InMemoryPlan,  # noqa: E402
                                ShardedPlan, plan_for, sharded_bytes)
from repro_torch.faults import KernelFailure  # noqa: E402
from repro_torch.obs import ledger  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET = 1 << 30
# max |a - b| / max |b|: the sums are taken in another order in each
# package (and by each shard count), never bit for bit
TOL = {np.float32: 5e-4, np.float64: 1e-10}
# (dims, nnz): order 3 with two K1 modes and one K2 (20-row) mode, and
# order 4 with a 7-row mode; both nnz ragged against every shard count
CASES = {
    "order3": ((150, 20, 200), 3001),
    "order4": ((40, 7, 130, 9), 2003),
}
RANK = 8
MESHES = ((4, 1), (2, 2), (1, 4))
SWEEPS = 2
# each subprocess imports torch (and the reference JAX) and runs a few
# dozen small MTTKRPs: seconds, far inside this limit
PROC_TIMEOUT = 300


def _coo(dims, nnz, seed=0, dtype=np.float32):
    """``nnz`` distinct coordinates and standard-normal values."""
    rng = np.random.default_rng(seed)
    lin = rng.choice(int(np.prod(dims)), nnz, replace=False)
    idx = np.stack(np.unravel_index(lin, dims), axis=1).astype(np.int64)
    return idx, rng.standard_normal(nnz).astype(dtype)


def _blcos(dims, nnz, seed=0, dtype=np.float32):
    """The same tensor as a reference BLCO and a port BLCO (many blocks)."""
    idx, vals = _coo(dims, nnz, seed, dtype)
    kw = dict(target_bits=10, max_nnz_per_block=256)
    ref = rcore.build_blco(rcore.from_coo(idx, vals, dims), **kw)
    port = core.build_blco(core.from_coo(idx, vals, dims), **kw)
    return ref, port


def _factors(dims, rank=RANK, dtype=np.float32, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((d, rank)).astype(dtype) for d in dims]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture
def world1(tmp_path):
    """A gloo group of one rank and its (1, 1) mesh; destroyed after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), device="cpu")
    finally:
        set_mesh(None)
        dist.destroy_process_group()


# ------------------------------------------------------------ host side
@pytest.mark.parametrize("num_shards", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("nnz", [840, 3001, 0],
                         ids=["divisible", "ragged", "empty"])
def test_shard_launch_arrays_match_reference(num_shards, nnz):
    ref, port = _blcos((150, 20, 200), nnz)
    want = ref_shard_launch_arrays(ref, num_shards)
    got = core.shard_launch_arrays(port, num_shards)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    for d in range(num_shards):
        row = core.shard_launch_arrays(port, num_shards, shard=d)
        for k in want:
            assert row[k].dtype == want[k].dtype
            np.testing.assert_array_equal(row[k], want[k][d])


def test_shard_arguments_checked():
    _, port = _blcos((150, 20, 200), 100)
    with pytest.raises(ValueError, match="shard 3 outside"):
        core.shard_launch_arrays(port, 3, shard=3)
    with pytest.raises(ValueError, match="at least 1"):
        core.shard_launch_arrays(port, 0)


def _meshes(shape):
    """A reference-shaped and a port-shaped stand-in mesh of ``shape``:
    ``sharded_bytes`` reads only the axis sizes."""
    names = ("data", "model")
    ref = types.SimpleNamespace(shape=dict(zip(names, shape)),
                                size=int(np.prod(shape)))
    port = types.SimpleNamespace(shape=tuple(shape), mesh_dim_names=names)
    return ref, port


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (4, 2), (3, 5),
                                   (7, 1)])
def test_sharded_bytes_match_reference(shape, dtype):
    ref, port = _blcos((40, 7, 130, 9), 2003, dtype=dtype)
    rmesh, pmesh = _meshes(shape)
    want = rengine.sharded_bytes(ref, rmesh)
    assert sharded_bytes(port, pmesh) == want
    per = -(-port.nnz // shape[0])
    assert want == per * shape[0] * (4 + 4 + np.dtype(dtype).itemsize
                                     + 4 * 4) * shape[1]


# the probe of a tuple data axis: random_tensor((30, 20, 40), 500, seed=0)
# keeps 496 distinct non-zeros, 124 slots on each of the 2 x 2 data ranks
# of 24 B (order 3, f32): 11904 B mesh-wide
TUPLE_MESH = ((2, 2, 1), ("pod", "data", "model"))
TUPLE_AXIS = ("pod", "data")
TUPLE_BYTES = 11904


def _tuple_coo():
    r = rcore.random_tensor((30, 20, 40), 500, seed=0)
    return np.array(r.indices), np.array(r.values), tuple(r.dims)


@pytest.mark.parametrize("data_axis", [("pod", "data"), ("data", "pod"),
                                       ("pod",), "data"])
def test_sharded_bytes_tuple_data_axis_match_reference(data_axis):
    idx, vals, dims = _tuple_coo()
    ref = rcore.build_blco(rcore.from_coo(idx, vals, dims))
    port = core.build_blco(core.from_coo(idx, vals, dims))
    shape, names = TUPLE_MESH
    rmesh = types.SimpleNamespace(shape=dict(zip(names, shape)),
                                  size=int(np.prod(shape)))
    pmesh = types.SimpleNamespace(shape=shape, mesh_dim_names=names)
    want = rengine.sharded_bytes(ref, rmesh, data_axis=data_axis)
    assert sharded_bytes(port, pmesh, data_axis=data_axis) == want
    if isinstance(data_axis, tuple) and len(data_axis) == 2:
        assert want == TUPLE_BYTES
    assert distributed.axis_size(pmesh, data_axis) == (
        4 if isinstance(data_axis, tuple) and len(data_axis) == 2 else 2)


def test_axis_size_refuses_unknown_and_repeated_names():
    pmesh = types.SimpleNamespace(shape=(2, 2, 1),
                                  mesh_dim_names=TUPLE_MESH[1])
    with pytest.raises(ValueError, match="no axis 'rack'"):
        distributed.axis_size(pmesh, ("pod", "rack"))
    with pytest.raises(ValueError, match="twice"):
        distributed.axis_size(pmesh, ("pod", "pod"))


# ------------------------------------------------------------ world size 1
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kernel", ["cuda", "torch"])
@pytest.mark.parametrize("case", list(CASES))
def test_world1_matches_reference_and_oracle(world1, case, kernel, dtype):
    dims, nnz = CASES[case]
    ref, port = _blcos(dims, nnz, dtype=dtype)
    f = _factors(dims, dtype=dtype)
    plan = plan_for(port, BUDGET, rank=RANK, dtype=torch.from_numpy(
        f[0]).dtype, mesh=world1, kernel=kernel, device="cpu")
    assert isinstance(plan, ShardedPlan) and plan.backend == "sharded"
    t = core.from_coo(*_coo(dims, nnz, dtype=dtype), dims)
    with jax.enable_x64(dtype == np.float64):
        run = ref_make_distributed_mttkrp(ref, make_test_mesh((1, 1)))
        for mode in range(len(dims)):
            want = np.asarray(run(tuple(f), mode))
            got = plan.mttkrp([torch.from_numpy(x) for x in f], mode)
            assert got.dtype == torch.from_numpy(f[0]).dtype
            assert _rel(got.numpy(), want) < TOL[dtype], mode
            oracle = core.mttkrp_dense_oracle(t, f, mode)
            assert _rel(got.numpy(), oracle) < TOL[dtype], mode
    assert plan.stats().mttkrp_calls == plan.stats().launches == len(dims)


def test_world1_plan_matches_reference_plan(world1):
    """Bytes, upload accounting, ledger, counters, span and close against
    the reference's ``ShardedPlan`` on its (1, 1) mesh."""
    dims, nnz = CASES["order4"]
    ref, port = _blcos(dims, nnz)
    rplan = rengine.plan_for(ref, BUDGET, rank=RANK,
                             mesh=make_test_mesh((1, 1)))
    ledger.clear()
    obs.trace.clear()
    try:
        with ledger.enabled(), obs.trace.enabled():
            plan = plan_for(port, BUDGET, rank=RANK, mesh=world1,
                            device="cpu")
            plan.mttkrp([torch.from_numpy(x) for x in _factors(dims)], 1)
        spans = [sp for sp in obs.trace.spans() if sp.name == "plan.mttkrp"]
        snap = ledger.snapshot()
        conservation = ledger.verify_conservation([("sharded",
                                                    plan.stats())])
    finally:
        ledger.clear()
        obs.trace.clear()
    assert len(spans) == 1 and spans[0].attrs["backend"] == "sharded"
    assert conservation["max_rel_err"] == 0.0
    assert snap["regimes"]["sharded"][ledger.HOST_DEVICE]["bytes"] \
        == plan.stats().h2d_bytes == rplan.stats().h2d_bytes
    assert plan.device_bytes() == rplan.device_bytes() \
        == sharded_bytes(port, world1)
    s = plan.stats()
    assert (s.mttkrp_calls, s.launches) == (1, 1)
    with pytest.raises(ValueError, match="sharded plan needs"):
        plan_for(port, plan.device_bytes() // 2, rank=RANK, mesh=world1,
                 device="cpu")
    assert plan.close() == rplan.close() > 0
    assert plan.close() == 0 and plan.device_bytes() == 0
    with pytest.raises(RuntimeError, match="closed"):
        plan.mttkrp([torch.from_numpy(x) for x in _factors(dims)], 0)


def test_world1_empty_tensor_gives_zeros_at_promoted_dtype(world1):
    dims = (6, 5, 4)
    idx, vals = np.zeros((0, 3), np.int64), np.zeros(0, np.float64)
    port = core.build_blco(core.from_coo(idx, vals, dims))
    plan = plan_for(port, BUDGET, rank=4, mesh=world1, device="cpu")
    f = [torch.ones((d, 4)) for d in dims]
    for mode, d in enumerate(dims):
        out = plan.mttkrp(f, mode)
        assert out.dtype == torch.float64 and out.shape == (d, 4)
        assert not out.any()
    assert plan.device_bytes() == 0 and plan.stats().launches == 3


def _group_count():
    return len(dist.distributed_c10d._world.pg_map)


def test_tuple_axis_groups_made_once_per_mesh(tmp_path):
    """Re-planning with a tuple data axis reuses the flattened groups made
    for the mesh: the count of process groups does not grow from one
    ``ShardedPlan`` to the next, and ``set_mesh(None)`` destroys them."""
    dims, nnz = CASES["order3"]
    _, port = _blcos(dims, nnz)
    factors = [torch.from_numpy(f) for f in _factors(dims)]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1, 1), TUPLE_MESH[1], device="cpu")
        set_mesh(mesh)
        before = _group_count()
        outs, counts = [], []
        for _ in range(2):
            plan = ShardedPlan(port, mesh, data_axis=TUPLE_AXIS,
                               kernel="torch", device="cpu")
            outs.append(plan.mttkrp(factors, 0))
            plan.close()
            counts.append(_group_count())
        assert counts == [before + 1, before + 1]
        torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
        set_mesh(None)
        assert _group_count() == before
        assert distributed.release_axis_groups(mesh) == 0
    finally:
        set_mesh(None)
        dist.destroy_process_group()


def test_mesh_context_routes_auto(world1):
    dims, nnz = CASES["order3"]
    _, port = _blcos(dims, nnz)
    assert get_mesh() is None
    assert plan_for(port, BUDGET, rank=RANK, device="cpu").backend \
        == "in_memory"
    with pytest.raises(ValueError, match="requires an active mesh"):
        plan_for(port, BUDGET, rank=RANK, backend="sharded", device="cpu")
    set_mesh(world1)
    assert get_mesh() is world1
    assert plan_for(port, BUDGET, rank=RANK, device="cpu").backend \
        == "sharded"
    set_mesh(None)
    engine = DefaultEngine(mesh=world1, device="cpu")
    assert engine.plan(port, device_budget_bytes=BUDGET,
                       rank=RANK).backend == "sharded"


def test_sanitized_plan_issues_one_collective_per_call(world1, monkeypatch):
    dims, nnz = CASES["order3"]
    _, port = _blcos(dims, nnz)
    calls = []
    real = distributed.dist.all_reduce

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(distributed.dist, "all_reduce", counting)
    plan = plan_for(port, BUDGET, rank=RANK, mesh=world1, device="cpu",
                    sanitize=True)
    assert type(plan) is SanitizedPlan and isinstance(plan, ShardedPlan)
    f = [torch.from_numpy(x) for x in _factors(dims)]
    for mode in range(3):
        plan.mttkrp(f, mode)
    assert len(calls) == 3 and plan.stats().mttkrp_calls == 3


def test_kernel_failure_propagates_before_any_collective(world1,
                                                         monkeypatch):
    dims, nnz = CASES["order3"]
    _, port = _blcos(dims, nnz)
    plan = plan_for(port, BUDGET, rank=RANK, mesh=world1, device="cpu")

    def fail(*a, **kw):
        raise KernelFailure("K1 did not launch")

    def collective(*a, **kw):
        raise AssertionError("a collective after a failed kernel")

    from repro_torch.kernels import fused
    monkeypatch.setattr(fused, "fused_mttkrp_flat", fail)
    monkeypatch.setattr(distributed.dist, "all_reduce", collective)
    with pytest.raises(KernelFailure):
        plan.mttkrp([torch.from_numpy(x) for x in _factors(dims)], 0)


@pytest.mark.parametrize("kernel", ["cuda", "torch"])
def test_world1_cpu_path_is_deterministic(world1, kernel):
    """R = 32 on a 30 x 20 x 40 tensor: the size at which a threaded
    scatter on the CPU reorders its additions from run to run."""
    dims = (30, 20, 40)
    _, port = _blcos(dims, 6000)
    plan = plan_for(port, BUDGET, rank=32, mesh=world1, kernel=kernel,
                    device="cpu")
    f = [torch.from_numpy(x) for x in _factors(dims, rank=32)]
    for mode in range(3):
        assert torch.equal(plan.mttkrp(f, mode), plan.mttkrp(f, mode))


def test_make_mesh_checks_its_group(tmp_path):
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 1), device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="holds 2 ranks"):
            make_mesh((2, 1), device="cpu")
        with pytest.raises(ValueError, match="axis names"):
            make_mesh((1, 1), ("data",), device="cpu")
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ four ranks
_RANK_CODE = """
import json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import core
from repro_torch.core import cp_als_init, cp_als_step
from repro_torch.dist import make_mesh
from repro_torch.engine import plan_for, sharded_bytes

rank, store, out, cfg = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
    json.loads(sys.argv[4])
dims, nnz, R = tuple(cfg["dims"]), cfg["nnz"], cfg["rank"]
idx, vals = np.load(cfg["idx"]), np.load(cfg["vals"])
factors = [np.load(p) for p in cfg["factors"]]
b = core.build_blco(core.from_coo(idx, vals, dims), target_bits=10,
                    max_nnz_per_block=256)
norm_x = float(np.sqrt(np.sum(vals.astype(np.float64) ** 2)))
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=4)
meta = {}
for shape in cfg["meshes"]:
    mesh = make_mesh(tuple(shape), device="cpu")
    tag = f"{shape[0]}x{shape[1]}"
    for kernel in ("cuda", "torch"):
        plan = plan_for(b, 1 << 30, rank=R, mesh=mesh, kernel=kernel,
                        device="cpu")
        assert plan.backend == "sharded", plan.backend
        fs = [torch.from_numpy(f) for f in factors]
        for mode in range(len(dims)):
            np.save(f"{out}/{tag}_{kernel}_mode{mode}_r{rank}.npy",
                    plan.mttkrp(fs, mode).numpy())
        state = cp_als_init(dims, R, norm_x=norm_x, tol=0.0,
                            factors=[f.clone() for f in fs])
        for _ in range(cfg["sweeps"]):
            cp_als_step(plan, state)
        for m, f in enumerate(state.factors):
            np.save(f"{out}/{tag}_{kernel}_factor{m}_r{rank}.npy", f.numpy())
        meta[f"{tag}_{kernel}"] = {
            "fits": state.fits, "h2d": plan.stats().h2d_bytes,
            "device_bytes": plan.device_bytes(),
            "sharded_bytes": sharded_bytes(b, mesh)}
        plan.close()
    if shape[1] > 1:        # R % M is refused before any collective
        try:
            plan_for(b, 1 << 30, rank=R, mesh=mesh, device="cpu").mttkrp(
                [torch.ones((d, R + 1)) for d in dims], 0)
            raise SystemExit("expected ValueError")
        except ValueError as e:
            assert "not a multiple" in str(e), e
json.dump(meta, open(f"{out}/meta_r{rank}.json", "w"))
dist.destroy_process_group()
"""

_REF_CODE = """
import json, sys
import numpy as np, jax
from jax.sharding import PartitionSpec as P
from repro import core
from repro.core.distributed import make_distributed_mttkrp
from repro.engine import sharded_bytes
from repro.launch.mesh import make_test_mesh

out, cfg = sys.argv[1], json.loads(sys.argv[2])
dims = tuple(cfg["dims"])
idx, vals = np.load(cfg["idx"]), np.load(cfg["vals"])
factors = [np.load(p) for p in cfg["factors"]]
b = core.build_blco(core.from_coo(idx, vals, dims), target_bits=10,
                    max_nnz_per_block=256)
meta = {}
for shape in cfg["meshes"]:
    mesh = make_test_mesh(tuple(shape), ("data", "model"))
    tag = f"{shape[0]}x{shape[1]}"
    fs = [jax.device_put(f, jax.NamedSharding(mesh, P(None, "model")))
          for f in factors]
    run = make_distributed_mttkrp(b, mesh)
    for mode in range(len(dims)):
        np.save(f"{out}/{tag}_ref_mode{mode}.npy", np.asarray(run(fs, mode)))
    meta[tag] = sharded_bytes(b, mesh)
json.dump(meta, open(f"{out}/meta_ref.json", "w"))
"""


def _spawn(argvs, env, timeout):
    """Start every command at once; wait for all within ``timeout`` s and
    kill whatever is left.  Returns ``(returncode, stderr)`` per command."""
    deadline = time.monotonic() + timeout
    procs = [subprocess.Popen(a, env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for a in argvs]
    try:
        results = []
        for p in procs:
            err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[1]
            results.append((p.returncode, err))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_four_gloo_ranks_match_reference(tmp_path):
    """Four gloo ranks on the (4, 1), (2, 2) and (1, 4) meshes of one
    group: bitwise-equal outputs and CP-ALS factors on every rank, within
    tolerance of the reference at the same mesh shapes (four fake XLA
    devices) and of the dense oracle; the fits within 1e-4 of the port's
    own ``InMemoryPlan``; the upload bytes summed over the ranks equal the
    reference's mesh-wide bytes."""
    dims, nnz = CASES["order3"]
    idx, vals = _coo(dims, nnz)
    factors = _factors(dims)
    np.save(tmp_path / "idx.npy", idx)
    np.save(tmp_path / "vals.npy", vals)
    paths = []
    for m, f in enumerate(factors):
        paths.append(str(tmp_path / f"f{m}.npy"))
        np.save(paths[-1], f)
    cfg = json.dumps({"dims": dims, "nnz": nnz, "rank": RANK,
                      "meshes": MESHES, "sweeps": SWEEPS,
                      "idx": str(tmp_path / "idx.npy"),
                      "vals": str(tmp_path / "vals.npy"),
                      "factors": paths})
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    ref_env = dict(env)
    ref_env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                            " --xla_force_host_platform_device_count=4")
    store = str(tmp_path / "store")
    ranks = [[sys.executable, "-c", textwrap.dedent(_RANK_CODE), str(r),
              store, str(tmp_path), cfg] for r in range(4)]
    results = _spawn(ranks, env, PROC_TIMEOUT)
    results += _spawn([[sys.executable, "-c", textwrap.dedent(_REF_CODE),
                        str(tmp_path), cfg]], ref_env, PROC_TIMEOUT)
    for rc, err in results:
        assert rc == 0, err[-4000:]

    t = core.from_coo(idx, vals, dims)
    ref_bytes = json.loads((tmp_path / "meta_ref.json").read_text())
    metas = [json.loads((tmp_path / f"meta_r{r}.json").read_text())
             for r in range(4)]
    b = core.build_blco(t, target_bits=10, max_nnz_per_block=256)
    norm_x = float(np.sqrt(np.sum(vals.astype(np.float64) ** 2)))
    for kernel in ("cuda", "torch"):
        in_mem = InMemoryPlan(b, kernel=kernel, device="cpu")
        state = core.cp_als_init(dims, RANK, norm_x=norm_x, tol=0.0,
                                 factors=[torch.from_numpy(f.copy())
                                          for f in factors])
        for _ in range(SWEEPS):
            core.cp_als_step(in_mem, state)
        for shape in MESHES:
            tag = f"{shape[0]}x{shape[1]}"
            for mode in range(len(dims)):
                outs = [np.load(tmp_path / f"{tag}_{kernel}_mode{mode}_r{r}"
                                           f".npy") for r in range(4)]
                for o in outs[1:]:
                    np.testing.assert_array_equal(o, outs[0])
                want = np.load(tmp_path / f"{tag}_ref_mode{mode}.npy")
                assert _rel(outs[0], want) < TOL[np.float32], (tag, mode)
                oracle = core.mttkrp_dense_oracle(t, factors, mode)
                assert _rel(outs[0], oracle) < TOL[np.float32], (tag, mode)
            for m in range(len(dims)):
                fs = [np.load(tmp_path / f"{tag}_{kernel}_factor{m}_r{r}"
                                         f".npy") for r in range(4)]
                for f in fs[1:]:
                    np.testing.assert_array_equal(f, fs[0])
            key = f"{tag}_{kernel}"
            fits = [meta[key]["fits"] for meta in metas]
            assert all(f == fits[0] for f in fits)
            assert np.max(np.abs(np.subtract(fits[0], state.fits))) < 1e-4
            assert sum(meta[key]["h2d"] for meta in metas) \
                == ref_bytes[tag] == metas[0][key]["device_bytes"] \
                == metas[0][key]["sharded_bytes"]


_TUPLE_RANK_CODE = """
import json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import core
from repro_torch.core import distributed
from repro_torch.core.distributed import axis_group
from repro_torch.dist import make_mesh
from repro_torch.engine import ShardedPlan, sharded_bytes

rank, store, out, cfg = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
    json.loads(sys.argv[4])
dims, axis = tuple(cfg["dims"]), tuple(cfg["axis"])
idx, vals = np.load(cfg["idx"]), np.load(cfg["vals"])
factors = [torch.from_numpy(np.load(p)) for p in cfg["factors"]]
b = core.build_blco(core.from_coo(idx, vals, dims), target_bits=10,
                    max_nnz_per_block=64)
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=4)
mesh = make_mesh(tuple(cfg["shape"]), tuple(cfg["names"]), device="cpu")
group, shard = axis_group(mesh, axis)
meta = {"shard": shard, "pod": mesh.get_local_rank("pod"),
        "data": mesh.get_local_rank("data"),
        "group_size": dist.get_world_size(group)}
for kernel in ("cuda", "torch"):
    plan = ShardedPlan(b, mesh, data_axis=axis, kernel=kernel, device="cpu")
    for mode in range(len(dims)):
        np.save(f"{out}/tuple_{kernel}_mode{mode}_r{rank}.npy",
                plan.mttkrp(factors, mode).numpy())
    meta[kernel] = {"h2d": plan.stats().h2d_bytes,
                    "device_bytes": plan.device_bytes(),
                    "sharded_bytes": sharded_bytes(b, mesh, data_axis=axis),
                    "groups": len(dist.distributed_c10d._world.pg_map)}
    plan.close()
meta["released"] = distributed.release_axis_groups(mesh)
json.dump(meta, open(f"{out}/tuple_meta_r{rank}.json", "w"))
dist.destroy_process_group()
"""

_TUPLE_REF_CODE = """
import json, sys
import numpy as np, jax
from jax.sharding import PartitionSpec as P
from repro import core
from repro.core.distributed import make_distributed_mttkrp
from repro.engine import sharded_bytes
from repro.launch.mesh import make_test_mesh

out, cfg = sys.argv[1], json.loads(sys.argv[2])
dims, axis = tuple(cfg["dims"]), tuple(cfg["axis"])
idx, vals = np.load(cfg["idx"]), np.load(cfg["vals"])
b = core.build_blco(core.from_coo(idx, vals, dims), target_bits=10,
                    max_nnz_per_block=64)
mesh = make_test_mesh(tuple(cfg["shape"]), tuple(cfg["names"]))
fs = [jax.device_put(np.load(p), jax.NamedSharding(mesh, P(None, "model")))
      for p in cfg["factors"]]
run = make_distributed_mttkrp(b, mesh, data_axis=axis)
for mode in range(len(dims)):
    np.save(f"{out}/tuple_ref_mode{mode}.npy", np.asarray(run(fs, mode)))
json.dump(sharded_bytes(b, mesh, data_axis=axis),
          open(f"{out}/tuple_meta_ref.json", "w"))
"""


def test_four_gloo_ranks_tuple_data_axis_match_reference(tmp_path):
    """Four gloo ranks on a (2, 2, 1) mesh named (pod, data, model), the
    nnz split over ``data_axis=("pod", "data")``: each rank holds the shard
    of its row-major (pod, data) coordinate, its data group spans the
    four ranks, every rank's outputs are bitwise equal and within 5e-4
    of the reference's ``make_distributed_mttkrp`` on the same mesh of
    four fake XLA devices; ``sharded_bytes`` is the reference's 11904 B,
    and the ranks' uploads sum to it.  The second plan makes no new
    group, and releasing the mesh destroys the one flattened group."""
    idx, vals, dims = _tuple_coo()
    factors = _factors(dims)
    np.save(tmp_path / "idx.npy", idx)
    np.save(tmp_path / "vals.npy", vals)
    paths = []
    for m, f in enumerate(factors):
        paths.append(str(tmp_path / f"f{m}.npy"))
        np.save(paths[-1], f)
    shape, names = TUPLE_MESH
    cfg = json.dumps({"dims": dims, "shape": shape, "names": names,
                      "axis": TUPLE_AXIS, "idx": str(tmp_path / "idx.npy"),
                      "vals": str(tmp_path / "vals.npy"),
                      "factors": paths})
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    ref_env = dict(env)
    ref_env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                            " --xla_force_host_platform_device_count=4")
    store = str(tmp_path / "store")
    results = _spawn([[sys.executable, "-c", textwrap.dedent(
        _TUPLE_RANK_CODE), str(r), store, str(tmp_path), cfg]
        for r in range(4)], env, PROC_TIMEOUT)
    results += _spawn([[sys.executable, "-c", textwrap.dedent(
        _TUPLE_REF_CODE), str(tmp_path), cfg]], ref_env, PROC_TIMEOUT)
    for rc, err in results:
        assert rc == 0, err[-4000:]

    ref_bytes = json.loads((tmp_path / "tuple_meta_ref.json").read_text())
    assert ref_bytes == TUPLE_BYTES
    metas = [json.loads((tmp_path / f"tuple_meta_r{r}.json").read_text())
             for r in range(4)]
    assert sorted(m["shard"] for m in metas) == [0, 1, 2, 3]
    for m in metas:
        assert m["shard"] == 2 * m["pod"] + m["data"]
        assert m["group_size"] == 4
        # the second plan reuses the first one's flattened group
        assert m["cuda"]["groups"] == m["torch"]["groups"]
        assert m["released"] == 1
    t = core.from_coo(idx, vals, dims)
    for kernel in ("cuda", "torch"):
        for mode in range(len(dims)):
            outs = [np.load(tmp_path / f"tuple_{kernel}_mode{mode}_r{r}.npy")
                    for r in range(4)]
            for o in outs[1:]:
                np.testing.assert_array_equal(o, outs[0])
            want = np.load(tmp_path / f"tuple_ref_mode{mode}.npy")
            assert _rel(outs[0], want) < TOL[np.float32], (kernel, mode)
            oracle = core.mttkrp_dense_oracle(t, factors, mode)
            assert _rel(outs[0], oracle) < TOL[np.float32], (kernel, mode)
        assert sum(m[kernel]["h2d"] for m in metas) == TUPLE_BYTES
        assert all(m[kernel]["device_bytes"] == m[kernel]["sharded_bytes"]
                   == TUPLE_BYTES for m in metas)
