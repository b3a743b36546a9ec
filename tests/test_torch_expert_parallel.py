"""Expert parallelism (``repro_torch.models.moe.moe_apply_sharded``) on
gloo ranks against the JAX package's ``moe_apply_sharded`` on fake XLA
devices, on the CPU.

Four gloo ranks (``python -c`` subprocesses, the rendezvous a
``FileStore`` in ``tmp_path``) run the layer on the (2, 2) and (1, 4)
``("data", "model")`` meshes of one group; one more subprocess runs the
reference on four fake XLA devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) on the same
meshes.  The configs are deepseek-v2 (a shared expert) and dbrx
``reduced()`` in f32, one MoE layer of the reference's weights.

The objective is ``sum(out * w) + aux`` for a fixed random ``w``.  The
port's per-rank gradients are those of its data shard's objective (the
sharded train step averages them over the data axes), the reference's
those of the mean over the data shards: so the reference's router and
expert gradients are the mean over the port's data ranks, and its ``x``
rows the port's divided by the data axis's size.  Output, ``aux`` and
every gradient are held within 1e-5 (f32) of the reference's, the
outputs and gradients bitwise across the model ranks of a data row; on
the non-aux path (``sum(out * w)`` alone) the gradients equal the port's
unsharded ``moe_apply``'s over the whole batch.  Each rank runs both the
whole expert stack (its block taken inside) and only its own block, as
``chip_smoke.py``'s ``[mesh]`` part 3 does.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import torch_lm_support as lm  # noqa: E402
from repro_torch.models import moe  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["deepseek_v2_236b", "dbrx_132b"]
MESHES = [(2, 2), (1, 4)]
SHAPE = (4, 8)               # (B, S): B divides over the data axis
TOL = 1e-5
PROC_TIMEOUT = 240

_RANK_CODE = """
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.dist import make_mesh, set_mesh
from repro_torch.models import moe

rank, store, out, names, meshes = int(sys.argv[1]), sys.argv[2], \\
    sys.argv[3], json.loads(sys.argv[4]), json.loads(sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=4)
for name in names:
    arr = np.load(f"{out}/{name}_in.npz")
    cfg = get_config(name).reduced()
    for shape in meshes:
        mesh = make_mesh(tuple(shape), device="cpu")
        set_mesh(mesh)
        tp = shape[1]
        d, c = mesh.get_local_rank("data"), mesh.get_local_rank("model")
        rows = slice(d * arr["x"].shape[0] // shape[0],
                     (d + 1) * arr["x"].shape[0] // shape[0])
        el = cfg.num_experts // tp
        for kind in ("whole", "block", "noaux"):
            p = moe.moe_init(None, cfg, torch.float32, "cpu")
            p.load_state_dict({k: torch.from_numpy(arr[k])
                               for k in p.state_dict()}, assign=True)
            if kind == "block":
                for k in ("wi", "wg", "wo"):
                    w = getattr(p, k)
                    w.w = torch.nn.Parameter(w.w[c * el:(c + 1) * el].clone())
            x = torch.from_numpy(arr["x"][rows]).requires_grad_()
            w = torch.from_numpy(arr["w"][rows])
            # without drops (capacity >= the rank's tokens) for "noaux"
            y, aux = moe.moe_layer(p, cfg if kind != "noaux" else
                                   dataclasses.replace(cfg, capacity_factor=
                                   cfg.num_experts / cfg.top_k), x)
            obj = (y * w).sum() + (0 if kind == "noaux" else aux)
            obj.backward()
            res = {"out": y.detach().numpy(), "aux": aux.detach().numpy(),
                   "x": x.grad.numpy()}
            res.update({k: v.grad.numpy() for k, v in p.named_parameters()})
            tag = f"{name}_{shape[0]}x{shape[1]}_{kind}_r{rank}"
            np.savez(f"{out}/{tag}.npz", **res)
        set_mesh(None)
dist.destroy_process_group()
"""

_REF_CODE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch.mesh import make_test_mesh
from repro.models import moe

out, names, meshes = sys.argv[1], json.loads(sys.argv[2]), \\
    json.loads(sys.argv[3])
for name in names:
    arr = dict(np.load(f"{out}/{name}_in.npz"))
    cfg = get_config(name).reduced()
    p = {}
    for k, v in arr.items():
        if k in ("x", "w"):
            continue
        node = p
        *path, leaf = k.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(v)
    x, w = jnp.asarray(arr["x"]), jnp.asarray(arr["w"])
    for shape in meshes:
        mesh = make_test_mesh(tuple(shape), ("data", "model"))
        dp = shape[0]

        def obj(p, x):
            y, aux = moe.moe_apply_sharded(p, cfg, x, mesh)
            return jnp.sum(y * w) / dp + aux, (y, aux)
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            obj, argnums=(0, 1), has_aux=True))(p, x)
        res = {"out": np.asarray(y), "aux": np.asarray(aux),
               "x": np.asarray(gx)}
        for k in ("router", "wi", "wg", "wo", "shared_wi", "shared_wg",
                  "shared_wo"):
            if k in gp:
                res[k + ".w"] = np.asarray(gp[k]["w"])
        np.savez(f"{out}/{name}_{shape[0]}x{shape[1]}_ref.npz", **res)
# the pod-major split of a tuple axis: each device's block of a (8,)
# array under P(("pod", "data")) on a (2, 2, 1) (pod, data, model) mesh
mesh = make_test_mesh((2, 2, 1), ("pod", "data", "model"))
index = NamedSharding(mesh, P(("pod", "data"))).devices_indices_map((8,))
coords = {d: c for c, d in np.ndenumerate(mesh.devices)}
json.dump([[list(coords[d]), [s[0].start, s[0].stop]]
           for d, s in index.items()], open(f"{out}/pod_major.json", "w"))
"""


def _inputs(tmp_path, name):
    """One MoE layer of the reference's weights and seeded (x, w)."""
    cfg, _, rp, _ = lm.pair(name, "float32")
    layer = jax.tree.map(lambda a: np.asarray(a[0]), rp["moe_layers"]["moe"])
    flat = {}
    for k, v in layer.items():
        for leaf, a in v.items():
            flat[f"{k}.{leaf}"] = a
    rng = np.random.default_rng(11)
    flat["x"] = rng.standard_normal(SHAPE + (cfg.d_model,)).astype(np.float32)
    flat["w"] = rng.standard_normal(SHAPE + (cfg.d_model,)).astype(np.float32)
    np.savez(tmp_path / f"{name}_in.npz", **flat)
    return cfg, flat


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages on both meshes: the inputs, then the four gloo ranks
    and the reference's subprocess side by side."""
    tmp_path = tmp_path_factory.mktemp("ep")
    inputs = {name: _inputs(tmp_path, name) for name in NAMES}
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    ref_env = dict(env)
    ref_env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                            " --xla_force_host_platform_device_count=4")
    names, meshes = json.dumps(NAMES), json.dumps(MESHES)
    ranks = [[sys.executable, "-c", textwrap.dedent(_RANK_CODE), str(r),
              str(tmp_path / "store"), str(tmp_path), names, meshes]
             for r in range(4)]
    ref = [[sys.executable, "-c", textwrap.dedent(_REF_CODE), str(tmp_path),
            names, meshes]]
    deadline = time.monotonic() + PROC_TIMEOUT
    procs = [subprocess.Popen(a, env=e, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for a, e in [(a, env) for a in ranks] + [(ref[0], ref_env)]]
    try:
        errs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                [1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    return tmp_path, inputs


def _rank(path, name, shape, kind, r):
    return dict(np.load(path / f"{name}_{shape[0]}x{shape[1]}_{kind}_r{r}"
                                ".npz"))


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_sharded_moe_matches_reference(runs, name, shape):
    """Output, aux and the gradients of x, the router, the experts (and
    the shared expert) within 1e-5 of the reference's on the same mesh;
    bitwise across each data row's model ranks."""
    path, _ = runs
    ref = dict(np.load(path / f"{name}_{shape[0]}x{shape[1]}_ref.npz"))
    dp, tp = shape
    ranks = [_rank(path, name, shape, "whole", r) for r in range(4)]
    by_row = [ranks[d * tp:(d + 1) * tp] for d in range(dp)]
    for row in by_row:
        for other in row[1:]:
            for k, v in row[0].items():
                np.testing.assert_array_equal(other[k], v, err_msg=k)
    heads = [row[0] for row in by_row]
    assert _rel(np.concatenate([h["out"] for h in heads]), ref["out"]) <= TOL
    assert _rel(np.concatenate([h["x"] for h in heads]) / dp,
                ref["x"]) <= TOL
    for h in heads:
        assert abs(float(h["aux"]) - float(ref["aux"])) <= TOL * float(
            ref["aux"])
    for k in ref:
        if k.endswith(".w"):
            mean = np.mean([h[k] for h in heads], axis=0)
            assert _rel(mean, ref[k]) <= TOL, k


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_own_block_equals_whole_stack(runs, name, shape):
    """A rank given only its E/tp experts computes what it computes from
    the whole stack: output, aux and the gradients of x and the router
    bitwise, its experts' gradients the whole stack's rows of its block."""
    path, inputs = runs
    cfg = inputs[name][0]
    el = cfg.num_experts // shape[1]
    for r in range(4):
        whole = _rank(path, name, shape, "whole", r)
        block = _rank(path, name, shape, "block", r)
        c = r % shape[1]
        for k, v in block.items():
            want = whole[k][c * el:(c + 1) * el] if k in (
                "wi.w", "wg.w", "wo.w") else whole[k]
            np.testing.assert_array_equal(v, want, err_msg=k)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_non_aux_gradients_equal_the_unsharded(runs, name, shape):
    """Without the aux term, the gradients summed over the data ranks (x:
    concatenated) are the unsharded ``moe_apply``'s over the whole batch,
    within 1e-5: the combine's backward reaches each expert's partial
    once, not tp times.  Both with a capacity no expert's load can pass
    (capacity_factor E / k), since the sharded layer's capacity is per
    data shard, as the reference's is."""
    path, inputs = runs
    cfg, arr = inputs[name]
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                              / cfg.top_k)
    p = moe.moe_init(None, cfg, torch.float32, "cpu")
    p.load_state_dict({k: torch.from_numpy(arr[k].copy())
                       for k in p.state_dict()},
                      assign=True)
    x = torch.from_numpy(arr["x"]).requires_grad_()
    y, _ = moe.moe_apply(p, cfg, x)
    (y * torch.from_numpy(arr["w"])).sum().backward()
    dp, tp = shape
    heads = [_rank(path, name, shape, "noaux", d * tp) for d in range(dp)]
    assert _rel(np.concatenate([h["x"] for h in heads]),
                x.grad.numpy()) <= TOL
    for k, v in p.named_parameters():
        assert _rel(np.sum([h[k] for h in heads], axis=0),
                    v.grad.numpy()) <= TOL, k


def test_pod_major_block_matches_the_reference_split(runs):
    """``sharding.block`` of an (8,) tensor under the spec
    ``(("pod", "data"),)`` on a (2, 2, 1) (pod, data, model) mesh is, at
    each coordinate, the slice JAX gives that device under
    ``P(("pod", "data"))``: pod-major."""
    from repro_torch.dist import sharding as shd
    path, _ = runs

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 2, 1)

        def __init__(self, coord):
            self.coord = dict(zip(self.mesh_dim_names, coord))

        def size(self, i):
            return self.shape[i]

        def get_local_rank(self, axis):
            return self.coord[axis]

    full = torch.arange(8)
    for coord, (start, stop) in json.loads(
            (path / "pod_major.json").read_text()):
        mesh = Mesh(coord)
        got = shd.block(full, mesh, shd.placements(mesh, (("pod", "data"),)))
        assert got.tolist() == list(range(start, stop)), coord
