"""The port's sharding rules and logical-axis anchors
(``repro_torch.dist.sharding``, ``repro_torch.dist.context``) against the
JAX package's, on the CPU, as pure shape arithmetic: no process group,
no allocation.

* every leaf of all ten full-width configs gets the reference's spec
  (``repro.dist.sharding.param_shardings`` on the reference's
  ``jax.eval_shape`` tree; the port's ``leaf_specs`` on ``meta`` tensors by
  state-dict name), at the production axis sizes (``PLAN_AXIS_SIZES``,
  ``("data", "model")`` and ``("pod", "data", "model")``) and on the test
  meshes (4, 2) and (2, 2), in both modes; and each per-layer tensor takes
  its leaf's spec without the stack dims;
* a per-layer tensor below ``MIN_SHARD_ELEMS`` whose stack is above it is
  sharded, as the reference shards the stack;
* ``placements`` of a spec, the pod-major split of a tuple axis;
* ``_resolve`` against the reference's on fake meshes, and ``constrain``:
  its input itself, with and without a mesh, and the reference's arity
  assert under one.
"""
import functools

import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import ASSIGNED  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.dist import context as ref_context  # noqa: E402
from repro.dist import sharding as ref_shd  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import context, sharding as shd  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402

MESHES = {"plan-2d": ("data", "model"), "plan-3d": ("pod", "data", "model"),
          "test-4x2": {"data": 4, "model": 2},
          "test-2x2": {"data": 2, "model": 2}}


class PortMesh:
    """Shape-only stand-in for a ``DeviceMesh``."""

    def __init__(self, sizes: dict):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


class RefMesh:
    """Shape-only stand-in for a jax ``Mesh`` (tests/test_sharding.py)."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


def _sizes(mesh) -> dict:
    if isinstance(mesh, dict):
        return mesh
    return {a: shd.PLAN_AXIS_SIZES[a] for a in mesh}


@functools.lru_cache(maxsize=None)
def _ref_abstract(name):
    return jax.eval_shape(ref_build(ref_config(name)).init, jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _port_named(name):
    return dict(init_params(get_config(name), device="meta")
                .named_parameters())


def _ref_specs(name, sizes, mode, monkeypatch):
    """The reference's ``param_shardings`` by leaf path, each spec as a
    tuple (its ``NamedSharding`` needs devices: the spec is kept)."""
    monkeypatch.setattr(ref_shd, "NamedSharding", lambda mesh, spec: spec)
    out = ref_shd.param_shardings(RefMesh(sizes), _ref_abstract(name),
                                  mode=mode)
    return {p: tuple(s) for p, s in ref_shd.tree_paths(out).items()}


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ASSIGNED)
def test_specs_match_reference(name, mesh, mode, monkeypatch):
    sizes = _sizes(MESHES[mesh])
    want = _ref_specs(name, sizes, mode, monkeypatch)
    named = _port_named(name)
    got = shd.leaf_specs(PortMesh(sizes), named, mode=mode)
    assert set(got) == set(want)
    ref_shapes = ref_shd.tree_paths(_ref_abstract(name))
    for path, spec in want.items():
        # the port's stacked shape is the reference leaf's
        assert shd.reference_leaves(named)[path][0] == \
            tuple(ref_shapes[path].shape), path
        assert got[path] == spec, (path, got[path], spec)
    per_layer = shd.param_shardings(PortMesh(sizes), named, mode=mode)
    for path, (_, names) in shd.reference_leaves(named).items():
        for n in names:
            assert per_layer[n] == got[path][shd._n_stack_dims(path):], n


def test_stack_size_decides_min_shard_elems():
    """qwen2.5-14b's norm scale is 5120 elements a layer, below
    ``MIN_SHARD_ELEMS``; its 48-layer stack is above it, so the reference
    shards the stack's d dim over ``data`` and each layer's tensor takes
    that dim's spec."""
    named = _port_named("qwen2_5_14b")
    n = "dense_layers.0.ln1.scale"
    assert named[n].numel() < shd.MIN_SHARD_ELEMS
    mesh = PortMesh({"data": 16, "model": 16})
    assert shd.param_shardings(mesh, named)[n] == ("data",)
    assert shd.leaf_specs(mesh, named)["dense_layers/ln1/scale"] == \
        (None, "data")
    alone = shd.param_spec("ln1/scale", named[n].shape, "data")
    assert alone == (None,)


def test_hybrid_stack_is_two_dims():
    named = _port_named("zamba2_1_2b")
    leaves = shd.reference_leaves(named)
    shape, names = leaves["group_layers/mamba/A_log"]
    assert len(names) == shape[0] * shape[1] and len(shape) == 3
    assert names[:2] == ["group_layers.0.0.mamba.A_log",
                         "group_layers.0.1.mamba.A_log"]


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = PortMesh({"pod": 2, "data": 2, "model": 2})
    assert shd.placements(mesh, (None, ("pod", "data"))) == [
        Shard(1), Shard(1), Replicate()]
    assert shd.placements(mesh, ("model", None)) == [
        Replicate(), Replicate(), Shard(0)]
    assert shd.placements(mesh, ()) == [Replicate()] * 3


def test_block_is_pod_major():
    """A tuple axis splits its dim pod-major: the block at (pod p, data d)
    of a (2, 2, 1) mesh is chunk p * 2 + d of four."""
    class Mesh(PortMesh):
        def __init__(self, coord):
            super().__init__({"pod": 2, "data": 2, "model": 1})
            self.coord = dict(zip(self.mesh_dim_names, coord))

        def size(self, i):
            return self.shape[i]

        def get_local_rank(self, axis):
            return self.coord[axis]

    full = torch.arange(24).reshape(3, 8)
    for p in range(2):
        for d in range(2):
            mesh = Mesh((p, d, 0))
            got = shd.block(full, mesh, shd.placements(
                mesh, (None, ("pod", "data"))))
            k = p * 2 + d
            assert torch.equal(got, full[:, 2 * k:2 * k + 2])


@pytest.mark.parametrize("axes", [("data", "model"), ("pod", "data", "model"),
                                  ("data",), ("model",), ("pod", "data")])
@pytest.mark.parametrize("logical", ["dp", "tp", None, "data", "model", "pod",
                                     "bogus"])
def test_resolve_matches_reference(axes, logical):
    sizes = {a: 2 for a in axes}
    assert context._resolve(PortMesh(sizes), logical) == \
        ref_context._resolve(RefMesh(sizes), logical)


def test_constrain_returns_its_input():
    x = torch.ones(4, 3, 8)
    assert context.get_mesh() is None
    assert context.constrain(x, "dp", None, "tp") is x
    assert context.constrain(x, "dp") is x          # no mesh: no check
    try:
        context.set_mesh(PortMesh({"data": 2, "model": 2}))
        assert context.constrain(x, "dp", None, "tp") is x
        with pytest.raises(AssertionError):
            context.constrain(x, "dp", None)
    finally:
        context._MESH = None
