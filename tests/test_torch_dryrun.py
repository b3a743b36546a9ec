"""The port's dry run (``repro_torch.launch.{steps,roofline,dryrun}``)
against the JAX package's ``repro.launch``, on the CPU.

* ``SHAPES``, ``ENC_LEN`` and ``shape_skip_reason`` for the ten configs
  and four shapes;
* ``batch_specs`` and ``cache_specs``: shapes, dtypes and specs equal to
  the reference's for every config, every non-skipped shape and the
  production 2-D and 3-D meshes and the (4, 2) test mesh, as shape
  arithmetic (the reference's ``NamedSharding`` monkeypatched to keep the
  spec, its cache from ``jax.eval_shape``);
* ``param_counts`` and the model flops against the reference's loop
  (``dryrun.py:193-216``) on its ``eval_shape`` tree, for all ten configs;
* ``collective_stats`` against ``parse_collectives`` on HLO lines written
  for the same ops, ``roofline_terms`` against the reference's with the
  constants patched equal, and the constants held to the H100's;
* the per-rank prefill and serve steps on four gloo ranks (``python -c``
  subprocesses) on the (2, 2) and (1, 4) meshes, each rank's logits
  within 1e-5 (f32) of the reference's unsharded step;
* ``run_cell`` in a subprocess (fake process groups of 256 and 512 ranks,
  ``--device cpu``) for train, prefill, decode and skipped cells: the
  reference's record schema but for ``DIFFERENCES``, the depth points'
  extrapolation equal to the full trace, ``useful_flops_ratio`` in
  (0, 1]; beside the reference's own ``run_cell`` on one reduced cell in
  one more subprocess (512 fake XLA devices), the two records' status,
  chips, parameter counts and model flops equal.

The tools over its records (``run_matrix``, ``report``, ``perf``,
``gen_perf``) are held in ``tests/test_torch_launch_tools.py``.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
import time
from fractions import Fraction

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import torch_lm_support as lm  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.dist import sharding as ref_shd  # noqa: E402
from repro.launch import roofline as ref_rl  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, roofline, steps  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["mamba2-370m", "zamba2-1.2b", "minicpm-2b", "internvl2-2b",
         "h2o-danube-3-4b", "seamless-m4t-large-v2", "stablelm-12b",
         "qwen2.5-14b", "dbrx-132b", "deepseek-v2-236b"]
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MESHES = {"plan-2d": {"data": 16, "model": 16},
          "plan-3d": {"pod": 2, "data": 16, "model": 16},
          "test-4x2": {"data": 4, "model": 2}}
PROC_TIMEOUT = 300
TOL = 1e-5

# every departure of the port's dry run from the reference's, by the
# string in the port's source that carries it
DIFFERENCES = {
    "launch/dryrun.py": {
        "FakeTensorMode": "the per-rank program is traced on fake tensors "
                          "under a fake process group of the mesh's size "
                          "(no XLA compile to read); each cell still its "
                          "own process",
        '"trace_s"': "trace_s, the build and trace seconds, in place of "
                     "lower_s and compile_s",
        '"ops_traced"': "the aten ops traced in place of hlo_bytes",
        "MemTracker": "memory_analysis from MemTracker over the traced "
                      "rank: arguments, outputs, their alias, the rest of "
                      "the peak as temporaries; no generated code",
        "FlopCounterMode": "flops are FlopCounterMode's (matmuls, "
                           "convolutions, attention), not XLA's every-op "
                           "count",
        "OpRecorder": "bytes are eager's unfused count (each aten op's "
                      "inputs and outputs, views skipped), an upper bound "
                      "on XLA's fused bytes",
        "Fraction": "the depth points' extrapolation in exact integers; "
                    "cost_analysis is the full trace's count, which eager "
                    "makes exact (the hybrid's groups do not extrapolate "
                    "linearly)",
        '"--device"': "--device: the card by default, cpu for the tests",
    },
    "launch/roofline.py": {
        "989.4e12": "the H100 SXM's bf16 peak in place of the v5e's 197e12",
        "3.35e12": "the H100's HBM3 rate in place of 819e9",
        "400 Gb/s NDR": "LINK_BW (the reference's 50e9 too) is one 400 "
                        "Gb/s NDR port per GPU across nodes, in place of "
                        "the v5e's ICI link",
        "def collective_stats": "the collectives the trace recorded (c10d "
                                "op, payload, group size) in place of "
                                "parse_collectives' HLO text",
    },
    "launch/steps.py": {
        "def shard_serve_params": "a serving rank gathers every parameter "
                                  "whole from its serve-mode spec (the "
                                  "dense layers run whole on every model "
                                  "rank), the routed experts kept as its "
                                  "E / tp block",
        "def _rows": "a serving rank runs its rows of the batch where they "
                     "divide over the data axes, else the whole batch",
        "rows = b // dps": "the decode cache is the rank's rows (the whole "
                           "batch's at long_500k): neither the KV heads "
                           "over model nor the sequence over data "
                           "(_cache_shardings' put(2, dp, dps)) split it",
        "donate=True, mesh=mesh": "the train cell runs the in-place ZeRO "
                                  "step (the state gathered whole on every "
                                  "rank)",
        'device="meta"': "batch and cache specs are meta tensors (the "
                         "reference's ShapeDtypeStructs); specs are tuples",
    },
}


class PortMesh:
    """Shape-only stand-in for a ``DeviceMesh``."""

    def __init__(self, sizes: dict):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


class RefMesh:
    """Shape-only stand-in for a jax ``Mesh``."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


def _cells():
    return [(a, s) for a in ARCHS for s in SHAPE_NAMES
            if ref_steps.shape_skip_reason(ref_config(a), s) is None]


@pytest.mark.parametrize("difference", sorted(DIFFERENCES))
def test_each_difference_is_in_the_port_and_not_the_reference(difference):
    port = open(os.path.join(REPO, "src", "repro_torch", difference)).read()
    ref = open(os.path.join(REPO, "src", "repro", difference)).read()
    for name in DIFFERENCES[difference]:
        assert name in port, name
        assert name not in ref, name


def test_every_reference_module_has_a_counterpart():
    """No module of ``src/repro/`` lacks one in ``src/repro_torch/``, but
    ``dist/compat.py`` (shard_map across jax releases) and the jaxpr
    audit that item 11c replaced with ``trace/op_audit.py``."""
    def modules(top):
        root = os.path.join(REPO, "src", top)
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, fs in os.walk(root) for f in fs
                if f.endswith(".py") and "__pycache__" not in d}
    missing = modules("repro") - modules("repro_torch")
    assert missing == {"dist/compat.py", "analysis/trace/jaxprs.py",
                       "analysis/trace/jaxpr_audit.py"}, sorted(missing)
    launch = {m for m in modules("repro") if m.startswith("launch/")}
    assert launch <= modules("repro_torch")


def test_shapes_match_reference():
    assert steps.SHAPES == ref_steps.SHAPES
    assert steps.ENC_LEN == ref_steps.ENC_LEN


@pytest.mark.parametrize("arch", ARCHS)
def test_skip_reasons_match_reference(arch):
    for shape in SHAPE_NAMES:
        assert steps.shape_skip_reason(get_config(arch), shape) == \
            ref_steps.shape_skip_reason(ref_config(arch), shape)


def _dtype(dt) -> str:
    return str(dt).replace("torch.", "")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@functools.lru_cache(maxsize=None)
def _ref_cache(arch, shape):
    cfg = ref_config(arch)
    info = ref_steps.SHAPES[shape]
    model = ref_build(cfg)
    if cfg.is_encdec:
        return jax.eval_shape(lambda: model.init_cache(
            info["batch"], info["seq"], enc_len=ref_steps.ENC_LEN))
    return jax.eval_shape(lambda: model.init_cache(info["batch"],
                                                   info["seq"]))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", _cells())
def test_batch_and_cache_specs_match_reference(arch, shape, mesh,
                                               monkeypatch):
    monkeypatch.setattr(ref_steps, "NamedSharding", lambda mesh, spec: spec)
    sizes = MESHES[mesh]
    rb, rs = ref_steps.batch_specs(ref_config(arch), shape, RefMesh(sizes))
    pb, ps = steps.batch_specs(get_config(arch), shape, PortMesh(sizes))
    assert set(pb) == set(rb)
    for k in rb:
        assert tuple(pb[k].shape) == tuple(rb[k].shape), k
        assert _dtype(pb[k].dtype) == str(rb[k].dtype), k
        assert pb[k].is_meta
        assert ps[k] == tuple(rs[k]), (k, ps[k], rs[k])
    if ref_steps.SHAPES[shape]["kind"] != "decode":
        return
    ref_cache = _ref_cache(arch, shape)
    want_sh = ref_steps._cache_shardings(RefMesh(sizes), ref_cache,
                                         ref_steps.SHAPES[shape]["batch"])
    cache, got_sh = steps.cache_specs(get_config(arch), shape,
                                      PortMesh(sizes))
    want, want_sh = _flat(ref_cache), _flat(want_sh)
    got, got_sh = _flat(cache), _flat(got_sh)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert _dtype(got[k].dtype) == str(want[k].dtype), k
        assert got[k].is_meta
        assert got_sh[k] == tuple(want_sh[k]), (k, got_sh[k], want_sh[k])


def _ref_counts(arch):
    """The reference's parameter loop (``dryrun.py:193-202``)."""
    params = jax.eval_shape(ref_build(ref_config(arch)).init,
                            jax.random.key(0))
    total, embed, moe_expert = 0, 0, 0
    for path, leaf in ref_shd.tree_paths(params).items():
        n = int(leaf.size)
        total += n
        if path.startswith("embed/") or path.startswith("lm_head/"):
            embed += n
        if "/moe/w" in path and "/shared" not in path:
            moe_expert += n
    return total, embed, moe_expert


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    total, embed, moe_expert = dryrun.param_counts(cfg)
    assert (total, embed, moe_expert) == _ref_counts(arch)
    nonembed = total - embed
    active = nonembed - moe_expert + (moe_expert * cfg.top_k
                                      // max(1, cfg.num_experts))
    for shape, info in steps.SHAPES.items():
        n_tokens = info["batch"] * (info["seq"] if info["kind"] != "decode"
                                    else 1)
        assert roofline.model_flops(
            cfg, n_tokens, params_nonembed=nonembed,
            params_active_nonembed=active) == ref_rl.model_flops(
            rcfg, n_tokens, params_nonembed=nonembed,
            params_active_nonembed=active)


# (c10d op, the reference's HLO kind, the HLO result shape given the
# group size g: what the reference reads as the payload)
HLO_CASES = {
    "allreduce_": ("all-reduce", lambda g: "f32[1024,64]{1,0}"),
    "allgather_": ("all-gather", lambda g: f"f32[{128 * g},64]{{1,0}}"),
    "_reduce_scatter_base_": ("reduce-scatter",
                              lambda g: f"bf16[{2048 // g},64]{{1,0}}"),
    "alltoall_base_": ("all-to-all", lambda g: "f32[256,32]{1,0}"),
}


def _hlo_line(kind, shape, g, i=0):
    groups = ",".join(str(r) for r in range(g))
    return (f"  %{kind}.{i} = {shape} {kind}({shape} %p{i}), "
            f"replica_groups={{{{{groups}}}}}, dimensions={{0}}")


def _shape_bytes(shape) -> int:
    dt, dims = shape.split("[")
    n = int(np.prod([int(d) for d in dims.split("]")[0].split(",")]))
    return n * {"f32": 4, "bf16": 2}[dt]


@pytest.mark.parametrize("g", [1, 2, 16])
@pytest.mark.parametrize("op", sorted(HLO_CASES))
def test_collective_stats_match_parse_collectives(op, g):
    kind, shape = HLO_CASES[op]
    want = ref_rl.parse_collectives(_hlo_line(kind, shape(g), g))
    got = roofline.collective_stats([(op, _shape_bytes(shape(g)), g)])
    assert got.summary() == want.summary()


def test_collective_stats_of_a_schedule_and_unnamed_ops():
    """A mixed schedule sums as the reference's does; an op the table
    does not name keeps its own name and the reference's
    all-to-all/permute wire."""
    ops = sorted(HLO_CASES)
    lines, records = [], []
    for i, (op, g) in enumerate(zip(ops * 3, [1, 2, 16] * 4)):
        kind, shape = HLO_CASES[op]
        lines.append(_hlo_line(kind, shape(g), g, i))
        records.append((op, _shape_bytes(shape(g)), g))
    assert roofline.collective_stats(records).summary() == \
        ref_rl.parse_collectives("\n".join(lines)).summary()
    for g in (1, 2, 16):
        want = ref_rl.parse_collectives(
            _hlo_line("collective-permute", "f32[64,64]{1,0}", g))
        got = roofline.collective_stats([("broadcast_", 64 * 64 * 4, g)])
        assert got.counts == {"broadcast_": 1}
        assert got.wire_bytes == want.wire_bytes


def test_roofline_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == 989.4e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 50e9


@pytest.mark.parametrize("terms", [(1.7e15, 1.6e14, 3.0e10), (0.0, 1e9, 0.0),
                                   (5e12, 0.0, 7e11)])
def test_roofline_terms_match_reference(terms, monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(ref_rl, name, getattr(roofline, name))
    got = roofline.roofline_terms(*terms).as_dict()
    assert got == ref_rl.roofline_terms(*terms).as_dict()
    assert got["dominant"] == max(
        ("compute", "memory", "collective"), key=lambda k: got[k + "_s"])


# --------------------------------------------- per-rank prefill and serve
SERVE_CASES = [("minicpm-2b", (2, 2)), ("deepseek-v2-236b", (2, 2)),
               ("deepseek-v2-236b", (1, 4)), ("deepseek-v2-236b", (4, 1)),
               ("zamba2-1.2b", (2, 2))]
SERVE_B, SERVE_S, DECODE_STEPS = 4, 8, 3

_RANK_CODE = """
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.dist import make_mesh, set_mesh
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.models.model import family, init_params

rank, store, out, cases = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
    json.loads(sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=4)
for name, shape, changes, steps_n in cases:
    cfg = dataclasses.replace(get_config(name).reduced(), **changes)
    arr = np.load(f"{out}/{name}_in.npz")
    mesh = make_mesh(tuple(shape), device="cpu")
    set_mesh(mesh)
    model = transformer.with_params(init_params(cfg, device="cpu"), {
        k[2:]: torch.from_numpy(arr[k]) for k in arr.files
        if k.startswith("p.")})
    params = steps.shard_serve_params(model, mesh)
    toks = torch.from_numpy(arr["tokens"])
    res = {"prefill": steps.make_prefill_step(cfg, mesh=mesh)(
               params, {"tokens": toks}).numpy(),
           "prefill_one": steps.make_prefill_step(cfg, mesh=mesh)(
               params, {"tokens": toks[:1]}).numpy()}
    serve = steps.make_serve_step(cfg, mesh=mesh)
    rows = toks.shape[0] // shape[0]
    cache = family(cfg).init_cache(cfg, rows, toks.shape[1],
                                   dtype=torch.float32, device="cpu")
    for t in range(steps_n):
        logits, cache = serve(params, cache, toks[:, t:t + 1], t)
        res[f"step{t}"] = logits.numpy()
    blocks = {n: p.to_local().shape[0]
              for n, p in params.named_parameters() if "moe.wi" in n}
    res["expert_rows"] = np.array(sorted(set(blocks.values())) or [0])
    tag = f"{name}_{shape[0]}x{shape[1]}_r{rank}"
    np.savez(f"{out}/{tag}.npz", **res)
    set_mesh(None)
dist.destroy_process_group()
"""


def _moe_changes(name):
    cfg = get_config(name).reduced()
    # no drops: the unsharded reference's capacity is over all the tokens,
    # each rank's over its own
    return {"capacity_factor": float(cfg.num_experts / cfg.top_k)} \
        if cfg.moe else {}


def _serve_changes(name):
    return dict(_moe_changes(name), compute_dtype="float32")


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """The reference's unsharded prefill and serve steps here, the four
    gloo ranks' per-rank steps in subprocesses."""
    tmp = tmp_path_factory.mktemp("serve")
    want = {}
    for name in sorted({n for n, _ in SERVE_CASES}):
        cfg, rm, rp, model = lm.pair(name, "float32", **_moe_changes(name))
        rng = np.random.default_rng(7)
        toks = rng.integers(0, cfg.vocab_size, (SERVE_B, SERVE_S)).astype(
            np.int32)
        arrays = {"p." + n: p.detach().numpy()
                  for n, p in model.named_parameters()}
        np.savez(tmp / f"{name}_in.npz", tokens=toks, **arrays)
        prefill = ref_steps.make_prefill_step(rm.cfg)
        ref = {"prefill": np.asarray(prefill(rp, {"tokens": toks})),
               "prefill_one": np.asarray(prefill(rp, {"tokens": toks[:1]}))}
        serve = ref_steps.make_serve_step(rm.cfg)
        cache = rm.init_cache(SERVE_B, SERVE_S, dtype=jax.numpy.float32)
        for t in range(DECODE_STEPS):
            logits, cache = serve(rp, cache, toks[:, t:t + 1], t)
            ref[f"step{t}"] = np.asarray(logits)
        want[name] = ref
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    cases = json.dumps([[n, list(m), _serve_changes(n), DECODE_STEPS]
                        for n, m in SERVE_CASES])
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANK_CODE), str(r),
         str(tmp / "store"), str(tmp), cases], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    deadline = time.monotonic() + PROC_TIMEOUT
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
    return tmp, want


def _rank_rows(shape, r, b):
    """The rows of the batch rank ``r`` of a (data, model) mesh runs."""
    d = r // shape[1]
    n = b // shape[0]
    return slice(d * n, (d + 1) * n)


@pytest.mark.parametrize("name,shape", SERVE_CASES)
def test_per_rank_steps_match_the_unsharded_reference(serve_runs, name,
                                                      shape):
    tmp, want = serve_runs
    for r in range(4):
        got = dict(np.load(tmp / f"{name}_{shape[0]}x{shape[1]}_r{r}.npz"))
        rows = _rank_rows(shape, r, SERVE_B)
        for key in ["prefill"] + [f"step{t}" for t in range(DECODE_STEPS)]:
            assert lm.rel(got[key], want[name][key][rows]) < TOL, (r, key)
        # one row does not divide over the data axis: the whole batch
        assert lm.rel(got["prefill_one"], want[name]["prefill_one"]) < TOL
        if get_config(name).moe and shape[1] > 1:
            # each model rank holds its E / tp experts
            e = get_config(name).reduced().num_experts
            assert list(got["expert_rows"]) == [e // shape[1]]


# ------------------------------------------------------------ run_cell
# (arch, shape, mesh, overrides beyond reduced(), skip the cost model)
CELLS = [("minicpm-2b", "train_4k", "single", {"num_layers": 6}, False),
         ("minicpm-2b", "decode_32k", "multi", {"num_layers": 6}, False),
         ("minicpm-2b", "prefill_32k", "single", {}, True),
         ("mamba2-370m", "decode_32k", "single", {"num_layers": 6}, False),
         ("mamba2-370m", "long_500k", "multi", {}, True),
         ("minicpm-2b", "long_500k", "single", {}, False)]


def _extrapolated(rec: dict, key: str):
    """A cell's depth points' linear extrapolation of ``key`` to its
    config's full depth, exactly (the reference's ``extrap``)."""
    cfg = get_config(rec["arch"])
    if rec.get("overrides"):
        cfg = dataclasses.replace(cfg, **rec["overrides"])
    (la, a), (lb, b) = sorted((int(L), p[key])
                              for L, p in rec["depth_points"].items())
    return a + (cfg.num_layers - la) * Fraction(b - a, lb - la)


def _overrides(arch, extra):
    full = get_config(arch)
    red = full.reduced()
    ov = {f.name: getattr(red, f.name) for f in dataclasses.fields(full)
          if getattr(red, f.name) != getattr(full, f.name)}
    return dict(ov, **extra)


_PORT_CODE = """
import json, sys
import torch
from repro_torch.launch import dryrun
torch.set_num_threads(1)
out, cells = sys.argv[1], json.loads(sys.argv[2])
recs = [dryrun.run_cell(a, s, m, overrides=ov, skip_cost_model=skip,
                        device="cpu") for a, s, m, ov, skip in cells]
json.dump(recs, open(out, "w"))
"""

_REF_CODE = """
import json, sys
from repro.launch import dryrun
out, cells = sys.argv[1], json.loads(sys.argv[2])
recs = [dryrun.run_cell(a, s, m, overrides=ov, skip_cost_model=skip)
        for a, s, m, ov, skip in cells]
json.dump(recs, open(out, "w"), default=str)
"""

# the reference's cells: one compiled train cell with its cost model, and
# a skipped one
REF_CELLS = [CELLS[0], CELLS[-1]]


@pytest.fixture(scope="module")
def cell_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cells")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    runs = []
    for code, cells, name in ((_PORT_CODE, CELLS, "port"),
                              (_REF_CODE, REF_CELLS, "ref")):
        arg = json.dumps([[a, s, m, _overrides(a, ov), skip]
                          for a, s, m, ov, skip in cells])
        runs.append((tmp / f"{name}.json", subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(code),
             str(tmp / f"{name}.json"), arg], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)))
    deadline = time.monotonic() + PROC_TIMEOUT
    out = []
    try:
        for path, p in runs:
            err = p.communicate(timeout=max(1.0, deadline -
                                            time.monotonic()))[1]
            assert p.returncode == 0, err[-4000:]
            out.append(json.load(open(path)))
    finally:
        for _, p in runs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


# the reference's record keys that the port names otherwise
RENAMED = {"lower_s": "trace_s", "compile_s": "trace_s",
           "hlo_bytes": "ops_traced"}


def _schema(rec) -> set:
    keys = set()
    for k, v in rec.items():
        k = RENAMED.get(k, k)
        keys.add(k)
        if k in ("rolled_analysis", "memory_analysis", "roofline"):
            keys |= {f"{k}/{RENAMED.get(s, s)}" for s in v}
    return keys


@pytest.mark.parametrize("i", range(len(CELLS)))
def test_run_cell_writes_the_reference_schema(cell_runs, i):
    port, ref = cell_runs
    rec = port[i]
    if CELLS[i][-1]:
        want = _schema(ref[0]) - {"depth_points",
                                  "collective_counts_extrapolated"}
    else:
        want = _schema(ref[0])
    if rec["status"] == "skipped":
        assert _schema(rec) == _schema(ref[1])
        assert rec["reason"] == ref[1]["reason"]
        return
    assert rec["status"] == "ok"
    # memory_analysis has no generated code to size
    assert _schema(rec) == want - {"memory_analysis/"
                                   "generated_code_size_in_bytes"}
    assert rec["chips"] == (512 if rec["mesh"] == "multi" else 256)
    assert 0 < rec["useful_flops_ratio"] <= 1
    ma = rec["memory_analysis"]
    assert rec["hbm_per_device_bytes"] == (
        ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
        + max(0, ma["output_size_in_bytes"] - ma["alias_size_in_bytes"]))
    assert rec["cost_analysis"]["flops"] == rec["rolled_analysis"]["flops"]
    assert rec["roofline"]["step_time_s"] > 0


@pytest.mark.parametrize("i", [i for i, c in enumerate(CELLS)
                               if not c[-1] and c[1] != "long_500k"])
def test_depth_points_extrapolate_to_the_full_trace(cell_runs, i):
    """Eager traces every layer, so the full trace is exact; the depth
    points' linear extrapolation equals it where every layer repeats and
    the ZeRO layout does not change with depth."""
    rec = cell_runs[0][i]
    for key in ("flops", "bytes_accessed", "wire_bytes"):
        assert _extrapolated(rec, key) == \
            rec["rolled_analysis"][key], key
    assert rec["collective_counts_extrapolated"] == \
        rec["rolled_analysis"]["collectives"]["counts"]


def test_run_cell_matches_the_reference_cell(cell_runs):
    port, ref = cell_runs
    for key in ("status", "chips", "params_total", "params_nonembed",
                "params_active_nonembed", "model_flops_global"):
        assert port[0][key] == ref[0][key], key


def test_entry_point_writes_a_skipped_cell(tmp_path):
    out = tmp_path / "cell.json"
    assert dryrun.main(["--arch", "qwen2.5-14b", "--shape", "long_500k",
                        "--out", str(out), "--device", "cpu"]) == 0
    rec = json.load(open(out))
    assert rec["status"] == "skipped" and "full-attention" in rec["reason"]


def test_run_cell_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_cell("minicpm-2b", "train_4k", "single")
