"""Tensor parallelism over ``model`` (``repro_torch.dist.tensor_parallel``,
``sharding.tp_blocks``, ``context.tp_layout``/``tp_cache_layout`` and the
per-rank steps of ``launch.steps``) against the JAX package's GSPMD
program, on the CPU.

All ``reduced()`` configs, in f32 unless named:

* minicpm-2b at (1, 2), (2, 2) and (1, 4): the ``"heads"`` layout and the
  KV-heads cache; at (1, 2) in bf16 too;
* qwen2.5-14b at (1, 2) and (2, 2): one KV head, so ``"rows"`` and the
  ``head_dim`` cache, with the QKV biases and an untied head;
* h2o-danube-3-4b at (1, 2) over 64 positions: the sliding window of 32
  crosses the row blocks;
* dbrx-132b at (2, 2): tensor and expert parallelism together.

The ranks are gloo processes (``python -c`` subprocesses, each group's
rendezvous a ``FileStore`` in the temporary directory); the reference
runs its jitted steps with ``set_mesh`` and its own ``param_shardings`` /
``cache_specs`` on fake XLA devices in two more subprocesses (each
config on its largest mesh, ``SHARDED_REF``: its SPMD compiles are most
of the module's time), and its unsharded steps for every case in the
test process meanwhile.  Held:

* each rank's forward logits (its vocab block), prefill logits, every
  decode step's logits, and the train step's loss, grad norm, updated
  parameters, m and v within 1e-5 (f32) of the reference's sharded and
  unsharded steps, 2e-2 in bf16 (max |d| / max |ref| per tensor; the
  train state in f32 only, ``BF16_STATE``); the unsharded train step is
  the reference's loss and gradients per data block, averaged, then one
  AdamW update (the sharded MoE's capacity and aux are per block); the
  QKV biases, zeros at init and so all update after one step, within a
  tenth of lr, and the k bias's m and v, rounding noise in both packages
  (the softmax cancels it), within ``NOISE_SHARE`` of the largest;
* the serving ranks' blocks: the shapes ``tp_blocks`` gives, the values
  ``convert.tp_blocks_from_jax`` cuts from the reference's parameters,
  and their cache blocks the shapes ``cache_specs`` gives;
* the tied table's gradient on a (1, 2) rank against
  ``jax.value_and_grad`` of the unsharded reference;
* the dry run's traced flops per rank at (1, m) are 1/m of (1, 1)'s
  within 1% for m = 2 and 4 (the reference's ``cost_analysis`` ratio is
  printed beside them, not held);
* shape arithmetic: the layout decisions against ``_attn_constrain``'s
  and ``cache_specs``', and the serving blocks' bytes against the
  reference's serve-mode blocks; a mesh that reaches the KV-length cache
  layout gives each rank its block of positions.
"""
import dataclasses
import json
import math
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
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import context, sharding  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL, BF16_TOL = 1e-5, 2e-2
FLOPS_TOL = 0.01
# the k bias's m and v are rounding noise in both packages (its gradient
# is zero but for rounding): held within this share of the largest m, v
NOISE_SHARE = 1e-3
# BF16_STATE: in bf16 the train step's loss, nll, aux and grad norm are
# held at 2e-2 against the reference, but its updated parameters and
# moments against the port's own unsharded bf16 step: one bf16 step's
# gradients differ from the reference's per element by up to 2.4% (v 4.1%;
# qwen2.5-14b's biases and MLP at (1, 2)), the port rounding each op to
# bf16 where XLA keeps a chain in f32.  Against its own unsharded step,
# minicpm-2b at (1, 2) stands at most 1.53e-2 off (v of the table; m at
# most 1.04e-2), and the same step in f32 at most 1.80e-2 (v of the MLP's
# wg): splitting the heads reorders bf16 roundings about as much as f32
# does, so the hold sees a layout fault (a block on the wrong rank, a sum
# missed or made twice), not a rounding one, which the f32 cases hold
BF16_STATE_TOL = 2e-2
B, S, DECODE_STEPS = 4, 16, 3
PROC_TIMEOUT = 300
GQA_ARCHS = ["minicpm-2b", "qwen2.5-14b", "stablelm-12b", "h2o-danube-3-4b",
             "internvl2-2b", "dbrx-132b"]
# (name, mesh, compute dtype, sequence)
CASES = [("minicpm-2b", (1, 2), "float32", S),
         ("minicpm-2b", (2, 2), "float32", S),
         ("minicpm-2b", (1, 4), "float32", S),
         ("minicpm-2b", (1, 2), "bfloat16", S),
         ("qwen2.5-14b", (1, 2), "float32", S),
         ("qwen2.5-14b", (2, 2), "float32", S),
         ("h2o-danube-3-4b", (1, 2), "float32", 64),
         ("dbrx-132b", (2, 2), "float32", S)]
TABLE_CASE = "minicpm-2b_1x2_float32"
# layer 0's attention in the "rows" layout through KV chunks of CHUNK: the
# window of 32 and the chunk edges both cross the row blocks of 32
CHUNKED_CASE, CHUNK = "h2o-danube-3-4b_1x2_float32", 8
# the cases the reference's sharded program runs too (its SPMD compiles
# are the fixture's cost): each config on its largest mesh
SHARDED_REF = {"minicpm-2b_2x2_float32", "minicpm-2b_1x4_float32",
               "qwen2.5-14b_2x2_float32", "h2o-danube-3-4b_1x2_float32",
               "dbrx-132b_2x2_float32"}


def _tag(case) -> str:
    name, shape, cd, _ = case
    return f"{name}_{shape[0]}x{shape[1]}_{cd}"


def _changes(name) -> dict:
    cfg = get_config(name).reduced()
    # no drops: a data rank's capacity is over its own tokens
    return {"capacity_factor": float(cfg.num_experts / cfg.top_k)} \
        if cfg.moe else {}


def _cfg(case):
    name, _, cd, _ = case
    return dataclasses.replace(get_config(name).reduced(), compute_dtype=cd,
                               **_changes(name))


class PortMesh:
    """Shape-only stand-in for a ``DeviceMesh``, with one rank's
    coordinates."""

    def __init__(self, sizes: dict, coords=None):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())
        self.coords = coords or {}

    def get_local_rank(self, axis):
        return self.coords[axis]


class RefMesh:
    """Shape-only stand-in for a jax ``Mesh``."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


_RANK_CODE = """
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.dist import make_mesh, set_mesh, sharding as shd
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.launch import steps
from repro_torch.models import attention, transformer
from repro_torch.models.model import family, init_params
from repro_torch.optim import adamw

rank, world, store, out, cases = int(sys.argv[1]), int(sys.argv[2]), \\
    sys.argv[3], sys.argv[4], json.loads(sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=world)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


for tag, name, shape, changes, steps_n, table in cases:
    cfg = dataclasses.replace(get_config(name).reduced(), **changes)
    arr = np.load(f"{out}/{tag}_in.npz")
    mesh = make_mesh(tuple(shape), device="cpu")
    set_mesh(mesh)
    model = transformer.with_params(init_params(cfg, device="cpu"), {
        k[2:]: torch.from_numpy(arr[k]) for k in arr.files
        if k.startswith("p.")})
    toks = torch.from_numpy(arr["tokens"])
    labels = torch.from_numpy(arr["labels"])
    rows = steps.data_rows(mesh, {"tokens": toks, "labels": labels})
    res = {}
    # ---- layer 0's attention through small KV chunks, with gradients
    if "x" in arr.files:
        p0 = model.dense_layers[0].attn
        x = torch.from_numpy(arr["x"]).requires_grad_()
        with torch.enable_grad():
            y = attention.gqa_apply(
                p0, cfg, x, positions=torch.arange(x.shape[1],
                                                   dtype=torch.int32),
                impl="chunked", chunk=int(arr["chunk"]))
            grads = torch.autograd.grad(
                (y * torch.from_numpy(arr["ct"])).sum(),
                [x, p0.wq.w, p0.wk.w, p0.wv.w, p0.wo.w])
        res["chunked"] = y.detach().numpy()
        for k, g in zip(("x", "wq", "wk", "wv", "wo"), grads):
            res["chunked.d" + k] = g.numpy()
    # ---- serving: the rank's blocks, forward, prefill, decode
    params = steps.shard_serve_params(model, mesh)
    for n, p in params.named_parameters():
        res["blk." + n] = p.to_local().detach().numpy()
    with torch.no_grad():
        local = steps._serve_whole(params, mesh)
        res["forward"] = transformer.forward(
            local, cfg, {"tokens": rows["tokens"]})[0].numpy()
    res["prefill"] = steps.make_prefill_step(cfg, mesh=mesh)(
        params, {"tokens": toks}).float().numpy()
    cache_dt = torch.float32 if cfg.compute_dtype == "float32" \\
        else torch.bfloat16
    cache = family(cfg).init_cache(cfg, rows["tokens"].shape[0],
                                   toks.shape[1], dtype=cache_dt,
                                   device="cpu", mesh=mesh)
    res["cache_k_shape"] = np.array(cache["k"].shape)
    serve = steps.make_serve_step(cfg, mesh=mesh)
    for t in range(steps_n):
        logits, cache = serve(params, cache, toks[:, t:t + 1], t)
        res[f"step{t}"] = logits.float().numpy()
    # ---- the tied table's gradient on this rank's blocks
    if table:
        named = dict(model.named_parameters())
        split = shd.tp_blocks(named, cfg, mesh, mode="train")
        tp = tpar.plan(cfg, mesh)
        run = steps._with_blocks(model, {
            n: p.detach() if split[n] is None else
            tp.block(p.detach(), split[n]).clone()
            for n, p in named.items()}, requires_grad=True)
        with torch.enable_grad():
            loss, _ = transformer.loss_fn(run, cfg, rows)
            res["table_grad"] = torch.autograd.grad(
                loss, run.embed.table)[0].numpy()
    opt_cfg = adamw.AdamWConfig(total_steps=10)
    # ---- in bf16: the port's own unsharded step on the same draws, and
    # the same step in f32 as a control (BF16_STATE)
    if rank == 0 and cfg.compute_dtype != "float32":
        set_mesh(None)
        for key, c in (("own", cfg), ("f32", dataclasses.replace(
                cfg, compute_dtype="float32"))):
            new, _ = steps.make_train_step(c, opt_cfg)(
                {"params": model, "opt": adamw.init_state(model, opt_cfg)},
                {"tokens": toks, "labels": labels})
            for k, v in flat(convert.train_state_to_jax(new)).items():
                res[f"{key}/{k}"] = v
        set_mesh(mesh)
    # ---- one ZeRO + TP train step
    state = {"params": model, "opt": adamw.init_state(model, opt_cfg)}
    state = steps.shard_state(state, mesh,
                              steps.train_state_shardings(mesh, state))
    new, met = steps.make_train_step(cfg, opt_cfg, mesh=mesh)(
        state, {"tokens": toks, "labels": labels})
    for k, v in met.items():
        res["met." + k] = np.array(float(v))
    tree = flat(convert.train_state_to_jax(steps.gather_state(new, "cpu")))
    for k, v in tree.items():
        res["state/" + k] = v if rank == 0 else np.array(
            float(np.abs(v.astype(np.float64)).sum()))
    np.savez(f"{out}/{tag}_r{rank}.npz", **res)
    set_mesh(None)
dist.destroy_process_group()
"""

_REF_CODE = """
import contextlib, dataclasses, json, shutil, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.dist import context as dc, sharding as shd
from repro.launch import steps
from repro.launch.mesh import make_test_mesh
from repro.models import build_model
from repro.optim import adamw


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


def run(out, cases, sharded):
    def jit(fn, ins=None, outs=None):
        if not sharded:
            return jax.jit(fn)
        return jax.jit(fn, in_shardings=ins, out_shardings=outs)

    # unsharded, a case's serving results depend on its config alone and
    # its train step on the config and the data ranks: each is run once
    served, trained = {}, {}
    for tag, name, shape, changes, steps_n, table in cases:
        key = (name, json.dumps(changes, sort_keys=True))
        if not sharded and key + (shape[0],) in trained:
            shutil.copy(trained[key + (shape[0],)],
                        f"{out}/{tag}_whole.npz")
            continue
        cfg = dataclasses.replace(get_config(name).reduced(), **changes)
        arr = np.load(f"{out}/{tag}_in.npz")
        model = build_model(cfg)
        params = model.init(jax.random.key(1))
        toks, labels = jnp.asarray(arr["tokens"]), jnp.asarray(arr["labels"])
        b, s = toks.shape
        cache_dt = jnp.float32 if cfg.compute_dtype == "float32" \\
            else jnp.bfloat16
        opt_cfg = adamw.AdamWConfig(total_steps=10)
        state = {"params": params, "opt": adamw.init_state(params, opt_cfg)}
        cache = model.init_cache(b, s, dtype=cache_dt)
        psh = csh = bsh = ssh = repl = None
        mesh = make_test_mesh(tuple(shape)) if sharded else None
        res = {}
        with mesh or contextlib.nullcontext():
            if sharded:
                dc.set_mesh(mesh)
                psh = shd.param_shardings(mesh, params, mode="serve")
                bsh = steps._batch_spec(mesh, b, 2)
                csh = steps._cache_shardings(mesh, cache, b)
                ssh = steps.train_state_shardings(
                    mesh, jax.eval_shape(lambda x: x, state))
                repl = NamedSharding(mesh, P())
            # the forward, and the prefill step's last position of it
            if key in served:
                res.update(served[key])
            else:
                fwd = jit(lambda p, t: (lambda x: (x, x[:, -1]))(
                    model.forward(p, {"tokens": t})[0]), (psh, bsh))
                res["forward"], res["prefill"] = fwd(params, toks)
                serve = jit(steps.make_serve_step(cfg),
                            (psh, csh, bsh, repl), (bsh, csh))
                for t in range(steps_n):
                    logits, cache = serve(params, cache, toks[:, t:t + 1],
                                          jnp.int32(t))
                    res[f"step{t}"] = logits
                if not sharded:
                    served[key] = dict(res)
            batch = {"tokens": toks, "labels": labels}
            if sharded:
                train = jit(steps.make_train_step(cfg, opt_cfg), (ssh, None),
                            (ssh, None))
                new, met = train(state, batch)
            else:
                new, met = jax.jit(accumulated(model, cfg, opt_cfg, shape[0],
                                               table))(state, batch)
                if table:
                    res["table_grad"] = met.pop("table_grad")
            dc.set_mesh(None)
        for k, v in met.items():
            res["met." + k] = v
        for k, v in flat(jax.tree.map(np.asarray, new)).items():
            res["state/" + k] = v
        path = f"{out}/{tag}_{'sharded' if sharded else 'whole'}.npz"
        np.savez(path, **{k: np.asarray(v, dtype=np.float32)
                          if np.asarray(v).dtype == jnp.bfloat16
                          else np.asarray(v) for k, v in res.items()})
        trained[key + (shape[0],)] = path


def accumulated(model, cfg, opt_cfg, n, table):
    \"\"\"The unsharded counterpart of a step over n data ranks: the loss
    and gradients of each data block, averaged, then one update.\"\"\"
    vg = jax.value_and_grad(model.loss, has_aux=True)

    def step(state, batch):
        params = state["params"]
        b = batch["tokens"].shape[0]
        losses, grads, nlls, auxes = [], None, [], []
        for i in range(n):
            blk = {k: v[i * (b // n):(i + 1) * (b // n)]
                   for k, v in batch.items()}
            (loss, m), g = vg(params, blk)
            losses.append(loss)
            nlls.append(m["nll"])
            auxes.append(m["aux"])
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        grads = jax.tree.map(lambda g: g / n, grads)
        new_p, opt, om = adamw.apply_updates(params, grads, state["opt"],
                                             opt_cfg)
        met = {"loss": sum(losses) / n, "nll": sum(nlls) / n,
               "aux": sum(auxes) / n, **om}
        if table:
            met["table_grad"] = grads["embed"]["table"]
        return {"params": new_p, "opt": opt}, met
    return step


if __name__ == "__main__":
    run(sys.argv[1], json.loads(sys.argv[2]), sys.argv[3] == "sharded")
"""

_FLOPS_CODE = """
import json, sys
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_config
from repro_torch.core.distributed import axis_group
from repro_torch.dist import context as dc, make_mesh
from repro_torch.launch import dryrun
from repro_torch.optim import adamw

torch.set_num_threads(1)
out, shapes, sizes = sys.argv[1], json.loads(sys.argv[2]), \\
    json.loads(sys.argv[3])
cfg = get_config("minicpm-2b").reduced()
res = {}
for m in sizes:
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=m)
    mesh = make_mesh((1, m), device="cpu")
    dc.set_mesh(mesh)
    axis_group(mesh, dc._resolve(mesh, "dp"))
    for shape in shapes:
        rec = dryrun._trace_once(cfg, shape, mesh, adamw.AdamWConfig(),
                                 "cpu")
        res[f"{shape}/{m}"] = rec["flops"]
        res[f"{shape}/{m}/collectives"] = rec["collectives"]
    dc.set_mesh(None)
    dist.destroy_process_group()
json.dump(res, open(out, "w"))
"""

_REF_FLOPS_CODE = """
import json, sys
from repro.configs import get_config
from repro.launch import dryrun
from repro.launch.mesh import make_test_mesh
from repro.optim import adamw

out, sizes = sys.argv[1], json.loads(sys.argv[2])
cfg = get_config("minicpm-2b").reduced()
res = {}
for m in sizes:
    _, compiled = dryrun._compile_once(cfg, "train_4k",
                                       make_test_mesh((1, m)),
                                       adamw.AdamWConfig())
    res[str(m)] = dryrun._analyse(compiled)["flops"]
json.dump(res, open(out, "w"))
"""

FLOPS_SHAPES = ["train_4k", "decode_32k"]
FLOPS_SIZES = [1, 2, 4]


def _env(devices=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    if devices:
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_"
                            f"platform_device_count={devices}")
    return env


def _start(code, args, env):
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code),
                             *map(str, args)], env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)


def _wait(procs, timeout=PROC_TIMEOUT):
    deadline = time.monotonic() + timeout
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's inputs written, then all of it at once: the gloo ranks
    of world 2 and world 4, the reference's sharded and unsharded
    subprocesses, the port's dry-run traces and the reference's compiles.
    Returns the directory and the two flops records."""
    tmp = tmp_path_factory.mktemp("tp")
    procs = [_start(_FLOPS_CODE, [tmp / "flops.json",
                                  json.dumps(FLOPS_SHAPES),
                                  json.dumps(FLOPS_SIZES)], _env()),
             _start(_REF_FLOPS_CODE, [tmp / "ref_flops.json",
                                      json.dumps(FLOPS_SIZES)],
                    _env(devices=4))]
    by_world: dict = {}
    ref_cases = []
    for case in CASES:
        name, shape, cd, s = case
        cfg, _, _, model = lm.pair(name, cd, **_changes(name))
        rng = np.random.default_rng(11)
        chunked = {}
        if _tag(case) == CHUNKED_CASE:
            chunked = {k: rng.standard_normal((B, s, cfg.d_model)).astype(
                np.float32) for k in ("x", "ct")}
            chunked["chunk"] = np.array(CHUNK)
        np.savez(tmp / f"{_tag(case)}_in.npz",
                 tokens=rng.integers(0, cfg.vocab_size, (B, s)).astype(
                     np.int32),
                 labels=rng.integers(0, cfg.vocab_size, (B, s)).astype(
                     np.int32),
                 **{"p." + n: p.detach().numpy()
                    for n, p in model.named_parameters()}, **chunked)
        row = [_tag(case), name, list(shape),
               dict(_changes(name), compute_dtype=cd), DECODE_STEPS,
               _tag(case) == TABLE_CASE]
        by_world.setdefault(math.prod(shape), []).append(row)
        ref_cases.append(row)
    for world, cases in sorted(by_world.items()):
        procs += [_start(_RANK_CODE, [r, world, tmp / f"store{world}", tmp,
                                      json.dumps(cases)], _env())
                  for r in range(world)]
    sharded = [c for c in ref_cases if c[0] in SHARDED_REF]
    procs += [_start(_REF_CODE, [tmp, json.dumps(sharded[part::2]),
                                 "sharded"], _env(devices=4))
              for part in range(2)]
    try:
        # the unsharded reference here, meanwhile
        ref = {"__name__": "tp_reference"}
        exec(textwrap.dedent(_REF_CODE), ref)
        ref["run"](str(tmp), ref_cases, False)
    finally:
        _wait(procs)
    return (tmp, json.load(open(tmp / "flops.json")),
            json.load(open(tmp / "ref_flops.json")))


def _references(tmp, case):
    """The reference's unsharded results, and its sharded ones where the
    case is in ``SHARDED_REF``."""
    which = ["whole"] + (["sharded"] if _tag(case) in SHARDED_REF else [])
    return {w: _load(tmp, case, w) for w in which}


def _load(tmp, case, which):
    return dict(np.load(tmp / f"{_tag(case)}_{which}.npz"))


def _rows(shape, r, b=B):
    """The rows of the batch rank ``r`` of a (data, model) mesh runs."""
    n = b // shape[0]
    d = r // shape[1]
    return slice(d * n, (d + 1) * n)


def _tol(cd):
    return F32_TOL if cd == "float32" else BF16_TOL


@pytest.mark.parametrize("case", CASES, ids=[_tag(c) for c in CASES])
def test_logits_match_reference(runs, case):
    """Every rank's forward vocab block, prefill logits and decode logits
    against the reference's sharded and unsharded steps; the ranks of one
    data row block agree bit for bit (greedy tokens repeat)."""
    tmp = runs[0]
    _, shape, cd, _ = case
    m = shape[1]
    wants = list(_references(tmp, case).values())
    worst = 0.0
    for r in range(math.prod(shape)):
        got = _load(tmp, case, f"r{r}")
        rows = _rows(shape, r)
        vl = got["forward"].shape[-1]
        cols = slice((r % m) * vl, (r % m + 1) * vl)
        for want in wants:
            assert vl * m == want["forward"].shape[-1]
            err = lm.rel(got["forward"], want["forward"][rows][..., cols])
            assert err < _tol(cd), (r, "forward", err)
            for key in ["prefill"] + [f"step{t}"
                                      for t in range(DECODE_STEPS)]:
                err = lm.rel(got[key], want[key][rows])
                assert err < _tol(cd), (r, key, err)
                worst = max(worst, err)
        first = _load(tmp, case, f"r{r - r % m}")
        for key in ["prefill"] + [f"step{t}" for t in range(DECODE_STEPS)]:
            np.testing.assert_array_equal(got[key], first[key])
            np.testing.assert_array_equal(got[key].argmax(-1),
                                          first[key].argmax(-1))
    print(_tag(case), "worst logits rel", worst)


@pytest.mark.parametrize("case", CASES, ids=[_tag(c) for c in CASES])
def test_train_step_matches_reference(runs, case):
    """Loss, nll, aux, grad norm and the updated parameters, m and v of the
    ZeRO + TP step against the reference's sharded step and its unsharded
    counterpart; every rank's gathered state is rank 0's."""
    tmp = runs[0]
    _, shape, cd, _ = case
    tol = _tol(cd)
    got0 = _load(tmp, case, "r0")
    for r in range(1, math.prod(shape)):
        got = _load(tmp, case, f"r{r}")
        for k, v in got.items():
            if k.startswith("met."):
                assert float(v) == float(got0[k]), (r, k)
            elif k.startswith("state/"):
                assert float(v) == float(np.abs(got0[k].astype(
                    np.float64)).sum()), (r, k)
    for which, want in _references(tmp, case).items():
        for k in ("loss", "nll", "aux", "grad_norm", "lr"):
            g, w = float(got0["met." + k]), float(want["met." + k])
            assert abs(g - w) <= tol * max(abs(w), 1e-6), (which, k, g, w)
        keys = [k for k in want if k.startswith("state/")]
        assert {k for k in got0 if k.startswith("state/")} == set(keys)
        if cd != "float32":
            continue        # against the port's own step below
        lr = float(want["met.lr"])
        for k in _held(want, keys):
            if k.endswith("/wk/b"):
                _hold_noise_leaf(k, got0, want, lr, keys)
                continue
            if k.startswith("state/params/") and k.endswith("/b"):
                # zeros at init: the leaf is all update, held against lr
                d = np.abs(got0[k].astype(np.float64) - want[k]).max()
                assert d <= lm.PARAM_ATOL_LR * lr, (which, k, d, lr)
                continue
            err = lm.rel(got0[k], want[k])
            assert err <= tol, (which, k, err)
    if cd != "float32":
        _hold_bf16_state(got0)


def _held(want, keys):
    """The state's leaves but the step count and scalars held at zero."""
    return [k for k in keys if not (k.endswith("/step") or want[k].size == 1
                                    and float(want[k]) == 0.0)]


def _hold_bf16_state(got):
    """The bf16 ZeRO + TP step's updated parameters, m and v against the
    port's own unsharded bf16 step on the same draws, within
    ``BF16_STATE_TOL`` per leaf (``BF16_STATE``); the same unsharded step
    in f32, the control, is printed beside it."""
    keys = _held(got, [k for k in got if k.startswith("state/")])
    gap = {k: lm.rel(got[k], got["own/" + k[6:]]) for k in keys}
    control = {k: lm.rel(got["f32/" + k[6:]], got["own/" + k[6:]])
               for k in keys}
    worst = max(gap, key=gap.get)
    print(f"bf16 state: worst gap from the unsharded step {gap[worst]:.3e} "
          f"({worst}); f32 control's worst {max(control.values()):.3e}")
    assert gap[worst] <= BF16_STATE_TOL, (worst, gap[worst])


def _hold_noise_leaf(k, got, want, lr, keys):
    """The k projection's bias: the softmax cancels it (it adds ``q . b``
    to every score of a query), so its gradient is zero up to rounding,
    in either package, and AdamW normalises that noise.  Its parameter is
    held within a tenth of lr, as the Trainer tests hold every parameter,
    and its m and v, noise in both packages, within ``NOISE_SHARE`` of the
    state's largest m and v."""
    d = np.abs(got[k].astype(np.float64) - want[k]).max()
    kind = k.split("/")[2] if k.startswith("state/opt/") else "params"
    if kind == "params":
        assert d <= lm.PARAM_ATOL_LR * lr, (k, d, lr)
        return
    scale = max(np.abs(want[j]).max() for j in keys
                if j.startswith(f"state/opt/{kind}/"))
    assert d <= NOISE_SHARE * scale, (k, d, scale)


def _serve_mesh(shape, r):
    return PortMesh({"data": shape[0], "model": shape[1]},
                    {"data": r // shape[1], "model": r % shape[1]})


@pytest.mark.parametrize("case", CASES, ids=[_tag(c) for c in CASES])
def test_blocks_are_the_layouts(runs, case, monkeypatch):
    """Each serving rank holds ``tp_blocks``' blocks, cut as
    ``convert.tp_blocks_from_jax`` cuts the reference's parameters (the
    routed experts' E / m among them), whole attention weights in the
    ``"rows"`` layout, and a cache block of ``cache_specs``' shape."""
    monkeypatch.setattr(ref_steps, "NamedSharding", lambda mesh, spec: spec)
    tmp = runs[0]
    name, shape, cd, s = case
    cfg = _cfg(case)
    _, _, rp, model = lm.pair(name, cd, **_changes(name))
    tree = jax.tree.map(np.asarray, rp)
    named = dict(model.named_parameters())
    rows_layout = context.tp_layout(cfg, _serve_mesh(shape, 0), s) == "rows"
    rcfg = dataclasses.replace(ref_config(name).reduced(), compute_dtype=cd,
                               **_changes(name))
    rcache = jax.eval_shape(lambda: ref_build(rcfg).init_cache(B, s))["k"]
    spec = ref_steps._cache_shardings(
        RefMesh({"data": shape[0], "model": shape[1]}), {"k": rcache},
        B)["k"]
    for r in range(math.prod(shape)):
        mesh = _serve_mesh(shape, r)
        got = _load(tmp, case, f"r{r}")
        dims = sharding.tp_blocks(named, cfg, mesh)
        want = convert.tp_blocks_from_jax(cfg, tree, mesh)
        for n, p in named.items():
            blk = got["blk." + n]
            np.testing.assert_array_equal(blk, want[n].numpy(), err_msg=n)
            full = list(p.shape)
            if dims[n] is not None:
                full[dims[n]] //= shape[1]
            assert list(blk.shape) == full, n
            if rows_layout and ".attn." in n:
                assert dims[n] is None and list(blk.shape) == list(p.shape)
        block = [n // (shape[0] if ax == "data" else shape[1]
                       if ax == "model" else 1)
                 for n, ax in zip(rcache.shape, spec)]
        assert list(got["cache_k_shape"]) == block, (r, spec)


def test_rows_attention_chunked_matches_reference(runs):
    """Layer 0's attention in the ``"rows"`` layout through the online
    softmax over KV chunks of ``CHUNK`` (each rank's query rows offset by
    its block, the sliding window crossing the blocks): its output and
    the gradients of its input and four weights on each (1, 2) rank
    against ``jax.vjp`` of the reference's chunked path."""
    from repro.models import attention as ref_attn
    tmp = runs[0]
    case = next(c for c in CASES if _tag(c) == CHUNKED_CASE)
    name, shape, cd, s = case
    _, rm, rp, _ = lm.pair(name, cd, **_changes(name))
    arr = np.load(tmp / f"{CHUNKED_CASE}_in.npz")
    rp0 = jax.tree.map(lambda a: a[0], rp["dense_layers"]["attn"])
    pos = jax.numpy.arange(s, dtype=jax.numpy.int32)
    want, vjp = jax.vjp(lambda x, p: ref_attn.gqa_apply(
        p, rm.cfg, x, positions=pos, impl="chunked", chunk=CHUNK),
        jax.numpy.asarray(arr["x"]), rp0)
    dx, dp = vjp(jax.numpy.asarray(arr["ct"]))
    wants = {"chunked": want, "chunked.dx": dx,
             **{f"chunked.d{k}": dp[k]["w"] for k in ("wq", "wk", "wv",
                                                       "wo")}}
    assert context.tp_layout(_cfg(case), _serve_mesh(shape, 0), s) == "rows"
    for r in range(math.prod(shape)):
        got = _load(tmp, case, f"r{r}")
        for k, w in wants.items():
            err = lm.rel(got[k], w)
            assert err < F32_TOL, (r, k, err)


def test_tied_table_gradient_matches_reference(runs):
    """The tied table's gradient on each (1, 2) rank: the lookup's, the
    same on both ranks, once, plus the head's on every vocab row (each
    rank's rows gathered), against ``jax.value_and_grad`` of the
    unsharded reference."""
    tmp = runs[0]
    case = next(c for c in CASES if _tag(c) == TABLE_CASE)
    want = _load(tmp, case, "whole")["table_grad"]
    for r in range(2):
        got = _load(tmp, case, f"r{r}")["table_grad"]
        assert got.shape == want.shape
        assert lm.rel(got, want) < F32_TOL


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("shape", FLOPS_SHAPES)
def test_traced_flops_split_over_model(runs, shape, m):
    """minicpm-2b ``reduced()`` (4 KV heads: the ``"heads"`` layout): the
    dry run's traced flops per rank at (1, m) are 1/m of (1, 1)'s; the
    reference's ``cost_analysis`` ratio for the same train cells is
    printed beside them."""
    _, flops, ref = runs
    ratio = flops[f"{shape}/{m}"] / flops[f"{shape}/1"]
    assert abs(ratio * m - 1) < FLOPS_TOL, ratio
    colls = {op for op, _, g in flops[f"{shape}/{m}/collectives"] if g == m}
    assert "allreduce_" in colls and "allgather_" in colls, colls
    if shape == "train_4k":
        print(f"(1, {m}) train_4k flops per rank / (1, 1)'s: port "
              f"{ratio:.6f}, reference cost_analysis "
              f"{ref[str(m)] / ref['1']:.6f}")


# ------------------------------------------------------- shape arithmetic
TEST_MESHES = [{"data": 1, "model": 2}, {"data": 2, "model": 2},
               {"data": 1, "model": 4}, {"data": 16, "model": 16},
               {"pod": 2, "data": 16, "model": 16}]


def _mesh_id(sizes):
    return "x".join(str(v) for v in sizes.values())


def _ref_attn_branch(kvh, seq, tp) -> str:
    """The branch ``repro.models.attention._attn_constrain`` takes."""
    if kvh % tp == 0:
        return "heads"
    if seq % tp == 0:
        return "rows"
    return "whole"


@pytest.mark.parametrize("sizes", TEST_MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_layouts_are_the_reference_anchors(arch, sizes, monkeypatch):
    """``tp_layout`` takes ``_attn_constrain``'s branch for every shape's
    sequence and ``tp_cache_layout`` the dim ``cache_specs`` puts
    ``model`` on (the KV length too where the data axes take a batch-1
    cache's length and leave ``model`` off it), full width and
    ``reduced()``."""
    monkeypatch.setattr(ref_steps, "NamedSharding", lambda mesh, spec: spec)
    for cfg in (get_config(arch), get_config(arch).reduced()):
        mesh = PortMesh(sizes)
        tp = sizes["model"]
        for info in ref_steps.SHAPES.values():
            seq = 1 if info["kind"] == "decode" else info["seq"]
            assert context.tp_layout(cfg, mesh, seq) == _ref_attn_branch(
                cfg.num_kv_heads, seq, tp)
        for b, seq in ((128, 64), (1, 4096)):
            leaf = jax.ShapeDtypeStruct(
                (cfg.num_layers, b, seq, cfg.num_kv_heads, cfg.head_dim),
                jax.numpy.bfloat16)
            spec = tuple(ref_steps._cache_shardings(
                RefMesh(sizes), {"k": leaf}, b)["k"])
            on = spec.index("model") if "model" in spec else None
            # model off the cache only where the data axes took a batch-1
            # cache's length: the port holds its KV-length block there
            assert context.tp_cache_layout(cfg, mesh) == \
                {3: "heads", 4: "head_dim", 2: "length",
                 None: "length"}[on], spec


@pytest.mark.parametrize("sizes", TEST_MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_serving_block_bytes_are_the_reference_blocks(arch, sizes):
    """Wherever the port and the reference's serve mode both split a leaf
    over ``model``, a rank holds the same bytes of it; ``"rows"``
    attention weights are whole, and a leaf the reference splits over
    ``model`` only in the ``"heads"`` layout, the MLP and the vocab."""
    cfg = get_config(arch)
    model = transformer.init_params(cfg, device="meta")
    named = dict(model.named_parameters())
    dims = sharding.tp_blocks(named, cfg, PortMesh(sizes))
    ref = sharding.param_shardings(PortMesh(sizes), named, mode="serve")
    m = sizes["model"]
    both = 0
    for n, d in dims.items():
        if d is None:
            if ".attn.w" in n and "_layers" in n:
                assert cfg.num_kv_heads % m, n
            continue
        assert named[n].shape[d] % m == 0, n
        if any(ax == "model" for ax in ref[n]):
            both += 1       # the same 1/m of the leaf's bytes
    assert both > 0


def test_length_cache_layout_raises():
    """A mesh whose ``model`` axis neither the KV heads nor ``head_dim``
    divides reaches the reference's KV-length cache layout: nothing
    raises, and each rank holds its block of ``ceil(S / m)`` positions,
    also where the axis does not divide the length (the reference leaves
    ``model`` off such a cache)."""
    cfg = get_config("minicpm-2b").reduced()          # 4 KV heads, hd 32
    mesh = PortMesh({"data": 1, "model": 3})
    assert context.tp_cache_layout(cfg, mesh) == "length"
    assert transformer.init_cache(cfg, 2, 9, mesh=mesh, device="meta")[
        "k"].shape == (cfg.num_layers, 2, 3, 4, 32)
    assert transformer.init_cache(cfg, 2, 8, mesh=mesh, device="meta")[
        "k"].shape == (cfg.num_layers, 2, 3, 4, 32)
    assert context.tp_cache_layout(
        cfg, PortMesh({"data": 1, "model": 2})) == "heads"
