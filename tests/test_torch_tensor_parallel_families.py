"""Tensor parallelism over ``model`` for every family beyond the dense, vlm
and GQA MoE ones (``tests/test_torch_tensor_parallel.py``): MLA, the SSD,
the hybrid's shared block with its per-site LoRA, the enc-dec, and the
KV-length decode cache, against the JAX package's GSPMD program on the
CPU.

All ``reduced()`` configs, in f32 unless named:

* deepseek-v2-236b at (1, 2) and (2, 2): MLA's heads, the absorbed decode
  over the latent and rope blocks, the leading dense MLP and the vocab,
  with the routed experts expert-parallel;
* mamba2-370m at (1, 2) and (1, 4) over two SSD chunks: the heads, the
  gated norm over every channel, the conv ring's channel blocks;
* zamba2-1.2b at (1, 2): two shared-block sites, their LoRA;
* seamless-m4t-large-v2 at (1, 2), in f32 and bf16: the encoder, the
  decoder, the cross-attention, the memory's cache blocks;
* the KV-length cache at (1, 3): minicpm-2b (4 KV heads, hd 32; also
  decoded over a whole cache on every rank), h2o-danube-3-4b over 48
  positions, whose window of 32 and decode positions cross the rank
  blocks of 16, and seamless-m4t-large-v2 over 16 positions (blocks of
  6, the last padded), whose memory of 4 positions the ranks hold as
  blocks of 2, 2 and none.

The ranks are gloo processes (``python -c`` subprocesses, each world's
rendezvous a ``FileStore`` in the temporary directory), with the harness
of ``tests/test_torch_tensor_parallel.py``; the reference runs its jitted
steps with ``set_mesh`` and its own ``param_shardings`` /
``cache_specs`` on fake XLA devices in one subprocess per world
(``SHARDED_REF``: one case per family), and its unsharded steps for every
case meanwhile, in two subprocesses (``UNSHARDED_APART``) and the test
process.  Held:

* each rank's forward logits (its vocab block), prefill logits, every
  decode step's logits, and the train step's loss, grad norm, updated
  parameters, m and v within 1e-5 (f32) of the reference's sharded and
  unsharded steps, 2e-2 in bf16 (the bf16 train state against the port's
  own unsharded bf16 step, as ``BF16_STATE`` there);
* each rank's blocks: the shapes ``tp_blocks`` gives, the values
  ``convert.tp_blocks_from_jax`` cuts from the reference's parameters, and
  every cache leaf the shape ``cache_specs`` gives its block;
* shape arithmetic for all ten configs, full width and ``reduced()``:
  ``plan`` splits each on a ``model`` axis above 1, ``tp_layout`` takes
  ``_attn_constrain``'s branch, and every cache leaf's block over
  ``model`` is the one ``cache_specs`` names.
"""
import ast
import dataclasses
import json
import math
import os
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import test_torch_tensor_parallel as tpt  # noqa: E402
import torch_lm_support as lm  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ASSIGNED  # noqa: E402
from repro_torch.dist import context, sharding  # noqa: E402
from repro_torch.dist import tensor_parallel as tpar  # noqa: E402
from repro_torch.models.model import family  # noqa: E402

REPO = tpt.REPO
# a memory of 4 positions: at (1, 3) the ranks hold blocks of 2, 2 and none
B, ENC = 4, 4
# (name, mesh, compute dtype, sequence, decode steps)
CASES = [("deepseek-v2-236b", (1, 2), "float32", 16, 3),
         ("deepseek-v2-236b", (2, 2), "float32", 16, 3),
         ("mamba2-370m", (1, 2), "float32", 32, 3),
         ("mamba2-370m", (1, 4), "float32", 32, 3),
         ("zamba2-1.2b", (1, 2), "float32", 32, 3),
         ("seamless-m4t-large-v2", (1, 2), "float32", 16, 3),
         ("seamless-m4t-large-v2", (1, 2), "bfloat16", 16, 3),
         ("minicpm-2b", (1, 3), "float32", 18, 18),
         ("h2o-danube-3-4b", (1, 3), "float32", 48, 48),
         ("seamless-m4t-large-v2", (1, 3), "float32", 16, 3)]
# the cases whose ranks decode over a whole cache too
WHOLE_CACHE = {"minicpm-2b_1x3_float32"}
# the cases the reference's sharded program runs too: one per family
SHARDED_REF = {"deepseek-v2-236b_2x2_float32", "mamba2-370m_1x4_float32",
               "zamba2-1.2b_1x2_float32",
               "seamless-m4t-large-v2_1x2_float32",
               "h2o-danube-3-4b_1x3_float32"}
# the configs whose unsharded reference runs in subprocesses, a set each
# (the others' in the test process)
UNSHARDED_APART = [{"mamba2-370m", "seamless-m4t-large-v2"},
                   {"zamba2-1.2b", "minicpm-2b"}]
ATTN_CACHES = ("k", "v", "attn_k", "attn_v", "mem_k", "mem_v")

# Where the port's layouts over model depart from the reference's on
# purpose: (port file, reference file, an identifier, the side whose
# source holds it and the other's does not, why)
DIFFERENCES = [
    ("src/repro_torch/models/transformer.py",
     "src/repro/models/transformer.py", "attention_cache", "port",
     "the KV-length cache block is ceil(S / m) positions on every rank, "
     "also where the reference's cache_specs leave model off the cache "
     "(the data axes took a batch-1 cache's length, or S does not divide "
     "the axis): the port keeps no sequence-parallel cache over the data "
     "axes, and a decode step reads its block's first position from the "
     "block's length alone"),
    ("src/repro_torch/models/attention.py", "src/repro/models/attention.py",
     "decode_attend", "port",
     "the decode over a KV-length cache block is flash-decoding as "
     "per-rank code: the softmax's max all-maxed and its sum all-reduced "
     "over model, each rank's f32 partial probs . v summed and then "
     "rounded, where GSPMD splits the reference's softmax over positions"),
    ("src/repro_torch/dist/tensor_parallel.py",
     "src/repro/dist/context.py", "reduce_sum", "port",
     "a sum over model that each rank consumes in its own per-rank code "
     "(the SSD's gated norm over its channels) all-reduces its gradient "
     "too; GSPMD derives that collective from the anchors"),
]


def _tag(case) -> str:
    name, shape, cd, _, _ = case
    return f"{name}_{shape[0]}x{shape[1]}_{cd}"


def _changes(name, cd) -> dict:
    cfg = get_config(name).reduced()
    out = {"compute_dtype": cd}
    if cfg.moe:
        # no drops: a data rank's capacity is over its own tokens
        out["capacity_factor"] = float(cfg.num_experts / cfg.top_k)
    return out


def _cfg(case):
    name, _, cd, _, _ = case
    return dataclasses.replace(get_config(name).reduced(),
                               **_changes(name, cd))


_RANK_CODE = """
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.dist import make_mesh, set_mesh
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.models.model import family, init_params
from repro_torch.optim import adamw

rank, world, store, out, cases = int(sys.argv[1]), int(sys.argv[2]), \\
    sys.argv[3], sys.argv[4], json.loads(sys.argv[5])
whole_cache = json.loads(sys.argv[6])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=world)


def flat(tree, prefix="", shapes=False):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else str(k),
                            shapes))
        return out
    return {prefix: np.array(tree.shape) if shapes else np.asarray(tree)}


for tag, name, shape, changes, steps_n, enc in cases:
    cfg = dataclasses.replace(get_config(name).reduced(), **changes)
    fam = family(cfg)
    arr = np.load(f"{out}/{tag}_in.npz")
    mesh = make_mesh(tuple(shape), device="cpu")
    set_mesh(mesh)
    model = transformer.with_params(init_params(cfg, device="cpu"), {
        k[2:]: torch.from_numpy(arr[k]) for k in arr.files
        if k.startswith("p.")})
    batch = {k: torch.from_numpy(arr[k]) for k in ("tokens", "labels",
                                                   "embeds")
             if k in arr.files}
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    rows = steps.data_rows(mesh, batch)
    res = {}
    # ---- serving: the rank's blocks, forward, prefill, decode
    params = steps.shard_serve_params(model, mesh)
    for n, p in params.named_parameters():
        res["blk." + n] = p.to_local().detach().float().numpy()
    cache_dt = torch.float32 if cfg.compute_dtype == "float32" \\
        else torch.bfloat16
    b = rows["tokens"].shape[0]
    s = batch["tokens"].shape[1]
    with torch.no_grad():
        local = steps._serve_whole(params, mesh)
        res["forward"] = fam.forward(local, cfg, {
            k: v for k, v in rows.items() if k != "labels"})[0].float(
            ).numpy()
        if cfg.is_encdec:
            cache = fam.init_cache(cfg, b, s, enc, dtype=cache_dt,
                                   device="cpu", mesh=mesh)
            cache = fam.prefill_memory(local, cfg, cache, rows["embeds"])
        else:
            cache = fam.init_cache(cfg, b, s, dtype=cache_dt, device="cpu",
                                   mesh=mesh)
    res["prefill"] = steps.make_prefill_step(cfg, mesh=mesh)(
        params, inputs).float().numpy()
    for k, v in flat(cache, shapes=True).items():
        res["cache_shape/" + k] = v
    serve = steps.make_serve_step(cfg, mesh=mesh)
    toks = batch["tokens"]
    for t in range(steps_n):
        logits, cache = serve(params, cache, toks[:, t:t + 1], t)
        res[f"step{t}"] = logits.float().numpy()
    if tag in whole_cache:
        cache = fam.init_cache(cfg, b, s, dtype=cache_dt, device="cpu")
        for t in range(steps_n):
            logits, cache = serve(params, cache, toks[:, t:t + 1], t)
            res[f"whole_cache{t}"] = logits.float().numpy()
    opt_cfg = adamw.AdamWConfig(total_steps=10)
    # ---- in bf16: the port's own unsharded step on the same draws
    if rank == 0 and cfg.compute_dtype != "float32":
        set_mesh(None)
        new, _ = steps.make_train_step(cfg, opt_cfg)(
            {"params": model, "opt": adamw.init_state(model, opt_cfg)},
            batch)
        for k, v in flat(convert.train_state_to_jax(new)).items():
            res["own/" + k] = v
        set_mesh(mesh)
    # ---- one ZeRO + TP train step
    state = {"params": model, "opt": adamw.init_state(model, opt_cfg)}
    state = steps.shard_state(state, mesh,
                              steps.train_state_shardings(mesh, state))
    new, met = steps.make_train_step(cfg, opt_cfg, mesh=mesh)(state, batch)
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
from repro.models import build_model, encdec
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

    # unsharded, a case's serving results depend on its config and inputs
    # alone and its train step on those and the data ranks: each is run
    # once
    served, trained = {}, {}
    for tag, name, shape, changes, steps_n, enc in cases:
        arr = np.load(f"{out}/{tag}_in.npz")
        key = (name, json.dumps(changes, sort_keys=True), enc,
               arr["tokens"].shape, steps_n)
        if not sharded and key + (shape[0],) in trained:
            shutil.copy(trained[key + (shape[0],)],
                        f"{out}/{tag}_whole.npz")
            continue
        cfg = dataclasses.replace(get_config(name).reduced(), **changes)
        model = build_model(cfg)
        params = model.init(jax.random.key(1))
        batch = {k: jnp.asarray(arr[k]) for k in ("tokens", "labels",
                                                   "embeds")
                 if k in arr.files}
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        b, s = batch["tokens"].shape
        cache_dt = jnp.float32 if cfg.compute_dtype == "float32" \\
            else jnp.bfloat16
        opt_cfg = adamw.AdamWConfig(total_steps=10)
        state = {"params": params, "opt": adamw.init_state(params, opt_cfg)}
        if cfg.is_encdec:
            cache = model.init_cache(b, s, enc_len=enc, dtype=cache_dt)
        else:
            cache = model.init_cache(b, s, dtype=cache_dt)
        psh = csh = ish = ssh = repl = None
        mesh = make_test_mesh(tuple(shape)) if sharded else None
        res = {}
        with mesh or contextlib.nullcontext():
            if sharded:
                dc.set_mesh(mesh)
                psh = shd.param_shardings(mesh, params, mode="serve")
                ish = {k: steps._batch_spec(mesh, b, v.ndim)
                       for k, v in inputs.items()}
                csh = steps._cache_shardings(mesh, cache, b)
                ssh = steps.train_state_shardings(
                    mesh, jax.eval_shape(lambda x: x, state))
                repl = NamedSharding(mesh, P())
            if key in served:
                res.update(served[key])
            else:
                fwd = jit(lambda p, x: (lambda y: (y, y[:, -1]))(
                    model.forward(p, x)[0]), (psh, ish))
                res["forward"], res["prefill"] = fwd(params, inputs)
                if cfg.is_encdec:
                    cache = jit(lambda p, c, e: encdec.prefill_memory(
                        p, cfg, c, e), (psh, csh, ish and ish["embeds"]),
                        csh)(params, cache, batch["embeds"])
                serve = jit(steps.make_serve_step(cfg),
                            (psh, csh, ish and ish["tokens"], repl),
                            (ish and ish["tokens"], csh))
                for t in range(steps_n):
                    logits, cache = serve(params, cache,
                                          batch["tokens"][:, t:t + 1],
                                          jnp.int32(t))
                    res[f"step{t}"] = logits
                if not sharded:
                    served[key] = dict(res)
            if sharded:
                train = jit(steps.make_train_step(cfg, opt_cfg), (ssh, None),
                            (ssh, None))
                new, met = train(state, batch)
            else:
                new, met = jax.jit(accumulated(model, opt_cfg, shape[0]))(
                    state, batch)
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


def accumulated(model, opt_cfg, n):
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
        return {"params": new_p, "opt": opt}, met
    return step


if __name__ == "__main__":
    run(sys.argv[1], json.loads(sys.argv[2]), sys.argv[3] == "sharded")
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: small CPU shapes run faster so, and the test
    workers do not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's inputs written, then all of it at once: the gloo ranks
    of worlds 2, 3 and 4 and the reference's sharded subprocesses, its
    unsharded steps in the test process meanwhile.  Returns the
    directory."""
    tmp = tmp_path_factory.mktemp("tpf")
    by_world: dict = {}
    rows = []
    for case in CASES:
        name, shape, cd, s, steps_n = case
        cfg, _, _, model = lm.pair(name, cd, **{
            k: v for k, v in _changes(name, cd).items()
            if k != "compute_dtype"})
        rng = np.random.default_rng(13)
        extra = {}
        if cfg.is_encdec:
            extra["embeds"] = rng.standard_normal(
                (B, ENC, cfg.frontend_dim)).astype(np.float32)
        np.savez(tmp / f"{_tag(case)}_in.npz",
                 tokens=rng.integers(0, cfg.vocab_size, (B, s)).astype(
                     np.int32),
                 labels=rng.integers(0, cfg.vocab_size, (B, s)).astype(
                     np.int32),
                 **{"p." + n: p.detach().numpy()
                    for n, p in model.named_parameters()}, **extra)
        row = [_tag(case), name, list(shape), _changes(name, cd), steps_n,
               ENC]
        by_world.setdefault(math.prod(shape), []).append(row)
        rows.append(row)
    # the unsharded reference in three parts, each config's cases in one
    # (its serving results are run once): two in subprocesses
    apart = [[r for r in rows if r[1] in names]
             for names in UNSHARDED_APART]
    procs = [tpt._start(_REF_CODE, [tmp, json.dumps(part), "whole"],
                        tpt._env()) for part in apart]
    for world, cases in sorted(by_world.items()):
        procs += [tpt._start(_RANK_CODE, [r, world, tmp / f"store{world}",
                                          tmp, json.dumps(cases),
                                          json.dumps(sorted(WHOLE_CACHE))],
                             tpt._env()) for r in range(world)]
        sharded = [c for c in cases if c[0] in SHARDED_REF]
        if sharded:
            procs.append(tpt._start(_REF_CODE, [tmp, json.dumps(sharded),
                                                "sharded"],
                                    tpt._env(devices=world)))
    try:
        ref = {"__name__": "tpf_reference"}
        exec(textwrap.dedent(_REF_CODE), ref)
        ref["run"](str(tmp), [r for r in rows
                              if all(r not in part for part in apart)],
                   False)
    finally:
        tpt._wait(procs)
    return tmp


def _references(tmp, case):
    which = ["whole"] + (["sharded"] if _tag(case) in SHARDED_REF else [])
    return {w: dict(np.load(tmp / f"{_tag(case)}_{w}.npz")) for w in which}


def _load(tmp, case, which):
    return dict(np.load(tmp / f"{_tag(case)}_{which}.npz"))


@pytest.mark.parametrize("case", CASES, ids=[_tag(c) for c in CASES])
def test_logits_match_reference(runs, case):
    """Every rank's forward vocab block, prefill logits and every decode
    step's logits against the reference's sharded and unsharded steps
    (``WHOLE_CACHE``: also the steps over a whole cache on every rank);
    the ranks of one data row block agree bit for bit."""
    _, shape, cd, _, steps_n = case
    m = shape[1]
    tol = tpt._tol(cd)
    wants = list(_references(runs, case).values())
    keys = ["prefill"] + [f"step{t}" for t in range(steps_n)]
    worst = 0.0
    for r in range(math.prod(shape)):
        got = _load(runs, case, f"r{r}")
        rows = tpt._rows(shape, r)
        vl = got["forward"].shape[-1]
        whole = vl == wants[0]["forward"].shape[-1]      # vocab unsplit
        cols = slice(None) if whole else slice((r % m) * vl,
                                               (r % m + 1) * vl)
        for want in wants:
            assert whole or vl * m == want["forward"].shape[-1]
            err = lm.rel(got["forward"], want["forward"][rows][..., cols])
            assert err < tol, (r, "forward", err)
            for key in keys:
                err = lm.rel(got[key], want[key][rows])
                assert err < tol, (r, key, err)
                worst = max(worst, err)
            for t in range(steps_n if _tag(case) in WHOLE_CACHE else 0):
                err = lm.rel(got[f"whole_cache{t}"], want[f"step{t}"][rows])
                assert err < tol, (r, "whole cache", t, err)
        first = _load(runs, case, f"r{r - r % m}")
        for key in keys:
            np.testing.assert_array_equal(got[key], first[key])
    print(_tag(case), "worst logits rel", worst)


@pytest.mark.parametrize("case", CASES, ids=[_tag(c) for c in CASES])
def test_train_step_matches_reference(runs, case):
    """Loss, nll, aux, grad norm and the updated parameters, m and v of the
    ZeRO + TP step against the reference's sharded step and its unsharded
    counterpart (bf16: the state against the port's own unsharded step);
    every rank's gathered state is rank 0's."""
    _, shape, cd, _, _ = case
    tol = tpt._tol(cd)
    got0 = _load(runs, case, "r0")
    for r in range(1, math.prod(shape)):
        got = _load(runs, case, f"r{r}")
        for k, v in got.items():
            if k.startswith("met."):
                assert float(v) == float(got0[k]), (r, k)
            elif k.startswith("state/"):
                assert float(v) == float(np.abs(got0[k].astype(
                    np.float64)).sum()), (r, k)
    for which, want in _references(runs, case).items():
        for k in ("loss", "nll", "aux", "grad_norm", "lr"):
            g, w = float(got0["met." + k]), float(want["met." + k])
            assert abs(g - w) <= tol * max(abs(w), 1e-6), (which, k, g, w)
        keys = [k for k in want if k.startswith("state/")]
        assert {k for k in got0 if k.startswith("state/")} == set(keys)
        if cd != "float32":
            continue
        lr = float(want["met.lr"])
        zeros = _zero_leaves(runs, case)
        for k in tpt._held(want, keys):
            if not np.abs(want[k]).max():
                # a moment whose gradient is exactly zero (each site's
                # LoRA a, b being zeros at init) is zero in both
                assert not np.abs(got0[k]).max(), (which, k)
                continue
            if k[len("state/params/"):] in zeros:
                # zeros at init (the SSD's A_log, dt_bias and conv bias,
                # the sites' LoRA b): the leaf is all update, held
                # against lr as the Trainer tests hold it
                d = np.abs(got0[k].astype(np.float64) - want[k]).max()
                assert d <= lm.PARAM_ATOL_LR * lr, (which, k, d, lr)
                continue
            err = lm.rel(got0[k], want[k])
            assert err <= tol, (which, k, err)
    if cd != "float32":
        keys = tpt._held(got0, [k for k in got0 if k.startswith("state/")])
        gap = {k: lm.rel(got0[k], got0["own/" + k[6:]]) for k in keys}
        worst = max(gap, key=gap.get)
        assert gap[worst] <= tpt.BF16_STATE_TOL, (worst, gap[worst])


def _zero_leaves(tmp, case) -> set:
    """The reference leaf paths (``a/b/c``) whose parameters are zeros at
    init."""
    arr = np.load(tmp / f"{_tag(case)}_in.npz")
    return {"/".join(p for p in k[2:].split(".") if not p.isdigit())
            for k in arr.files if k.startswith("p.") and
            not np.abs(arr[k]).max()}


def _ref_cache(rcfg, b, s, enc=ENC):
    """The reference's decode cache of ``rcfg`` as shapes."""
    model = ref_build(rcfg)
    if rcfg.is_encdec:
        return jax.eval_shape(lambda: model.init_cache(b, s, enc_len=enc))
    return jax.eval_shape(lambda: model.init_cache(b, s))


def _block(shape, spec, sizes):
    """A leaf's block under ``spec`` on a mesh of ``sizes``."""
    out = []
    for n, ax in zip(shape, spec):
        axes = () if ax is None else (ax,) if isinstance(ax, str) else ax
        out.append(n // math.prod(sizes[a] for a in axes))
    return out


@pytest.mark.parametrize("case", CASES, ids=[_tag(c) for c in CASES])
def test_blocks_are_the_layouts(runs, case, monkeypatch):
    """Each serving rank holds ``tp_blocks``' blocks, cut as
    ``convert.tp_blocks_from_jax`` cuts the reference's parameters (the
    routed experts' E / m among them), and every cache leaf's block of
    the shape ``cache_specs`` gives (``ceil(S / m)`` positions in the
    KV-length layout where the reference leaves ``model`` off the cache,
    of which the memory holds the ones its length reaches)."""
    monkeypatch.setattr(ref_steps, "NamedSharding", lambda mesh, spec: spec)
    name, shape, cd, s, _ = case
    cfg = _cfg(case)
    _, _, rp, model = lm.pair(name, cd, **{
        k: v for k, v in _changes(name, cd).items() if k != "compute_dtype"})
    tree = jax.tree.map(np.asarray, rp)
    named = dict(model.named_parameters())
    sizes = {"data": shape[0], "model": shape[1]}
    rcache = _ref_cache(dataclasses.replace(ref_config(name).reduced(),
                                            **_changes(name, cd)), B, s)
    specs = lm.leaves(ref_steps._cache_shardings(tpt.RefMesh(sizes),
                                                 rcache, B))
    ref_shapes = lm.leaves(rcache)
    for r in range(math.prod(shape)):
        mesh = tpt._serve_mesh(shape, r)
        got = _load(runs, case, f"r{r}")
        dims = sharding.tp_blocks(named, cfg, mesh)
        want = convert.tp_blocks_from_jax(cfg, tree, mesh)
        for n, p in named.items():
            blk = got["blk." + n]
            np.testing.assert_array_equal(blk, want[n].float().numpy(),
                                          err_msg=n)
            full = list(p.shape)
            if dims[n] is not None:
                full[dims[n]] //= shape[1]
            assert list(blk.shape) == full, n
        for k, spec in specs.items():
            got_shape = list(got["cache_shape/" + k.replace(".", "/")])
            want = _block(ref_shapes[k].shape, spec, sizes)
            if "model" not in spec and cfg.attention != "none" and \
                    tpar.plan(cfg, mesh).cache == "length" and \
                    k.split(".")[-1] in ATTN_CACHES:
                n, c = want[2], -(-want[2] // shape[1])
                lo = (r % shape[1]) * c
                want[2] = max(0, min(c, n - lo)) if k.startswith("mem_") \
                    else c
            assert got_shape == want, (r, k, spec)


def _attn_heads(cfg) -> int:
    """The head count ``_attn_constrain`` reads: KV heads, MLA's heads."""
    return cfg.num_heads if cfg.attention == "mla" else cfg.num_kv_heads


@pytest.mark.parametrize("sizes", tpt.TEST_MESHES, ids=tpt._mesh_id)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_every_config_splits(arch, sizes, monkeypatch):
    """``plan`` splits each config on a ``model`` axis above 1;
    ``tp_layout`` takes ``_attn_constrain``'s branch for every shape's
    sequence (``"whole"`` without attention); every leaf of the decode
    cache that ``init_cache(mesh=)`` gives is the block ``cache_specs``
    names over ``model`` (the KV length's block too where the data axes
    took a batch-1 cache's length), full width and ``reduced()``."""
    monkeypatch.setattr(ref_steps, "NamedSharding", lambda mesh, spec: spec)
    m = sizes["model"]
    for cfg, rcfg in ((get_config(arch), ref_config(arch)),
                      (get_config(arch).reduced(),
                       ref_config(arch).reduced())):
        mesh = tpt.PortMesh(sizes)
        tp = tpar.plan(cfg, mesh)
        assert tp is not None and tp.size == m
        for info in ref_steps.SHAPES.values():
            seq = 1 if info["kind"] == "decode" else info["seq"]
            want = "whole" if cfg.attention == "none" else \
                tpt._ref_attn_branch(_attn_heads(cfg), seq, m)
            assert context.tp_layout(cfg, mesh, seq) == want
        for b, seq in ((128, 64), (1, 4096)):
            ref = _ref_cache(rcfg, b, seq, enc=64)
            specs = lm.leaves(ref_steps._cache_shardings(
                tpt.RefMesh(sizes), ref, b))
            if cfg.is_encdec:
                port = family(cfg).init_cache(cfg, b, seq, 64, device="meta",
                                              mesh=mesh)
            else:
                port = family(cfg).init_cache(cfg, b, seq, device="meta",
                                              mesh=mesh)
            port = {k: tuple(v.shape) for k, v in lm.leaves(port).items()}
            assert set(port) == set(specs)
            for k, spec in specs.items():
                want = [n // m if "model" in (ax if isinstance(ax, tuple)
                                              else (ax,)) else n
                        for n, ax in zip(lm.leaves(ref)[k].shape, spec)]
                if "model" not in spec and tp.cache == "length" and \
                        k.split(".")[-1] in ATTN_CACHES:
                    want[2] = -(-want[2] // m)
                assert list(port[k]) == want, (cfg.name, k, spec)


def test_serving_blocks_are_a_share_of_the_model():
    """On a (1, m) mesh a serving rank's split leaves hold 1/m of their
    bytes, and every config splits some leaf, deepseek-v2-236b's
    ``wuk``/``wuv`` whole (design (a)) and its ``wuq`` by heads."""
    from repro_torch.models.model import init_params
    mesh = tpt.PortMesh({"data": 1, "model": 16})
    for arch in ASSIGNED:
        cfg = get_config(arch)
        named = dict(init_params(cfg, device="meta").named_parameters())
        dims = sharding.tp_blocks(named, cfg, mesh)
        assert any(d is not None for d in dims.values()), arch
        for n, d in dims.items():
            if d is not None:
                assert named[n].shape[d] % 16 == 0, n
        if cfg.attention == "mla":
            train = sharding.tp_blocks(named, cfg, mesh, mode="train")
            for n in named:
                if ".attn.wuk" in n or ".attn.wuv" in n:
                    assert dims[n] is None and train[n] == 1, n
                if n.endswith("attn.wuq.w"):
                    assert dims[n] == 1, n


def test_length_cache_position_past_the_blocks_raises():
    """A decode position that no rank's KV-length block reaches (a cache
    too short for it) raises, before any collective, where no rank would
    write it."""
    from repro_torch.models import attention, transformer
    from repro_torch.models.model import init_params
    cfg = get_config("minicpm-2b").reduced()
    lp = init_params(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0)).dense_layers[0]
    mesh = tpt.PortMesh({"data": 1, "model": 3}, {"data": 0, "model": 0})
    cache = transformer.init_cache(cfg, 1, 7, torch.float32, device="cpu",
                                   mesh=mesh)
    assert cache["k"].shape[2] == 3
    x = torch.ones((1, 1, cfg.d_model))
    context.set_mesh(mesh)
    try:
        with pytest.raises(ValueError, match="past 3 blocks of 3"):
            attention.gqa_decode(lp.attn, cfg, x, cache["k"][0],
                                 cache["v"][0], 9)
    finally:
        context.set_mesh(None)


def _identifiers(path) -> set:
    out = set()
    for node in ast.walk(ast.parse(open(path).read())):
        for attr in ("id", "attr", "arg", "name"):
            value = getattr(node, attr, None)
            if isinstance(value, str):
                out.add(value)
    return out


@pytest.mark.parametrize("port,ref,name,where,why", DIFFERENCES,
                         ids=[f"{p.split('/')[-1]}:{n}"
                              for p, _, n, _, _ in DIFFERENCES])
def test_each_difference_is_in_one_source_only(port, ref, name, where, why):
    ids = {"port": _identifiers(os.path.join(REPO, port)),
           "reference": _identifiers(os.path.join(REPO, ref))}
    other = "reference" if where == "port" else "port"
    assert name in ids[where] and name not in ids[other], (name, why)
