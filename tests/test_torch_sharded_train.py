"""The ZeRO-sharded train state (``repro_torch.launch.steps``' sharded
step, ``train_state_shardings``, the ``Trainer``'s mesh) against the JAX
package's, on the CPU: the counterparts of the reference's
``tests/test_distributed.py::test_sharded_train_step_matches_single_device``
and ``::test_elastic_reshard_roundtrip``, and the launcher's
``--mesh`` (``python -m torch.distributed.run ... --mesh test``).

dbrx ``reduced()`` in f32 with 8 experts (divisible by the model axis)
and ``capacity_factor`` 8.0 (no drops), the reference's test settings.
The reference's initial state (``model.init(key 0)``) is written as a
step-0 checkpoint that both packages read.  Eight gloo ranks (``python
-c`` subprocesses, the rendezvous a ``FileStore`` in the temporary
directory) take one sharded step on a (4, 2) ``("data", "model")`` mesh,
beside the reference's ``jax.jit(train_step, in_shardings=...)`` on
eight fake XLA devices in one more subprocess; both packages write the
state they reach as a checkpoint.  Held, with ``quantize_v`` none and
int8:

* loss, nll, aux and grad norm within 1e-5 of the reference's; the
  updated parameters, m, v and every ``v_scale`` within 1e-5 (max |d| /
  max |ref| per tensor), v_q's int8 codes within one code of the
  reference's (``CODE_STEP``: a v within rounding of a code's midpoint
  may round either way; named in ``test_torch_training.py``'s
  ``DIFFERENCES``);
* against the port's own single-device step, the reference test's 5e-3;
* the elastic restart: the (4, 2) state brought to the host (rank 0
  writes it) and put onto a (2, 2) mesh of a second group of four ranks
  by a ``Trainer`` restoring it: gathered there, it is bitwise the
  checkpoint.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANGES = dict(compute_dtype="float32", num_experts=8, capacity_factor=8.0)
BATCH = (4, 16)
QUANT = ("none", "int8")
TOL = 1e-5
# an int8 code of v may be the reference's neighbour: a v whose reordered
# reductions move it across a code's midpoint rounds the other way
CODE_STEP = 1
SINGLE_TOL = 5e-3           # the reference test's own bound
PROC_TIMEOUT = 300

_RANK_CODE = """
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.dist import set_mesh
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt

rank, store, out, changes = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
    json.loads(sys.argv[4])
torch.set_num_threads(1)
cfg = dataclasses.replace(get_config("dbrx_132b").reduced(), **changes)
batch = {k: torch.from_numpy(v) for k, v in np.load(f"{out}/batch.npz").items()}
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=8)
mesh = make_test_mesh((4, 2), device="cpu")
set_mesh(mesh)
for qv in ("none", "int8"):
    opt_cfg = adamw.AdamWConfig(total_steps=10, quantize_v=qv)
    like = convert.train_state_to_jax(steps.abstract_train_state(cfg, opt_cfg))
    _, host = ckpt.restore_latest(f"{out}/init_{qv}", like)
    state = convert.train_state_from_jax(cfg, host, device="cpu")
    sh = steps.train_state_shardings(mesh, state)
    state = steps.shard_state(state, mesh, sh)
    new, met = steps.make_train_step(cfg, opt_cfg, mesh=mesh)(state, batch)
    tree = convert.train_state_to_jax(steps.gather_state(new, "cpu"))
    ckpt.save(f"{out}/port_{qv}", 1, tree, mesh=mesh)
    if rank == 0:
        json.dump({k: float(v) for k, v in met.items()},
                  open(f"{out}/port_{qv}.json", "w"))
set_mesh(None)
dist.destroy_process_group()
"""

_RESHARD_CODE = """
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.dist import set_mesh
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.optim import adamw
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.checkpoint import _flatten

rank, store, out, changes = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
    json.loads(sys.argv[4])
torch.set_num_threads(1)
cfg = dataclasses.replace(get_config("dbrx_132b").reduced(), **changes)
opt_cfg = adamw.AdamWConfig(total_steps=10)
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=4)
mesh = make_test_mesh((2, 2), device="cpu")
set_mesh(mesh)
sh = steps.train_state_shardings(mesh, steps.abstract_train_state(cfg, opt_cfg))
tr = Trainer(TrainerConfig(total_steps=1, ckpt_dir=f"{out}/port_none"), cfg,
             opt_cfg, steps.make_train_step(cfg, opt_cfg, mesh=mesh),
             SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                    global_batch=4, seq_len=16)),
             device="cpu", mesh=mesh, state_shardings=sh)
assert tr.start_step == 1
blocks = {n: (p.to_local().shape, [getattr(q, "dim", None)
                                    for q in p.placements])
          for n, p in tr.state["params"].named_parameters()}
host = tr.state_to_host()
np.savez(f"{out}/reshard_r{rank}.npz",
         **{"/".join(map(str, k)): v for k, v in _flatten(host)})
if rank == 0:
    json.dump({n: [list(s), p] for n, (s, p) in blocks.items()},
              open(f"{out}/reshard_blocks.json", "w"))
set_mesh(None)
dist.destroy_process_group()
"""

_REF_CODE = """
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.dist import context as dist_context
from repro.launch import steps
from repro.launch.mesh import make_test_mesh
from repro.models import build_model
from repro.optim import adamw
from repro.train import checkpoint as ckpt

out, changes = sys.argv[1], json.loads(sys.argv[2])
cfg = dataclasses.replace(get_config("dbrx_132b").reduced(), **changes)
batch = {k: jnp.asarray(v) for k, v in np.load(f"{out}/batch.npz").items()}
model = build_model(cfg)
mesh = make_test_mesh((4, 2), ("data", "model"))
for qv in ("none", "int8"):
    opt_cfg = adamw.AdamWConfig(total_steps=10, quantize_v=qv)
    like = jax.eval_shape(lambda: {"params": model.init(jax.random.key(0)),
                                   "opt": adamw.init_state(model.init(
                                       jax.random.key(0)), opt_cfg)})
    _, host = ckpt.restore_latest(f"{out}/init_{qv}", like)
    state = jax.tree.map(jnp.asarray, host)
    with mesh:
        dist_context.set_mesh(mesh)
        state_sh = steps.train_state_shardings(
            mesh, jax.eval_shape(lambda s: s, state))
        sh_state = jax.tree.map(jax.device_put, state, state_sh)
        sh_step = jax.jit(steps.make_train_step(cfg, opt_cfg),
                          in_shardings=(state_sh, None),
                          out_shardings=(state_sh, None))
        new, met = sh_step(sh_state, batch)
        dist_context.set_mesh(None)
    ckpt.save(f"{out}/ref_{qv}", 1, jax.tree.map(np.asarray, new))
    json.dump({k: float(v) for k, v in met.items()},
              open(f"{out}/ref_{qv}.json", "w"))
"""


def _env(devices=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    if devices:
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_"
                            f"platform_device_count={devices}")
    return env


def _run_all(argvs, timeout=PROC_TIMEOUT):
    """Start every (argv, env) at once; wait for all within ``timeout`` s,
    kill whatever is left, and assert every exit code is 0."""
    deadline = time.monotonic() + timeout
    procs = [subprocess.Popen(a, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for a, e in argvs]
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[:3000]
    return [o for o, _ in outs]


def _cfg():
    return dataclasses.replace(get_config("dbrx_132b").reduced(), **CHANGES)


def _like(qv):
    opt_cfg = adamw.AdamWConfig(total_steps=10, quantize_v=qv)
    return convert.train_state_to_jax(steps.abstract_train_state(_cfg(),
                                                                 opt_cfg))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's initial states as step-0 checkpoints and a seeded
    batch; then the eight gloo ranks and the reference's subprocess side
    by side, then four ranks resharding the port's state."""
    out = tmp_path_factory.mktemp("zero")
    rcfg = dataclasses.replace(ref_config("dbrx_132b").reduced(), **CHANGES)
    params = ref_build(rcfg).init(jax.random.key(0))
    for qv in QUANT:
        opt_cfg = ref_adamw.AdamWConfig(total_steps=10, quantize_v=qv)
        state = {"params": params, "opt": ref_adamw.init_state(params,
                                                               opt_cfg)}
        ref_ckpt.save(str(out / f"init_{qv}"), 0,
                      jax.tree.map(np.asarray, state))
    rng = np.random.default_rng(0)
    np.savez(out / "batch.npz",
             tokens=rng.integers(0, rcfg.vocab_size, BATCH).astype(np.int32),
             labels=rng.integers(0, rcfg.vocab_size, BATCH).astype(np.int32))
    changes = json.dumps(CHANGES)
    _run_all([([sys.executable, "-c", textwrap.dedent(_RANK_CODE), str(r),
                str(out / "store8"), str(out), changes], _env())
              for r in range(8)] +
             [([sys.executable, "-c", textwrap.dedent(_REF_CODE), str(out),
                changes], _env(devices=8))])
    _run_all([([sys.executable, "-c", textwrap.dedent(_RESHARD_CODE), str(r),
                str(out / "store4"), str(out), changes], _env())
              for r in range(4)])
    return out


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(map(str, prefix)), np.asarray(tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


@pytest.mark.parametrize("qv", QUANT)
def test_sharded_step_matches_reference_sharded_step(runs, qv):
    port = json.loads((runs / f"port_{qv}.json").read_text())
    ref = json.loads((runs / f"ref_{qv}.json").read_text())
    for k in ("loss", "nll", "aux", "grad_norm", "lr"):
        assert abs(port[k] - ref[k]) <= TOL * abs(ref[k]), (k, port[k], ref[k])
    like = _like(qv)
    _, got = ckpt.restore_latest(str(runs / f"port_{qv}"), like)
    _, want = ref_ckpt.restore_latest(str(runs / f"ref_{qv}"), like)
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    worst = {}
    for path, w in want.items():
        kind = path.split("/")[1] if path.startswith("opt/") else "params"
        if kind == "v_q":
            continue                       # held dequantised, below
        err = _rel(got[path], w)
        worst[kind] = max(worst.get(kind, 0.0), err)
        assert err <= TOL, (path, err)
    flipped = 0
    if qv == "int8":
        for path in want:
            if path.startswith("opt/v_q/"):
                diff = np.abs(got[path].astype(np.int32) - want[path])
                assert diff.max() <= CODE_STEP, path
                flipped += int(np.count_nonzero(diff))
    print(qv, worst, "int8 codes one step off:", flipped)


@pytest.mark.parametrize("qv", QUANT)
def test_sharded_step_matches_single_device_step(runs, qv):
    """The port's sharded step against its own single-device step from
    the same state and batch: the reference test's 5e-3."""
    cfg = _cfg()
    opt_cfg = adamw.AdamWConfig(total_steps=10, quantize_v=qv)
    _, host = ckpt.restore_latest(str(runs / f"init_{qv}"), _like(qv))
    state = convert.train_state_from_jax(cfg, host, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in np.load(runs / "batch.npz").items()}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        new, met = steps.make_train_step(cfg, opt_cfg)(state, batch)
    finally:
        torch.set_num_threads(n)
    port = json.loads((runs / f"port_{qv}.json").read_text())
    assert abs(port["loss"] - float(met["loss"])) < SINGLE_TOL
    _, got = ckpt.restore_latest(str(runs / f"port_{qv}"), _like(qv))
    want = convert.train_state_to_jax(new)
    for path, w in _leaves(want["params"]):
        np.testing.assert_allclose(dict(_leaves(got["params"]))[path], w,
                                   rtol=SINGLE_TOL, atol=SINGLE_TOL)


def test_elastic_reshard_is_bitwise(runs):
    """The (4, 2) state through rank 0's checkpoint onto a (2, 2) mesh of
    four other ranks (a ``Trainer`` restoring it): every rank's gathered
    state is bitwise the checkpoint, and each parameter's block is the
    (2, 2) layout's."""
    _, host = ckpt.restore_latest(str(runs / "port_none"), _like("none"))
    want = dict(_leaves(host))
    for r in range(4):
        got = dict(np.load(runs / f"reshard_r{r}.npz"))
        assert set(got) == set(want)
        for path, w in want.items():
            np.testing.assert_array_equal(got[path], w, err_msg=path)
    blocks = json.loads((runs / "reshard_blocks.json").read_text())
    named = dict(steps.abstract_train_state(
        _cfg(), adamw.AdamWConfig())["params"].named_parameters())
    sharded = 0
    for n, (shape, place) in blocks.items():
        full = list(named[n].shape)
        if place[0] is not None:          # Shard(d) over data
            full[place[0]] //= 2
            sharded += 1
        assert shape == full and place[1] is None, n
    assert sharded > 0


# ------------------------------------------------------------ the launcher
def test_launcher_mesh_test_under_torch_distributed_run(tmp_path):
    """Eight gloo ranks on the host: ``--mesh test`` trains 2 steps,
    prints finite losses, and every rank's gathered final state has the
    same digest."""
    out = _run_all([([sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc-per-node", "8",
                      "-m", "repro_torch.launch.train", "--arch",
                      "dbrx-132b", "--reduced", "--mesh", "test",
                      "--steps", "2", "--device", "cpu", "--ckpt-dir",
                      str(tmp_path / "ckpt")], _env())])[0]
    digests = re.findall(r"rank (\d): final state sha256 ([0-9a-f]{64})",
                         out)
    assert sorted(int(r) for r, _ in digests) == list(range(8)), out
    assert len({d for _, d in digests}) == 1
    losses = [float(x) for x in re.findall(r"loss ([-0-9.e+]+|nan)", out)]
    assert losses and all(np.isfinite(losses)), out
    assert "final step 2" in out and "world 8" in out
    assert ckpt.list_steps(str(tmp_path / "ckpt")) == [2]
