"""The port's training substrate (``repro_torch.data``, ``.train``, the
train state's conversion, the entry points) on the CPU, against the JAX
package's where both run:

* the data pipeline's copy is the reference's code statement for
  statement and gives bitwise its batches;
* the port's twin of each test of ``tests/test_trainer.py``
  (checkpoint roundtrip, interrupted save, resume continues, resume
  exact — here bit for bit —, NaN guard, async save, data sharding);
* checkpoints across packages both ways, with equal manifests, also of
  the hybrid whose ``group_layers`` stack on two axes;
* the Trainer against the reference's: both start from the reference's
  fresh state, saved as a step-0 checkpoint, and run 10 steps of
  minicpm's ``reduced()`` config on the same batches; the losses and the
  final parameters within the bounds stated below;
* ``python -m repro_torch.examples.train_lm`` and
  ``python -m repro_torch.launch.train`` on the CPU.
"""
import ast
import contextlib
import dataclasses
import io
import json
import os
import shutil
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.data import prefetch as ref_prefetch  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.train import Trainer as RefTrainer  # noqa: E402
from repro.train import TrainerConfig as RefTrainerConfig  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 params_to_jax, train_state_from_jax,
                                 train_state_to_jax)
from repro_torch.data import DataConfig, SyntheticLM, prefetch  # noqa: E402
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.trainer import put_batch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the Trainer against the reference over 10 steps of the reduced minicpm
# in f32 and in the config's bf16 compute: AdamW normalises each
# gradient element, so where a
# gradient sits at the noise floor of the two packages' summation orders
# its step differs, by up to about 2 lr a step.  In f32 compute the
# losses within 1e-5 relative and every parameter within a tenth of lr
# (measured 0.005 lr); in the config's bf16 compute the losses within
# the bf16 logits tolerance of the forward tests and each leaf's
# difference within a tenth of how far it moved in the 10 steps, in the
# Frobenius norm (measured 1.4e-2; its largest element 4.5 lr)
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PARAM_ATOL_LR = 0.1
PARAM_FRO_MOVED = 0.1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's small CPU steps: they run
    faster so, and the test workers' thread pools do not oversubscribe
    the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ data
def _code(path: Path, pkg: str) -> str:
    """The module's AST without docstrings, ``pkg`` imports renamed."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[0] == pkg:
            node.module = "PKG" + node.module[len(pkg):]
    return ast.dump(tree)


@pytest.mark.parametrize("module", ["data/pipeline.py", "data/__init__.py"])
def test_data_copy_is_the_reference_code(module):
    port = ROOT / "src" / "repro_torch" / module
    ref = ROOT / "src" / "repro" / module
    assert _code(port, "repro_torch") == _code(ref, "repro")


def test_data_copy_check_sees_a_changed_statement(tmp_path):
    ref = ROOT / "src" / "repro" / "data" / "pipeline.py"
    bad = tmp_path / "pipeline.py"
    bad.write_text(ref.read_text().replace("zipf(1.2", "zipf(1.3"))
    assert _code(bad, "repro") != _code(ref, "repro")


@pytest.mark.parametrize("kw", [
    dict(vocab_size=512, global_batch=8, seq_len=16, seed=3),
    dict(vocab_size=122_753, global_batch=2, seq_len=64),
    dict(vocab_size=512, global_batch=4, seq_len=8, input_mode="embeddings",
         frontend_dim=12),
    dict(vocab_size=300, global_batch=4, seq_len=8, input_mode="embeddings",
         frontend_dim=6, encdec=True)])
def test_batches_bitwise_equal_reference(kw):
    for hosts in (1, 2):
        for h in range(hosts):
            a = SyntheticLM(DataConfig(**kw), host_id=h, num_hosts=hosts)
            b = RefSyntheticLM(RefDataConfig(**kw), host_id=h,
                               num_hosts=hosts)
            for step in (0, 1, 7, 1000):
                x, y = a.batch_at(step), b.batch_at(step)
                assert x.keys() == y.keys()
                for k in x:
                    assert x[k].dtype == y[k].dtype
                    assert np.array_equal(x[k], y[k])


def test_prefetch_puts_batches_on_the_device():
    data = SyntheticLM(DataConfig(vocab_size=100, global_batch=2, seq_len=8))
    got = prefetch(iter(data), 2, put_fn=lambda b: put_batch(b, "cpu"))
    for step, batch in zip(range(5), got):
        want = data.batch_at(step)
        assert all(isinstance(t, torch.Tensor) for t in batch.values())
        assert all(np.array_equal(batch[k].numpy(), want[k]) for k in want)


@pytest.mark.parametrize("n,depth", [(0, 2), (1, 2), (2, 2), (5, 2),
                                     (5, 1), (3, 4)])
def test_prefetch_of_a_finite_stream_is_the_reference_s(n, depth):
    """On a finite stream the copy yields what the reference yields: both
    drop the item popped when the stream ends (ROADMAP queue 3)."""
    got = list(prefetch(iter(range(n)), depth))
    want = list(ref_prefetch(iter(range(n)), depth))
    assert got == want


# ------------------------------------------------- tests/test_trainer.py
@pytest.fixture
def tiny(tmp_path):
    cfg = get_config("minicpm_2b").reduced()
    opt_cfg = adamw.AdamWConfig(total_steps=30, peak_lr=1e-3, warmup=3)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, global_batch=4,
                                  seq_len=16))
    return cfg, opt_cfg, data, str(tmp_path / "ckpt")


def _trainer(tc, cfg, opt_cfg, data, step=None, **kw):
    return Trainer(tc, cfg, opt_cfg, step or steps.make_train_step(cfg,
                                                                   opt_cfg),
                   data, device="cpu", **kw)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": {"b": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "step": np.int32(7)}
    d = str(tmp_path)
    ckpt.save(d, 5, tree)
    assert ckpt.list_steps(d) == [5]
    like = {"a": {"b": np.zeros((2, 3), np.float32)},
            "step": np.zeros((), np.int32)}
    s, back = ckpt.restore_latest(d, like)
    assert s == 5
    np.testing.assert_array_equal(back["a"]["b"], tree["a"]["b"])
    assert back["step"] == 7
    with pytest.raises(ValueError, match="a__b"):
        ckpt.restore(d, 5, {"a": {"b": np.zeros((3, 2))}, "step": 0})


def test_interrupted_save_never_corrupts(tmp_path):
    d = str(tmp_path)
    tree = {"x": np.ones((4,), np.float32)}
    ckpt.save(d, 1, tree)
    # simulate a crash mid-save of step 2: stray .tmp directory
    os.makedirs(os.path.join(d, "step_2.tmp"))
    s, back = ckpt.restore_latest(d, {"x": np.zeros((4,), np.float32)})
    assert s == 1                        # incomplete step 2 is invisible


def test_async_snapshot_is_a_copy(tmp_path):
    """An async save writes the state as it was when saved, though the
    caller's arrays (here views of CPU tensors) change under it."""
    t = torch.arange(1 << 20, dtype=torch.float32)
    thread = ckpt.save(str(tmp_path), 1, {"t": t.numpy()}, blocking=False)
    t.add_(1.0)                          # an in-place step
    thread.join(timeout=60)
    assert not thread.is_alive()
    _, back = ckpt.restore_latest(str(tmp_path), {"t": t})
    assert np.array_equal(back["t"], np.arange(1 << 20, dtype=np.float32))


def test_keep_collects_old_steps(tmp_path):
    for s in range(1, 6):
        ckpt.save(str(tmp_path), s, {"x": np.zeros(2)}, keep=2)
    assert ckpt.list_steps(str(tmp_path)) == [4, 5]


def test_resume_continues_training(tiny):
    cfg, opt_cfg, data, d = tiny
    tc = TrainerConfig(total_steps=10, ckpt_dir=d, ckpt_every=5,
                       log_every=2, ckpt_async=False)
    out1 = _trainer(tc, cfg, opt_cfg, data).run()
    tc2 = TrainerConfig(total_steps=16, ckpt_dir=d, ckpt_every=8,
                        log_every=2, ckpt_async=False)
    tr2 = _trainer(tc2, cfg, opt_cfg, data)
    assert tr2.start_step == 10
    out2 = tr2.run()
    assert out2["final_step"] == 16
    assert out2["history"][-1]["loss"] < out1["history"][0]["loss"]


def test_resume_bit_exact(tiny):
    """Uninterrupted 8 steps == 4 steps + restart + 4 steps: on the CPU
    the whole state is bitwise equal (the reference's test holds the
    table within 1e-6)."""
    cfg, opt_cfg, data, d = tiny

    def gen():
        return torch.Generator().manual_seed(3)

    tc = TrainerConfig(total_steps=8, ckpt_dir=d + "_a", ckpt_every=100,
                       ckpt_async=False)
    tr = _trainer(tc, cfg, opt_cfg, data, init_generator=gen())
    tr.run()
    tc1 = TrainerConfig(total_steps=4, ckpt_dir=d + "_b", ckpt_every=4,
                        ckpt_async=False)
    _trainer(tc1, cfg, opt_cfg, data, init_generator=gen()).run()
    tc2 = TrainerConfig(total_steps=8, ckpt_dir=d + "_b", ckpt_every=100,
                        ckpt_async=False)
    t2 = _trainer(tc2, cfg, opt_cfg, data, init_generator=gen())
    assert t2.start_step == 4
    t2.run()
    for a, b in zip(jax.tree.leaves(tr.state_to_host()),
                    jax.tree.leaves(t2.state_to_host())):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(tr.state["params"].embed.table.detach(),
                               t2.state["params"].embed.table.detach(),
                               rtol=1e-6, atol=1e-6)


def _poisoned(cfg, opt_cfg, data, *, donate=False):
    class PoisonData:
        def __init__(self, inner):
            self.inner = inner

        def batch_at(self, step):
            b = self.inner.batch_at(step)
            if step == 2:               # poison one batch
                b = dict(b)
                b["labels"] = np.full_like(b["labels"], 0)
                b["poison"] = None
            return b

    inner = steps.make_train_step(cfg, opt_cfg, donate=donate)

    def poison_step(state, batch):
        nan = "poison" in batch
        batch = {k: v for k, v in batch.items() if k != "poison"}
        new_state, metrics = inner(state, batch)
        if nan:
            metrics = dict(metrics)
            metrics["loss"] = torch.tensor(float("nan"))
        return new_state, metrics

    return PoisonData(data), poison_step


def test_nan_guard_skips_bad_batch(tiny):
    cfg, opt_cfg, data, d = tiny
    pdata, poison_step = _poisoned(cfg, opt_cfg, data)
    tc = TrainerConfig(total_steps=5, ckpt_dir=d, ckpt_every=100,
                       ckpt_async=False)
    tr = _trainer(tc, cfg, opt_cfg, pdata, poison_step)
    out = tr.run()
    assert out["nan_skipped"] == [2]
    assert int(tr.state["opt"]["step"]) == 4  # one skipped


def test_nan_guard_raises_after_an_in_place_step(tiny):
    cfg, opt_cfg, data, d = tiny
    pdata, poison_step = _poisoned(cfg, opt_cfg, data, donate=True)
    tc = TrainerConfig(total_steps=5, ckpt_dir=d, ckpt_every=100,
                       ckpt_async=False, donate=True)
    tr = _trainer(tc, cfg, opt_cfg, pdata, poison_step)
    with pytest.raises(FloatingPointError, match="in place"):
        tr.run()
    assert int(tr.state["opt"]["step"]) == 3


def test_async_checkpoint_does_not_block(tiny):
    cfg, opt_cfg, data, d = tiny
    tc = TrainerConfig(total_steps=6, ckpt_dir=d, ckpt_every=3,
                       ckpt_async=True)
    out = _trainer(tc, cfg, opt_cfg, data).run()
    assert out["final_step"] == 6
    assert ckpt.list_steps(d) == [3, 6]


def test_data_pipeline_determinism_and_sharding():
    c = DataConfig(vocab_size=100, global_batch=8, seq_len=16, seed=9)
    a = SyntheticLM(c).batch_at(5)
    b = SyntheticLM(c).batch_at(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    h0 = SyntheticLM(c, host_id=0, num_hosts=2).batch_at(5)
    h1 = SyntheticLM(c, host_id=1, num_hosts=2).batch_at(5)
    assert h0["tokens"].shape == (4, 16)
    assert not np.array_equal(h0["tokens"], h1["tokens"])


def test_request_stop_saves_and_exits(tiny):
    cfg, opt_cfg, data, d = tiny
    tc = TrainerConfig(total_steps=10, ckpt_dir=d, ckpt_every=100,
                       ckpt_async=False)
    tr = _trainer(tc, cfg, opt_cfg, data)

    class Stopping:
        def batch_at(self, step):
            if step == 3:
                tr.request_stop()
            return data.batch_at(step)

    tr.data = Stopping()
    out = tr.run()
    assert out["final_step"] == 4 and ckpt.list_steps(d) == [4]


def test_state_through_the_host(tiny):
    cfg, opt_cfg, data, d = tiny
    tc = TrainerConfig(total_steps=2, ckpt_dir=d, ckpt_async=False)
    tr = _trainer(tc, cfg, opt_cfg, data)
    tr.run()
    host = tr.state_to_host()
    back = tr.state_from_host(host)
    for a, b in zip(jax.tree.leaves(host),
                    jax.tree.leaves(train_state_to_jax(back))):
        assert np.array_equal(a, b)
    assert back["params"].embed.table.device.type == "cpu"


def test_the_card_is_the_default(tiny):
    cfg, opt_cfg, data, d = tiny
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainerConfig(ckpt_dir=d), cfg, opt_cfg,
                steps.make_train_step(cfg, opt_cfg), data)


# ------------------------------------------------ across the two packages
def _ref_fresh(cfg, opt_cfg, key=0):
    params = ref_build(cfg).init(jax.random.key(key))
    return {"params": params, "opt": ref_adamw.init_state(params, opt_cfg)}


def _ref_like(cfg, opt_cfg):
    return jax.eval_shape(lambda: _ref_fresh(cfg, opt_cfg))


@pytest.mark.parametrize("quantize_v", ["none", "int8"])
def test_checkpoints_cross_packages_with_equal_manifests(tmp_path,
                                                         quantize_v):
    _cross_packages(tmp_path, "qwen2_5_14b", quantize_v)


@pytest.mark.parametrize("quantize_v", ["none", "int8"])
def test_hybrid_checkpoints_cross_packages(tmp_path, quantize_v):
    """The reduced zamba2, whose ``group_layers`` stack on two axes
    (groups, layers per group): a checkpoint of each package restores in
    the other, bitwise, with equal manifests."""
    _cross_packages(tmp_path, "zamba2_1_2b", quantize_v)


def test_two_axis_stacking_round_trips():
    """``convert``'s split and stack of the hybrid's two-axis leaves: a
    (G, K, ...) leaf becomes ``group_layers.<g>.<i>...`` tensors, each
    ``[g, i]``, and stacks back to (G, K, ...)."""
    g, k = 3, 2
    leaf = np.arange(g * k * 5, dtype=np.float32).reshape(g, k, 5)
    lora = np.arange(g * 4, dtype=np.float32).reshape(g, 4)
    tree = {"group_layers": {"ln": {"scale": leaf}},
            "site_lora": {"q": {"a": lora}}, "ln_f": {"scale": lora[0]}}
    named = convert._unstacked(tree)
    assert sorted(named) == sorted(
        [f"group_layers.{a}.{b}.ln.scale" for a in range(g)
         for b in range(k)] + [f"site_lora.{a}.q.a" for a in range(g)]
        + ["ln_f.scale"])
    for a in range(g):
        for b in range(k):
            assert np.array_equal(
                named[f"group_layers.{a}.{b}.ln.scale"].numpy(), leaf[a, b])
    back = convert._tree(named)
    assert back["group_layers"]["ln"]["scale"].shape == (g, k, 5)
    assert np.array_equal(back["group_layers"]["ln"]["scale"], leaf)
    assert np.array_equal(back["site_lora"]["q"]["a"], lora)


def _cross_packages(tmp_path, name, quantize_v):
    rcfg = ref_config(name).reduced()
    cfg = get_config(name).reduced()
    opt_cfg = adamw.AdamWConfig(quantize_v=quantize_v)
    ref_state = jax.tree.map(np.asarray, _ref_fresh(rcfg, opt_cfg, key=2))
    ref_state["opt"]["step"] = np.int32(11)
    # reference -> port
    ref_ckpt.save(str(tmp_path / "ref"), 11, ref_state)
    s, host = ckpt.restore_latest(str(tmp_path / "ref"), ref_state)
    assert s == 11
    state = train_state_from_jax(cfg, host, device="cpu")
    assert int(state["opt"]["step"]) == 11
    back = train_state_to_jax(state)
    assert jax.tree.structure(back) == jax.tree.structure(ref_state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_state)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # port -> reference, into the reference's own like tree
    ckpt.save(str(tmp_path / "port"), 11, back)
    s, restored = ref_ckpt.restore_latest(str(tmp_path / "port"),
                                          _ref_like(rcfg, opt_cfg))
    assert s == 11
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(ref_state)):
        assert np.array_equal(np.asarray(a), b)
    manifests = [json.loads((tmp_path / w / "step_11" /
                             "manifest.json").read_text())
                 for w in ("ref", "port")]
    assert manifests[0] == manifests[1]
    assert sorted(os.listdir(tmp_path / "ref" / "step_11")) == \
        sorted(os.listdir(tmp_path / "port" / "step_11"))


def test_a_reference_checkpoint_resumes_in_the_port(tiny):
    """The reference's Trainer saves step 4; the port's resumes there and
    its state is the reference's, bitwise."""
    cfg, opt_cfg, data, d = tiny
    rcfg = ref_config("minicpm_2b").reduced()
    rdata = RefSyntheticLM(RefDataConfig(vocab_size=rcfg.vocab_size,
                                         global_batch=4, seq_len=16))
    rt = RefTrainer(RefTrainerConfig(total_steps=4, ckpt_dir=d,
                                     ckpt_every=100, ckpt_async=False),
                    ref_build(rcfg), opt_cfg,
                    ref_steps.make_train_step(rcfg, opt_cfg), rdata)
    rt.run()
    tr = _trainer(TrainerConfig(total_steps=6, ckpt_dir=d, ckpt_every=100,
                                ckpt_async=False), cfg, opt_cfg, data)
    assert tr.start_step == 4
    for a, b in zip(jax.tree.leaves(tr.state_to_host()),
                    jax.tree.leaves(rt.state_to_host())):
        assert np.array_equal(a, np.asarray(b))
    assert tr.run()["final_step"] == 6


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_trainer_matches_reference_over_ten_steps(tmp_path, cd):
    rcfg = dataclasses.replace(ref_config("minicpm_2b").reduced(),
                               compute_dtype=cd)
    cfg = dataclasses.replace(get_config("minicpm_2b").reduced(),
                              compute_dtype=cd)
    opt_cfg = adamw.AdamWConfig(total_steps=10, peak_lr=1e-3, warmup=3,
                                schedule=cfg.schedule)
    kw = dict(vocab_size=cfg.vocab_size, global_batch=4, seq_len=16)
    fresh = jax.tree.map(np.asarray, _ref_fresh(rcfg, opt_cfg, key=5))
    ref_ckpt.save(str(tmp_path / "port"), 0, fresh)       # the shared start
    tc = dict(total_steps=10, ckpt_every=100, log_every=1, ckpt_async=False)
    rt = RefTrainer(RefTrainerConfig(ckpt_dir=str(tmp_path / "ref"), **tc),
                    ref_build(rcfg), opt_cfg,
                    ref_steps.make_train_step(rcfg, opt_cfg),
                    RefSyntheticLM(RefDataConfig(**kw)),
                    init_key=jax.random.key(5))
    tr = _trainer(TrainerConfig(ckpt_dir=str(tmp_path / "port"), **tc),
                  cfg, opt_cfg, SyntheticLM(DataConfig(**kw)))
    assert tr.start_step == 0
    want, got = rt.run(), tr.run()
    assert [h["step"] for h in got["history"]] == list(range(1, 11))
    for a, b in zip(got["history"], want["history"]):
        assert abs(a["loss"] - b["loss"]) <= LOSS_TOL[cd] * abs(b["loss"])
        assert abs(a["lr"] - b["lr"]) <= 1e-6 * b["lr"]
    assert got["history"][-1]["loss"] < got["history"][0]["loss"]
    lr_max = max(h["lr"] for h in want["history"])
    start = jax.tree.leaves(fresh["params"])
    worst, moved = 0.0, []
    for a, b, p0 in zip(jax.tree.leaves(tr.state_to_host()["params"]),
                        jax.tree.leaves(rt.state_to_host()["params"]),
                        start):
        b = np.asarray(b, np.float64)
        worst = max(worst, float(np.abs(a - b).max()))
        moved.append(float(np.linalg.norm(a - b) / np.linalg.norm(b - p0)))
    print(f"{cd}, 10 steps: losses "
          f"{[round(h['loss'], 4) for h in got['history']]}; largest "
          f"parameter difference {worst:.3e} = {worst / lr_max:.3f} lr; "
          f"largest leaf difference / its movement {max(moved):.3e}")
    if cd == "float32":
        assert worst <= PARAM_ATOL_LR * lr_max
    else:
        assert max(moved) <= PARAM_FRO_MOVED


# -------------------------------------------------------------- the steps
def _pair(name, cd="float32"):
    """(cfg, reference model, reference params, port model) on the CPU."""
    rcfg = dataclasses.replace(ref_config(name).reduced(), compute_dtype=cd)
    cfg = dataclasses.replace(get_config(name).reduced(), compute_dtype=cd)
    rm = ref_build(rcfg)
    rp = rm.init(jax.random.key(1))
    return cfg, rm, rp, params_from_jax(cfg, jax.tree.map(np.asarray, rp),
                                        device="cpu")


def _batch(cfg, seed):
    """(reference batch, port batch) of tokens and labels, (2, 16)."""
    rng = np.random.default_rng(seed)
    b = {k: rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
         for k in ("tokens", "labels")}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_train_step_matches_reference():
    """One step of ``make_train_step`` against the reference's: the
    metrics and the new parameters (f32 compute)."""
    cfg, rm, rp, model = _pair("qwen2_5_14b")
    rcfg = rm.cfg
    opt_cfg = adamw.AdamWConfig(warmup=2, total_steps=10, schedule="wsd")
    rb, pb = _batch(cfg, seed=6)
    rstate = {"params": rp, "opt": ref_adamw.init_state(rp, opt_cfg)}
    rnew, rmet = ref_steps.make_train_step(rcfg, opt_cfg)(rstate, rb)
    state = {"params": model, "opt": adamw.init_state(model, opt_cfg)}
    new, met = steps.make_train_step(cfg, opt_cfg)(state, pb)
    assert set(met) == set(rmet) == {"loss", "nll", "aux", "lr", "grad_norm"}
    for k in met:
        assert _rel(met[k], rmet[k]) <= 1e-5 if float(rmet[k]) else \
            float(met[k]) == 0.0
    # one AdamW step moves an element by about lr where its gradient is
    # far above the two packages' rounding and by less where it is not
    # (qwen's wk bias has a gradient of exactly 0 in exact arithmetic:
    # the softmax cancels it), so the new parameters are held within a
    # tenth of lr, as the ten-step Trainer test above holds them
    lr = float(rmet["lr"])
    for a, b in zip(jax.tree.leaves(params_to_jax(new["params"])),
                    jax.tree.leaves(rnew["params"])):
        assert np.abs(a - np.asarray(b)).max() <= PARAM_ATOL_LR * lr
    assert int(new["opt"]["step"]) == 1 and new["params"] is not model


def test_prefill_and_serve_steps_match_reference():
    cfg, rm, rp, model = _pair("h2o_danube_3_4b")
    rb, pb = _batch(cfg, seed=8)
    rb, pb = {"tokens": rb["tokens"]}, {"tokens": pb["tokens"]}
    want = ref_steps.make_prefill_step(rm.cfg)(rp, rb)
    got = steps.make_prefill_step(cfg)(model, pb)
    assert got.shape == (2, cfg.padded_vocab) and _rel(got, want) <= 1e-5
    rc = rm.init_cache(2, 4, dtype=jnp.float32)
    pc = model.init_cache(2, 4, dtype=torch.float32)
    serve, rserve = steps.make_serve_step(cfg), \
        ref_steps.make_serve_step(rm.cfg)
    for t in range(4):
        want, rc = rserve(rp, rc, rb["tokens"][:, t:t + 1], jnp.int32(t))
        got, pc = serve(model, pc, pb["tokens"][:, t:t + 1], t)
        assert got.shape == (2, cfg.padded_vocab)
        assert _rel(got, want) <= 1e-5


# ------------------------------------------------------------ entry points
def _run(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _losses(out) -> list[float]:
    return [float(line.split("loss")[1].split()[0])
            for line in out.splitlines() if line.startswith("step")]


def test_train_lm_example_on_the_cpu(tmp_path):
    d = str(tmp_path / "ckpt")
    rc, out = _run(train_lm.main, ["--steps", "20", "--device", "cpu",
                                   "--ckpt-dir", d])
    assert rc == 0, out
    assert "done at step 20" in out and "embed_grad=segment" in out
    losses = _losses(out)
    assert len(losses) == 2 and losses[-1] < losses[0]
    assert ckpt.list_steps(d) == [20]


def test_launch_train_on_the_cpu(tmp_path, monkeypatch):
    """``--mesh none`` trains; the handlers it installs for SIGTERM and
    SIGINT stop the trainer, and are put back when it returns."""
    installed = {}

    def record(sig, handler):
        installed.setdefault(sig, []).append(handler)
        return signal.SIG_DFL

    monkeypatch.setattr(launch_train.signal, "signal", record)
    d = str(tmp_path / "ckpt")
    rc, out = _run(launch_train.main, [
        "--arch", "minicpm-2b", "--reduced", "--steps", "10", "--device",
        "cpu", "--ckpt-dir", d, "--ckpt-every", "5"])
    assert rc == 0, out
    assert "final step 10" in out and "nan-skipped 0" in out
    losses = _losses(out)
    assert losses[-1] < losses[0]
    assert ckpt.list_steps(d) == [5, 10]
    for sig in (signal.SIGTERM, signal.SIGINT):
        stop, restored = installed[sig]
        assert stop.__name__ == "request_stop" and restored is signal.SIG_DFL


@pytest.mark.parametrize("mesh,world", [("test", 8), ("single", 256),
                                        ("multi", 512)])
def test_launch_train_refuses_a_mesh(mesh, world, monkeypatch):
    """Outside a process group of the mesh's size, ``--mesh`` raises a
    ``ValueError`` naming the world it needs (under
    ``torch.distributed.run``: tests/test_torch_sharded_train.py)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match=f"needs a world of {world} ranks"):
        launch_train.main(["--arch", "minicpm-2b", "--reduced", "--mesh",
                           mesh, "--device", "cpu"])
