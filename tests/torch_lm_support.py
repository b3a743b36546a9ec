"""Shared helpers of the family tests (``test_torch_moe.py``,
``test_torch_ssm.py``, ``test_torch_hybrid.py``, ``test_torch_encdec.py``):
the port's LM against the JAX package's on the CPU, on the ``reduced()``
configs, with the reference's weights carried in by
``convert.params_from_jax`` and the inputs made from a seed with numpy.

Each ``check_*`` function is one comparison that a family's file runs on
its configs:

* ``check_forward``: the logits (and the MoE aux loss) of ``forward``,
  full and chunked, within ``F32_TOL`` in f32 and ``BF16_TOL`` in bf16,
  as max |d| / max |ref|;
* ``check_decode``: every step of a 16-step decode and the cache it
  leaves, the same bounds;
* ``check_consistency``: decode against the port's own teacher-forced
  forward within ``CONSISTENCY_TOL``, at the reference's
  ``test_train_decode_consistency`` settings (``CONSISTENCY``);
* ``check_grads``: the loss and every gradient leaf against
  ``jax.value_and_grad`` in f32 within ``GRAD_TOL``;
* ``check_trainer``: the Trainer against the reference's from one step-0
  checkpoint, as ``test_torch_trainer.py`` holds the dense family.
"""
import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.launch import steps as ref_steps
from repro.models import build_model as ref_build
from repro.models import encdec as ref_encdec
from repro.models import transformer as ref_transformer
from repro.optim import adamw as ref_adamw
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig
from repro.train import checkpoint as ref_ckpt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import steps
from repro_torch.models.model import family
from repro_torch.optim import adamw
from repro_torch.train import Trainer, TrainerConfig

# f32 compute: both packages reduce in another order, nothing else
F32_TOL = 1e-5
# bf16 compute: the same roundings in the same order, but XLA may keep an
# elementwise chain in f32 where the port rounds once per op; a few bf16
# ulps (2^-8) of the largest logit
BF16_TOL = 2e-2
# decode against teacher-forced forward, the reference's own bound
CONSISTENCY_TOL = 2e-3
# tests/test_models.py::test_train_decode_consistency's settings: chunks
# of 8 positions, and a capacity no expert's load can pass (decode has
# t = B tokens, so the default capacity drops routed tokens there that
# the forward keeps)
CONSISTENCY = dict(ssd_chunk=8, capacity_factor=8.0)
GRAD_TOL = 1e-5
# the Trainer against the reference's (tests/test_torch_trainer.py's
# bounds): the losses within 1e-5 relative in f32 and every parameter
# within a tenth of lr
LOSS_TOL = 1e-5
PARAM_ATOL_LR = 0.1
B, S = 2, 16
ENC_LEN = 8          # the enc-dec's frame embeddings per request


@functools.lru_cache(maxsize=None)
def pair(name, cd, key=1, **changes):
    """(cfg, reference model, reference params, port model) on the CPU."""
    changes = dict(changes, compute_dtype=cd)
    rcfg = dataclasses.replace(ref_config(name).reduced(), **changes)
    cfg = dataclasses.replace(get_config(name).reduced(), **changes)
    rm = ref_build(rcfg)
    rp = rm.init(jax.random.key(key))
    model = params_from_jax(cfg, jax.tree.map(np.asarray, rp), device="cpu")
    return cfg, rm, rp, model


def ref_family(cfg):
    return ref_encdec if cfg.is_encdec else ref_transformer


def inputs(cfg, seed=0, b=B, s=S, labels=False):
    """(reference batch, port batch): tokens, embeddings for the vlm, both
    for the enc-dec (``ENC_LEN`` frames); with ``labels``, labels too."""
    rng = np.random.default_rng(seed)
    out = {}
    fd = cfg.frontend_dim or cfg.d_model
    if cfg.is_encdec:
        out["embeds"] = rng.standard_normal((b, ENC_LEN, fd)).astype(
            np.float32)
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    elif cfg.input_mode == "embeddings":
        out["embeds"] = rng.standard_normal((b, s, fd)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def step_key(cfg) -> str:
    """The batch entry a decode step reads."""
    return "embeds" if cfg.input_mode == "embeddings" and \
        not cfg.is_encdec else "tokens"


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def tol(cd):
    return F32_TOL if cd == "float32" else BF16_TOL


def leaves(tree, prefix=()) -> dict:
    """A nested dict of arrays or tensors by dotted path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, prefix + (k,)))
        else:
            out[".".join(prefix + (k,))] = v
    return out


# ------------------------------------------------------------------ checks
def check_forward(name, cd, impl, **changes):
    cfg, rm, rp, model = pair(name, cd, **changes)
    rb, pb = inputs(cfg)
    want, want_aux = ref_family(cfg).forward(rp, rm.cfg, rb, impl=impl)
    with torch.no_grad():
        got, aux = family(cfg).forward(model, cfg, pb, impl=impl)
    assert got.dtype == torch.float32
    assert got.shape == (B, S, cfg.padded_vocab)
    r = rel(got, want)
    print(f"{name} {cd} {impl}: forward max|d|/max|ref| {r:.3e}, aux "
          f"{float(aux):.6f} vs {float(want_aux):.6f}")
    assert r <= tol(cd), r
    assert abs(float(aux) - float(want_aux)) <= \
        tol(cd) * max(1.0, abs(float(want_aux)))
    return r


def _caches(cfg, rm, rp, model, rb, pb, cd):
    dt = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}[cd]
    if cfg.is_encdec:
        rc = rm.init_cache(B, S, enc_len=ENC_LEN, dtype=dt[0])
        rc = ref_encdec.prefill_memory(rp, rm.cfg, rc, rb["embeds"])
        pc = model.init_cache(B, S, enc_len=ENC_LEN, dtype=dt[1])
        pc = model.prefill_memory(pc, pb["embeds"])
    else:
        rc = rm.init_cache(B, S, dtype=dt[0])
        pc = model.init_cache(B, S, dtype=dt[1])
    return rc, pc


@functools.lru_cache(maxsize=None)
def _ref_step(name, cd, changes=()):
    return jax.jit(pair(name, cd, **dict(changes))[1].decode_step)


def check_decode(name, cd, **changes):
    """Every step of a 16-step decode and the cache left, against the
    reference's.  Returns the worst step's error."""
    cfg, rm, rp, model = pair(name, cd, **changes)
    rb, pb = inputs(cfg, seed=1)
    rc, pc = _caches(cfg, rm, rp, model, rb, pb, cd)
    want_leaves = leaves(jax.tree.map(np.asarray, rc))
    assert {k: tuple(v.shape) for k, v in leaves(pc).items()} == \
        {k: tuple(v.shape) for k, v in want_leaves.items()}
    key = step_key(cfg)
    step = _ref_step(name, cd, tuple(sorted(changes.items())))
    worst = 0.0
    for t in range(S):
        want, rc = step(rp, rc, rb[key][:, t:t + 1], jnp.int32(t))
        got, pc2 = model.decode_step(pc, pb[key][:, t:t + 1], t)
        assert pc2 is pc and got.shape == (B, 1, cfg.padded_vocab)
        r = rel(got, want)
        worst = max(worst, r)
        assert r <= tol(cd), (t, r)
    got_leaves = leaves(pc)
    for k, v in leaves(jax.tree.map(np.asarray, rc)).items():
        if np.abs(v.astype(np.float64)).max() == 0:
            assert float(got_leaves[k].abs().max()) == 0, k
        else:
            assert rel(got_leaves[k].float(), v.astype(np.float32)) \
                <= tol(cd), k
    print(f"{name} {cd}: worst decode step max|d|/max|ref| {worst:.3e}")
    return worst


def check_consistency(name):
    """Decode against the port's own teacher-forced forward, f32."""
    cfg, _, _, model = pair(name, "float32", **CONSISTENCY)
    rb, pb = inputs(cfg, seed=2)
    with torch.no_grad():
        ref, _ = model.forward(pb)
    if cfg.is_encdec:
        cache = model.init_cache(B, S, enc_len=ENC_LEN, dtype=torch.float32)
        cache = model.prefill_memory(cache, pb["embeds"])
    else:
        cache = model.init_cache(B, S, dtype=torch.float32)
    key = step_key(cfg)
    dec = torch.cat([model.decode_step(cache, pb[key][:, t:t + 1], t)[0]
                     for t in range(S)], dim=1)
    r = rel(dec, ref)
    print(f"{name}: decode vs own forward {r:.3e}")
    assert r < CONSISTENCY_TOL, r


def port_grads(model, cfg, batch):
    """(loss, metrics, gradients by state-dict name, None where unused)."""
    named = dict(model.named_parameters())
    loss, metrics = family(cfg).loss_fn(model, cfg, batch)
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True)
    return loss.detach(), metrics, dict(zip(named, grads))


def check_grads(name, **changes):
    """The loss, the aux and every gradient leaf against
    ``jax.value_and_grad``, f32, leaf by leaf in the reference's order."""
    cfg, rm, rp, model = pair(name, "float32", **changes)
    rb, pb = inputs(cfg, seed=3, labels=True)
    (want_loss, want_met), want = jax.jit(jax.value_and_grad(
        rm.loss, has_aux=True))(rp, rb)
    loss, met, grads = port_grads(model, cfg, pb)
    assert abs(float(loss) - float(want_loss)) <= \
        GRAD_TOL * abs(float(want_loss))
    assert abs(float(met["aux"].detach()) - float(want_met["aux"])) <= \
        GRAD_TOL * max(1.0, abs(float(want_met["aux"])))
    want = leaves(jax.tree.map(np.asarray, want))
    groups = adamw.leaf_groups(grads)
    assert list(groups) == list(want)      # the reference's leaf order
    worst = 0.0
    for key, names in groups.items():
        ref = want[key]
        got = np.stack([np.zeros(grads[n].shape if grads[n] is not None
                                 else (), np.float32)
                        if grads[n] is None else grads[n].numpy()
                        for n in names]).reshape(ref.shape)
        scale = np.abs(ref).max()
        if scale == 0:
            assert np.abs(got).max() == 0, key
            continue
        r = rel(got, ref)
        worst = max(worst, r)
        assert r <= GRAD_TOL, (key, r)
    print(f"{name}: loss {float(loss):.6f}, worst gradient leaf "
          f"max|d|/max|ref| {worst:.3e} over {len(groups)} leaves")


def check_trainer(tmp_path, name, steps_n=4, **changes):
    """The port's Trainer and the reference's from the reference's fresh
    state saved as a step-0 checkpoint, ``steps_n`` steps on the same
    batches, f32: the losses, the lr and every final parameter."""
    changes = dict(changes, compute_dtype="float32")
    rcfg = dataclasses.replace(ref_config(name).reduced(), **changes)
    cfg = dataclasses.replace(get_config(name).reduced(), **changes)
    opt_cfg = adamw.AdamWConfig(total_steps=steps_n, peak_lr=1e-3,
                                warmup=2, schedule=cfg.schedule)
    kw = dict(vocab_size=cfg.vocab_size, global_batch=2, seq_len=16,
              input_mode=cfg.input_mode,
              frontend_dim=cfg.frontend_dim or cfg.d_model,
              encdec=cfg.is_encdec)
    params = ref_build(rcfg).init(jax.random.key(5))
    fresh = jax.tree.map(np.asarray, {
        "params": params, "opt": ref_adamw.init_state(params, opt_cfg)})
    ref_ckpt.save(str(tmp_path / "port"), 0, fresh)       # the shared start
    tc = dict(total_steps=steps_n, ckpt_every=100, log_every=1,
              ckpt_async=False)
    rt = RefTrainer(RefTrainerConfig(ckpt_dir=str(tmp_path / "ref"), **tc),
                    ref_build(rcfg), opt_cfg,
                    ref_steps.make_train_step(rcfg, opt_cfg),
                    RefSyntheticLM(RefDataConfig(**kw)),
                    init_key=jax.random.key(5))
    tr = Trainer(TrainerConfig(ckpt_dir=str(tmp_path / "port"), **tc),
                 cfg, opt_cfg, steps.make_train_step(cfg, opt_cfg),
                 SyntheticLM(DataConfig(**kw)), device="cpu")
    assert tr.start_step == 0
    want, got = rt.run(), tr.run()
    assert [h["step"] for h in got["history"]] == list(range(1, steps_n + 1))
    for a, b in zip(got["history"], want["history"]):
        assert abs(a["loss"] - b["loss"]) <= LOSS_TOL * abs(b["loss"])
        assert abs(a["lr"] - b["lr"]) <= 1e-6 * b["lr"]
    lr_max = max(h["lr"] for h in want["history"])
    worst = 0.0
    for a, b in zip(jax.tree.leaves(tr.state_to_host()["params"]),
                    jax.tree.leaves(rt.state_to_host()["params"])):
        worst = max(worst, float(np.abs(a - np.asarray(b, np.float64)).max()))
    print(f"{name}, {steps_n} steps: losses "
          f"{[round(h['loss'], 5) for h in got['history']]}; largest "
          f"parameter difference {worst:.3e} = {worst / lr_max:.3f} lr")
    assert worst <= PARAM_ATOL_LR * lr_max
