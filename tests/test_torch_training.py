"""The port's training math (``repro_torch.models.transformer``'s loss,
``_remat``, ``launch.steps``) against the JAX package's on the CPU.

The reference's parameters (``model.init(jax.random.key(k))``) are carried
into the port with ``convert.params_from_jax``; both packages then take the
loss and its gradients on the same batch, made from a seed with numpy, for
the ``reduced()`` configs of the five dense-spine configs:

* f32 compute: max |d| / max |ref| of the loss and of every gradient leaf
  at most ``F32_TOL``;
* the configs' bf16 compute: the loss within ``BF16_TOL`` and each leaf's
  gradient within ``BF16_GRAD_FRO`` in the Frobenius norm, relative;
* both ``embed_grad`` methods; internvl2's table, which it never reads:
  zeros in the reference, ``None`` in the port, and AdamW takes the
  ``None`` as the zeros;
* the three remat policies give gradients bitwise equal to no
  checkpointing; ``parallel_cross_entropy`` within ``CE_TOL``.

Every intended difference between the two packages' training code is
named in ``DIFFERENCES``, and a test holds each name to the sources.
"""
import ast
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE = ["minicpm_2b", "qwen2_5_14b", "stablelm_12b", "h2o_danube_3_4b",
         "internvl2_2b"]
# f32 compute: the two packages add in other orders, nothing else
F32_TOL = 1e-5
# bf16 compute: the loss as the logits' bf16 tolerance of the forward
# tests; each gradient leaf, relative in the Frobenius norm: the bf16
# roundings of the backward's products differ (worst measured 2.25e-2,
# qwen's, whose reduced config has G = 4)
BF16_TOL = 2e-2
BF16_GRAD_FRO = 5e-2
CE_TOL = 1e-6
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's small CPU steps: they run
    faster so, and the test workers' thread pools do not oversubscribe
    the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Where the port's training code departs from the reference on purpose:
# (port file, reference file, an identifier, the side whose source holds
# it and the other's does not, why).  Paths are from the repo's root.
DIFFERENCES = [
    ("src/repro_torch/launch/steps.py", "src/repro/launch/steps.py",
     "donate", "port",
     "make_train_step(donate=True) updates the state in place (params, "
     "m, v, step) and returns it: the port's reading of the reference's "
     "TrainerConfig.donate, whose donated buffers leave no old state"),
    ("src/repro_torch/train/trainer.py", "src/repro/train/trainer.py",
     "FloatingPointError", "port",
     "with TrainerConfig.donate the NaN guard raises instead of skipping: "
     "the in-place step left no old state to keep (the reference fails "
     "on its next step, reading donated buffers)"),
    ("src/repro_torch/launch/steps.py", "src/repro/launch/steps.py",
     "allow_unused", "port",
     "a parameter the loss never reads (internvl2's table) gets a None "
     "gradient from torch.autograd.grad, which AdamW takes as zeros "
     "(jax.value_and_grad gives zeros): it is still decayed and its m "
     "and v still move"),
    ("src/repro_torch/train/trainer.py", "src/repro/train/trainer.py",
     "init_generator", "port",
     "the Trainer takes the model's config and init_generator, an "
     "explicit torch.Generator on its device, in place of a Model and a "
     "JAX key; the fresh state is drawn there"),
    ("src/repro_torch/train/trainer.py", "src/repro/train/trainer.py",
     "rank0_only", "port",
     "under a mesh the state is gathered tensor by tensor and only rank 0 "
     "keeps a host copy and writes the checkpoint (every rank waits for "
     "it): the reference's ranks are one process's devices"),
    ("chip_smoke.py", "tests/test_trainer.py", "RESUME_TOL", "port",
     "on the card a resumed run is held within 1e-6 of the straight run, "
     "the reference test's own bound, under "
     "torch.use_deterministic_algorithms: in the default mode index_add_'s "
     "atomics reorder the embedding gradient's additions and AdamW carries "
     "that to a few lr in places at full width (printed, not gated); "
     "bitwise on the CPU, test_torch_trainer.py::test_resume_bit_exact"),
    ("src/repro_torch/launch/train.py", "src/repro/launch/train.py",
     "init_process_group", "port",
     "--mesh test|single|multi join the process group their caller "
     "starts (python -m torch.distributed.run), of as many ranks as the "
     "mesh holds, and raise a ValueError naming that count otherwise; the "
     "backend is gloo on the host or on a shared card, NCCL where each "
     "rank has a card"),
    ("tests/test_torch_sharded_train.py", "tests/test_distributed.py",
     "CODE_STEP", "port",
     "against the reference's sharded step the int8 second moment's codes "
     "are held within one code (3 of dbrx reduced()'s codes, the rest "
     "equal): a v that the reordered reductions move across a code's "
     "midpoint rounds to its neighbour; v_scale and every other leaf are "
     "held at 1e-5"),
    ("src/repro_torch/launch/steps.py", "src/repro/launch/steps.py",
     "data_rows", "port",
     "the sharded step is per-rank code: each rank gathers the parameters, "
     "runs its B / dp rows of the batch and averages the gradients over "
     "the data axes; a batch the data axes do not divide raises, where "
     "the reference's _batch_spec replicates it"),
    ("src/repro_torch/train/checkpoint.py", "src/repro/train/checkpoint.py",
     "asarray", "reference",
     "the async snapshot copies every leaf (np.array): .numpy() of a CPU "
     "tensor shares its storage, and an in-place step would change it "
     "under the writer"),
    ("src/repro_torch/train/trainer.py", "src/repro/train/trainer.py",
     "tempfile", "port",
     "the default checkpoint directory is under the temporary directory "
     "(TMPDIR), not a fixed /tmp path; the entry points' too"),
]


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


# ------------------------------------------------------------------ helpers
@functools.lru_cache(maxsize=None)
def _pair(name, cd, embed_grad="segment"):
    """(cfg, reference model, reference params, port model) on the CPU."""
    changes = dict(compute_dtype=cd, embed_grad=embed_grad)
    rcfg = dataclasses.replace(ref_config(name).reduced(), **changes)
    cfg = dataclasses.replace(get_config(name).reduced(), **changes)
    rm = ref_build(rcfg)
    rp = rm.init(jax.random.key(1))
    model = params_from_jax(cfg, jax.tree.map(np.asarray, rp), device="cpu")
    return cfg, rm, rp, model


@functools.lru_cache(maxsize=None)
def _ref_grads(name, cd, embed_grad="segment"):
    """The reference's (loss, metrics, gradients) on ``_batch(cfg)``."""
    cfg, rm, rp, _ = _pair(name, cd, embed_grad)
    return jax.value_and_grad(rm.loss, has_aux=True)(rp, _batch(cfg)[0])


def _batch(cfg, seed=0):
    """(reference batch, port batch) with labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.input_mode == "embeddings":
        x = rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)
        key = "embeds"
    else:
        x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        key = "tokens"
    return ({key: jnp.asarray(x), "labels": jnp.asarray(labels)},
            {key: torch.from_numpy(x), "labels": torch.from_numpy(labels)})


def _grads(model, cfg, batch):
    """(loss, metrics, gradients by state-dict name, None where unused)."""
    named = dict(model.named_parameters())
    loss, metrics = transformer.loss_fn(model, cfg, batch)
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True)
    return loss.detach(), metrics, dict(zip(named, grads))


def _ref_leaves(tree) -> dict:
    """The reference's leaves by dotted path."""
    return {".".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _stacked(named, key, names, like):
    """The port's tensors of the reference leaf ``key``, stacked as the
    reference stacks a layer group (``None`` as zeros)."""
    stacked = names[0] != key
    shape = like.shape[1:] if stacked else like.shape
    ts = [np.zeros(shape, np.float32) if named[n] is None
          else named[n].detach().numpy() for n in names]
    return np.stack(ts) if stacked else ts[0]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# --------------------------------------------------------- loss and grads
# both embed_grad methods in f32 (internvl2 reads no table, so scatter
# adds nothing there); bf16 through the configs' default, segment
CASES = [(n, "float32", "segment") for n in DENSE] + \
    [(n, "float32", "scatter") for n in DENSE if n != "internvl2_2b"] + \
    [(n, "bfloat16", "segment") for n in DENSE]


@pytest.mark.parametrize("name,cd,embed_grad", CASES,
                         ids=["-".join(c) for c in CASES])
def test_loss_and_gradients_match_reference(name, cd, embed_grad):
    cfg, rm, rp, model = _pair(name, cd, embed_grad)
    (rloss, rmet), rgrads = _ref_grads(name, cd, embed_grad)
    loss, metrics, grads = _grads(model, cfg, _batch(cfg)[1])
    assert float(metrics["aux"]) == 0.0 == float(rmet["aux"])
    want = _ref_leaves(rgrads)
    groups = adamw.leaf_groups(grads)
    assert list(groups) == list(want)          # the reference's leaf order
    if cd == "float32":
        assert _rel(loss, rloss) <= F32_TOL
        assert _rel(metrics["nll"].detach(), rmet["nll"]) <= F32_TOL
    else:
        assert _rel(loss, rloss) <= BF16_TOL
    worst = 0.0
    for key, names in groups.items():
        got = _stacked(grads, key, names, want[key])
        if not np.abs(want[key]).any():
            # a leaf the loss never reads: internvl2's embedding table
            assert name == "internvl2_2b" and key == "embed.table"
            assert all(grads[n] is None for n in names)
            continue
        err = _rel(got, want[key]) if cd == "float32" else \
            _fro(got, want[key])
        worst = max(worst, err)
        assert err <= (F32_TOL if cd == "float32" else BF16_GRAD_FRO), \
            (key, err)
    print(f"{name} {cd} {embed_grad}: loss {float(loss):.6f} vs "
          f"{float(rloss):.6f}, worst gradient leaf {worst:.3e}")


def test_unused_table_updates_as_zeros():
    """internvl2 never reads its table: the port's ``None`` gradient is
    AdamW's zeros (bitwise), and one step matches the reference's, whose
    gradient there is zeros: the table is decayed, m and v stay 0."""
    cfg, rm, rp, model = _pair("internvl2_2b", "float32")
    _, grads = _ref_grads("internvl2_2b", "float32")
    opt_cfg = adamw.AdamWConfig(warmup=2, total_steps=10)
    ref_p, ref_s, _ = jax.jit(ref_adamw.apply_updates, static_argnums=3)(
        rp, grads, ref_adamw.init_state(rp, opt_cfg), opt_cfg)
    _, _, g = _grads(model, cfg, _batch(cfg)[1])
    assert g["embed.table"] is None
    zeros = dict(g, **{"embed.table": torch.zeros_like(model.embed.table)})
    a = adamw.apply_updates(model, g, adamw.init_state(model, opt_cfg),
                            opt_cfg)
    b = adamw.apply_updates(model, zeros, adamw.init_state(model, opt_cfg),
                            opt_cfg)
    for n in a[0]:
        assert torch.equal(a[0][n], b[0][n])
        assert torch.equal(a[1]["m"][n], b[1]["m"][n])
        assert torch.equal(a[1]["v"][n], b[1]["v"][n])
    want = np.asarray(ref_p["embed"]["table"])
    assert _rel(a[0]["embed.table"], want) <= CE_TOL
    assert not np.array_equal(want, np.asarray(rp["embed"]["table"]))
    assert not torch.any(a[1]["m"]["embed.table"])


# ------------------------------------------------------------------ remat
@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable",
                                    "dots_with_no_batch_dims_saveable"])
def test_remat_policies_give_the_gradients_of_no_checkpointing(
        policy, monkeypatch):
    cfg, _, _, model = _pair("qwen2_5_14b", "bfloat16")
    cfg = dataclasses.replace(cfg, remat_policy=policy)
    _, pb = _batch(cfg, seed=3)
    calls = []
    layer = transformer.dense_layer_apply

    def counted(*args, **kw):
        calls.append(1)
        return layer(*args, **kw)

    monkeypatch.setattr(transformer, "dense_layer_apply", counted)
    loss, _, grads = _grads(model, cfg, pb)
    # each layer ran twice: in the forward and again in the backward
    assert len(calls) == 2 * cfg.num_layers
    monkeypatch.setattr(transformer, "_remat", lambda fn, cfg: fn)
    loss0, _, grads0 = _grads(model, cfg, pb)
    assert len(calls) == 3 * cfg.num_layers
    assert torch.equal(loss, loss0)
    for n in grads:
        assert torch.equal(grads[n], grads0[n]), n


def test_forward_without_gradients_is_unchanged():
    """With gradients off no checkpoint wraps the layers, and the logits
    with gradients on are the same bits."""
    cfg, _, _, model = _pair("minicpm_2b", "bfloat16")
    _, pb = _batch(cfg)
    with torch.no_grad():
        a, _ = transformer.forward(model, cfg, pb)
    b, _ = transformer.forward(model, cfg, pb)
    assert b.requires_grad and torch.equal(a, b.detach())


# ------------------------------------------------------------ cross entropy
@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_parallel_cross_entropy_matches_reference(scale):
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((3, 5, 300)) * scale).astype(np.float32)
    labels = rng.integers(0, 300, (3, 5)).astype(np.int32)
    want = ref_transformer.parallel_cross_entropy(jnp.asarray(logits),
                                                  jnp.asarray(labels))
    got = transformer.parallel_cross_entropy(torch.from_numpy(logits),
                                             torch.from_numpy(labels))
    assert got.shape == (3, 5) and got.dtype == torch.float32
    assert _rel(got, want) <= CE_TOL
    plain = torch.nn.functional.cross_entropy(
        torch.from_numpy(logits).reshape(-1, 300),
        torch.from_numpy(labels).reshape(-1).long(), reduction="none")
    assert _rel(got.reshape(-1), plain) <= CE_TOL


def test_model_loss_is_loss_fn():
    cfg, rm, rp, model = _pair("stablelm_12b", "float32")
    rb, pb = _batch(cfg, seed=5)
    loss, met = model.loss(pb)
    rloss, rmet = rm.loss(rp, rb)
    assert _rel(loss.detach(), rloss) <= F32_TOL
    assert set(met) == set(rmet) == {"nll", "aux"}
