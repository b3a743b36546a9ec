"""The port's hybrid family (the ``hybrid`` branches of
``repro_torch.models.transformer``: a Mamba2 spine in ``pre_layers`` and
``group_layers``, one shared attention block with per-site LoRA) against
the JAX package's on the CPU, on zamba2-1.2b's ``reduced()`` config (two
groups of two SSM layers) and on one with a leading pre layer, the
reference's weights carried in by ``convert.params_from_jax``
(``torch_lm_support``):

* ``forward``, full and chunked, and every step of a 16-step decode
  (the shared block inline, its per-site cache): 1e-5 in f32, 2e-2 in
  bf16; decode against the port's own forward at ``ssd_chunk=8``;
* the loss and every gradient against ``jax.value_and_grad``: the
  two-axis ``group_layers`` leaves, ``site_lora`` per group, and
  ``shared_attn``'s gradient summed over its sites;
* ``hybrid_group_counts``, ``shared_attn_apply`` with a LoRA alone, the
  remat of each group around the remat of its layers (each group
  recomputed in the backward, the gradients those of no checkpointing);
* ``Server.generate`` and the Trainer against the reference's, and the
  entry points with ``--arch``.
"""
import ast
import contextlib
import dataclasses
import io
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_lm_support as lm  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.serving import ServeConfig as RefServeConfig  # noqa: E402
from repro.serving import Server as RefServer  # noqa: E402
from repro_torch.examples import serve_lm  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import ServeConfig, Server  # noqa: E402

NAME = "zamba2_1_2b"
PRE = dict(num_layers=5)           # one pre layer, then two groups of two
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Where the port's hybrid departs from the reference on purpose: (port
# file, reference file, an identifier, the side whose source holds it and
# the other's does not, why).  Paths are from the repo's root.
DIFFERENCES = [
    ("src/repro_torch/models/transformer.py",
     "src/repro/models/transformer.py", "_shared_attn_decode", "port",
     "the shared block's decode at one site is a function, where the "
     "reference writes it inline in decode_step's group body; the same "
     "ops in the same order, its k and v written into the site's cache "
     "views in place"),
    ("src/repro_torch/models/transformer.py",
     "src/repro/models/transformer.py", "_hybrid_group", "port",
     "one hybrid group (its SSM layers, then the shared block) is a "
     "function that forward runs under _remat, the reference's "
     "jax.checkpoint around its scan's group body"),
    ("src/repro_torch/models/transformer.py",
     "src/repro/models/transformer.py", "_site_qkv", "port",
     "the shared projections, each carrying a site's LoRA factors, as "
     "the GQA attention's weights: the prefill and the decode run "
     "attention.gqa_apply and gqa_decode over them, and so their "
     "layouts over model"),
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


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: small CPU shapes run faster so, and the test
    workers do not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- the whole model
@pytest.mark.parametrize("impl", ["full", "chunked"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_forward_matches_reference(cd, impl):
    lm.check_forward(NAME, cd, impl)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_every_decode_step_matches_reference(cd):
    lm.check_decode(NAME, cd)


def test_decode_reproduces_own_forward():
    lm.check_consistency(NAME)


def test_loss_and_every_gradient_match_reference():
    lm.check_grads(NAME)


def test_pre_layers_match_reference():
    """5 layers at every 2: one leading ``pre_layers`` layer (its own
    cache entry), then two groups."""
    cfg, _, _, model = lm.pair(NAME, "float32", **PRE)
    assert transformer.hybrid_group_counts(cfg) == (1, 2, 2)
    assert len(model.pre_layers) == 1 and len(model.group_layers) == 2
    lm.check_forward(NAME, "float32", "full", **PRE)
    lm.check_decode(NAME, "float32", **PRE)
    lm.check_grads(NAME, **PRE)


@pytest.mark.parametrize("layers,every", [(38, 6), (4, 2), (5, 2), (7, 3),
                                          (6, 6)])
def test_group_counts_equal_reference(layers, every):
    cfg = dataclasses.replace(lm.get_config(NAME), num_layers=layers,
                              shared_attn_every=every)
    rcfg = dataclasses.replace(lm.ref_config(NAME), num_layers=layers,
                               shared_attn_every=every)
    assert transformer.hybrid_group_counts(cfg) == \
        ref_transformer.hybrid_group_counts(rcfg)


def test_shared_block_with_a_lora_matches_reference():
    """The shared block at site 1 alone, its LoRA's ``b`` (zeros at init)
    drawn so the deltas count."""
    cfg, rm, rp, model = lm.pair(NAME, "float32")
    rng = np.random.default_rng(13)
    lora = jax.tree.map(lambda a: a[1], rp["site_lora"])
    for k in ("q", "k", "v"):
        lora[k]["b"] = jnp.asarray(rng.standard_normal(
            lora[k]["b"].shape).astype(np.float32) * 0.1)
    site = model.site_lora[1]
    with torch.no_grad():
        for k in ("q", "k", "v"):
            getattr(site, k).b.copy_(torch.from_numpy(
                np.array(lora[k]["b"])))
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    pos = np.arange(16, dtype=np.int32)
    want = ref_transformer.shared_attn_apply(
        rp["shared_attn"], lora, rm.cfg, jnp.asarray(x), jnp.asarray(pos),
        impl="full")
    try:
        with torch.no_grad():
            got = transformer.shared_attn_apply(
                model.shared_attn, site, cfg, torch.from_numpy(x),
                torch.from_numpy(pos), impl="full")
    finally:
        with torch.no_grad():
            for k in ("q", "k", "v"):
                getattr(site, k).b.zero_()
    assert lm.rel(got, want) <= lm.F32_TOL


def test_each_group_is_rematerialized_around_its_layers(monkeypatch):
    """Gradients on: each group runs under ``_remat`` and so does each of
    its layers; the gradients equal those without any checkpointing."""
    cfg, _, _, model = lm.pair(NAME, "float32")
    _, pb = lm.inputs(cfg, seed=4, labels=True)
    wrapped = []
    remat = transformer._remat

    def counting(fn, c):
        wrapped.append(fn.__name__)
        return remat(fn, c)
    monkeypatch.setattr(transformer, "_remat", counting)
    loss, _, grads = lm.port_grads(model, cfg, pb)
    assert wrapped.count("_hybrid_group") == 1
    # the spine's wrap, then one in each of the 2 groups' runs and one
    # more in each group's recompute in the backward
    assert wrapped.count("ssm_layer_apply") == 1 + 2 + 2
    monkeypatch.setattr(transformer, "_remat", lambda fn, c: fn)
    loss0, _, grads0 = lm.port_grads(model, cfg, pb)
    assert torch.equal(loss, loss0)
    for n, g in grads.items():
        assert torch.equal(g, grads0[n]), n


# ------------------------------------------------- serving, training, entry
def test_server_tokens_equal_reference():
    cfg, rm, rp, model = lm.pair(NAME, "float32")
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 5)).astype(np.int32)
    want = RefServer(rm.cfg, RefServeConfig(max_len=12), rp).generate(
        prompts, 7)
    got = Server(cfg, ServeConfig(max_len=12), model,
                 device="cpu").generate(prompts, 7)
    assert np.array_equal(got, want)


def test_trainer_matches_reference(tmp_path):
    lm.check_trainer(tmp_path, NAME)


def test_entry_points_take_the_family(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert serve_lm.main(["--arch", "zamba2-1.2b", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "3",
                              "--new-tokens", "3"]) == 0
        assert launch_train.main([
            "--arch", "zamba2-1.2b", "--reduced", "--steps", "2",
            "--device", "cpu", "--global-batch", "2", "--seq-len", "16",
            "--ckpt-dir", str(tmp_path)]) == 0
    assert "(hybrid) reduced" in out.getvalue()
    assert "final step 2" in out.getvalue()
