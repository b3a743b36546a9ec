"""The port's enc-dec family (``repro_torch.models.encdec``) against the
JAX package's on the CPU, on seamless-m4t-large-v2's ``reduced()`` config
(2 encoder and 2 decoder layers over 8 frame embeddings), the reference's
weights carried in by ``convert.params_from_jax`` (``torch_lm_support``):

* ``forward``, full and chunked, and every step of a 16-step decode over
  a memory filled by ``prefill_memory``: 1e-5 in f32, 2e-2 in bf16;
  decode against the port's own forward; the loss (no aux term) and
  every gradient against ``jax.value_and_grad``;
* ``encode`` and ``prefill_memory`` alone, the encoder's attention
  bidirectional, the cache's shapes from ``init_cache(..., enc_len)``;
* ``Server.generate`` over the zeroed memory of ``init_cache(b,
  max_len)``, as the reference's server gives it, and the Trainer against
  the reference's, and the entry points with ``--arch``.
"""
import ast
import contextlib
import io
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_lm_support as lm  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
from repro.serving import ServeConfig as RefServeConfig  # noqa: E402
from repro.serving import Server as RefServer  # noqa: E402
from repro_torch.examples import serve_lm  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.serving import ServeConfig, Server  # noqa: E402

NAME = "seamless_m4t_large_v2"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Where the port's enc-dec departs from the reference on purpose: (port
# file, reference file, an identifier, the side whose source holds it and
# the other's does not, why).  Paths are from the repo's root.
DIFFERENCES = [
    ("src/repro_torch/models/encdec.py", "src/repro/models/encdec.py",
     "EncDec", "port",
     "the parameters live in an EncDec module whose forward, loss, "
     "init_cache(batch, max_len, enc_len=1024, dtype), prefill_memory and "
     "decode_step run under its config: the reference's Model facade of "
     "models/model.py over a params pytree"),
    ("src/repro_torch/launch/mesh.py", "src/repro/launch/mesh.py",
     "compat", "reference",
     "dist/compat.py has no counterpart: it wraps shard_map and make_mesh "
     "across jax releases; the port's meshes are DeviceMeshes over the "
     "default process group (repro_torch.dist.make_mesh) and its SPMD "
     "code is per-rank"),
    ("src/repro_torch/models/encdec.py", "src/repro/models/encdec.py",
     "_mem_block", "port",
     "prefill_memory fills this rank's block of the memory's k and v "
     "(its KV heads, head_dim slice or positions) and the decode's "
     "cross-attention reads it (_cross_decode); in the KV-length layout "
     "a memory whose length the model axis does not divide is held as "
     "blocks of ceil(S / m) positions, the last shorter or empty, where "
     "the reference's cache_specs leave such a memory whole"),
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


# ------------------------------------------------------ encoder and memory
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_encode_and_prefill_memory_match_reference(cd):
    cfg, rm, rp, model = lm.pair(NAME, cd)
    rb, pb = lm.inputs(cfg, seed=5)
    want = ref_encdec.encode(rp, rm.cfg, rb["embeds"])
    with torch.no_grad():
        got = encdec.encode(model, cfg, pb["embeds"])
    assert got.shape == (lm.B, lm.ENC_LEN, cfg.d_model)
    assert lm.rel(got.float(), np.asarray(want, np.float32)) <= lm.tol(cd)
    rc = rm.init_cache(lm.B, 4, enc_len=3)
    pc = model.init_cache(lm.B, 4, enc_len=3)
    assert {k: tuple(v.shape) for k, v in pc.items()} == \
        {k: tuple(v.shape) for k, v in rc.items()}
    assert pc["mem_k"].dtype == torch.bfloat16
    rc = ref_encdec.prefill_memory(rp, rm.cfg, rc, rb["embeds"])
    filled = model.prefill_memory(pc, pb["embeds"])
    assert filled["k"] is pc["k"] and filled["v"] is pc["v"]
    for k in ("mem_k", "mem_v"):
        assert filled[k].shape == tuple(rc[k].shape)
        assert lm.rel(filled[k].float(), np.asarray(rc[k], np.float32)) \
            <= lm.tol("bfloat16"), k


def test_encoder_attention_is_bidirectional():
    """A change at the last frame moves the memory at the first: the
    encoder attends both ways (the decoder's self-attention does not)."""
    cfg, _, _, model = lm.pair(NAME, "float32")
    _, pb = lm.inputs(cfg, seed=6)
    e2 = pb["embeds"].clone()
    e2[:, -1] += 1.0
    with torch.no_grad():
        m1 = encdec.encode(model, cfg, pb["embeds"])
        m2 = encdec.encode(model, cfg, e2)
        t2 = pb["tokens"].clone()
        t2[:, -1] = (t2[:, -1] + 1) % cfg.vocab_size
        l1, _ = model.forward(pb)
        l2, _ = model.forward({"embeds": pb["embeds"], "tokens": t2})
    assert not torch.allclose(m1[:, 0], m2[:, 0])
    assert torch.equal(l1[:, :-1], l2[:, :-1])


# ------------------------------------------------- serving, training, entry
def test_server_tokens_equal_reference():
    """The server's cache has ``init_cache(b, max_len)``'s zeroed memory
    of 1024 positions in both packages."""
    cfg, rm, rp, model = lm.pair(NAME, "float32")
    assert model.init_cache(1, 4)["mem_k"].shape[2] == 1024
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
        assert serve_lm.main(["--arch", "seamless-m4t-large-v2",
                              "--device", "cpu", "--batch", "2",
                              "--prompt-len", "3", "--new-tokens", "3"]) == 0
        assert launch_train.main([
            "--arch", "seamless-m4t-large-v2", "--reduced", "--steps", "2",
            "--device", "cpu", "--global-batch", "2", "--seq-len", "16",
            "--ckpt-dir", str(tmp_path)]) == 0
    assert "(encdec-audio) reduced" in out.getvalue()
    assert "final step 2" in out.getvalue()
