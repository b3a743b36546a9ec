"""The port's SSM family (``repro_torch.models.ssm``, the ``ssm`` branches
of ``models/transformer.py``) against the JAX package's on the CPU, on
mamba2-370m's ``reduced()`` config, the reference's weights carried in by
``convert.params_from_jax`` (``torch_lm_support``):

* ``forward``, full and chunked, and every step of a 16-step decode:
  1e-5 in f32, 2e-2 in bf16; decode against the port's own forward at
  ``ssd_chunk=8``; the loss and every gradient against
  ``jax.value_and_grad``;
* ``mamba2_apply`` alone in both layouts (the fused ``in_proj`` and
  ``ssm_split_proj``) and with ``ssd_bf16``, ``mamba2_decode`` alone step
  by step with its state, ``_causal_conv``;
* the SSD's output does not depend on the chunk size (the port's and the
  reference's, chunks of 2 to 16);
* at the configs' own chunk of 256 the reference's masked ``exp``
  overflows and its gradients hold NaN; the port masks before the
  ``exp``, and its gradients there are finite and those of the
  reference at a chunk of 16 (``DIFFERENCES``);
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
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.modules import Rng  # noqa: E402
from repro.serving import ServeConfig as RefServeConfig  # noqa: E402
from repro.serving import Server as RefServer  # noqa: E402
from repro_torch.convert import _unstacked  # noqa: E402
from repro_torch.examples import serve_lm  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving import ServeConfig, Server  # noqa: E402

NAME = "mamba2_370m"
B, S = 2, 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the gradients at one chunk size against those at another: the SSD sums
# the same terms in another grouping, in f32
CHUNK_GRAD_TOL = 1e-4

# Where the port's SSM departs from the reference on purpose: (port file,
# reference file, an identifier, the side whose source holds it and the
# other's does not, why).  Paths are from the repo's root.
DIFFERENCES = [
    ("src/repro_torch/models/ssm.py", "src/repro/models/ssm.py", "inf",
     "port",
     "the intra-chunk decay masks diff with -inf before the exp, where the "
     "reference takes exp(diff) and masks after: the same values, but the "
     "reference's exp overflows above the diagonal once the chunk passes "
     "about 128 positions (the configs' 256), and its backward gives "
     "0 * inf = NaN; the port's gradients there are finite"),
    ("src/repro_torch/dist/context.py", "src/repro/dist/context.py",
     "NamedSharding", "reference",
     "the SSD's head-parallel anchors are no sharding hint: constrain "
     "returns its input, and under a mesh whose model axis divides the "
     "heads mamba2_apply and mamba2_decode compute this rank's heads "
     "in their module code"),
    ("src/repro_torch/models/ssm.py", "src/repro/models/ssm.py", "copy_",
     "port",
     "mamba2_decode writes the conv ring and the SSM state into the "
     "caller's state in place and returns it, where the reference returns "
     "a new state"),
    ("src/repro_torch/models/ssm.py", "src/repro/models/ssm.py",
     "_tp_projections", "port",
     "over model the fused in_proj and the conv stay whole on every rank "
     "behind copy_in, indexed at the rank's columns (its heads' z, x and "
     "dt, every group's B and C), where GSPMD splits the projection's "
     "output at the anchors: its [z | x | B | C | dt] segments are no "
     "one block per rank"),
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


def test_split_projections_match_reference():
    """``ssm_split_proj``: separate z/x/B/C/dt projections and convs; the
    decode materializes the fused layout for its cache."""
    lm.check_forward(NAME, "float32", "full", ssm_split_proj=True)
    lm.check_decode(NAME, "float32", ssm_split_proj=True)


# ------------------------------------------------------- the block alone
def _block(cd="float32", **changes):
    """(cfg, reference cfg, reference block params, port block) of one
    Mamba2 block drawn by the reference, carried in."""
    cfg = dataclasses.replace(lm.get_config(NAME).reduced(),
                              compute_dtype=cd, **changes)
    rcfg = dataclasses.replace(lm.ref_config(NAME).reduced(),
                               compute_dtype=cd, **changes)
    rp = ref_ssm.mamba2_init(Rng(jax.random.key(3)), rcfg, jnp.float32)
    # A_log, D and dt_bias start at constants: move them off, so the
    # decay and the skip are exercised
    rng = np.random.default_rng(8)
    h = cfg.ssm_heads
    rp = dict(rp, A_log=jnp.asarray(rng.uniform(-1, 1, h), jnp.float32),
              D=jnp.asarray(rng.uniform(0, 2, h), jnp.float32),
              dt_bias=jnp.asarray(rng.uniform(-1, 1, h), jnp.float32))
    p = ssm.mamba2_init(None, cfg, torch.float32)
    p.load_state_dict(_unstacked(jax.tree.map(np.asarray, rp)))
    return cfg, rcfg, rp, p


def _u(cfg, cd, seed=9, s=S):
    x = np.random.default_rng(seed).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cd]
    return jnp.asarray(x).astype(jnp.dtype(cd)), torch.from_numpy(x).to(dt)


@pytest.mark.parametrize("changes", [{}, {"ssm_split_proj": True},
                                     {"ssd_bf16": True}],
                         ids=["fused", "split", "ssd-bf16"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_mamba2_apply_matches_reference(cd, changes):
    cfg, rcfg, rp, p = _block(cd, **changes)
    assert hasattr(p, "in_proj") != bool(changes.get("ssm_split_proj"))
    uj, ut = _u(cfg, cd)
    want = ref_ssm.mamba2_apply(rp, rcfg, uj)
    with torch.no_grad():
        got = ssm.mamba2_apply(p, cfg, ut)
    assert got.dtype == ut.dtype
    assert lm.rel(got.float(), np.asarray(want, np.float32)) <= lm.tol(cd)


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
def test_mamba2_decode_matches_reference(split):
    """16 decode steps of one block: each output and the state (the conv
    ring, the f32 SSM state), written in place."""
    cfg, rcfg, rp, p = _block(ssm_split_proj=split)
    uj, ut = _u(cfg, "float32", seed=10)
    rs = ref_ssm.mamba2_decode_init(rcfg, B)
    ps = ssm.mamba2_decode_init(cfg, B)
    conv, state = ps["conv"], ps["ssm"]
    step = jax.jit(ref_ssm.mamba2_decode, static_argnums=1)
    for t in range(S):
        want, rs = step(rp, rcfg, uj[:, t:t + 1], rs)
        with torch.no_grad():
            got, ps2 = ssm.mamba2_decode(p, cfg, ut[:, t:t + 1], ps)
        assert ps2 is ps and ps["conv"] is conv and ps["ssm"] is state
        assert lm.rel(got, want) <= lm.F32_TOL, t
    for k in ("conv", "ssm"):
        assert lm.rel(ps[k], rs[k]) <= lm.F32_TOL, k


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b))
    got = ssm._causal_conv(*map(torch.from_numpy, (x, w, b)))
    assert lm.rel(got, want) <= 1e-6
    # causal: a change at position 5 leaves positions 0-4 as they were
    x2 = x.copy()
    x2[:, 5] += 1.0
    got2 = ssm._causal_conv(*map(torch.from_numpy, (x2, w, b)))
    assert torch.equal(got[:, :5], got2[:, :5])


@pytest.mark.parametrize("chunk", [2, 4, 8, 16])
def test_ssd_output_does_not_depend_on_the_chunk(chunk):
    """The chunked SSD is one function of the input whatever the chunk:
    the port's at each chunk size within 1e-5 of its own at 16 (one
    chunk: no inter-chunk state) and of the reference's at the same
    chunk; a chunk that does not divide the sequence raises."""
    cfg, rcfg, rp, p = _block()
    uj, ut = _u(cfg, "float32", seed=12, s=32)
    with torch.no_grad():
        whole = ssm.mamba2_apply(p, dataclasses.replace(cfg, ssd_chunk=32),
                                 ut)
        got = ssm.mamba2_apply(p, dataclasses.replace(cfg, ssd_chunk=chunk),
                               ut)
    want = ref_ssm.mamba2_apply(rp, dataclasses.replace(rcfg,
                                                        ssd_chunk=chunk), uj)
    assert lm.rel(got, whole) <= lm.F32_TOL
    assert lm.rel(got, want) <= lm.F32_TOL
    with pytest.raises(ValueError, match="multiple"):
        ssm.mamba2_apply(p, dataclasses.replace(cfg, ssd_chunk=12), ut)


def test_long_chunk_gradients_are_finite_where_the_reference_overflows():
    """The configs' chunk of 256 over 256 positions, f32: the reference's
    gradients hold NaN (its masked exp overflowed); the port's are finite,
    its loss the reference's, and each gradient leaf within
    ``CHUNK_GRAD_TOL`` of the reference's at a chunk of 16."""
    cfg, rm, rp, model = lm.pair(NAME, "float32", ssd_chunk=256)
    _, rm16, _, _ = lm.pair(NAME, "float32", ssd_chunk=16)
    rng = np.random.default_rng(14)
    toks = rng.integers(0, cfg.vocab_size, (1, 256)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (1, 256)).astype(np.int32)
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    grad = jax.jit(jax.value_and_grad(rm.loss, has_aux=True))
    (want_loss, _), want = grad(rp, rb)
    assert any(np.isnan(np.asarray(g)).any() for g in jax.tree.leaves(want))
    (_, _), want16 = jax.jit(jax.value_and_grad(rm16.loss, has_aux=True))(
        rp, rb)
    loss, _, grads = lm.port_grads(model, cfg, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert abs(float(loss) - float(want_loss)) <= \
        lm.F32_TOL * abs(float(want_loss))
    want16 = lm.leaves(jax.tree.map(np.asarray, want16))
    for key, names in adamw.leaf_groups(grads).items():
        got = np.stack([grads[n].numpy() for n in names]).reshape(
            want16[key].shape)
        assert np.isfinite(got).all(), key
        assert lm.rel(got, want16[key]) <= CHUNK_GRAD_TOL, key


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
        assert serve_lm.main(["--arch", "mamba2-370m", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "3",
                              "--new-tokens", "3"]) == 0
        assert launch_train.main([
            "--arch", "mamba2-370m", "--reduced", "--steps", "2",
            "--device", "cpu", "--global-batch", "2", "--seq-len", "16",
            "--ckpt-dir", str(tmp_path)]) == 0
    assert "(ssm) reduced" in out.getvalue()
    assert "final step 2" in out.getvalue()
