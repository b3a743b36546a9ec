"""The port's serving loop (``repro_torch.serving``) and its entry point
(``repro_torch.examples.serve_lm``) against the JAX package's on the CPU.

The reference's weights are carried into the port (``params_from_jax``):
greedy tokens must equal the reference's ``Server.generate`` in f32
compute; in the configs' bf16 compute they must equal up to the first
step where the reference's top-2 logits lie within ``BF16_TOL`` of each
other (a near tie that a last-bit difference may flip), and the test
prints that step.  The reference's own serving tests
(``tests/test_serving.py``) are mirrored on the port: greedy
determinism, batch independence, tokens below ``padded_vocab``."""
import contextlib
import dataclasses
import io
import os
import re
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.serving import ServeConfig as RefServeConfig  # noqa: E402
from repro.serving import Server as RefServer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.examples import serve_lm  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import ServeConfig, Server  # noqa: E402
from repro_torch.serving.decode import _sample  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN_CONFIGS = ["minicpm_2b", "qwen2_5_14b", "stablelm_12b",
                 "h2o_danube_3_4b"]
# the bf16 logits tolerance of tests/test_torch_models.py
BF16_TOL = 2e-2
BATCH, PROMPT, NEW = 3, 8, 10


def _pair(name, cd):
    rcfg = dataclasses.replace(ref_config(name).reduced(), compute_dtype=cd)
    cfg = dataclasses.replace(get_config(name).reduced(), compute_dtype=cd)
    rp = ref_build(rcfg).init(jax.random.key(2))
    return rcfg, rp, cfg, params_from_jax(cfg, jax.tree.map(np.asarray, rp),
                                          device="cpu")


def _prompts(cfg, seed=0, b=BATCH, n=PROMPT):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32)


@pytest.mark.parametrize("name", TOKEN_CONFIGS)
def test_greedy_tokens_equal_reference_in_f32(name):
    rcfg, rp, cfg, model = _pair(name, "float32")
    prompts = _prompts(cfg)
    want = RefServer(rcfg, RefServeConfig(max_len=32), rp).generate(
        prompts, NEW)
    got = Server(cfg, ServeConfig(max_len=32), model,
                 device="cpu").generate(prompts, NEW)
    assert got.dtype == np.int32 and got.shape == (BATCH, NEW)
    np.testing.assert_array_equal(got, want)


def _reference_greedy_logits(rcfg, rp, prompts, n_new, max_len):
    """The reference server's greedy loop, keeping each step's logits."""
    model = ref_build(rcfg)
    step = jax.jit(model.decode_step)
    b, plen = prompts.shape
    cache = model.init_cache(b, max_len)
    for t in range(plen):
        logits, cache = step(rp, cache, jnp.asarray(prompts[:, t:t + 1]),
                             jnp.int32(t))
    toks, seen = [], []
    for i in range(n_new):
        lg = np.asarray(logits[:, -1])
        seen.append(lg)
        tok = lg.argmax(axis=-1).astype(np.int32)
        toks.append(tok)
        logits, cache = step(rp, cache, jnp.asarray(tok[:, None]),
                             jnp.int32(plen + i))
    return np.stack(toks, axis=1), np.stack(seen, axis=1)


@pytest.mark.parametrize("name", TOKEN_CONFIGS)
def test_greedy_tokens_in_bf16_equal_until_a_near_tie(name):
    rcfg, rp, cfg, model = _pair(name, "bfloat16")
    prompts = _prompts(cfg, seed=1)
    want, logits = _reference_greedy_logits(rcfg, rp, prompts, NEW, 32)
    np.testing.assert_array_equal(
        want, RefServer(rcfg, RefServeConfig(max_len=32), rp).generate(
            prompts, NEW))
    got = Server(cfg, ServeConfig(max_len=32), model,
                 device="cpu").generate(prompts, NEW)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= \
        BF16_TOL * np.abs(logits).max(axis=-1)
    for row in range(BATCH):
        first = int(np.argmax(near[row])) if near[row].any() else NEW
        agree = int(np.argmin(got[row] == want[row])) \
            if (got[row] != want[row]).any() else NEW
        print(f"{name} row {row}: first near tie at step {first}, tokens "
              f"agree through step {agree - 1}")
        np.testing.assert_array_equal(got[row, :first], want[row, :first])


@pytest.mark.parametrize("name", ["minicpm_2b", "qwen2_5_14b"])
def test_greedy_generation_deterministic(name):
    cfg = get_config(name).reduced()
    model = build_model(cfg, device="cpu")
    srv = Server(cfg, ServeConfig(max_len=48), model, device="cpu")
    prompts = _prompts(cfg, b=3, n=8)
    a = srv.generate(prompts, 6)
    b = srv.generate(prompts, 6)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (3, 6)
    assert (a >= 0).all() and (a < cfg.padded_vocab).all()


def test_batch_independence():
    """Each batch row's continuation depends only on its own prompt."""
    cfg = get_config("minicpm_2b").reduced()
    srv = Server(cfg, ServeConfig(max_len=32), build_model(cfg, device="cpu"),
                 device="cpu")
    p = _prompts(cfg, seed=1, b=2, n=6)
    both = srv.generate(p, 4)
    solo0 = srv.generate(p[0:1], 4)
    np.testing.assert_array_equal(both[0], solo0[0])


def test_temperature_sampling_repeatable_per_seed():
    rcfg, rp, cfg, model = _pair("qwen2_5_14b", "float32")
    prompts = _prompts(cfg)
    runs = [Server(cfg, ServeConfig(max_len=32, temperature=1.0, seed=s),
                   model, device="cpu").generate(prompts, NEW)
            for s in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert all((r >= 0).all() and (r < cfg.padded_vocab).all() for r in runs)


def test_sample_draws_the_categorical_law():
    """``_sample`` draws softmax(logits / T): frequencies over 20,000 rows
    within 0.015 of the probabilities (about five standard errors)."""
    logits = torch.tensor([2.0, 1.0, 0.0, -1.0, 0.5])
    t = 0.7
    gen = torch.Generator().manual_seed(0)
    draws = _sample(logits.expand(20_000, 5), t, gen)
    freq = torch.bincount(draws, minlength=5).double() / 20_000
    want = torch.softmax(logits.double() / t, dim=0)
    assert float((freq - want).abs().max()) < 0.015


def test_server_refuses_a_model_elsewhere_and_a_long_request():
    cfg = get_config("minicpm_2b").reduced()
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="lie on"):
        Server(cfg, ServeConfig(), model, device="meta")
    srv = Server(cfg, ServeConfig(max_len=10), model, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        srv.generate(_prompts(cfg, n=8), 3)


def _run_reference_script(argv):
    path = os.path.join(REPO, "examples", "serve_lm.py")
    out = io.StringIO()
    old = sys.argv
    sys.argv = [path] + argv
    try:
        with contextlib.redirect_stdout(out):
            exec(compile(open(path).read(), path, "exec"),
                 {"__name__": "__main__", "__file__": path})
    finally:
        sys.argv = old
    return out.getvalue()


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen2.5-14b"])
def test_serve_lm_beside_the_reference_script(arch):
    """The entry point at the reference script's sizes: the same config
    and parameter count, batch x new tokens, every token in range."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve_lm.main(["--device", "cpu", "--arch", arch])
    assert rc == 0
    got, want = out.getvalue(), _run_reference_script(["--arch", arch])
    assert got.splitlines()[0] == want.splitlines()[0]   # name, params
    assert re.search(r"generated 4x24 tokens", got)
    rows = re.findall(r"request \d+: \[(.*)\]", got)
    assert len(rows) == len(re.findall(r"request \d+:", want)) == 4
    vocab = get_config(arch).padded_vocab
    for row in rows:
        toks = [int(x) for x in row.split(",")]
        assert len(toks) == 24 and all(0 <= x < vocab for x in toks)
