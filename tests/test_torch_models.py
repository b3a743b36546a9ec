"""The port's dense decoder LM (``repro_torch.models``) against the JAX
package's ``repro.models`` on the CPU.

The reference's parameters (``model.init(jax.random.key(k))``) are carried
into the port with ``convert.params_from_jax``; both packages then run the
same ``reduced()`` configs of the five dense-spine configs on the same
inputs, made from a seed with numpy:

* minicpm-2b (tied head, MHA: G = 1), qwen2.5-14b (QKV bias, G = 4 in the
  reduced config, rope theta 1e6, untied head), stablelm-12b,
  h2o-danube-3-4b (sliding window 32), internvl2-2b (embeddings input);
* ``forward`` (full, and chunked; the attention also with a small chunk)
  and every ``decode_step`` of a 16-step decode, held as max |d| / max
  |ref| of the logits: at most ``F32_TOL`` in f32 compute and
  ``BF16_TOL`` in the configs' bf16 compute;
* decode against the port's own ``forward`` in f32 (the reference's own
  bound, ``tests/test_models.py``), the sliding window, ``param_count``
  and every full-width parameter shape of all ten configs (on the
  ``meta`` device).  The other families are held against the reference
  in ``test_torch_moe.py``, ``test_torch_ssm.py``, ``test_torch_hybrid.py``
  and ``test_torch_encdec.py``.

Every intended difference between the two packages is named in
``DIFFERENCES``, and a test holds each name to the sources.
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
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import param_count as ref_count  # noqa: E402
from repro.models import modules as ref_modules  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.convert import (STACKED, params_from_jax,  # noqa: E402
                                 params_to_jax)
from repro_torch.models import attention, build_model, param_count  # noqa: E402
from repro_torch.models import modules, transformer  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE = ["minicpm_2b", "qwen2_5_14b", "stablelm_12b", "h2o_danube_3_4b",
         "internvl2_2b"]
# f32 compute: both packages reduce in another order, nothing else
F32_TOL = 1e-5
# bf16 compute: the same roundings in the same order, but XLA may keep an
# elementwise chain (silu x gate, the rotary halves) in f32 where the port
# rounds once per op; a few bf16 ulps (2^-8) of the largest logit
BF16_TOL = 2e-2
# decode against teacher-forced forward, the reference's own bound
# (tests/test_models.py::test_train_decode_consistency)
CONSISTENCY_TOL = 2e-3
B, S = 2, 16

# Where the port departs from the reference on purpose: (module under
# models/ or serving/, an identifier, the package whose source holds it
# and the other's does not, why).
DIFFERENCES = [
    ("models/modules.py", "generator", "port",
     "the port's own init draws: each weight is the reference's law (a "
     "truncated normal on [-2, 2] times its scale) drawn from a "
     "torch.Generator, not jax.random's draws; tests carry the reference's "
     "weights across with params_from_jax"),
    ("serving/decode.py", "_sample", "port",
     "temperature sampling's draws: Gumbel-max over torch.rand from a "
     "generator seeded by ServeConfig.seed, the law of "
     "jax.random.categorical with other draws"),
    ("dist/context.py", "with_sharding_constraint", "reference",
     "constrain returns its input (the local tensor): the reference hands "
     "each anchor to GSPMD as a layout hint; the port runs per-rank code, "
     "whose module code computes with the rank's blocks"),
    ("models/transformer.py", "_vocab_parallel_lookup", "port",
     "tensor parallelism over model as per-rank code "
     "(dist/tensor_parallel.py) where GSPMD splits at the anchors: every "
     "family's attention (GQA, MLA, the hybrid's shared block, the "
     "enc-dec's three), MLP, SSD heads, vocab and decode cache split, "
     "partial sums added in another order"),
    ("serving/decode.py", "device", "port",
     "Server(cfg, serve_cfg, model, device=...): the server takes the "
     "port's module (its parameters inside) and runs on the card unless "
     "the caller asks for the CPU; the model must lie there"),
    ("models/attention.py", "copy_", "port",
     "in-place cache writes: decode_step writes each layer's k and v at "
     "pos into the (L, B, max_len, KV, hd) cache and returns the same "
     "dict, where the reference returns an updated copy"),
]


def _identifiers(path) -> set:
    out = set()
    for node in ast.walk(ast.parse(open(path).read())):
        for attr in ("id", "attr", "arg", "name"):
            value = getattr(node, attr, None)
            if isinstance(value, str):
                out.add(value)
    return out


@pytest.mark.parametrize("module,name,where,why", DIFFERENCES,
                         ids=[f"{m}:{n}" for m, n, _, _ in DIFFERENCES])
def test_each_difference_is_in_one_source_only(module, name, where, why):
    port = _identifiers(os.path.join(REPO, "src", "repro_torch", module))
    ref = _identifiers(os.path.join(REPO, "src", "repro", module))
    has, lacks = (port, ref) if where == "port" else (ref, port)
    assert name in has and name not in lacks, (name, why)


# ------------------------------------------------------------------ helpers
@functools.lru_cache(maxsize=None)
def _pair(name, cd, key=1, **changes):
    """(cfg, reference model, reference params, port model) on the CPU."""
    rcfg = dataclasses.replace(ref_config(name).reduced(), compute_dtype=cd,
                               **changes)
    cfg = dataclasses.replace(get_config(name).reduced(), compute_dtype=cd,
                              **changes)
    rm = ref_build(rcfg)
    rp = rm.init(jax.random.key(key))
    model = params_from_jax(cfg, jax.tree.map(np.asarray, rp), device="cpu")
    return cfg, rm, rp, model


@functools.lru_cache(maxsize=None)
def _ref_step(name, cd):
    return jax.jit(_pair(name, cd)[1].decode_step)


def _inputs(cfg, seed=0, b=B, s=S):
    """(reference batch, port batch): tokens, or embeddings for the vlm."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        x = rng.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32)
        return {"embeds": jnp.asarray(x)}, {"embeds": torch.from_numpy(x)}
    x = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": jnp.asarray(x)}, {"tokens": torch.from_numpy(x)}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tol(cd):
    return F32_TOL if cd == "float32" else BF16_TOL


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("impl", ["full", "chunked"])
def test_forward_matches_reference(name, cd, impl):
    cfg, rm, rp, model = _pair(name, cd)
    rb, pb = _inputs(cfg)
    want, _ = ref_transformer.forward(rp, rm.cfg, rb, impl=impl)
    with torch.no_grad():
        got, aux = transformer.forward(model, cfg, pb, impl=impl)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert got.shape == (B, S, cfg.padded_vocab)
    rel = _rel(got, want)
    print(f"{name} {cd} {impl}: forward max|d|/max|ref| {rel:.3e}")
    assert rel <= _tol(cd), rel


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DENSE)
def test_attention_chunked_with_a_small_chunk(name, cd):
    """Layer 0's attention through four KV chunks of 4 (the online
    softmax's rescaling across chunks; a window of 32 never masks a
    whole chunk here), against the reference's and the port's full
    attention."""
    cfg, rm, rp, model = _pair(name, cd)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    dt = modules.dtype_of(cd)
    rp0 = jax.tree.map(lambda a: a[0], rp["dense_layers"]["attn"])
    pos = np.arange(S, dtype=np.int32)
    want = ref_attn.gqa_apply(rp0, rm.cfg, jnp.asarray(x).astype(
        jnp.dtype(cd)), positions=jnp.asarray(pos), impl="chunked", chunk=4)
    p0 = model.dense_layers[0].attn
    with torch.no_grad():
        got = attention.gqa_apply(p0, cfg, torch.from_numpy(x).to(dt),
                                  positions=torch.from_numpy(pos),
                                  impl="chunked", chunk=4)
        full = attention.gqa_apply(p0, cfg, torch.from_numpy(x).to(dt),
                                   positions=torch.from_numpy(pos))
    assert _rel(got.float(), np.asarray(want, np.float32)) <= _tol(cd)
    assert _rel(got.float(), full.float()) <= _tol(cd)


# ------------------------------------------------------------------- decode
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DENSE)
def test_every_decode_step_matches_reference(name, cd):
    cfg, rm, rp, model = _pair(name, cd)
    rb, pb = _inputs(cfg, seed=1)
    cache_dt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[cd]
    rc = rm.init_cache(B, S, dtype=cache_dt[0])
    pc = model.init_cache(B, S, dtype=cache_dt[1])
    assert pc["k"].shape == (cfg.num_layers, B, S, cfg.num_kv_heads,
                             cfg.head_dim)
    key = next(iter(rb))
    worst = 0.0
    for t in range(S):
        want, rc = _ref_step(name, cd)(rp, rc, rb[key][:, t:t + 1],
                                       jnp.int32(t))
        got, pc2 = model.decode_step(pc, pb[key][:, t:t + 1], t)
        assert pc2 is pc and got.shape == (B, 1, cfg.padded_vocab)
        rel = _rel(got, want)
        worst = max(worst, rel)
        assert rel <= _tol(cd), (t, rel)
    # the cache written in place equals the reference's returned cache
    for k in ("k", "v"):
        assert _rel(pc[k].float(), np.asarray(rc[k], np.float32)) \
            <= _tol(cd)
    print(f"{name} {cd}: worst decode step max|d|/max|ref| {worst:.3e}")


@pytest.mark.parametrize("name", DENSE)
def test_decode_reproduces_own_forward(name):
    cfg, _, _, model = _pair(name, "float32")
    _, pb = _inputs(cfg, seed=2)
    key = next(iter(pb))
    with torch.no_grad():
        ref, _ = model.forward(pb)
    cache = model.init_cache(B, S, dtype=torch.float32)
    dec = torch.cat([model.decode_step(cache, pb[key][:, t:t + 1], t)[0]
                     for t in range(S)], dim=1)
    assert _rel(dec, ref) < CONSISTENCY_TOL


def test_decode_in_f32_over_a_bf16_cache_matches_reference():
    """f32 compute over the default bf16 cache: both packages read the
    cache in f32 (``jnp.einsum``'s promotion)."""
    cfg, rm, rp, model = _pair("qwen2_5_14b", "float32")
    rb, pb = _inputs(cfg, seed=4)
    rc, pc = rm.init_cache(B, S), model.init_cache(B, S)
    assert pc["k"].dtype == torch.bfloat16
    for t in range(S):
        want, rc = _ref_step("qwen2_5_14b", "float32")(
            rp, rc, rb["tokens"][:, t:t + 1], jnp.int32(t))
        got, _ = model.decode_step(pc, pb["tokens"][:, t:t + 1], t)
        assert _rel(got, want) <= F32_TOL


def test_sliding_window_masks_history():
    """SWA: tokens beyond the window must not influence the logits, in
    forward and in decode (``tests/test_models.py``, mirrored)."""
    cfg, _, _, model = _pair("h2o_danube_3_4b", "float32", key=0,
                             sliding_window=4)
    rng = np.random.default_rng(2)
    n = 12
    t1 = rng.integers(0, cfg.vocab_size, (1, n))
    t2 = t1.copy()
    t2[0, 0:4] = (t2[0, 0:4] + 7) % cfg.vocab_size   # differ OUTSIDE window
    with torch.no_grad():
        l1, _ = model.forward({"tokens": torch.from_numpy(t1)})
        l2, _ = model.forward({"tokens": torch.from_numpy(t2)})
    np.testing.assert_allclose(l1[:, -1].numpy(), l2[:, -1].numpy(),
                               rtol=1e-5, atol=1e-5)
    last = []
    for toks in (t1, t2):
        cache = model.init_cache(1, n, dtype=torch.float32)
        for t in range(n):
            lg, _ = model.decode_step(
                cache, torch.from_numpy(toks[:, t:t + 1]), t)
        last.append(lg[:, -1].numpy())
    np.testing.assert_allclose(last[0], last[1], rtol=1e-5, atol=1e-5)
    assert not np.allclose(l1[:, 5].numpy(), l2[:, 5].numpy())


def test_gelu_mlp_matches_reference():
    """The ``gelu`` MLP (tanh form, ``jax.nn.gelu``'s default)."""
    cfg, rm, rp, model = _pair("minicpm_2b", "float32", mlp_type="gelu")
    assert not hasattr(model.dense_layers[0].mlp, "wg")
    rb, pb = _inputs(cfg)
    want, _ = rm.forward(rp, rb)
    with torch.no_grad():
        got, _ = model.forward(pb)
    assert _rel(got, want) <= F32_TOL


def test_rope_angles_equal_reference():
    """freqs built in numpy f64 and rounded once to f32: the angles equal
    the reference's exactly at theta 1e6 over 4096 positions."""
    pos = np.arange(4096, dtype=np.int32)
    for theta, dim in ((1e6, 128), (1e4, 64)):
        rc, rs = ref_modules.rope_angles(jnp.asarray(pos), dim, theta)
        c, s = modules.rope_angles(torch.from_numpy(pos),
                                   modules.rope_freqs(dim, theta))
        ang = torch.from_numpy(pos).float()[:, None] * \
            modules.rope_freqs(dim, theta)[None]
        want_ang = pos.astype(np.float32)[:, None] * \
            (1.0 / (theta ** (np.arange(dim // 2) * 2.0 / dim))
             ).astype(np.float32)
        np.testing.assert_array_equal(ang.numpy(), want_ang)
        np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=1e-6)
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=1e-6)


# ------------------------------------------------------------ params, shapes
@pytest.mark.parametrize("name", ASSIGNED)
def test_full_width_shapes_and_param_count_equal_reference(name):
    """Every parameter at full width and depth of each of the ten configs
    (the port on the ``meta`` device, the reference under
    ``jax.eval_shape``); a stacked leaf splits on its group's leading
    axes, two for the hybrid's ``group_layers``."""
    cfg = get_config(name)
    ref = jax.eval_shape(ref_build(ref_config(name)).init, jax.random.key(0))
    model = init_params(cfg, device="meta")
    assert param_count(model) == ref_count(ref)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        keys = [p.key for p in path]
        axes = STACKED.get(keys[0], 0)
        for index in np.ndindex(*leaf.shape[:axes]):
            want[".".join([keys[0], *map(str, index)] + keys[1:])] = \
                (tuple(leaf.shape[axes:]), str(leaf.dtype))
    got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for k, t in model.state_dict().items()}
    assert got == want
    if name == "minicpm_2b":
        assert param_count(model) == 2_725_173_504


def test_qwen_four_layers_count():
    cfg = dataclasses.replace(get_config("qwen2.5-14b"), num_layers=4)
    model = transformer.init_params(cfg, device="meta")
    assert param_count(model) == 2_658_214_912


@pytest.mark.parametrize("name", DENSE)
def test_reduced_param_count_equals_reference(name):
    cfg, _, rp, model = _pair(name, "bfloat16")
    assert param_count(model) == ref_count(rp)
    drawn = build_model(cfg, device="cpu")
    assert param_count(drawn) == ref_count(rp)


def test_params_round_trip_and_mismatches_raise():
    cfg, _, rp, model = _pair("qwen2_5_14b", "float32")
    tree = jax.tree.map(np.asarray, rp)
    back = params_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    missing = dict(tree)
    del missing["lm_head"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(cfg, missing, device="cpu")
    wrong = jax.tree.map(lambda a: a, tree)
    wrong["ln_f"] = {"scale": tree["ln_f"]["scale"].astype(np.float64)}
    with pytest.raises(ValueError, match="ln_f.scale"):
        params_from_jax(cfg, wrong, device="cpu")


def test_build_model_draws_the_reference_law():
    """The port's own draws: a truncated normal on [-2, 2] times each
    weight's scale (d_in^-0.5 for a projection), seeded by the generator."""
    cfg = get_config("minicpm_2b").reduced()
    a = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(5))
    b = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(5))
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb)
    w = a.dense_layers[0].attn.wq.w.detach()
    scale = cfg.d_model ** -0.5
    assert float(w.abs().max()) <= 2 * scale
    assert abs(float(w.std()) / scale - 0.88) < 0.05   # std of N(0,1)|[-2,2]
    assert torch.equal(a.ln_f.scale, torch.ones(cfg.d_model))
