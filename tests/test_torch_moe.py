"""The port's MoE family (``repro_torch.models.moe``, MLA in
``models/attention.py``, the ``moe`` branches of ``models/transformer.py``)
against the JAX package's on the CPU, on the ``reduced()`` configs of
dbrx-132b (GQA, 4 experts top-2 in the reduced config) and
deepseek-v2-236b (MLA, one dense layer then a MoE layer with a shared
expert), the reference's weights carried in by ``convert.params_from_jax``
(``torch_lm_support``):

* ``forward``, full and chunked, the aux loss, and every step of a
  16-step decode: 1e-5 in f32, 2e-2 in bf16;
* decode against the port's own forward at ``capacity_factor=8.0``
  (the reference's consistency settings), the loss and every gradient
  against ``jax.value_and_grad``;
* ``moe_apply`` alone on identical inputs (the routing ``top_e`` equal
  first, then the outputs), the twin of ``test_moe_routing_actually_sparse``,
  the capacity on the host, ``mla_apply`` and ``mla_decode`` alone with
  and without ``q_lora_rank``;
* ``Server.generate`` and the Trainer against the reference's, and the
  entry points with ``--arch``; ``moe_layer``'s choice of the sharded
  layer under a ``model`` axis.

In bf16 a last-bit difference in the router's logits could pick another
expert; on these inputs the picks agree (``top_e`` is held equal) and the
bf16 bound is the dense family's 2e-2, not widened.  Every intended
difference is named in ``DIFFERENCES`` and held to the sources.
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
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.serving import ServeConfig as RefServeConfig  # noqa: E402
from repro.serving import Server as RefServer  # noqa: E402
from repro_torch.examples import serve_lm  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention, moe  # noqa: E402
from repro_torch.serving import ServeConfig, Server  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["dbrx_132b", "deepseek_v2_236b"]

# Where the port's MoE departs from the reference on purpose: (port file,
# reference file, an identifier, the side whose source holds it and the
# other's does not, why).  Paths are from the repo's root.
DIFFERENCES = [
    ("src/repro_torch/models/moe.py", "src/repro/models/moe.py",
     "shard_map", "reference",
     "moe_apply_sharded is per-rank code, not a shard_map: x is this "
     "rank's rows, the expert weights all E (the rank takes its block) or "
     "only its E/tp, and its gradients are those of its data shard's "
     "objective (aux: this shard's, its value averaged over the data "
     "axes), which the sharded train step averages"),
    ("src/repro_torch/models/moe.py", "src/repro/models/moe.py",
     "ReduceOut", "port",
     "psum(combined, 'model') is an all_reduce whose backward is the "
     "identity (tensor_parallel.ReduceOut): torch.distributed.nn's "
     "all-reduce would send another all-reduce back, tp times the "
     "reference's gradient"),
    ("src/repro_torch/models/moe.py", "src/repro/models/moe.py",
     "_combine", "port",
     "the slabs and the combine are gathers, not scatter-adds: each token's "
     "k contributions are added in the reference's order (by expert id), "
     "rounding in the compute dtype after each, with no atomics on the "
     "card, so greedy tokens repeat bit for bit"),
    ("src/repro_torch/models/attention.py", "src/repro/models/attention.py",
     "copy_", "port",
     "mla_decode writes this token's ckv and kr at pos into the cache in "
     "place, as gqa_decode writes k and v"),
    ("src/repro_torch/models/attention.py", "src/repro/models/attention.py",
     "_mla_decode_tp", "port",
     "MLA's absorbed decode over model reads wuk and wuv by latent rows "
     "where the reference's serve-mode spec splits them by head columns: "
     "a serving rank holds both whole (sharding.tp_blocks, design (a)), "
     "its prefill takes their head columns and its decode their rows of "
     "its latent block, so no step exchanges q_eff or ctx over model"),
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
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name, cd, impl):
    lm.check_forward(name, cd, impl)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_every_decode_step_matches_reference(name, cd):
    lm.check_decode(name, cd)


@pytest.mark.parametrize("name", NAMES)
def test_decode_reproduces_own_forward(name):
    lm.check_consistency(name)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_every_gradient_match_reference(name):
    lm.check_grads(name)


def test_mla_with_q_lora_matches_reference():
    """deepseek's full config compresses q too (``q_lora_rank``), which
    the reduced config turns off: the whole model with a rank of 16."""
    lm.check_forward("deepseek_v2_236b", "float32", "full", q_lora_rank=16)
    lm.check_decode("deepseek_v2_236b", "float32", q_lora_rank=16)


# ------------------------------------------------------------ the MoE alone
def _moe_pair(cd):
    cfg, rm, rp, model = lm.pair("dbrx_132b", cd)
    rp0 = jax.tree.map(lambda a: a[0], rp["moe_layers"]["moe"])
    return cfg, rm.cfg, rp0, model.moe_layers[0].moe


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_moe_apply_matches_reference(cd):
    """One MoE layer on identical inputs: the routing first (each token's
    top-k experts equal), then the output and the aux loss."""
    cfg, rcfg, rp0, p = _moe_pair(cd)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cd]
    xj = jnp.asarray(x).astype(jnp.dtype(cd))
    xt = torch.from_numpy(x).to(dt)
    logits = jnp.einsum("td,de->te", xj.reshape(-1, cfg.d_model).astype(
        jnp.float32), rp0["router"]["w"].astype(jnp.float32))
    _, want_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    gates = torch.softmax(xt.reshape(-1, cfg.d_model).float()
                          @ p.router.w.float(), dim=-1)
    _, got_e = torch.topk(gates, cfg.top_k, dim=-1)
    assert np.array_equal(got_e.numpy(), np.asarray(want_e))
    want, want_aux = ref_moe.moe_apply(rp0, rcfg, xj)
    with torch.no_grad():
        got, aux = moe.moe_apply(p, cfg, xt)
    assert got.dtype == dt
    assert lm.rel(got.float(), np.asarray(want, np.float32)) <= lm.tol(cd)
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * float(want_aux)


def test_moe_drops_past_capacity_as_the_reference():
    """Fewer slots than routed tokens (capacity_factor 0.5): the same
    tokens are dropped in both packages."""
    cfg, rcfg, rp0, p = _moe_pair("float32")
    cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    rcfg = dataclasses.replace(rcfg, capacity_factor=0.5)
    x = np.random.default_rng(5).standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32)
    assert moe.capacity(cfg, 16) == 4
    want, _ = ref_moe.moe_apply(rp0, rcfg, jnp.asarray(x))
    with torch.no_grad():
        got, _ = moe.moe_apply(p, cfg, torch.from_numpy(x))
    assert lm.rel(got, want) <= lm.F32_TOL


def test_moe_routing_actually_sparse():
    """Zeroing one expert's weights must change only the tokens routed to
    it (``tests/test_models.py``'s test, on the port)."""
    cfg = dataclasses.replace(lm.get_config("dbrx_132b").reduced(),
                              compute_dtype="float32")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        out1, aux = moe.moe_apply(p, cfg, x)
        assert np.isfinite(float(aux))
        p.wo.w[0] = 0.0
        out2, _ = moe.moe_apply(p, cfg, x)
    changed = ((out1 - out2).abs() > 1e-7).any(dim=-1)
    assert 0 < int(changed.sum()) < x.shape[1]


def test_capacity_is_the_reference_rounding():
    """``int(max(1, round(t * k / e * cf)))`` on the host: deepseek's
    decode at B = 2 gets one slot per expert, its consistency setting
    (capacity_factor >= E / k) at least t."""
    cfg = lm.get_config("deepseek_v2_236b")
    assert moe.capacity(cfg, 2) == 1
    wide = dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                               / cfg.top_k)
    assert moe.capacity(wide, 2) >= 2
    for t in (1, 2, 7, 16, 4096):
        for c in (lm.get_config("dbrx_132b"), cfg):
            assert moe.capacity(c, t) == int(max(1, round(
                t * c.top_k / c.num_experts * c.capacity_factor)))


def test_moe_layer_is_sharded_under_a_model_axis(monkeypatch):
    """Under a mesh with a ``model`` axis ``moe_layer`` runs
    ``moe_apply_sharded`` on that mesh; without one (or with no ``model``
    axis) ``moe_apply`` (tests/test_torch_expert_parallel.py runs the
    sharded layer on gloo ranks)."""
    import repro_torch.dist as dist

    class Mesh:
        mesh_dim_names = ("data", "model")
    mesh = Mesh()
    cfg, _, _, p = _moe_pair("float32")
    x = torch.zeros((1, 4, cfg.d_model))
    calls = []
    monkeypatch.setattr(moe, "moe_apply_sharded",
                        lambda *a: calls.append(a) or ("sharded", None))
    monkeypatch.setattr(dist, "get_mesh", lambda: mesh)
    assert moe.moe_layer(p, cfg, x)[0] == "sharded"
    assert calls[0][3] is mesh and calls[0][2] is x
    mesh.mesh_dim_names = ("data",)
    assert moe.moe_layer(p, cfg, x)[0].shape == x.shape
    monkeypatch.setattr(dist, "get_mesh", lambda: None)
    assert moe.moe_layer(p, cfg, x)[0].shape == x.shape
    assert len(calls) == 1


# ------------------------------------------------------------- MLA alone
@pytest.mark.parametrize("q_lora", [0, 16], ids=["no-q-lora", "q-lora"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_mla_apply_and_decode_match_reference(cd, q_lora):
    """Layer 0's MLA: the non-absorbed prefill, full and in chunks of 4,
    and the absorbed decode over a 16-position cache, all against the
    reference's."""
    cfg, rm, rp, model = lm.pair("deepseek_v2_236b", cd, q_lora_rank=q_lora)
    rp0 = jax.tree.map(lambda a: a[0], rp["dense_layers"]["attn"])
    p0 = model.dense_layers[0].attn
    assert hasattr(p0, "wuq") == bool(q_lora)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cd]
    xj, xt = jnp.asarray(x).astype(jnp.dtype(cd)), torch.from_numpy(x).to(dt)
    pos = np.arange(16, dtype=np.int32)
    for impl, chunk in (("full", 1024), ("chunked", 4)):
        want = ref_attn.mla_apply(rp0, rm.cfg, xj, positions=jnp.asarray(pos),
                                  impl=impl, chunk=chunk)
        with torch.no_grad():
            got = attention.mla_apply(p0, cfg, xt,
                                      positions=torch.from_numpy(pos),
                                      impl=impl, chunk=chunk)
        assert lm.rel(got.float(), np.asarray(want, np.float32)) \
            <= lm.tol(cd), impl
    cdt = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}[cd]
    rc = (jnp.zeros((2, 16, cfg.kv_lora_rank), cdt[0]),
          jnp.zeros((2, 16, cfg.rope_head_dim), cdt[0]))
    pc = (torch.zeros((2, 16, cfg.kv_lora_rank), dtype=cdt[1]),
          torch.zeros((2, 16, cfg.rope_head_dim), dtype=cdt[1]))
    ref_decode = jax.jit(ref_attn.mla_decode, static_argnums=1)
    for t in range(16):
        want, *rc = ref_decode(rp0, rm.cfg, xj[:, t:t + 1], *rc,
                               jnp.int32(t))
        with torch.no_grad():
            got, ckv, kr = attention.mla_decode(p0, cfg, xt[:, t:t + 1],
                                                *pc, t)
        assert ckv is pc[0] and kr is pc[1]
        assert lm.rel(got.float(), np.asarray(want, np.float32)) \
            <= lm.tol(cd), t
    for g, w in zip(pc, rc):
        assert lm.rel(g.float(), np.asarray(w, np.float32)) <= lm.tol(cd)


# ------------------------------------------------- serving, training, entry
@pytest.mark.parametrize("name", NAMES)
def test_server_tokens_equal_reference(name):
    """Greedy ``generate`` in f32 compute over the default bf16 cache:
    the tokens equal the reference server's."""
    cfg, rm, rp, model = lm.pair(name, "float32")
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 5)).astype(np.int32)
    want = RefServer(rm.cfg, RefServeConfig(max_len=12), rp).generate(
        prompts, 7)
    got = Server(cfg, ServeConfig(max_len=12), model,
                 device="cpu").generate(prompts, 7)
    assert got.dtype == np.int32 and np.array_equal(got, want)


def test_trainer_matches_reference(tmp_path):
    lm.check_trainer(tmp_path, "deepseek_v2_236b")


@pytest.mark.parametrize("name", ["dbrx-132b", "deepseek-v2-236b"])
def test_entry_points_take_the_family(tmp_path, name):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert serve_lm.main(["--arch", name, "--device", "cpu",
                              "--batch", "2", "--prompt-len", "3",
                              "--new-tokens", "3"]) == 0
        assert launch_train.main([
            "--arch", name, "--reduced", "--steps", "2", "--device", "cpu",
            "--global-batch", "2", "--seq-len", "16",
            "--ckpt-dir", str(tmp_path)]) == 0
    assert "(moe) reduced" in out.getvalue()
    assert "final step 2" in out.getvalue()
