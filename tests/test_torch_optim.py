"""The port's optimizer (``repro_torch.optim``) against the JAX package's
``repro.optim`` on the CPU, on the same inputs made from a seed with
numpy:

* the cosine and WSD schedules at a grid of steps (warmup, plateau,
  decay, past the end) within ``TOL`` relative;
* ``apply_updates`` over 5 steps for {cosine, wsd} x {none, int8} on the
  reduced minicpm's parameters and the same gradients, every parameter,
  m and v (or v_q and v_scale) and the metrics within ``TOL`` (max |d| /
  max |ref| per reference leaf; the int8 codes as stated below);
* the global norm over the reference's leaves in its order; the state's
  layout; the in-place step (``donate=True``) bitwise equal to the
  out-of-place one, which leaves the old state untouched; a ``None``
  gradient bitwise the zeros;
* the reference's leaves where a group stacks on two axes (the hybrid's
  ``group_layers``, (groups, layers per group)): ``leaf_groups`` strips
  every layer index, and int8 AdamW on the reduced zamba2 keeps one
  ``v_scale`` per reference leaf, equal to the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import schedules as ref_schedules  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (_unstacked, params_from_jax,  # noqa: E402
                                 train_state_to_jax)
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.train.trainer import put_batch  # noqa: E402

TOL = 1e-6
STEPS = 5
# the schedules' grid: (peak_lr, warmup, total) and the steps to read
SCHEDULES = [(3e-4, 100, 10_000), (1e-3, 20, 300), (1e-3, 3, 30),
             (2e-4, 0, 7)]
GRID_STEPS = [0, 1, 2, 3, 7, 19, 20, 21, 99, 100, 101, 269, 270, 271, 285,
              299, 300, 301, 5000, 8999, 9000, 9500, 10_000, 12_000]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's small CPU steps: they run
    faster so, and the test workers' thread pools do not oversubscribe
    the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else \
        float(np.abs(got).max())


def _ref_leaves(tree) -> dict:
    return {".".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(named) -> dict:
    """The port's tensors by state-dict name as the reference's leaves
    (layers stacked), through ``train_state_to_jax``'s stacking."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[".".join(prefix + (k,))] = v
    walk(named, ())
    return flat


# -------------------------------------------------------------- schedules
@pytest.mark.parametrize("peak,warmup,total", SCHEDULES)
@pytest.mark.parametrize("name", ["cosine", "wsd"])
def test_schedule_matches_reference(name, peak, warmup, total):
    steps_ = np.array(GRID_STEPS, np.int32)
    fn, kw = schedules.make_schedule(name, peak_lr=peak, warmup=warmup,
                                     total=total)
    rfn, rkw = ref_schedules.make_schedule(name, peak_lr=peak,
                                           warmup=warmup, total=total)
    got = fn(torch.from_numpy(steps_), **kw)
    want = np.asarray(rfn(jnp.asarray(steps_), **rkw))
    assert got.dtype == torch.float32
    for s, g, w in zip(steps_, got.numpy(), want):
        assert abs(float(g) - float(w)) <= TOL * abs(float(w)), (s, g, w)
    # a device int32 scalar gives a device f32 scalar
    one = fn(torch.tensor(warmup + 1, dtype=torch.int32), **kw)
    assert one.shape == () and one.dtype == torch.float32


# ------------------------------------------------------------ the updates
def _setup(seed=0, name="minicpm_2b"):
    """The reference's reduced parameters of ``name`` and the port's
    copy."""
    rcfg = ref_config(name).reduced()
    rp = ref_build(rcfg).init(jax.random.key(seed))
    model = params_from_jax(get_config(name).reduced(),
                            jax.tree.map(np.asarray, rp), device="cpu")
    return rp, model


def _grads(rp, step):
    """Gradients for both packages: per leaf a normal draw at a scale of
    its own, a few exact zeros among them."""
    rng = np.random.default_rng(100 + step)
    leaves, treedef = jax.tree.flatten(rp)
    arrs = []
    for i, leaf in enumerate(leaves):
        g = rng.standard_normal(leaf.shape).astype(np.float32)
        g *= np.float32(10.0 ** rng.uniform(-4, 1))
        g[rng.random(leaf.shape) < 0.01] = 0.0
        arrs.append(g)
    tree = jax.tree.unflatten(treedef, arrs)
    # each stacked leaf split on its group's leading axes, as the port
    # holds it
    named = {k: v.clone() for k, v in _unstacked(tree).items()}
    return jax.tree.map(jnp.asarray, tree), named


@pytest.mark.parametrize("quantize_v", ["none", "int8"])
@pytest.mark.parametrize("schedule", ["cosine", "wsd"])
def test_apply_updates_matches_reference(schedule, quantize_v):
    cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup=2, total_steps=8,
                            schedule=schedule, quantize_v=quantize_v,
                            clip_norm=50.0)
    rp, model = _setup()
    rstate = ref_adamw.init_state(rp, cfg)
    params, state = model, adamw.init_state(model, cfg)
    worst = {}
    for step in range(STEPS):
        rg, pg = _grads(rp, step)
        rp, rstate, rmet = ref_adamw.apply_updates(rp, rg, rstate, cfg)
        params, state, met = adamw.apply_updates(params, pg, state, cfg)
        for k in ("lr", "grad_norm"):
            assert met[k].shape == () and _rel(met[k], rmet[k]) <= TOL
        got = _port_leaves(train_state_to_jax(
            {"params": transformer.with_params(model, params),
             "opt": state}))
        want = _ref_leaves({"params": rp, "opt": rstate})
        assert set(got) == set(want)
        for key, w in want.items():
            g = got[key]
            assert g.shape == w.shape and str(g.dtype) == str(w.dtype), key
            if key.startswith("opt.v_q"):
                # int8 codes: round(v / scale) may fall on the other side
                # of a .5 when v differs in its last bits
                d = np.abs(g.astype(np.int32) - w.astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() <= 1e-3, key
                continue
            err = _rel(g, w)
            kind = key.split(".")[1] if key.startswith("opt") else "params"
            worst[kind] = max(worst.get(kind, 0.0), err)
            assert err <= TOL, (step, key, err)
    assert int(state["step"]) == STEPS
    print(f"{schedule} {quantize_v}: worst per kind {worst}")


def test_global_norm_matches_reference():
    rp, model = _setup(seed=2)
    rg, pg = _grads(rp, 9)
    want = float(ref_adamw._global_norm(rg))
    got = adamw._global_norm(pg)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= TOL * want


def test_leaf_groups_follow_the_reference_leaves():
    rp, model = _setup()
    groups = adamw.leaf_groups(dict(model.named_parameters()))
    assert list(groups) == list(_ref_leaves(rp))
    assert groups["dense_layers.attn.wq.w"] == [
        "dense_layers.0.attn.wq.w", "dense_layers.1.attn.wq.w"]
    assert groups["embed.table"] == ["embed.table"]
    # layer 10 after layer 9, not after layer 1
    names = [f"dense_layers.{i}.ln1.scale" for i in (10, 9, 1, 0)]
    assert adamw.leaf_groups(names)["dense_layers.ln1.scale"] == \
        [f"dense_layers.{i}.ln1.scale" for i in (0, 1, 9, 10)]


def test_leaf_groups_strip_every_layer_index():
    """A two-axis leaf (``group_layers.<g>.<i>...``) is one group, its
    G x K tensors in the order of (g, i); the groups follow the reduced
    zamba2's reference leaves in the reference's order."""
    names = [f"group_layers.{g}.{i}.mamba.A_log"
             for g, i in ((2, 0), (0, 1), (10, 1), (1, 0), (0, 0), (2, 1),
                          (1, 1), (10, 0))]
    names += ["site_lora.1.q.a", "site_lora.0.q.a", "shared_attn.ln1.scale"]
    groups = adamw.leaf_groups(names)
    assert list(groups) == ["group_layers.mamba.A_log",
                            "shared_attn.ln1.scale", "site_lora.q.a"]
    assert groups["group_layers.mamba.A_log"] == [
        f"group_layers.{g}.{i}.mamba.A_log"
        for g in (0, 1, 2, 10) for i in (0, 1)]
    assert groups["site_lora.q.a"] == ["site_lora.0.q.a", "site_lora.1.q.a"]
    rp, model = _setup(name="zamba2_1_2b")
    groups = adamw.leaf_groups(dict(model.named_parameters()))
    want = _ref_leaves(rp)
    assert list(groups) == list(want)
    for key, members in groups.items():
        lead = want[key].shape[:want[key].ndim - model.get_parameter(
            members[0]).ndim]
        assert len(members) == int(np.prod(lead)), key


def test_int8_v_scale_one_per_reference_leaf_for_the_hybrid():
    """int8 AdamW over 3 steps on the reduced zamba2: ``v_scale`` holds
    one scale per reference leaf (the two-axis ``group_layers`` leaves
    included), each within ``TOL`` of the reference's; the global norm
    too."""
    cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup=2, total_steps=8,
                            quantize_v="int8", clip_norm=50.0)
    rp, model = _setup(name="zamba2_1_2b")
    rstate = ref_adamw.init_state(rp, cfg)
    params, state = model, adamw.init_state(model, cfg)
    assert set(state["v_scale"]) == set(_ref_leaves(rp))
    for step in range(3):
        rg, pg = _grads(rp, step)
        rp, rstate, rmet = ref_adamw.apply_updates(rp, rg, rstate, cfg)
        params, state, met = adamw.apply_updates(params, pg, state, cfg)
        assert _rel(met["grad_norm"], rmet["grad_norm"]) <= TOL
        want = _ref_leaves(rstate["v_scale"])
        assert list(state["v_scale"]) == list(want)
        for key, w in want.items():
            got = state["v_scale"][key]
            assert got.shape == () and _rel(got, w) <= TOL, (step, key)


@pytest.mark.parametrize("quantize_v", ["none", "int8"])
def test_init_state_has_the_reference_layout(quantize_v):
    cfg = adamw.AdamWConfig(quantize_v=quantize_v)
    rp, model = _setup()
    want = jax.tree.map(np.asarray, ref_adamw.init_state(rp, cfg))
    state = adamw.init_state(model, cfg)
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()
    got = train_state_to_jax({"params": model, "opt": state})["opt"]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert not a.any()


def test_none_gradient_is_zeros():
    cfg = adamw.AdamWConfig(warmup=1)
    _, model = _setup()
    _, pg = _grads(_setup()[0], 3)
    with_none = dict(pg, **{"ln_f.scale": None})
    zeros = dict(pg, **{"ln_f.scale": torch.zeros_like(pg["ln_f.scale"])})
    a = adamw.apply_updates(model, with_none, adamw.init_state(model, cfg),
                            cfg)
    b = adamw.apply_updates(model, zeros, adamw.init_state(model, cfg), cfg)
    for n in a[0]:
        assert torch.equal(a[0][n], b[0][n]), n
    assert torch.equal(a[2]["grad_norm"], b[2]["grad_norm"])
    # still decayed
    assert not torch.equal(a[0]["ln_f.scale"], model.ln_f.scale)


@pytest.mark.parametrize("quantize_v", ["none", "int8"])
def test_donate_is_bitwise_the_out_of_place_step(quantize_v):
    """Three steps of ``make_train_step`` both ways from the same weights:
    bitwise equal states and metrics; the out-of-place step leaves the
    old state as it was, the in-place one returns the state it was
    given."""
    mcfg = dataclasses.replace(get_config("minicpm_2b").reduced(),
                               compute_dtype="float32")
    ocfg = adamw.AdamWConfig(warmup=2, total_steps=10, schedule="wsd",
                             quantize_v=quantize_v)
    data = SyntheticLM(DataConfig(vocab_size=mcfg.vocab_size,
                                  global_batch=2, seq_len=16))
    rp, _ = _setup(seed=4)
    states = []
    for donate in (False, True):
        model = params_from_jax(mcfg, jax.tree.map(np.asarray, rp),
                                device="cpu")
        states.append({"params": model, "opt": adamw.init_state(model,
                                                                ocfg)})
    step_out = steps.make_train_step(mcfg, ocfg)
    step_in = steps.make_train_step(mcfg, ocfg, donate=True)
    for i in range(3):
        batch = put_batch(data.batch_at(i), "cpu")
        old = train_state_to_jax(states[0])
        new_out, m_out = step_out(states[0], batch)
        assert new_out["params"] is not states[0]["params"]
        for a, b in zip(jax.tree.leaves(train_state_to_jax(states[0])),
                        jax.tree.leaves(old)):
            assert np.array_equal(a, b)          # the old state survives
        new_in, m_in = step_in(states[1], batch)
        assert new_in["params"] is states[1]["params"]
        assert new_in["opt"]["m"] is not None
        for k in m_out:
            assert torch.equal(m_out[k], m_in[k]), k
        for a, b in zip(jax.tree.leaves(train_state_to_jax(new_out)),
                        jax.tree.leaves(train_state_to_jax(new_in))):
            assert np.array_equal(a, b)
        states = [new_out, new_in]
        assert all(p.requires_grad for p in new_out["params"].parameters())
