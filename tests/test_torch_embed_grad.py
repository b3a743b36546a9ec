"""The port's embedding-gradient accumulation
(``repro_torch.core.embed_grad``) against the JAX package's
``repro.core.embed_grad`` on the CPU: ``_grad_scatter`` and
``_grad_segment`` on Zipf(1.3) ids (hot tokens, the conflict regime the
paper targets) as a property test, ``torch.autograd`` through
``embedding_lookup`` against ``jax.grad`` of the reference's, the
forward as an exact gather, and the duplicate-plus-last-row case."""
import numpy as np
import pytest
import torch

from conftest import hypothesis_or_stub

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import embed_grad as ref  # noqa: E402
from repro_torch.core import embedding_lookup  # noqa: E402
from repro_torch.core.embed_grad import (_grad_scatter,  # noqa: E402
                                         _grad_segment)

given, settings, st = hypothesis_or_stub()

# both packages add in another order (a segment's rows, the scatter's
# duplicates): the reference's own segment-vs-scatter tolerance
TOL = 2e-4


def _inputs(vocab, b, s, seed, d=8):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((vocab, d)).astype(np.float32)
    ids = (rng.zipf(1.3, size=(b, s)) % vocab).astype(np.int32)
    g = rng.standard_normal((b, s, d)).astype(np.float32)
    return table, ids, g


@settings(max_examples=25, deadline=None)
@given(vocab=st.integers(3, 200), b=st.integers(1, 4), s=st.integers(1, 64),
       seed=st.integers(0, 2**31 - 1))
def test_segment_and_scatter_match_reference(vocab, b, s, seed):
    _, ids, g = _inputs(vocab, b, s, seed)
    want_seg = np.asarray(ref._grad_segment(jnp.asarray(ids), jnp.asarray(g),
                                            vocab))
    want_sc = np.asarray(ref._grad_scatter(jnp.asarray(ids.reshape(-1)),
                                           jnp.asarray(g.reshape(-1, 8)),
                                           vocab))
    got_seg = _grad_segment(torch.from_numpy(ids), torch.from_numpy(g),
                            vocab).numpy()
    got_sc = _grad_scatter(torch.from_numpy(ids.reshape(-1)),
                           torch.from_numpy(g.reshape(-1, 8)), vocab).numpy()
    np.testing.assert_allclose(got_seg, want_seg, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_sc, want_sc, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_seg, got_sc, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("method", ["segment", "scatter"])
@pytest.mark.parametrize("shape", [(3, 40), (1, 64), (64,), (2, 3, 10)])
def test_autograd_matches_jax_grad(method, shape):
    rng = np.random.default_rng(7)
    vocab, d = 50, 8
    table = rng.standard_normal((vocab, d)).astype(np.float32)
    ids = (rng.zipf(1.3, size=shape) % vocab).astype(np.int32)
    tgt = rng.standard_normal(shape + (d,)).astype(np.float32)

    def loss(tab):
        e = ref.embedding_lookup(tab, jnp.asarray(ids), method)
        return jnp.sum((e - tgt) ** 2)

    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    e = embedding_lookup(t, torch.from_numpy(ids), method)
    ((e - torch.from_numpy(tgt)) ** 2).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=TOL, atol=TOL)


def test_autograd_backward_is_the_segment_function():
    """The backward dispatches to ``_grad_segment`` itself: bitwise."""
    _, ids, g = _inputs(97, 3, 50, 3)
    t = torch.zeros((97, 8), requires_grad=True)
    embedding_lookup(t, torch.from_numpy(ids), "segment").backward(
        torch.from_numpy(g))
    want = _grad_segment(torch.from_numpy(ids), torch.from_numpy(g), 97)
    assert torch.equal(t.grad, want)


def test_forward_is_plain_gather():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 7))
    for method in ("segment", "scatter"):
        out = embedding_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                               method)
        np.testing.assert_array_equal(out.numpy(), table[ids])
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(ref.embedding_lookup(
                jnp.asarray(table), jnp.asarray(ids), method)))


def test_grad_duplicates_and_last_row_exact():
    ids = np.asarray([[1, 1, 1, 63]])     # duplicates + last row
    t = torch.zeros((64, 4), requires_grad=True)
    embedding_lookup(t, torch.from_numpy(ids), "segment").sum().backward()
    g = t.grad
    assert float(g[1].sum()) == 12.0      # 3 occurrences x 4 dims
    assert float(g[63].sum()) == 4.0
    assert float(g[2:63].abs().sum()) == 0.0
    want = jax.grad(lambda tab: ref.embedding_lookup(
        tab, jnp.asarray(ids), "segment").sum())(jnp.zeros((64, 4)))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))


def test_unknown_method_raises_in_backward():
    t = torch.zeros((8, 2), requires_grad=True)
    out = embedding_lookup(t, torch.tensor([[1, 2]]), "bogus")
    with pytest.raises(ValueError, match="bogus"):
        out.sum().backward()
