"""The port's CP-ALS against the JAX package's, from the same numpy factors."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro import engine as rengine  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.convert import cpstate_from_numpy  # noqa: E402
from repro_torch.engine import plan_for  # noqa: E402

# Per-sweep fits agree within 1e-4 absolute in f32: the two frameworks add
# in other orders, and the pseudo-inverse of each sweep amplifies those
# last-bit differences before the fit is read.
FIT_TOL = 1e-4
CASES = [
    ((40, 25, 30), 2000, "powerlaw", 64, 1 << 27, 8),
    ((13, 7, 29, 5), 499, "uniform", 8, 64, 6),        # many launches
    ((300, 20, 16), 2500, "clustered", 64, 1 << 27, 5),
]


def _norm(t):
    return float(np.linalg.norm(t.values))


def _pair(dims, nnz, dist, tb, mx, seed=4):
    t = rcore.random_tensor(dims, nnz, seed=seed, dist=dist)
    ref = rcore.build_blco(t, target_bits=tb, max_nnz_per_block=mx)
    port = core.build_blco(core.random_tensor(dims, nnz, seed=seed,
                                              dist=dist),
                           target_bits=tb, max_nnz_per_block=mx)
    return t, ref, port


@pytest.mark.parametrize("kernel", ["cuda", "torch"])
@pytest.mark.parametrize("dims,nnz,dist,tb,mx,rank", CASES)
def test_five_sweeps_match_reference(dims, nnz, dist, tb, mx, rank, kernel):
    t, ref, port = _pair(dims, nnz, dist, tb, mx)
    want = rcore.cp_als(rengine.plan_for(ref, 1 << 30, rank=rank), dims,
                        rank, norm_x=_norm(t), iters=5, seed=11, tol=0.0)
    plan = plan_for(port, 1 << 30, rank=rank, kernel=kernel, device="cpu")
    got = core.cp_als(plan, dims, rank, norm_x=_norm(t), iters=5, seed=11,
                      tol=0.0, device="cpu")
    assert got.iterations == want.iterations == 5
    np.testing.assert_allclose(got.fits, want.fits, rtol=0, atol=FIT_TOL)
    np.testing.assert_allclose(got.lam, np.asarray(want.lam), rtol=1e-3,
                               atol=1e-3)


def test_init_factors_are_the_reference_draws():
    for dtype, rdtype in ((torch.float32, np.float32),
                          (torch.float64, np.float64)):
        got = core.init_factors((7, 5, 3), 4, seed=9, dtype=dtype,
                                device="cpu")
        with jax.enable_x64(True):
            want = rcore.init_factors((7, 5, 3), 4, seed=9, dtype=rdtype)
        for g, w in zip(got, want):
            assert g.dtype == dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_step_from_reference_state():
    """A state carried across with ``cpstate_from_numpy`` takes the same
    next sweep as the reference."""
    t, ref, port = _pair(*CASES[0][:5])
    rank = 8
    rplan = rengine.plan_for(ref, 1 << 30, rank=rank)
    rstate = rcore.cp_als_init(t.dims, rank, norm_x=_norm(t), seed=3,
                               tol=0.0)
    for _ in range(2):
        rcore.cp_als_step(rplan, rstate)
    state = cpstate_from_numpy(
        dims=rstate.dims, rank=rank, norm_x=rstate.norm_x, tol=rstate.tol,
        factors=[np.asarray(f) for f in rstate.factors],
        lam=np.asarray(rstate.lam), fits=rstate.fits,
        prev_fit=rstate.prev_fit, iteration=rstate.iteration,
        converged=rstate.converged, device="cpu")
    assert state.iteration == 2 and state.fits == rstate.fits
    rcore.cp_als_step(rplan, rstate)
    core.cp_als_step(plan_for(port, 1 << 30, rank=rank, device="cpu"), state)
    assert abs(state.fits[-1] - rstate.fits[-1]) < FIT_TOL
    assert state.iteration == rstate.iteration == 3


def test_reconstruct_dense_on_rank_exact_tensor():
    rng = np.random.default_rng(0)
    dims, r0 = (9, 8, 7), 2
    factors = [rng.standard_normal((d, r0)) for d in dims]
    dense = np.einsum("ir,jr,kr->ijk", *factors)
    idx = np.argwhere(np.ones(dims, bool))             # every entry stored
    t = core.from_coo(idx, dense[tuple(idx.T)].astype(np.float64), dims)
    b = core.build_blco(t)
    res = core.cp_als(plan_for(b, 1 << 30, rank=r0, dtype=torch.float64,
                               device="cpu"),
                      dims, r0, norm_x=_norm(t), iters=200, tol=1e-12,
                      seed=1, dtype=torch.float64, device="cpu")
    recon = core.reconstruct_dense(res)
    resid = np.linalg.norm(recon - dense) / np.linalg.norm(dense)
    assert resid < 1e-4, resid
    assert abs((1 - resid) - res.fits[-1]) < 1e-4
    assert res.lam.dtype == np.float64


def test_backend_adapter():
    f = core.as_mttkrp_fn(lambda fs, m: fs[m])
    assert f([1, 2], 1) == 2
    _, _, port = _pair(*CASES[0][:5])
    plan = plan_for(port, 1 << 30, rank=4, device="cpu")
    assert core.as_mttkrp_fn(plan) == plan.mttkrp
    with pytest.raises(TypeError):
        core.as_mttkrp_fn(42)
