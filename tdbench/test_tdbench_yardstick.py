"""The yardstick: the work counts against the figures worked by hand, the
reference against a dense einsum and ALS, the trace reading and the
metric readers on made-up input."""
import types

import numpy as np
import pytest
import torch

from tdbench import check, reference, tracing, work
from tdbench.manifest import reader

NELL2 = ((12092, 9184, 28818), 76_879_419)
DELICIOUS = ((532924, 17262471, 2480308, 1443), 140_126_181)


@pytest.mark.parametrize("dims,nnz,idx_bytes,gb,least_ms,flop_ms", [
    (*NELL2, 6, 2.325, 0.694, 0.33),
    (*DELICIOUS, 10, 18.23, 5.44, 1.07),
])
def test_work_matches_hand_worked(dims, nnz, idx_bytes, gb, least_ms,
                                  flop_ms):
    w = work.mttkrp_work(dims, nnz, 32)
    assert work.index_bytes(dims) == idx_bytes
    assert w["bytes"] / 1e9 == pytest.approx(gb, rel=1e-3)
    assert work.least_s(w) * 1e3 == pytest.approx(least_ms, rel=1e-3)
    assert w["flops"] / work.PEAK_F32_FLOPS * 1e3 == pytest.approx(
        flop_ms, rel=1e-2)
    assert work.least_s(work.sweep_work(dims, nnz, 32)) > work.least_s(w)


def _dense_case(seed=0):
    rng = np.random.default_rng(seed)
    dims, rank = (5, 4, 6), 3
    dense = np.where(rng.random(dims) < 0.5, rng.standard_normal(dims), 0.0)
    idx = np.argwhere(dense != 0)
    vals = dense[tuple(idx.T)]
    factors = [rng.standard_normal((d, rank)) for d in dims]
    return dense, torch.from_numpy(idx), torch.from_numpy(vals), factors


def _dense_mttkrp(dense, factors, mode):
    letters = "abc"
    others = [m for m in range(3) if m != mode]
    spec = (f"{letters},{letters[others[0]]}r,{letters[others[1]]}r"
            f"->{letters[mode]}r")
    return np.einsum(spec, dense, factors[others[0]], factors[others[1]])


def test_reference_mttkrp_matches_dense_einsum():
    dense, idx, vals, factors = _dense_case()
    tf = [torch.from_numpy(f) for f in factors]
    for mode in range(3):
        got = reference.mttkrp(idx, vals, tf, mode, block=7).numpy()
        np.testing.assert_allclose(got, _dense_mttkrp(dense, factors, mode),
                                   rtol=1e-12, atol=1e-12)


def test_reference_sweep_matches_dense_als():
    dense, idx, vals, factors = _dense_case(1)
    norm_x = float(np.linalg.norm(dense))
    state = reference.State(factors=[torch.from_numpy(f) for f in factors],
                            lam=torch.ones(3, dtype=torch.float64),
                            norm_x=norm_x, rtol=1e-12)
    reference.sweep(lambda fs, n: reference.mttkrp(idx, vals, fs, n), state)
    want = [f.copy() for f in factors]
    for n in range(3):
        others = [want[m] for m in range(3) if m != n]
        v = (others[0].T @ others[0]) * (others[1].T @ others[1])
        a = _dense_mttkrp(dense, want, n) @ np.linalg.pinv(v)
        lam = np.linalg.norm(a, axis=0)
        want[n] = a / lam
    for got, w in zip(state.factors, want):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(state.lam.numpy(), lam, rtol=1e-9)
    approx = np.einsum("r,ar,br,cr->abc", lam, *want)
    fit = 1 - np.linalg.norm(dense - approx) / norm_x
    assert state.fits == [pytest.approx(fit, abs=1e-10)]
    assert state.iteration == 1


def test_solve_residual_leaves_out_a_direction_under_the_cut_off():
    """A pseudo-inverse that drops V's smallest direction, as the
    program's does under its cut-off, leaves M's component there in the
    full residual; the projected one reads rounding."""
    gen = torch.Generator().manual_seed(3)
    rank, rtol = 8, 3.814697265625e-05
    u, _ = torch.linalg.qr(torch.randn(rank, rank, generator=gen,
                                       dtype=torch.float64))
    w = torch.logspace(0, -5, rank, dtype=torch.float64)
    v = u @ torch.diag(w) @ u.T
    x_true = torch.randn(50, rank, generator=gen, dtype=torch.float64)
    m_mat = x_true @ v
    x = m_mat @ torch.linalg.pinv(v, rtol=rtol)
    lam = torch.linalg.vector_norm(x, dim=0)
    proj, below = check.kept(v, check.KEEP_ABOVE * rtol)
    assert check.kept(v, rtol)[1] == 1 and below == 3
    assert check.residual(x / lam, lam, v, m_mat) > 1e-6
    assert check.residual(x / lam, lam, v, m_mat, proj) < 1e-13


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10, -3.5])
    assert reference.tf32(x).tolist() == [1.0, 1.0 + 2**-9, 1.0 + 2**-10,
                                          -3.5]


def _ev(name, dev, a, z, corr=0, annotation=False):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if dev else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=a, end=z), id=corr,
        is_user_annotation=annotation)


def test_trace_summary_attributes_kernels_by_span():
    events = [
        _ev("sweep", False, 0, 100, annotation=True),
        _ev("mttkrp.mode0", False, 10, 40, annotation=True),
        _ev("cudaLaunchKernel", False, 12, 13, corr=7),
        _ev("cudaLaunchKernel", False, 50, 51, corr=8),
        _ev("segment_kernel", True, 14, 38, corr=7),
        _ev("gemm", True, 52, 60, corr=8),
        _ev("cudaStreamSynchronize", True, 38, 40, corr=9),
    ]
    s = tracing.summarize(events)
    assert s["sweeps"] == 1 and s["matched_events"] == 2
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(32e-6)
    assert s["mttkrp_device_s"] == pytest.approx(24e-6)
    assert s["device_ops"][0] == ["segment_kernel", pytest.approx(24e-6)]
    gaps = dict(s["idle_gaps"])
    assert gaps["solve.mode0"] == pytest.approx(14e-6 + 40e-6)
    assert gaps["sweep start"] == pytest.approx(14e-6)
    assert tracing.summarize(events[:4]) is None


def test_metric_readers():
    prof = {"sweeps": 2, "window_s": 0.05, "busy_s": 0.04,
            "mttkrp_device_s": 0.036}
    run = {"dims": list(NELL2[0]), "nnz": NELL2[1], "rank": 32,
           "build": {"sort": 30.0, "linearize": 5.0}, "sweeps": 4,
           "sweep_s": [0.025] * 4, "mttkrp_s": [0.02] * 4,
           "dispatch_s": 0.002, "profile": prof, "work": work}
    assert reader("build_s")(run) == pytest.approx(35.0)
    assert reader("dispatch_ms")(run) == pytest.approx(0.5)
    assert reader("solve_ms")(run) == pytest.approx(5.0)
    assert reader("device_idle_pct")(run) == pytest.approx(20.0)
    assert reader("mttkrp_roofline_pct")(run) == pytest.approx(
        100 * 0.6942145e-3 / 0.018, rel=1e-5)
    assert 0 < reader("sweep_roofline_pct")(run) < 100
    empty = dict(run, build=None, mttkrp_s=[], dispatch_s=None,
                 profile=None)
    for name in ("build_s", "dispatch_ms", "solve_ms", "device_idle_pct",
                 "mttkrp_roofline_pct"):
        assert reader(name)(empty) is None
