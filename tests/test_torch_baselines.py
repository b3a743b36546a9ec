"""The port's baselines (``repro_torch.core.baselines``: COO, F-COO, CSF;
``engine.plans.BaselinePlan``; ``plan_for(backend="coo"|"fcoo"|"csf")``)
against the JAX package's, on the CPU: the host formats array for array,
the MTTKRPs against the reference and the dense oracle on every mode."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro import engine as rengine  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.engine import (BASELINE_KINDS, BaselinePlan,  # noqa: E402
                                plan_for)

# max |port - x| / max |x|: the JAX package's tests bound f32 at 5e-4; f64
# differs only in the order of additions
TOL = {np.float32: 5e-4, np.float64: 1e-10}
RANK = 5
BUDGET = 1 << 30
# (dims, nnz, dist): order 3 with repeated targets (a powerlaw draw),
# order 4 with a 2-row mode (long fibers, one segment holding many nnz),
# and order 3 with a mode of 70,000 rows
CASES = {
    "order3": ((20, 15, 12), 700, "powerlaw"),
    "order4": ((13, 2, 29, 5), 500, "uniform"),
    # a mode above 2^16 rows: F-COO sorts its key as int64 there, as
    # 16-bit keys elsewhere
    "wide": ((70_000, 9, 6), 400, "uniform"),
}
HOST = {"coo": (baselines.COOFormat, rcore.COOFormat),
        "fcoo": (baselines.FCOOFormat, rcore.FCOOFormat),
        "csf": (baselines.CSFFormat, rcore.CSFFormat)}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30)


@functools.lru_cache(maxsize=None)
def _tensors(case, dtype=np.float32):
    """The reference's and the port's SparseTensor of the same COO."""
    dims, nnz, dist = CASES[case]
    t = rcore.random_tensor(dims, nnz, seed=7, dist=dist, dtype=dtype)
    return t, core.from_coo(t.indices, t.values, dims)


def _factors(dims, dtype=np.float32, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((d, RANK)).astype(dtype) for d in dims]


def _arrays(fmt) -> list:
    """Every array of a host format, in field order."""
    out = []
    for f in fmt.__dataclass_fields__:
        v = getattr(fmt, f)
        items = v if isinstance(v, list) else [v]
        for x in items:
            if hasattr(x, "__dataclass_fields__"):
                out += [getattr(x, g) for g in x.__dataclass_fields__]
            else:
                out.append(x)
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", BASELINE_KINDS)
def test_builds_array_equal_to_reference(kind, case):
    rt, pt = _tensors(case)
    port_cls, ref_cls = HOST[kind]
    got, want = port_cls.build(pt), ref_cls.build(rt)
    a, b = _arrays(got), _arrays(want)
    assert len(a) == len(b) > 2
    for x, y in zip(a, b):
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert x == y
    assert got.device_bytes() == want.device_bytes()


def _ref_mttkrp(kind, rfmt, factors, mode, root=None):
    if kind == "coo":
        return rcore.coo_mttkrp(rfmt, factors, mode)
    if kind == "fcoo":
        return rcore.fcoo_mttkrp(rfmt, factors, mode)
    return rcore.csf_mttkrp(rfmt, factors, mode, root=root)


def _port_mttkrp(kind, fmt, factors, mode, root=None):
    if kind == "coo":
        return core.coo_mttkrp(fmt, factors, mode, device="cpu")
    if kind == "fcoo":
        return core.fcoo_mttkrp(fmt, factors, mode, device="cpu")
    return core.csf_mttkrp(fmt, factors, mode, root=root, device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", BASELINE_KINDS)
def test_mttkrp_matches_reference_and_oracle(kind, case, dtype):
    """Every mode; CSF from the tree rooted at the mode and from the next
    mode's tree (the non-root scatter fallback)."""
    rt, pt = _tensors(case, dtype)
    port_cls, ref_cls = HOST[kind]
    fmt, rfmt = port_cls.build(pt), ref_cls.build(rt)
    f = _factors(rt.dims, dtype)
    ft = [torch.from_numpy(x) for x in f]
    order = len(rt.dims)
    roots = (None, 1) if kind == "csf" else (None,)
    with jax.enable_x64(dtype == np.float64):
        for mode in range(order):
            oracle = rcore.mttkrp_dense_oracle(rt, f, mode)
            for shift in roots:
                root = None if shift is None else (mode + shift) % order
                out = _port_mttkrp(kind, fmt, ft, mode, root)
                want = np.asarray(_ref_mttkrp(kind, rfmt, f, mode, root))
                assert out.numpy().dtype == want.dtype
                assert out.shape == want.shape == (rt.dims[mode], RANK)
                assert _rel(out, want) < TOL[dtype], (mode, root)
                assert _rel(out, oracle) < TOL[dtype], (mode, root)


def test_device_csf_from_every_root():
    """``DeviceCSF.mttkrp(root=)`` runs the tree of any root: the target
    mode's by default, another's by the scatter fallback, as
    ``csf_mttkrp``."""
    rt, pt = _tensors("order4")
    fmt = baselines.CSFFormat.build(pt)
    dev = baselines.DeviceCSF(fmt, device="cpu")
    f = _factors(rt.dims)
    ft = [torch.from_numpy(x) for x in f]
    for mode in range(4):
        oracle = rcore.mttkrp_dense_oracle(rt, f, mode)
        assert torch.equal(dev.mttkrp(ft, mode),
                           core.csf_mttkrp(fmt, ft, mode, device="cpu"))
        for root in range(4):
            out = dev.mttkrp(ft, mode, root=root)
            assert torch.equal(out, core.csf_mttkrp(fmt, ft, mode, root=root,
                                                    device="cpu"))
            assert _rel(out, oracle) < TOL[np.float32]


def test_f64_values_with_f32_factors_accumulate_in_f64():
    rt, pt = _tensors("order3", np.float64)
    f = _factors(rt.dims, np.float32)
    for kind in BASELINE_KINDS:
        plan = BaselinePlan.from_tensor(pt, kind, device="cpu")
        out = plan.mttkrp([torch.from_numpy(x) for x in f], 0)
        assert out.dtype == torch.float64
        assert _rel(out, rcore.mttkrp_dense_oracle(rt, f, 0)) < 1e-6


@pytest.mark.parametrize("source", ["tensor", "blco"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", BASELINE_KINDS)
def test_plan_for_matches_reference_baseline_plan(kind, case, source):
    """``plan_for(backend=kind, kernel="torch")`` from ``tensor=`` and from
    the BLCO decode gives a BaselinePlan whose outputs, device bytes and
    stats match the reference's."""
    rt, pt = _tensors(case)
    rb, pb = rcore.build_blco(rt), core.build_blco(pt)
    kw = {"tensor": pt} if source == "tensor" else {}
    rkw = {"tensor": rt} if source == "tensor" else {}
    plan = plan_for(pb, BUDGET, rank=RANK, backend=kind, kernel="torch",
                    device="cpu", **kw)
    rplan = rengine.plan_for(rb, BUDGET, rank=RANK, backend=kind, **rkw)
    assert isinstance(plan, BaselinePlan) and plan.backend == kind
    assert plan.device_bytes() == rplan.device_bytes()
    f = _factors(rt.dims)
    for mode in range(len(rt.dims)):
        out = plan.mttkrp([torch.from_numpy(x) for x in f], mode)
        want = np.asarray(rplan.mttkrp(f, mode))
        assert _rel(out, want) < TOL[np.float32]
        assert _rel(out, rcore.mttkrp_dense_oracle(rt, f, mode)) \
            < TOL[np.float32]
    s, w = plan.stats(), rplan.stats()
    for key in ("backend", "h2d_bytes", "mttkrp_calls", "launches"):
        assert getattr(s, key) == getattr(w, key), key
    assert plan.close() == w.h2d_bytes and plan.close() == 0
    with pytest.raises(RuntimeError, match="closed"):
        plan.mttkrp([torch.from_numpy(x) for x in f], 0)


def test_empty_tensor_gives_zeros():
    """An empty tensor gives a zero output in every format.  The reference
    does so for COO; its F-COO call and CSF build raise on it."""
    dims = (4, 5, 6)
    pt = core.from_coo(np.zeros((0, 3), np.int64), np.zeros(0, np.float32),
                       dims)
    rt = rcore.from_coo(np.zeros((0, 3), np.int64), np.zeros(0, np.float32),
                        dims)
    f = _factors(dims)
    want = np.asarray(rcore.coo_mttkrp(rcore.COOFormat.build(rt), f, 1))
    assert np.array_equal(want, np.zeros((5, RANK), np.float32))
    fcoo = baselines.FCOOFormat.build(pt)
    assert [s.tolist() for s in fcoo.per_mode_segids] == [[0]] * 3
    assert baselines.DeviceFCOO(fcoo, device="cpu").per_mode[0][3] == 1
    csf = baselines.CSFFormat.build(pt)
    assert all(tr.fiber_ptr.tolist() == [0] and len(tr.fiber_root) == 0
               for tr in csf.trees)
    for kind in BASELINE_KINDS:
        plan = plan_for(core.build_blco(pt), BUDGET, rank=RANK,
                        backend=kind, kernel="torch", device="cpu",
                        tensor=pt)
        for mode, d in enumerate(dims):
            out = plan.mttkrp([torch.from_numpy(x) for x in f], mode)
            assert out.shape == (d, RANK) and not out.any()
    out = core.csf_mttkrp(csf, [torch.from_numpy(x) for x in f], 0, root=2,
                          device="cpu")
    assert out.shape == (4, RANK) and not out.any()


def test_other_kernels_refused_and_sharded_unported():
    _, pt = _tensors("order3")
    pb = core.build_blco(pt)
    for kind in BASELINE_KINDS:
        with pytest.raises(ValueError, match="use kernel='torch'"):
            plan_for(pb, BUDGET, rank=RANK, backend=kind, kernel="cuda",
                     device="cpu", tensor=pt)
    with pytest.raises(ValueError, match="requires an active mesh"):
        plan_for(pb, BUDGET, rank=RANK, backend="sharded", kernel="torch",
                 device="cpu")
    with pytest.raises(ValueError, match="unknown baseline kind"):
        BaselinePlan.from_tensor(pt, "hicoo", device="cpu")


def test_n_copy_footprints_against_blco():
    """BLCO's one copy against the N copies of F-COO and CSF (the JAX
    package's ``test_mode_agnostic_single_copy`` bounds)."""
    t = core.random_tensor((30, 40, 50), 2000, seed=3)
    b = core.build_blco(t)
    fcoo = core.FCOOFormat.build(t)
    csf = core.CSFFormat.build(t)
    assert len(fcoo.per_mode_indices) == len(csf.trees) == t.order
    assert fcoo.device_bytes() > 2.4 * core.format_bytes(b)
    assert csf.device_bytes() > 1.9 * core.format_bytes(b)
    for kind, fmt in (("fcoo", fcoo), ("csf", csf)):
        plan = BaselinePlan.from_tensor(t, kind, device="cpu")
        # the device format holds the host arrays; CSF holds its leaves'
        # fiber numbers (int32) in place of the fiber pointers
        extra = sum(tr.values.shape[0] * 4 - tr.fiber_ptr.nbytes
                    for tr in csf.trees) if kind == "csf" else 0
        assert plan.device_bytes() == fmt.device_bytes() + extra


def test_default_device_is_the_card():
    """Without device="cpu" the baselines go to the card: where there is
    none they raise, and nothing runs on the CPU instead."""
    _, pt = _tensors("order3")
    fmt = baselines.COOFormat.build(pt)
    f = _factors(pt.dims)
    if torch.cuda.is_available():
        out = core.coo_mttkrp(fmt, f, 0)
        assert out.is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        core.coo_mttkrp(fmt, f, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        baselines.DeviceCSF(baselines.CSFFormat.build(pt))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_for(core.build_blco(pt), BUDGET, rank=RANK, backend="fcoo",
                 kernel="torch", tensor=pt)


@pytest.mark.parametrize("huge", [False, True], ids=["linear", "lexsort"])
def test_csf_build_with_duplicate_coordinates_order4(huge):
    """CSF's build on an order-4 tensor whose coordinates repeat (a
    ``SparseTensor`` made directly, not deduplicated): the trees equal the
    reference's array for array, so the stable sort of the linearized key
    keeps tied non-zeros in input order as ``np.lexsort`` does; with dims
    whose product passes int64 the port keeps the lexsort."""
    rng = np.random.default_rng(11)
    dims = (7, 3, 2 ** 61, 5) if huge else (7, 3, 11, 5)
    base = rng.integers(0, [7, 3, 11, 5], (60, 4))
    idx = np.concatenate([base, base[rng.integers(0, 60, 40)]])
    idx = idx[rng.permutation(len(idx))].astype(np.int64)
    vals = rng.standard_normal(len(idx)).astype(np.float32)
    assert len(np.unique(idx, axis=0)) < len(idx)
    from repro.core.tensor import SparseTensor as RefTensor
    from repro_torch.core.tensor import SparseTensor
    got = baselines.CSFFormat.build(SparseTensor(dims, idx, vals))
    want = rcore.CSFFormat.build(RefTensor(dims, idx, vals))
    a, b = _arrays(got), _arrays(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert x == y
    for root in range(4):
        rest = [idx[:, m] for m in range(4) if m != root]
        np.testing.assert_array_equal(
            baselines._csf_order(idx, dims, root),
            np.lexsort(tuple(reversed(rest)) + (idx[:, root],)))
