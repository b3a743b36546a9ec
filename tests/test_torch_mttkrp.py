"""The port's plain PyTorch MTTKRP (``kernel="torch"``) against the JAX
package's XLA path and the dense oracle, in all three resolutions."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro.core import u64 as ru64  # noqa: E402
from repro.core.launches import LaunchCache as RefCache  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import u64  # noqa: E402
from repro_torch.core.launches import LaunchCache  # noqa: E402

# (dims, nnz, dist, target_bits, max_nnz_per_block)
CASES = [
    ((70, 40, 30), 1777, "powerlaw", 12, 512),
    ((13, 7, 29, 5), 499, "uniform", 8, 64),         # forced blocking
    ((128, 4, 256, 8, 3), 801, "clustered", 16, 128),
    ((300, 20, 16), 2500, "powerlaw", 64, 1 << 27),  # register + hierarchical
]
RESOLUTIONS = ["direct", "register", "hierarchical"]
# max |port - x| / max |x|: the JAX package's tests bound f32 at 5e-4;
# f64 differs only in the order of additions
F32_TOL, F64_TOL = 5e-4, 1e-10


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30)


def _setup(dims, nnz, dist, tb, mx, dtype=np.float32, seed=7):
    t = rcore.random_tensor(dims, nnz, seed=seed, dist=dist, dtype=dtype)
    tp = core.random_tensor(dims, nnz, seed=seed, dist=dist, dtype=dtype)
    return (t, rcore.build_blco(t, target_bits=tb, max_nnz_per_block=mx),
            core.build_blco(tp, target_bits=tb, max_nnz_per_block=mx))


def _factors(dims, rank=8, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((d, rank)).astype(dtype) for d in dims]


@pytest.mark.parametrize("resolution", RESOLUTIONS)
@pytest.mark.parametrize("dims,nnz,dist,tb,mx", CASES)
def test_torch_path_matches_reference_and_oracle_f32(dims, nnz, dist, tb, mx,
                                                     resolution):
    t, ref, port = _setup(dims, nnz, dist, tb, mx)
    factors = _factors(dims)
    rc = RefCache.from_blco(ref)
    pc = LaunchCache.from_blco(port, device="cpu")
    ft = [torch.from_numpy(f) for f in factors]
    for mode in range(len(dims)):
        oracle = rcore.mttkrp_dense_oracle(t, factors, mode)
        out = pc.mttkrp(ft, mode, resolution=resolution)
        assert out.dtype == torch.float32 and out.shape == (dims[mode], 8)
        want = rc.mttkrp(factors, mode, resolution=resolution)
        assert _rel(out, want) < F32_TOL, (mode, resolution)
        assert _rel(out, oracle) < F32_TOL, (mode, resolution)
        assert _rel(core.mttkrp_dense_oracle(t, ft, mode), oracle) == 0


@pytest.mark.parametrize("resolution", RESOLUTIONS)
@pytest.mark.parametrize("dims,nnz,dist,tb,mx", CASES[:2])
def test_torch_path_matches_reference_f64(dims, nnz, dist, tb, mx,
                                          resolution):
    t, ref, port = _setup(dims, nnz, dist, tb, mx, dtype=np.float64)
    factors = _factors(dims, dtype=np.float64)
    pc = LaunchCache.from_blco(port, device="cpu")
    ft = [torch.from_numpy(f) for f in factors]
    with jax.enable_x64(True):
        rc = RefCache.from_blco(ref)
        for mode in range(len(dims)):
            want = np.asarray(rc.mttkrp(factors, mode, resolution=resolution))
            assert want.dtype == np.float64
            out = pc.mttkrp(ft, mode, resolution=resolution)
            assert out.dtype == torch.float64
            assert _rel(out, want) < F64_TOL, (mode, resolution)
            assert _rel(out, rcore.mttkrp_dense_oracle(t, factors, mode)) \
                < F64_TOL


def test_f64_values_with_f32_factors_promote():
    t, ref, port = _setup((40, 25, 30), 2000, "powerlaw", 12, 256,
                          dtype=np.float64)
    factors = _factors(t.dims)
    pc = LaunchCache.from_blco(port, device="cpu")
    ft = [torch.from_numpy(f) for f in factors]
    with jax.enable_x64(True):
        rc = RefCache.from_blco(ref)
        for mode in range(3):
            out = pc.mttkrp(ft, mode)
            assert out.dtype == torch.float64
            want = np.asarray(rc.mttkrp(factors, mode))
            assert want.dtype == np.float64
            assert _rel(out, want) < F64_TOL


def test_empty_tensor_gives_zeros():
    t = core.from_coo(np.zeros((0, 3), np.int64), np.zeros(0, np.float32),
                      (5, 6, 7))
    b = core.build_blco(t)
    pc = LaunchCache.from_blco(b, device="cpu")
    assert pc.num_launches == 0 and pc.device_bytes() == 0
    ft = [torch.ones(d, 4) for d in (5, 6, 7)]
    for mode, d in enumerate((5, 6, 7)):
        out = pc.mttkrp(ft, mode)
        assert out.shape == (d, 4) and not out.any()


@pytest.mark.parametrize("resolution", RESOLUTIONS)
def test_zero_padding_is_exact(resolution):
    """More padding slots per launch leave the plain path's result
    unchanged: each pad slot adds +0.0 to row 0."""
    t, _, port = _setup((30, 22, 14), 1003, "powerlaw", 12, 256)
    ft = [torch.from_numpy(f) for f in _factors(t.dims)]
    tight = LaunchCache.from_blco(port, device="cpu")
    loose = LaunchCache.from_blco(port, reservation_nnz=4 * tight.reservation,
                                  device="cpu")
    for mode in range(3):
        a = tight.mttkrp(ft, mode, resolution=resolution)
        b = loose.mttkrp(ft, mode, resolution=resolution)
        assert torch.equal(a, b), (mode, resolution)


def test_mode_agnostic_one_copy_counts_dispatches():
    """One tensor copy serves every mode; the plain path records one
    dispatch per BLCO launch."""
    t, _, port = _setup((13, 7, 29, 5), 499, "uniform", 8, 64)
    pc = LaunchCache.from_blco(port, device="cpu")
    ft = [torch.from_numpy(f) for f in _factors(t.dims)]
    for mode in range(4):
        c0 = core.dispatch_count()
        pc.mttkrp(ft, mode)
        assert core.dispatch_count() - c0 == pc.num_launches > 1


def test_resolution_rule_and_kernel_names():
    assert core.choose_resolution(127) == "hierarchical" == \
        rcore.choose_resolution(127)
    assert core.choose_resolution(128) == "register" == \
        rcore.choose_resolution(128)
    assert core.KERNELS == ("torch", "cuda")
    for k in core.KERNELS:
        assert core.validate_kernel(k) == k
    with pytest.raises(ValueError):
        core.validate_kernel("xla")
    with pytest.raises(ValueError):
        LaunchCache.from_blco(_setup((30, 22, 14), 100, "uniform", 64,
                                     1 << 27)[2], device="cpu").mttkrp(
            [torch.ones(d, 2) for d in (30, 22, 14)], 0, resolution="bogus")


@pytest.mark.parametrize("shift,width", [(0, 12), (12, 12), (24, 12), (20, 12),
                                         (32, 15), (40, 24), (31, 32),
                                         (0, 32), (32, 32), (5, 0)])
def test_extract_field_matches_reference(shift, width):
    rng = np.random.default_rng(shift * 64 + width)
    hi = rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32)
    hi[:3] = 0xFFFFFFFF                       # top bit set: sign of int64
    want = np.asarray(ru64.extract_field(hi, lo, shift, width)).astype(
        np.int64)
    got = u64.extract_field(torch.from_numpy(hi), torch.from_numpy(lo),
                            shift, width)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    x = u64.join64(*u64.split64(u64.join64(hi, lo)))
    np.testing.assert_array_equal(x, ru64.join64(hi, lo))
