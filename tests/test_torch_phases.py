"""The three-phase pipeline of the port — K3 ``delinearize``, K4
``mttkrp_segments``, K5 ``mttkrp_stash`` and ``cuda_mttkrp_phases`` — and the
free-function MTTKRP API, against the JAX package on the same numpy inputs.

The JAX side runs as its own tests run it: the Pallas kernels in interpret
mode.  The port's wrappers are given CPU tensors here, so they run their
plain versions (``kernels/ref.py``); the CUDA kernels are held against those
on the card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""
import contextlib
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro.core.mttkrp import (clear_launch_cache as ref_clear,  # noqa: E402
                               launch_cache_for as ref_cache_for,
                               mttkrp as ref_mttkrp,
                               mttkrp_per_launch as ref_per_launch)
from repro.core import tensor as rtensor  # noqa: E402
from repro.kernels import blco_mttkrp as rk  # noqa: E402
from repro.kernels.delinearize import delinearize as pallas_delinearize  # noqa: E402,E501
from repro.kernels.ops import pallas_mttkrp, pallas_mttkrp_phases  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core.launches import LaunchCache  # noqa: E402
from repro_torch.kernels import (blco_mttkrp, cuda_mttkrp,  # noqa: E402
                                 cuda_mttkrp_phases, delinearize, ops)
from repro_torch.kernels.delinearize import _check_inputs  # noqa: E402

# (dims, nnz, target_bits, max_nnz_per_block): tests/test_fused.py's cases
# (ragged nnz: every launch ends in padding slots) plus a field that
# straddles the two index words (mode 2: shift 22, width 11)
CASES = [
    ((70, 40, 30), 1777, 12, 512),             # order 3
    ((13, 7, 29, 5), 499, 8, 64),              # order 4, forced blocking
    ((128, 4, 256, 8, 3), 801, 16, 128),       # order 5
    ((2048, 2048, 2048), 3001, 64, 1 << 27),   # straddling field
]
# (values dtype, factors dtype)
PAIRS = {"f32": (np.float32, np.float32), "f64": (np.float64, np.float64),
         "f64xf32": (np.float64, np.float32)}
# max |port - x| / max |x|: the JAX package's kernel tests bound f32 at
# 5e-4; in f64 only the order of additions differs
TOL = {np.dtype(np.float32): 5e-4, np.dtype(np.float64): 1e-10}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30)


def _x64(pair):
    """JAX computes in f64 only under ``enable_x64``."""
    return jax.enable_x64(True) if pair[0] == np.float64 else \
        contextlib.nullcontext()


def _setup(dims, nnz, tb, mx, *, vdt=np.float32, fdt=np.float32, rank=8):
    """Both packages' BLCO of one tensor, the port's CPU launch cache and
    numpy factors."""
    t = rcore.random_tensor(dims, nnz, seed=7, dist="powerlaw", dtype=vdt)
    rb = rcore.build_blco(t, target_bits=tb, max_nnz_per_block=mx)
    pb = core.build_blco(core.random_tensor(dims, nnz, seed=7,
                                            dist="powerlaw", dtype=vdt),
                         target_bits=tb, max_nnz_per_block=mx)
    rng = np.random.default_rng(0)
    factors = [rng.standard_normal((d, rank)).astype(fdt) for d in dims]
    return t, rb, pb, LaunchCache.from_blco(pb, device="cpu"), factors


def _gathered(factors, coords, mode):
    return tuple(torch.from_numpy(f).index_select(0, coords[:, m])
                 for m, f in enumerate(factors) if m != mode)


def _np(xs):
    return tuple(x.numpy() for x in xs)


@pytest.mark.parametrize("dims,nnz,tb,mx", CASES)
def test_delinearize_matches_pallas_exactly(dims, nnz, tb, mx):
    _, _, pb, pc, _ = _setup(dims, nnz, tb, mx)
    hi, lo, _, bases = pc.flat()
    kw = dict(field_bits=pb.re.field_bits, field_shifts=pb.re.field_shift)
    got = delinearize(hi, lo, bases, **kw)
    assert got.dtype == torch.int32 and got.shape == (hi.shape[0], len(dims))
    want = pallas_delinearize(*_np((hi, lo, bases)), tile=256, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the real non-zeros decode to the tensor's coordinates
    real = pc.vals.reshape(-1) != 0
    assert set(map(tuple, got[real].tolist())) == \
        set(map(tuple, core.decode_coords(pb).tolist()))
    # a ragged stream (T not a multiple of 256) decodes the same rows
    cut = hi.shape[0] - 96
    part = delinearize(hi[:cut], lo[:cut], bases[:cut], **kw)
    np.testing.assert_array_equal(part.numpy(), got[:cut].numpy())


@pytest.mark.parametrize("pair", PAIRS.values(), ids=PAIRS.keys())
@pytest.mark.parametrize("dims,nnz,tb,mx", CASES)
def test_segments_and_stash_match_pallas(dims, nnz, tb, mx, pair):
    vdt, fdt = pair
    _, _, pb, pc, factors = _setup(dims, nnz, tb, mx, vdt=vdt, fdt=fdt)
    hi, lo, vals, bases = pc.flat()
    coords = delinearize(hi, lo, bases, field_bits=pb.re.field_bits,
                         field_shifts=pb.re.field_shift)
    tile = math.gcd(hi.shape[0], 256)
    tol = TOL[np.result_type(vdt, fdt)]
    for mode, d in enumerate(dims):
        g = _gathered(factors, coords, mode)
        tgt = coords[:, mode].contiguous()
        seg_tgt, seg_sums = blco_mttkrp.mttkrp_segments(vals, tgt, g,
                                                        tile=tile)
        assert seg_tgt.dtype == torch.int32
        assert seg_sums.dtype == torch.promote_types(vals.dtype, g[0].dtype)
        with _x64(pair):
            want_tgt, want_sums = rk.mttkrp_segments(
                vals.numpy(), tgt.numpy(), _np(g), tile=tile)
            want_tgt, want_sums = np.asarray(want_tgt), np.asarray(want_sums)
            if 8 * d * np.dtype(np.result_type(vdt, fdt)).itemsize \
                    <= blco_mttkrp.STASH_MAX_BYTES:
                want_stash = np.asarray(rk.mttkrp_stash(
                    vals.numpy(), tgt.numpy(), _np(g), out_rows=d, tile=tile))
            else:
                want_stash = None
        assert want_sums.dtype == np.result_type(vdt, fdt)
        np.testing.assert_array_equal(seg_tgt.numpy(), want_tgt)
        assert _rel(seg_sums, want_sums) < tol, mode
        if want_stash is not None:
            got = blco_mttkrp.mttkrp_stash(vals, tgt, g, out_rows=d)
            assert got.shape == (d, 8) and got.dtype == seg_sums.dtype
            assert _rel(got, want_stash) < tol, mode


@pytest.mark.parametrize("tile,length", [(24, 1200), (1, 40), (96, 1152)])
def test_segments_any_tile_dividing_a_ragged_stream(tile, length):
    """K4 at tiles that are not 256 (T = ``length`` has gcd(T, 256) < 256),
    down to one non-zero per tile."""
    dims, nnz, tb, mx = CASES[1]
    _, _, pb, pc, factors = _setup(dims, nnz, tb, mx)
    assert length <= pc.num_launches * pc.reservation
    hi, lo, vals, bases = (x[:length] for x in pc.flat())
    assert math.gcd(length, 256) < 256
    coords = delinearize(hi, lo, bases, field_bits=pb.re.field_bits,
                         field_shifts=pb.re.field_shift)
    for mode in (0, 3):
        g = _gathered(factors, coords, mode)
        tgt = coords[:, mode].contiguous()
        seg_tgt, seg_sums = blco_mttkrp.mttkrp_segments(vals, tgt, g,
                                                        tile=tile)
        want_tgt, want_sums = rk.mttkrp_segments(vals.numpy(), tgt.numpy(),
                                                 _np(g), tile=tile)
        np.testing.assert_array_equal(seg_tgt.numpy(), np.asarray(want_tgt))
        assert _rel(seg_sums, want_sums) < 5e-4
        if tile == 1:
            assert (seg_tgt.numpy() == tgt.numpy()).all()


def test_recurring_target_in_one_tile_starts_a_new_run():
    """Runs are found in stream order and never merged by key."""
    tgt = np.array([2, 2, 5, 2, 2, 2, 7, 7, 2, 5] * 4 + [1] * 24, np.int32)
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(64).astype(np.float32)
    rows = (rng.standard_normal((64, 5)).astype(np.float32),)
    seg_tgt, seg_sums = blco_mttkrp.mttkrp_segments(
        torch.from_numpy(vals), torch.from_numpy(tgt),
        tuple(map(torch.from_numpy, rows)), tile=32)
    want_tgt, want_sums = rk.mttkrp_segments(vals, tgt, rows, tile=32)
    np.testing.assert_array_equal(seg_tgt.numpy(), np.asarray(want_tgt))
    assert _rel(seg_sums, want_sums) < 5e-4
    # tile 0 holds 32 slots: runs 2|5|2|7|2|5 repeat, so target 2 owns
    # several rows of the tile and -1 pads the rest
    first = seg_tgt[:32].tolist()
    assert first[:6] == [2, 5, 2, 7, 2, 5] and first.count(2) > 3
    assert first[first.index(-1):] == [-1] * (32 - first.index(-1))
    assert not seg_sums[:32][seg_tgt[:32] < 0].any()


# "register" takes K4 on every mode; "hierarchical" takes K5 where the mode
# has at most STASH_MAX_ROWS rows ("auto" is one of the two per mode)
@pytest.mark.parametrize("resolution", ["register", "hierarchical"])
@pytest.mark.parametrize("pair", PAIRS.values(), ids=PAIRS.keys())
@pytest.mark.parametrize("dims,nnz,tb,mx", CASES)
def test_phases_path_matches_pallas_and_oracle(dims, nnz, tb, mx, pair,
                                               resolution):
    vdt, fdt = pair
    t, rb, pb, pc, factors = _setup(dims, nnz, tb, mx, vdt=vdt, fdt=fdt)
    ft = [torch.from_numpy(f) for f in factors]
    tol = TOL[np.result_type(vdt, fdt)]
    for mode, d in enumerate(dims):
        c0 = core.dispatch_count()
        got = cuda_mttkrp_phases(pb, ft, mode, resolution=resolution,
                                 cache=pc)
        assert core.dispatch_count() - c0 == 3
        assert got.shape == (d, 8)
        assert got.dtype == torch.promote_types(ft[0].dtype, pc.vals.dtype)
        with _x64(pair):
            want = np.asarray(pallas_mttkrp_phases(rb, factors, mode,
                                                   resolution=resolution))
        assert _rel(got, want) < tol, (mode, resolution)
        if math.prod(dims) < 1 << 24:
            assert _rel(got, rcore.mttkrp_dense_oracle(t, factors, mode)) \
                < tol, (mode, resolution)


def test_phases_path_picks_stash_only_where_it_fits(monkeypatch):
    """A hierarchical mode takes K5 only if its stash fits 227 KB: at
    R = 300 in f64, 100 rows (240 KB) take K4 + scatter, 30 rows K5."""
    t, rb, pb, pc, factors = _setup((100, 30, 20), 500, 64, 1 << 27,
                                    vdt=np.float64, fdt=np.float64,
                                    rank=300)
    calls = []
    for name in ("mttkrp_segments", "mttkrp_stash"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    ft = [torch.from_numpy(f) for f in factors]
    for mode, kernel in ((0, "mttkrp_segments"), (1, "mttkrp_stash"),
                         (2, "mttkrp_stash")):
        calls.clear()
        got = cuda_mttkrp_phases(pb, ft, mode, cache=pc)
        assert calls == [kernel], mode
        with jax.enable_x64(True):
            want = np.asarray(pallas_mttkrp_phases(rb, factors, mode))
        assert _rel(got, want) < 1e-10
        assert _rel(got, rcore.mttkrp_dense_oracle(t, factors, mode)) < 1e-10
    with pytest.raises(ValueError):        # the wrapper refuses it outright
        blco_mttkrp.mttkrp_stash(torch.ones(256, dtype=torch.float64),
                                 torch.zeros(256, dtype=torch.int32),
                                 (torch.ones(256, 300,
                                             dtype=torch.float64),),
                                 out_rows=100)


@pytest.mark.parametrize("dims,nnz,tb,mx", CASES[:3])
def test_cuda_mttkrp_matches_pallas_one_dispatch(dims, nnz, tb, mx):
    t, rb, pb, _, factors = _setup(dims, nnz, tb, mx)
    ft = [torch.from_numpy(f) for f in factors]
    try:
        for mode in range(len(dims)):
            c0 = core.dispatch_count()
            got = cuda_mttkrp(pb, ft, mode, device="cpu")
            assert core.dispatch_count() - c0 == 1
            assert _rel(got, pallas_mttkrp(rb, factors, mode)) < 5e-4
            assert _rel(got, rcore.mttkrp_dense_oracle(t, factors, mode)) \
                < 5e-4
    finally:
        core.clear_launch_cache(pb)
        ref_clear(rb)


def test_empty_tensor_gives_zeros():
    t = core.from_coo(np.zeros((0, 3), np.int64), np.zeros(0, np.float64),
                      (5, 6, 7))
    b = core.build_blco(t)
    ft = [torch.ones(d, 3) for d in (5, 6, 7)]
    for fn in (cuda_mttkrp, cuda_mttkrp_phases):
        out = fn(b, ft, 1, device="cpu")
        assert out.shape == (6, 3) and out.dtype == torch.float64 and \
            not out.any()


@pytest.mark.parametrize("resolution", ["direct", "register", "hierarchical"])
@pytest.mark.parametrize("dims,nnz,tb,mx", CASES[:2])
def test_free_function_mttkrp_matches_reference(dims, nnz, tb, mx,
                                                resolution):
    t, rb, pb, _, factors = _setup(dims, nnz, tb, mx)
    ft = [torch.from_numpy(f) for f in factors]
    try:
        for mode in range(len(dims)):
            oracle = rcore.mttkrp_dense_oracle(t, factors, mode)
            want = ref_mttkrp(rb, factors, mode, resolution=resolution)
            for pad in (True, False):
                c0 = core.dispatch_count()
                got = core.mttkrp(pb, ft, mode, resolution=resolution,
                                  pad=pad, device="cpu")
                # the cached path and the per-launch loop: one dispatch per
                # BLCO launch
                assert core.dispatch_count() - c0 == len(pb.launches)
                assert got.shape == (dims[mode], 8)
                assert _rel(got, want) < 5e-4 and _rel(got, oracle) < 5e-4
            # the padded per-launch loop against the reference's (pad=False
            # is held against the oracle above; the reference's would
            # compile once per launch shape)
            loop = core.mttkrp_per_launch(pb, ft, mode, resolution=resolution,
                                          device="cpu")
            ref_loop = ref_per_launch(rb, factors, mode,
                                      resolution=resolution)
            assert _rel(loop, ref_loop) < 5e-4
            assert _rel(loop, oracle) < 5e-4
    finally:
        core.clear_launch_cache(pb)
        ref_clear(rb)


def test_per_launch_promotes_f64_values_with_f32_factors():
    t, rb, pb, _, factors = _setup((40, 25, 30), 2000, 12, 256,
                                   vdt=np.float64)
    ft = [torch.from_numpy(f) for f in factors]
    with jax.enable_x64(True):
        for mode in range(3):
            got = core.mttkrp_per_launch(pb, ft, mode, device="cpu")
            want = np.asarray(ref_per_launch(rb, factors, mode))
            assert got.dtype == torch.float64 and want.dtype == np.float64
            assert _rel(got, want) < 1e-10


def test_launch_cache_for_attaches_once_and_clears():
    _, rb, pb, _, _ = _setup(*CASES[1])
    cache = core.launch_cache_for(pb, device="cpu")
    assert core.launch_cache_for(pb, device="cpu") is cache
    ref_cache = ref_cache_for(rb)
    assert cache.num_launches == ref_cache.num_launches
    assert cache.reservation == ref_cache.reservation
    assert cache.device_bytes() == ref_cache.device_bytes()
    for got, want in zip(cache.flat(), ref_cache.flat()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    freed = core.clear_launch_cache(pb)
    assert freed == ref_clear(rb) > 0
    assert cache.closed and core.clear_launch_cache(pb) == 0
    again = core.launch_cache_for(pb, device="cpu")
    assert again is not cache and not again.closed
    core.clear_launch_cache(pb)
    with pytest.raises(ValueError):
        core.mttkrp(pb, [torch.ones(d, 2) for d in pb.dims], 4,
                    device="cpu")


@pytest.mark.parametrize("name", sorted(rtensor.PAPER_LIKE_SUITE))
def test_paper_like_is_byte_identical(name):
    assert core.tensor.PAPER_LIKE_SUITE[name] == \
        rtensor.PAPER_LIKE_SUITE[name]
    got = core.paper_like(name, seed=0)
    want = rtensor.paper_like(name, seed=0)
    assert got.dims == want.dims
    assert got.indices.tobytes() == want.indices.tobytes()
    assert got.values.dtype == want.values.dtype
    assert got.values.tobytes() == want.values.tobytes()


def test_wrapper_input_checks():
    _, _, pb, pc, factors = _setup(*CASES[0])
    hi, lo, vals, bases = pc.flat()
    fb, fs = pb.re.field_bits, pb.re.field_shift
    _check_inputs(hi, lo, bases, fb, fs)
    with pytest.raises(TypeError):
        _check_inputs(hi.to(torch.int64), lo, bases, fb, fs)
    with pytest.raises(TypeError):
        _check_inputs(hi, lo, bases.to(torch.int64), fb, fs)
    with pytest.raises(ValueError):
        _check_inputs(hi[1:], lo, bases, fb, fs)
    with pytest.raises(ValueError):
        _check_inputs(hi, lo, bases, fb, fs[:2])
    with pytest.raises(ValueError):
        _check_inputs(hi, lo, bases.t().contiguous().t(), fb, fs)

    coords = delinearize(hi, lo, bases, field_bits=fb, field_shifts=fs)
    g = _gathered(factors, coords, 0)
    tgt = coords[:, 0].contiguous()
    blco_mttkrp._check_kernel_inputs(vals, tgt, g)
    with pytest.raises(TypeError):           # int64 targets
        blco_mttkrp._check_kernel_inputs(vals, tgt.long(), g)
    with pytest.raises(TypeError):           # f32 values x f64 rows
        blco_mttkrp._check_kernel_inputs(vals, tgt, [x.double() for x in g])
    with pytest.raises(TypeError):           # rows of two dtypes
        blco_mttkrp._check_kernel_inputs(vals.double(), tgt,
                                         [g[0].double(), g[1]])
    with pytest.raises(ValueError):
        blco_mttkrp._check_kernel_inputs(vals, tgt, [x.t() for x in g])
    for bad_tile in (0, 512, 7):             # out of range / not dividing T
        with pytest.raises(ValueError):
            blco_mttkrp.mttkrp_segments(vals, tgt, g, tile=bad_tile)
    with pytest.raises(ValueError):          # no gathered rows
        blco_mttkrp.mttkrp_segments(vals, tgt, (), tile=256)
    with pytest.raises(ValueError):          # rows of another length
        blco_mttkrp.mttkrp_stash(vals, tgt, [x[1:] for x in g], out_rows=70)
