"""The plain versions of the fused kernels K1 (segment) and K2 (stash)
against the JAX package's Pallas kernels in interpret mode, and the CPU
dispatch of the port's kernel wrappers."""
import math

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro.core.launches import LaunchCache as RefCache  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.fused import fused_mttkrp_flat as ref_fused  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core.launches import LaunchCache  # noqa: E402
from repro_torch.kernels import fused, ref  # noqa: E402


def _case(dims, nnz, tb, mx, *, rank=8, cut=0, id):
    """One stream: ``rank`` columns, ``cut`` slots cut off its end."""
    return pytest.param(dims, nnz, tb, mx, rank, cut, id=id)


# tests/test_fused.py's CASES (ragged nnz: every launch ends in padding
# slots) plus a field that straddles the two index words, then the edges of
# the kernels' batched walk: a stream whose length is not a multiple of 32,
# target modes of 1 and 2 rows (one run over the whole stream, longer than
# any batch or chunk), R in {1, 16, 33, 64}, and order 8 (MAX_ORDER)
CASES = [
    _case((70, 40, 30), 1777, 12, 512, id="dims0-1777-12-512"),   # order 3
    _case((13, 7, 29, 5), 499, 8, 64,                 # order 4, forced blocking
          id="dims1-499-8-64"),
    _case((128, 4, 256, 8, 3), 801, 16, 128, id="dims2-801-16-128"),
    _case((2048, 2048, 2048), 3001, 64, 1 << 27,      # mode-2 field shift 22
          id="dims3-3001-64-134217728"),
    _case((70, 40, 30), 1777, 12, 512, rank=1, cut=40, id="rank1-T984"),
    _case((1, 2, 300, 200), 3000, 64, 1 << 27, rank=16, id="rows1-rows2"),
    _case((600, 90, 9), 1500, 64, 1 << 27, rank=33, id="rank33"),
    _case((2, 3, 5, 4, 3, 2, 6, 7), 3000, 64, 1 << 27, rank=64,
          id="order8-rank64"),
]
F32_TOL = 5e-4      # max-rel bound of the JAX package's kernel tests


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30)


def _streams(dims, nnz, tb, mx, rank=8, cut=0):
    """The tensor, its BLCO, the reference's and the port's launch caches
    and numpy factors; ``cut`` is applied by ``_flat``."""
    t = rcore.random_tensor(dims, nnz, seed=7, dist="powerlaw")
    b = core.build_blco(core.random_tensor(dims, nnz, seed=7,
                                           dist="powerlaw"),
                        target_bits=tb, max_nnz_per_block=mx)
    rc = RefCache.from_blco(rcore.build_blco(t, target_bits=tb,
                                             max_nnz_per_block=mx))
    pc = LaunchCache.from_blco(b, device="cpu")
    rng = np.random.default_rng(0)
    factors = [rng.standard_normal((d, rank)).astype(np.float32)
               for d in dims]
    return t, b, rc, pc, factors


def _flat(cache, cut):
    """The cache's flat stream without its last ``cut`` slots."""
    return tuple(x[:x.shape[0] - cut] for x in cache.flat())


@pytest.mark.parametrize("resolution", ["register", "hierarchical"])
@pytest.mark.parametrize("dims,nnz,tb,mx,rank,cut", CASES)
def test_plain_kernels_match_pallas_interpret(dims, nnz, tb, mx, rank, cut,
                                              resolution):
    t, b, rc, pc, factors = _streams(dims, nnz, tb, mx, rank)
    ft = [torch.from_numpy(f) for f in factors]
    rflat, pflat = _flat(rc, cut), _flat(pc, cut)
    # the dense oracle holds while only padding slots (value 0) are cut
    whole = not pc.flat()[2][pflat[0].shape[0]:].any()
    for mode in range(len(dims)):
        kw = dict(field_bits=b.re.field_bits, field_shifts=b.re.field_shift,
                  mode=mode, out_rows=dims[mode], resolution=resolution)
        want = ref_fused(*rflat, factors, interpret=True, **kw)
        got = fused.fused_mttkrp_flat(*pflat, ft, **kw)
        assert got.shape == (dims[mode], rank) and got.dtype == torch.float32
        assert _rel(got, want) < F32_TOL, (mode, resolution)
        if whole and math.prod(dims) < 1 << 24:
            assert _rel(got, rcore.mttkrp_dense_oracle(t, factors, mode)) \
                < F32_TOL


@pytest.mark.parametrize("dims,nnz,tb,mx,rank,cut", CASES)
def test_segment_outputs_match_reference_segments(dims, nnz, tb, mx, rank,
                                                  cut):
    """K1's per-tile (seg_tgt, seg_sums) with the reference's tile rule."""
    _, b, rc, pc, factors = _streams(dims, nnz, tb, mx, rank)
    ft = [torch.from_numpy(f) for f in factors]
    hi, lo, vals, bases = _flat(pc, cut)
    rhi, rlo, rvals, rbases = _flat(rc, cut)
    coords = rref.delinearize_ref(rhi, rlo, rbases,
                                  field_bits=b.re.field_bits,
                                  field_shifts=b.re.field_shift)
    tile = math.gcd(hi.shape[0], 256)
    for mode in range(len(dims)):
        gathered = tuple(jnp.take(jnp.asarray(factors[m]), coords[:, m],
                                  axis=0)
                         for m in range(len(dims)) if m != mode)
        want_tgt, want_sums = rref.mttkrp_segments_ref(
            rvals, coords[:, mode], gathered, tile=tile)
        seg_tgt, seg_sums = ref.fused_segment_ref(
            hi, lo, vals, bases, ft, field_bits=b.re.field_bits,
            field_shifts=b.re.field_shift, mode=mode, tile=tile)
        assert seg_tgt.dtype == torch.int32
        np.testing.assert_array_equal(seg_tgt.numpy(), np.asarray(want_tgt))
        np.testing.assert_allclose(seg_sums.numpy(), np.asarray(want_sums),
                                   rtol=1e-5, atol=1e-5)
        scattered = ref.scatter_segments_ref(seg_tgt, seg_sums, dims[mode])
        want = rref.scatter_segments_ref(want_tgt, want_sums, dims[mode])
        assert _rel(scattered, want) < F32_TOL


def test_plain_stash_matches_reference_stash():
    _, b, rc, pc, factors = _streams(*CASES[1].values)
    ft = [torch.from_numpy(f) for f in factors]
    rhi, rlo, rvals, rbases = rc.flat()
    coords = rref.delinearize_ref(rhi, rlo, rbases,
                                  field_bits=b.re.field_bits,
                                  field_shifts=b.re.field_shift)
    for mode, d in enumerate(b.dims):
        gathered = tuple(jnp.take(jnp.asarray(factors[m]), coords[:, m],
                                  axis=0)
                         for m in range(b.order) if m != mode)
        want = rref.mttkrp_stash_ref(rvals, coords[:, mode], gathered,
                                     out_rows=d)
        got = ref.fused_stash_ref(*pc.flat(), ft, field_bits=b.re.field_bits,
                                  field_shifts=b.re.field_shift, mode=mode,
                                  out_rows=d)
        assert _rel(got, want) < F32_TOL


def test_variant_rule_rows_and_shared_memory():
    four = dict(rank=32, itemsize=4)
    assert fused._variant_for("hierarchical", fused.STASH_MAX_ROWS,
                              **four) == "stash"
    assert fused._variant_for("hierarchical", fused.STASH_MAX_ROWS + 1,
                              **four) == "segment"
    assert fused._variant_for("register", 4, **four) == "segment"
    assert fused._variant_for("direct", 4, **four) == "segment"
    # the stash must fit one CTA's shared memory (227 KB): at R = 32 an
    # f64 stash of 512 rows (128 KB) fits; at R = 64, 512 f64 rows do not
    assert fused.STASH_MAX_BYTES == 227 * 1024
    assert fused._variant_for("hierarchical", 512, rank=32,
                              itemsize=8) == "stash"
    assert fused._variant_for("hierarchical", 512, rank=64,
                              itemsize=8) == "segment"
    assert fused._variant_for("hierarchical", 100, rank=290,
                              itemsize=8) == "stash"
    assert fused._variant_for("hierarchical", 100, rank=291,
                              itemsize=8) == "segment"


def test_cpu_dispatch_runs_the_plain_version():
    _, b, _, pc, factors = _streams(*CASES[0].values)
    ft = [torch.from_numpy(f) for f in factors]
    hi, lo, vals, bases = pc.flat()
    kw = dict(field_bits=b.re.field_bits, field_shifts=b.re.field_shift)
    counts = dict(fused.launch_counts)
    for mode, res in ((0, "register"), (1, "hierarchical")):
        c0 = core.dispatch_count()
        got = fused.fused_cache_mttkrp(pc, ft, mode, resolution=res)
        assert core.dispatch_count() - c0 == 1
        if res == "register":
            want = ref.fused_segment_mttkrp_ref(
                hi, lo, vals, bases, ft, mode=mode, out_rows=b.dims[mode],
                tile=256, **kw)
        else:
            want = ref.fused_stash_ref(hi, lo, vals, bases, ft, mode=mode,
                                       out_rows=b.dims[mode], **kw)
        assert torch.equal(got, want)
    # no kernel was launched: the counters count launches on the card only
    assert fused.launch_counts == counts


def test_empty_cache_and_closed_cache():
    t = core.from_coo(np.zeros((0, 3), np.int64), np.zeros(0, np.float64),
                      (5, 6, 7))
    pc = LaunchCache.from_blco(core.build_blco(t), device="cpu")
    out = fused.fused_cache_mttkrp(pc, [torch.ones(d, 3) for d in (5, 6, 7)],
                                   1)
    assert out.shape == (6, 3) and out.dtype == torch.float64 and \
        not out.any()
    pc.delete()
    with pytest.raises(RuntimeError):
        fused.fused_cache_mttkrp(pc, [torch.ones(d, 3) for d in (5, 6, 7)], 1)


def test_kernel_input_checks():
    _, b, _, pc, factors = _streams(*CASES[0].values)
    hi, lo, vals, bases = pc.flat()
    ft = [torch.from_numpy(f) for f in factors]
    fb, fs = b.re.field_bits, b.re.field_shift
    fused._check_inputs(hi, lo, vals, bases, ft, fb, fs, 0)
    with pytest.raises(TypeError):           # f32 values x f64 factors
        fused._check_inputs(hi, lo, vals, bases, [f.double() for f in ft],
                            fb, fs, 0)
    with pytest.raises(TypeError):
        fused._check_inputs(hi.to(torch.int64), lo, vals, bases, ft, fb, fs,
                            0)
    with pytest.raises(ValueError):
        fused._check_inputs(hi[1:], lo, vals, bases, ft, fb, fs, 0)
    with pytest.raises(ValueError):
        fused._check_inputs(hi, lo, vals, bases, ft[:2], fb, fs, 0)
    with pytest.raises(ValueError):
        fused._check_inputs(hi, lo, vals, bases.t().contiguous().t(), ft, fb,
                            fs, 0)
    with pytest.raises(ValueError):          # mode out of range
        fused._check_inputs(hi, lo, vals, bases, ft, fb, fs, 3)


# NELL-2's and Uber's padded streams at full size, and tiny ones
@pytest.mark.parametrize("t", [83_886_080, 3_670_016, 1, 31, 33, 5120])
@pytest.mark.parametrize("sms,per_sm", [(132, 2), (132, 5), (1, 1)])
def test_launch_geometry_is_one_wave_covering_t_once(t, sms, per_sm):
    blocks, chunk = fused.launch_geometry(t, sms, per_sm, 256)
    pieces = -(-t // chunk)
    assert chunk >= 32 and chunk % 32 == 0
    assert (pieces - 1) * chunk < t <= pieces * chunk   # each slot once
    assert 1 <= blocks <= sms * per_sm                  # one wave
    assert (blocks - 1) * 8 < pieces      # no CTA without a piece to take
    assert pieces <= sms * per_sm * 8 * fused.PIECES_PER_WARP
    if t >= 32 * 8 * fused.PIECES_PER_WARP * sms * per_sm:
        assert blocks == sms * per_sm     # a large stream fills the wave
    geo = fused.Geometry(blocks, chunk, 256, sms, per_sm, 32)
    assert geo.waves == 1 and geo.warps_per_sm == 8 * per_sm


def test_launch_geometry_refuses_what_cannot_launch():
    for args in ((0, 132, 2, 256), (100, 132, 0, 256), (100, 0, 2, 256),
                 (100, 132, 2, 48)):
        with pytest.raises(ValueError):
            fused.launch_geometry(*args)
