"""The CUDA kernels K1 (segment), K2 (stash), K3 (delinearize), K4
(segments) and K5 (stash_phases) against their plain PyTorch versions, on
the card.

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips where no card is present; whether one is present is decided inside
the fixture, never at import time.  This file imports only the port, so it
also runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.core.launches import LaunchCache
from repro_torch.core.mttkrp import CONTENTION_THRESHOLD
from repro_torch.engine import plan_for
from repro_torch.kernels import (blco_mttkrp, common, cuda_mttkrp_phases,
                                 delinearize, fused, ref)

pytestmark = pytest.mark.gpu

# (dims, nnz, target_bits, max_nnz_per_block, rank): orders 3-5 with ragged
# nnz, forced blocking, a field straddling the two index words with R > 32;
# then the edges of K1/K2's batched walk: R in {1, 16, 33, 64}, target modes
# of 1 and 2 rows (one run over the whole stream), order 8 (MAX_ORDER), and
# a stream of 196,608 slots, many pieces per warp
CASES = [
    ((70, 40, 30), 1777, 12, 512, 8),
    ((13, 7, 29, 5), 499, 8, 64, 32),
    ((128, 4, 256, 8, 3), 801, 16, 128, 16),
    ((2048, 2048, 2048), 6007, 64, 1 << 27, 40),
    ((70, 40, 30), 1777, 12, 512, 1),
    ((1, 2, 300, 200), 3000, 64, 1 << 27, 16),
    ((600, 90, 9), 1500, 64, 1 << 27, 33),
    ((2, 3, 5, 4, 3, 2, 6, 7), 3000, 64, 1 << 27, 64),
    ((1, 1 << 16, 1 << 16), 1_000_000, 64, 1 << 27, 32),
]
# slots cut off the stream's end in the K1/K2 test: T - 7 is no multiple of 32
RAGGED = 7
PAIRS = [(torch.float32, torch.float32), (torch.float64, torch.float64),
         (torch.float64, torch.float32)]
# max |kernel - plain| / max |plain|: 5e-4 in f32 (the JAX package's kernel
# tests); in f64 only the order of the atomic additions differs
REL_TOL = {torch.float32: 5e-4, torch.float64: 1e-10}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _plain(variant, hi, lo, vals, bases, fs, **kw):
    if variant == "stash":
        return ref.fused_stash_ref(hi, lo, vals, bases, fs, **kw)
    return ref.fused_segment_mttkrp_ref(hi, lo, vals, bases, fs,
                                        tile=math.gcd(hi.shape[0], 256), **kw)


@pytest.mark.parametrize("pair", PAIRS, ids=["f32", "f64", "f64xf32"])
@pytest.mark.parametrize("dims,nnz,tb,mx,rank", CASES)
def test_kernels_match_plain_versions(cuda, dims, nnz, tb, mx, rank, pair):
    """K1 and K2 on the whole stream and on one whose length is no multiple
    of 32, each launch one wave."""
    vdt, fdt = pair
    t = core.random_tensor(dims, nnz, seed=7, dist="powerlaw")
    b = core.build_blco(t, target_bits=tb, max_nnz_per_block=mx)
    flat = LaunchCache.from_blco(b, device=cuda).flat()
    rng = np.random.default_rng(0)
    fs = [torch.as_tensor(rng.standard_normal((d, rank))).to(cuda, fdt)
          for d in dims]
    for cut in (0, RAGGED):
        hi, lo, vals, bases = (x[:x.shape[0] - cut] for x in flat)
        vals = vals.to(vdt)
        for mode, d in enumerate(dims):
            kw = dict(field_bits=b.re.field_bits,
                      field_shifts=b.re.field_shift, mode=mode, out_rows=d)
            for res in ("register", "hierarchical"):
                before = dict(fused.launch_counts)
                out = fused.fused_mttkrp_flat(hi, lo, vals, bases, fs,
                                              resolution=res, **kw)
                variant = fused._variant_for(res, d, rank=rank,
                                             itemsize=out.element_size())
                assert fused.launch_counts[variant] == before[variant] + 1
                geo = fused.kernel_geometry(variant, vdt, fdt, len(dims), d,
                                            rank, hi.shape[0], cuda)
                assert geo.waves == 1, geo
                want = _plain(variant, hi, lo, vals, bases, fs, **kw)
                torch.cuda.synchronize()
                assert out.dtype == torch.promote_types(vdt, fdt)
                assert out.shape == (d, rank)
                assert _rel(out, want) < REL_TOL[out.dtype], \
                    (cut, mode, res, variant)


@pytest.mark.parametrize("pair", PAIRS, ids=["f32", "f64", "f64xf32"])
def test_piece_edges_match_plain_versions(cuda, pair):
    """Pinned (blocks, chunk) layouts: a run of one target over the whole
    stream (a 1-row mode) and runs of a 2-row mode cross batches inside a
    piece, piece boundaries (many pieces per warp, or one), and a last piece
    shorter than a batch."""
    vdt, fdt = pair
    t = core.random_tensor((1, 2, 300, 200), 3000, seed=7, dist="powerlaw")
    b = core.build_blco(t, target_bits=64, max_nnz_per_block=1 << 27)
    hi, lo, vals, bases = (x[:x.shape[0] - RAGGED] for x in
                           LaunchCache.from_blco(b, device=cuda).flat())
    vals = vals.to(vdt)
    n = hi.shape[0]
    rng = np.random.default_rng(0)
    fs = [torch.as_tensor(rng.standard_normal((d, 33))).to(cuda, fdt)
          for d in b.dims]
    out_dtype = torch.promote_types(vdt, fdt)
    for mode in (0, 1):
        kw = dict(field_bits=b.re.field_bits, field_shifts=b.re.field_shift,
                  mode=mode, out_rows=b.dims[mode])
        for layout in ((1, 32), (2, 64), (5, 96), (1, -(-n // 256) * 32)):
            for variant in fused.VARIANTS:
                out = fused._launch(variant, hi, lo, vals, bases, fs,
                                    out_dtype=out_dtype, layout=layout, **kw)
                want = _plain(variant, hi, lo, vals, bases, fs, **kw)
                torch.cuda.synchronize()
                assert _rel(out, want) < REL_TOL[out_dtype], \
                    (mode, layout, variant)


def test_occupancy_is_asked_once_and_a_bad_layout_raises(cuda):
    t = core.random_tensor((30, 20, 10), 300, seed=1)
    b = core.build_blco(t)
    hi, lo, vals, bases = LaunchCache.from_blco(b, device=cuda).flat()
    fs = [torch.ones(d, 4, device=cuda) for d in b.dims]
    kw = dict(field_bits=b.re.field_bits, field_shifts=b.re.field_shift,
              mode=0, out_rows=30)
    fused._occupancy.cache_clear()
    for _ in range(3):
        fused.fused_mttkrp_flat(hi, lo, vals, bases, fs,
                                resolution="register", **kw)
    assert fused._occupancy.cache_info().misses == 1
    geo = fused.kernel_geometry("segment", vals.dtype, fs[0].dtype, 3, 30, 4,
                                hi.shape[0], cuda)
    assert geo.waves == 1 and geo.batch in (16, 32)
    assert geo.sms == torch.cuda.get_device_properties(0).multi_processor_count
    for layout in ((1, 48), (0, 32)):       # not 32 | chunk; no CTA
        with pytest.raises(RuntimeError):
            fused._launch("segment", hi, lo, vals, bases, fs,
                          out_dtype=torch.float32, layout=layout, **kw)


def test_plan_is_one_launch_per_call(cuda):
    t = core.random_tensor((13, 7, 29, 5), 499, seed=3, dist="powerlaw")
    b = core.build_blco(t, target_bits=8, max_nnz_per_block=64)
    plan = plan_for(b, 1 << 30, rank=8)
    assert plan.resident.device.type == "cuda"
    fs = core.init_factors(b.dims, 8, seed=1)
    before = sum(fused.launch_counts.values())
    for mode in range(b.order):
        plan.mttkrp(fs, mode)
    assert sum(fused.launch_counts.values()) - before == b.order
    assert plan.stats().launches == plan.stats().mttkrp_calls == b.order


def test_unsupported_dtypes_raise(cuda):
    t = core.random_tensor((30, 20, 10), 300, seed=1)
    b = core.build_blco(t)
    hi, lo, vals, bases = LaunchCache.from_blco(b, device=cuda).flat()
    fs = [torch.ones(d, 4, device=cuda, dtype=torch.float64) for d in b.dims]
    with pytest.raises(TypeError):          # f32 values x f64 factors
        fused.fused_mttkrp_flat(hi, lo, vals, bases, fs,
                                field_bits=b.re.field_bits,
                                field_shifts=b.re.field_shift, mode=0,
                                out_rows=30)


def test_build_reports_registers(cuda):
    from repro_torch.kernels.build import load_libraries, load_library
    assert set(load_libraries()) == {"fused_mttkrp", "phases"}
    ph = load_library("phases")
    assert "registers" in ph.log
    assert ph.lib.phases_max_order() == common.MAX_ORDER
    assert ph.lib.phases_max_tile() == blco_mttkrp.MAX_TILE
    assert ph.lib.phases_stash_max_bytes() == common.STASH_MAX_BYTES
    kl = load_library("fused_mttkrp")
    assert kl.path.is_file()
    assert "registers" in kl.log
    # the limits the wrapper checks are the ones the C side enforces
    assert kl.lib.fused_mttkrp_max_order() == common.MAX_ORDER
    assert kl.lib.fused_mttkrp_stash_max_bytes() == common.STASH_MAX_BYTES


@pytest.mark.parametrize("pair", PAIRS, ids=["f32", "f64", "f64xf32"])
@pytest.mark.parametrize("dims,nnz,tb,mx,rank", CASES)
def test_phase_kernels_match_plain_versions(cuda, dims, nnz, tb, mx, rank,
                                            pair):
    """K3 exactly, K4's seg_tgt exactly and its sums and K5 within the
    tolerance, at the stream's tile, a non-power-of-two tile over a ragged
    prefix, and tile 1."""
    vdt, fdt = pair
    t = core.random_tensor(dims, nnz, seed=7, dist="powerlaw")
    b = core.build_blco(t, target_bits=tb, max_nnz_per_block=mx)
    hi, lo, vals, bases = LaunchCache.from_blco(b, device=cuda).flat()
    vals = vals.to(vdt)
    kw = dict(field_bits=b.re.field_bits, field_shifts=b.re.field_shift)
    before = common.launch_counts["delinearize"]
    coords = delinearize(hi, lo, bases, **kw)
    assert common.launch_counts["delinearize"] == before + 1
    assert torch.equal(coords, ref.delinearize_ref(hi, lo, bases, **kw))
    cut = hi.shape[0] - 160
    assert torch.equal(delinearize(hi[:cut], lo[:cut], bases[:cut], **kw),
                       coords[:cut])
    rng = np.random.default_rng(0)
    fs = [torch.as_tensor(rng.standard_normal((d, rank))).to(cuda, fdt)
          for d in dims]
    t_all = hi.shape[0]
    ragged = (t_all // 96) * 96 - 96
    for mode, d in enumerate(dims):
        g = tuple(fs[m].index_select(0, coords[:, m])
                  for m in range(len(dims)) if m != mode)
        tgt = coords[:, mode].contiguous()
        for tile, n in ((math.gcd(t_all, 256), t_all), (96, ragged), (1, 64)):
            args = (vals[:n], tgt[:n], tuple(x[:n] for x in g))
            seg_tgt, seg_sums = blco_mttkrp.mttkrp_segments(*args, tile=tile)
            want_tgt, want_sums = ref.mttkrp_segments_ref(*args, tile=tile)
            torch.cuda.synchronize()
            assert seg_sums.dtype == torch.promote_types(vdt, fdt)
            assert torch.equal(seg_tgt, want_tgt), (mode, tile)
            assert _rel(seg_sums, want_sums) < REL_TOL[seg_sums.dtype], \
                (mode, tile)
        if d * rank * seg_sums.element_size() <= common.STASH_MAX_BYTES:
            out = blco_mttkrp.mttkrp_stash(vals, tgt, g, out_rows=d)
            want = ref.mttkrp_stash_ref(vals, tgt, g, out_rows=d)
            torch.cuda.synchronize()
            assert out.shape == (d, rank)
            assert _rel(out, want) < REL_TOL[out.dtype], mode


def test_phases_path_is_one_launch_of_each_phase_kernel(cuda):
    """One K3 and one K4 or K5 launch per call; a hierarchical mode whose
    stash fits takes K5; the result agrees with the fused kernel."""
    t = core.random_tensor((13, 7, 29, 5), 499, seed=3, dist="powerlaw")
    b = core.build_blco(t, target_bits=8, max_nnz_per_block=64)
    cache = LaunchCache.from_blco(b, device=cuda)
    fs = core.init_factors(b.dims, 8, seed=1, device=cuda)
    for mode in range(b.order):
        before = dict(common.launch_counts)
        c0 = core.dispatch_count()
        out = cuda_mttkrp_phases(b, fs, mode, cache=cache)
        assert core.dispatch_count() - c0 == 3
        after = dict(common.launch_counts)
        stash = b.dims[mode] < CONTENTION_THRESHOLD
        assert {k: after[k] - before[k] for k in after} == {
            "segment": 0, "stash": 0, "delinearize": 1,
            "segments": 0 if stash else 1, "stash_phases": 1 if stash else 0}
        want = fused.fused_cache_mttkrp(cache, fs, mode)
        torch.cuda.synchronize()
        assert _rel(out, want) < REL_TOL[torch.float32], mode


def test_phase_kernels_refuse_unsupported_inputs(cuda):
    vals = torch.ones(256, device=cuda)
    tgt = torch.zeros(256, dtype=torch.int32, device=cuda)
    rows = (torch.ones(256, 4, dtype=torch.float64, device=cuda),)
    with pytest.raises(TypeError):          # f32 values x f64 rows
        blco_mttkrp.mttkrp_segments(vals, tgt, rows, tile=256)
    with pytest.raises(TypeError):
        blco_mttkrp.mttkrp_stash(vals, tgt, rows, out_rows=4)
    with pytest.raises(TypeError):          # int64 targets
        blco_mttkrp.mttkrp_segments(vals, tgt.long(),
                                    (rows[0].float(),), tile=256)
    hi = torch.zeros(256, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):          # index words must be uint32
        delinearize(hi, hi, torch.zeros(256, 1, dtype=torch.int32,
                                        device=cuda),
                    field_bits=(8,), field_shifts=(0,))
