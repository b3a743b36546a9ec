"""The port's host side against the JAX package's: synthetic tensors, the
BLCO build and the stacked launch cache, byte for byte."""
import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro.core import linearize as rlin  # noqa: E402
from repro.core import padding as rpad  # noqa: E402
from repro.core.launches import LaunchCache as RefCache  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.convert import blco_from_arrays  # noqa: E402
from repro_torch.core import linearize as lin  # noqa: E402
from repro_torch.core import padding  # noqa: E402
from repro_torch.core.launches import LaunchCache  # noqa: E402

# (dims, nnz, target_bits, max_nnz_per_block): tests/test_fused.py's CASES,
# then widths (12, 12, 12), whose mode-2 field (shift 24) straddles the two
# index words, then a 5-mode tensor whose ALTO index exceeds 64 bits
CASES = [
    ((70, 40, 30), 1777, 12, 512),
    ((13, 7, 29, 5), 499, 8, 64),
    ((128, 4, 256, 8, 3), 801, 16, 128),
    ((4096, 4096, 4096), 3001, 64, 1 << 27),
    ((1 << 20, 1 << 20, 1 << 18, 1 << 16, 1 << 15), 2000, 64, 1 << 27),
]
IDS = ["order3", "order4-blocked", "order5", "straddle", "alto-128bit"]


def _pair(dims, nnz, tb, mx, dist="powerlaw", seed=7):
    t = rcore.random_tensor(dims, nnz, seed=seed, dist=dist)
    tp = core.random_tensor(dims, nnz, seed=seed, dist=dist)
    return (rcore.build_blco(t, target_bits=tb, max_nnz_per_block=mx),
            core.build_blco(tp, target_bits=tb, max_nnz_per_block=mx))


def _block_tuples(b):
    return [(k.key, k.start, k.end, k.upper) for k in b.blocks]


def _launch_tuples(b):
    return [(l.block_ids, l.start, l.end) for l in b.launches]


@pytest.mark.parametrize("dist", ["uniform", "powerlaw", "clustered"])
def test_random_tensor_identical(dist):
    for dims, nnz, _, _ in CASES:
        a = rcore.random_tensor(dims, nnz, seed=3, dist=dist)
        b = core.random_tensor(dims, nnz, seed=3, dist=dist)
        assert a.dims == b.dims
        assert a.indices.tobytes() == b.indices.tobytes()
        assert a.values.tobytes() == b.values.tobytes()


def test_from_coo_sums_duplicates_identically():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 5, size=(400, 3))
    vals = rng.standard_normal(400).astype(np.float32)
    a = rcore.from_coo(idx, vals, (5, 5, 5))
    b = core.from_coo(idx, vals, (5, 5, 5))
    assert a.indices.tobytes() == b.indices.tobytes()
    assert a.values.tobytes() == b.values.tobytes()
    # coordinates outside dims take the reference's lexsort path
    idx[0, 0] = 9
    a = rcore.from_coo(idx, vals, (5, 5, 5))
    b = core.from_coo(idx, vals, (5, 5, 5))
    assert a.indices.tobytes() == b.indices.tobytes()


@pytest.mark.parametrize("dims,nnz,tb,mx", CASES, ids=IDS)
def test_build_blco_byte_identical(dims, nnz, tb, mx):
    ref, port = _pair(dims, nnz, tb, mx)
    assert port.dims == ref.dims and port.nnz == ref.nnz
    for name in ("idx_hi", "idx_lo", "values"):
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert _block_tuples(port) == _block_tuples(ref)
    assert _launch_tuples(port) == _launch_tuples(ref)
    assert (port.re.field_bits, port.re.field_shift, port.re.block_bits) == \
        (ref.re.field_bits, ref.re.field_shift, ref.re.block_bits)
    assert (port.spec.bits, port.spec.positions, port.spec.total_bits) == \
        (ref.spec.bits, ref.spec.positions, ref.spec.total_bits)
    assert core.format_bytes(port) == rcore.format_bytes(ref)
    np.testing.assert_array_equal(core.decode_coords(port),
                                  rcore.decode_coords(ref))


def test_cases_cover_straddle_blocking_and_wide_alto():
    _, port = _pair(*CASES[3])
    assert port.re.field_bits == (12, 12, 12)
    assert any(s < 32 < s + w for s, w in zip(port.re.field_shift,
                                               port.re.field_bits))
    _, port = _pair(*CASES[1])
    assert len(port.launches) > 1
    _, port = _pair(*CASES[4])
    assert port.spec.total_bits > 64 and len(port.blocks) > 1


@pytest.mark.parametrize("dims", [(70, 40, 30), (1 << 20, 1 << 19, 1 << 18),
                                  (1 << 25,) * 5])
def test_alto_encode_and_sort_identical(dims):
    rng = np.random.default_rng(1)
    idx = np.stack([rng.integers(0, d, 3000) for d in dims], 1)
    spec = lin.LinearSpec.make(dims)
    rspec = rlin.LinearSpec.make(dims)
    hi, lo = lin.alto_encode(spec, idx)
    rhi, rlo = rlin.alto_encode(rspec, idx)
    assert hi.tobytes() == rhi.tobytes() and lo.tobytes() == rlo.tobytes()
    np.testing.assert_array_equal(lin.sort_by_alto(hi, lo),
                                  rlin.sort_by_alto(rhi, rlo))
    np.testing.assert_array_equal(lin.alto_decode(spec, hi, lo), idx)


def test_random_tensor_exact_reaches_nnz():
    dims, nnz = (183, 24, 1140, 1717), 20_000
    head = core.random_tensor(dims, nnz, seed=5, dist="powerlaw")
    t = core.top_up_uniform(head, nnz, seed=5)
    assert t.values.dtype == np.float32
    ref_head = rcore.random_tensor(dims, nnz, seed=5, dist="powerlaw")
    assert t.nnz == nnz > head.nnz == ref_head.nnz
    assert len(np.unique(np.ravel_multi_index(tuple(t.indices.T), dims))) \
        == nnz
    assert (t.indices < np.array(dims)).all() and (t.values != 0).all()
    # the skewed head is the reference draw, unchanged
    assert t.indices[:head.nnz].tobytes() == ref_head.indices.tobytes()
    assert t.values[:head.nnz].tobytes() == ref_head.values.tobytes()
    again = core.top_up_uniform(head, nnz, seed=5)
    assert again.indices.tobytes() == t.indices.tobytes()
    assert core.top_up_uniform(head, head.nnz) is head
    with pytest.raises(ValueError):
        core.top_up_uniform(head, head.nnz - 1)
    # an empty head is all background
    empty = core.from_coo(np.zeros((0, 4), np.int64), np.zeros(0), dims)
    assert core.top_up_uniform(empty, 500, seed=1).nnz == 500


def test_padding_helpers_identical():
    for n in list(range(1, 3000, 7)) + [1 << 20, (1 << 20) + 1, 76_879_419]:
        assert padding.next_pow2(n) == rpad.next_pow2(n)
        assert padding.pad_pow2(n) == rpad.pad_pow2(n)
        assert padding.pad_multiple(n) == rpad.pad_multiple(n)
        assert padding.pad_bucket(n) == rpad.pad_bucket(n)


@pytest.mark.parametrize("dims,nnz,tb,mx", CASES, ids=IDS)
def test_launch_cache_matches_reference(dims, nnz, tb, mx):
    ref, port = _pair(dims, nnz, tb, mx)
    rc = RefCache.from_blco(ref)
    pc = LaunchCache.from_blco(port, device="cpu")
    for name in ("hi", "lo", "vals", "bases"):
        a = np.asarray(getattr(rc, name))
        b = getattr(pc, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert a.tobytes() == b.tobytes(), name
    assert pc.reservation == rc.reservation
    assert pc.num_launches == rc.num_launches
    assert pc.device_bytes() == rc.device_bytes() == \
        core.launch_cache_bytes(port)
    # an explicit ragged reservation rounds up the same way
    rc2 = RefCache.from_blco(ref, reservation_nnz=pc.reservation + 3)
    pc2 = LaunchCache.from_blco(port, reservation_nnz=pc.reservation + 3,
                                device="cpu")
    assert pc2.reservation == rc2.reservation


def test_launch_cache_flat_is_a_view():
    _, port = _pair(*CASES[1])
    pc = LaunchCache.from_blco(port, device="cpu")
    hi, lo, vals, bases = pc.flat()
    t = pc.num_launches * pc.reservation
    assert hi.shape == (t,) and bases.shape == (t, port.order)
    for flat, stacked in ((hi, pc.hi), (lo, pc.lo), (vals, pc.vals),
                          (bases, pc.bases)):
        assert flat.data_ptr() == stacked.data_ptr()
    with pytest.raises(ValueError):
        LaunchCache.from_blco(port, reservation_nnz=1, device="cpu")
    pc.delete()
    assert pc.device_bytes() == 0
    with pytest.raises(RuntimeError):
        pc.flat()


@pytest.mark.parametrize("dims,nnz,tb,mx", CASES, ids=IDS)
def test_blco_from_arrays_roundtrip(dims, nnz, tb, mx):
    ref, port = _pair(dims, nnz, tb, mx)
    conv = blco_from_arrays(
        ref.dims, ref.re.field_bits, ref.re.field_shift, ref.re.block_bits,
        ref.idx_hi, ref.idx_lo, ref.values, _block_tuples(ref),
        _launch_tuples(ref))
    for name in ("idx_hi", "idx_lo", "values"):
        assert getattr(conv, name).tobytes() == getattr(port, name).tobytes()
    assert conv.re == port.re and conv.spec == port.spec
    assert conv.blocks == port.blocks and conv.launches == port.launches
    a = LaunchCache.from_blco(conv, device="cpu")
    b = LaunchCache.from_blco(port, device="cpu")
    assert torch.equal(a.bases, b.bases) and torch.equal(a.vals, b.vals)
