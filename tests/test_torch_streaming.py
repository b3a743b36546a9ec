"""The port's out-of-memory regime (``stream_mttkrp``, ``StreamedPlan``,
``OOMExecutor``, the streamed rung of ``plan_for``) against the JAX
package's, on the CPU: the same ring of buffers as on the card, unpinned
and without streams."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro import engine as rengine  # noqa: E402
from repro.core import streaming as rstreaming  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import streaming  # noqa: E402
from repro_torch.engine import (ExecutionPlan, InMemoryPlan,  # noqa: E402
                                StreamedPlan, factor_bytes, in_memory_bytes,
                                plan_for)

# max |port - x| / max |x|: the JAX package's tests bound f32 at 5e-4; f64
# differs only in the order of additions
F32_TOL, F64_TOL = 5e-4, 1e-10
# CP-ALS fits in f32 (the pseudo-inverse amplifies reordered additions)
FIT_TOL = 1e-4
RANK = 6
# (dims, nnz, dist, target_bits, max_nnz_per_block): order 4 with a stash
# mode (7 rows) and launches of 64, 63, 64, 63, 36; order 3 with launches
# of at most 96 non-zeros (the default reservation, 128, is above the
# largest) and a ragged last launch
CASES = {
    "order4-stash": ((13, 7, 29, 5), 499, "powerlaw", 8, 64),
    "order3-ragged": ((30, 22, 14), 1500, "powerlaw", 64, 96),
}
# the reservation: next_pow2 of the largest launch, the largest launch
# itself, or 37 slots above it
RESERVATIONS = ["pow2", "exact", "above"]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30)


@functools.lru_cache(maxsize=None)
def _setup(case, dtype=np.float32):
    dims, nnz, dist, tb, mx = CASES[case]
    t = rcore.random_tensor(dims, nnz, seed=5, dist=dist, dtype=dtype)
    ref = rcore.build_blco(t, target_bits=tb, max_nnz_per_block=mx)
    port = core.build_blco(core.random_tensor(dims, nnz, seed=5, dist=dist,
                                              dtype=dtype),
                           target_bits=tb, max_nnz_per_block=mx)
    return t, ref, port


def _reservation(blco, which):
    largest = max(l.nnz for l in blco.launches)
    return {"pow2": None, "exact": largest, "above": largest + 37}[which]


def _factors(dims, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((d, RANK)).astype(dtype) for d in dims]


@functools.lru_cache(maxsize=None)
def _reference_outputs(case, which):
    """The reference StreamedPlan's output (kernel="xla") on every mode."""
    t, ref, _ = _setup(case)
    plan = rengine.StreamedPlan(ref, queues=2,
                                reservation_nnz=_reservation(ref, which))
    f = _factors(t.dims)
    return tuple(np.asarray(plan.mttkrp(f, m)) for m in range(t.order))


@pytest.mark.parametrize("which", RESERVATIONS)
@pytest.mark.parametrize("case", CASES)
def test_reservation_for_matches_reference(case, which):
    _, ref, port = _setup(case)
    res = _reservation(port, which)
    spec = streaming.reservation_for(port, res)
    want = rstreaming.reservation_for(ref, res)
    assert (spec.nnz, spec.order, spec.value_itemsize) == \
        (want.nnz, want.order, want.value_itemsize)
    assert spec.bytes_per_launch == want.bytes_per_launch
    for q in (1, 3, 8):
        assert spec.bytes_in_flight(q) == want.bytes_in_flight(q)
    largest = max(l.nnz for l in port.launches)
    with pytest.raises(ValueError, match="reservation smaller"):
        streaming.reservation_for(port, largest - 1)
    with pytest.raises(ValueError, match="exceeds reservation"):
        core.LaunchChunks(port, largest - 1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("which", RESERVATIONS)
@pytest.mark.parametrize("case", CASES)
def test_chunk_into_equals_chunk_byte_for_byte(case, which, dtype):
    """``chunk_into`` writes what port ``chunk`` and reference
    ``LaunchChunks.chunk`` return, also into buffers that last held the
    fullest chunk (a stale tail past the launch), and counts one pad."""
    _, ref, port = _setup(case, dtype)
    res = streaming.reservation_for(port, _reservation(port, which)).nnz
    pc = core.LaunchChunks(port, res)
    rc = rstreaming.LaunchChunks(ref, res)
    spec = streaming.reservation_for(port, res)
    ring = streaming.StreamBuffers(spec, 1, port.values.dtype, device="cpu")
    bufs = ring.host_set(0)
    fullest = max(range(len(pc)), key=lambda i: port.launches[i].nnz)
    for i in range(len(pc)):
        pc.chunk_into(fullest, bufs)
        pads = pc.pads
        n = pc.chunk_into(i, bufs)
        assert pc.pads == pads + 1
        want = rc.chunk(i)
        got = pc.chunk(i)
        assert n == want[4] == got[4] == port.launches[i].nnz
        for a, g, w in zip(bufs, got[:4], want[:4]):
            assert a.dtype == g.dtype == w.dtype
            assert a.shape == g.shape == w.shape
            assert a.tobytes() == g.tobytes() == w.tobytes()
    with pytest.raises(ValueError, match="reservation"):
        core.LaunchChunks(port, res + 1).chunk_into(0, bufs)


@pytest.mark.parametrize("kernel", ["cuda", "torch"])
@pytest.mark.parametrize("queues", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("which", RESERVATIONS)
@pytest.mark.parametrize("case", CASES)
def test_streamed_matches_in_memory_reference_and_oracle(case, which, queues,
                                                         kernel):
    """Every mode through the port's StreamedPlan against its InMemoryPlan,
    the reference StreamedPlan and the dense oracle; ``kernel="cuda"`` runs
    the plain versions of K1/K2 on the CPU, once per chunk."""
    t, _, port = _setup(case)
    plan = StreamedPlan(port, queues=queues,
                        reservation_nnz=_reservation(port, which),
                        kernel=kernel, device="cpu")
    in_mem = InMemoryPlan(port, kernel=kernel, device="cpu")
    f = _factors(t.dims)
    ft = [torch.from_numpy(x) for x in f]
    want = _reference_outputs(case, which)
    for mode in range(t.order):
        c0 = core.dispatch_count()
        out = plan.mttkrp(ft, mode)
        assert core.dispatch_count() - c0 == len(port.launches)
        assert out.dtype == torch.float32 and out.shape == (t.dims[mode],
                                                            RANK)
        assert _rel(out, in_mem.mttkrp(ft, mode)) < F32_TOL, mode
        assert _rel(out, want[mode]) < F32_TOL, mode
        assert _rel(out, rcore.mttkrp_dense_oracle(t, f, mode)) < F32_TOL
    assert plan.stats().launches == t.order * len(port.launches)
    assert plan.chunks.pads == t.order * len(port.launches)


@pytest.mark.parametrize("kernel", ["cuda", "torch"])
@pytest.mark.parametrize("case", CASES)
def test_streamed_f64_matches_reference(case, kernel):
    t, ref, port = _setup(case, np.float64)
    f = _factors(t.dims, np.float64)
    ft = [torch.from_numpy(x) for x in f]
    plan = StreamedPlan(port, queues=3, kernel=kernel, device="cpu")
    with jax.enable_x64(True):
        rplan = rengine.StreamedPlan(ref, queues=3)
        for mode in range(t.order):
            want = np.asarray(rplan.mttkrp(f, mode))
            assert want.dtype == np.float64
            out = plan.mttkrp(ft, mode)
            assert out.dtype == torch.float64
            assert _rel(out, want) < F64_TOL, mode
            assert _rel(out, rcore.mttkrp_dense_oracle(t, f, mode)) \
                < F64_TOL


def test_stats_match_reference():
    """h2d_bytes, launches, mttkrp_calls and pads count what the
    reference's do, and the snapshot has the reference's scalar keys."""
    t, ref, port = _setup("order3-ragged")
    f = _factors(t.dims)
    plan = StreamedPlan(port, queues=3, device="cpu")
    rplan = rengine.StreamedPlan(ref, queues=3)
    for mode in (0, 2, 1):
        plan.mttkrp([torch.from_numpy(x) for x in f], mode)
        rplan.mttkrp(f, mode)
    s, w = plan.stats(), rplan.stats()
    for key in ("backend", "h2d_bytes", "launches", "mttkrp_calls"):
        assert getattr(s, key) == getattr(w, key), key
    assert s.h2d_bytes == 3 * len(port.launches) * plan.spec.bytes_per_launch
    assert plan.chunks.pads == rplan._chunks.pads == 3 * len(port.launches)
    want = [k for k in w.snapshot() if k != "hist"]
    assert list(s.snapshot()) == want
    assert s.device_time_s >= s.dispatch_time_s > 0
    assert s.put_time_s > 0 and s.total_time_s >= s.device_time_s


def test_device_bytes_host_window_and_close():
    t, ref, port = _setup("order3-ragged")
    plan = plan_for(port, 1 << 30, rank=RANK, backend="streamed", queues=3,
                    device="cpu")
    rplan = rengine.plan_for(ref, 1 << 30, rank=RANK, backend="streamed",
                             queues=3)
    assert isinstance(plan, StreamedPlan) and isinstance(plan,
                                                         ExecutionPlan)
    assert plan.device_bytes() == plan.spec.bytes_in_flight(3) == \
        rplan.device_bytes()
    assert plan.host_window_bytes() == plan.spec.bytes_per_launch * 3 == \
        rplan.host_window_bytes()
    assert plan.chunks.pads == 0            # nothing padded at construction
    assert plan.close() == rplan.close() == plan.spec.bytes_in_flight(3)
    assert plan.device_bytes() == plan.host_window_bytes() == 0
    assert plan.close() == 0                # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        plan.mttkrp([torch.from_numpy(x) for x in _factors(t.dims)], 0)


def test_plan_for_picks_streamed_one_byte_short():
    """Mirrors the reference's regime decision: in memory where the tensor
    and the factors fit, streamed one byte short of that, and a
    ValueError where neither fits."""
    t, ref, port = _setup("order3-ragged")
    fits = in_memory_bytes(port) + factor_bytes(t.dims, RANK, torch.float32)
    assert fits == rengine.in_memory_bytes(ref) + \
        rengine.factor_bytes(t.dims, RANK, np.float32)
    big = plan_for(port, fits, rank=RANK, device="cpu")
    small = plan_for(port, fits - 1, rank=RANK, queues=2, device="cpu")
    assert isinstance(big, InMemoryPlan) and big.backend == "in_memory"
    assert isinstance(small, StreamedPlan) and small.backend == "streamed"
    assert isinstance(rengine.plan_for(ref, fits - 1, rank=RANK, queues=2),
                      rengine.StreamedPlan)
    f = _factors(t.dims)
    ft = [torch.from_numpy(x) for x in f]
    for mode in range(t.order):
        oracle = rcore.mttkrp_dense_oracle(t, f, mode)
        for plan in (big, small):
            assert _rel(plan.mttkrp(ft, mode), oracle) < F32_TOL
    stream_need = small.device_bytes() + factor_bytes(t.dims, RANK,
                                                      torch.float32)
    assert isinstance(plan_for(port, stream_need, rank=RANK, queues=2,
                               device="cpu"), StreamedPlan)
    for budget in (stream_need - 1, 1024):
        with pytest.raises(ValueError, match="no regime fits"):
            plan_for(port, budget, rank=RANK, queues=2, device="cpu")
        with pytest.raises(ValueError, match="no regime fits"):
            rengine.plan_for(ref, budget, rank=RANK, queues=2)
    with pytest.raises(ValueError, match="in-memory plan needs"):
        plan_for(port, fits - 1, rank=RANK, backend="in_memory",
                 device="cpu")


@pytest.mark.parametrize("kernel", ["cuda", "torch"])
def test_cp_als_streamed_gives_in_memory_fits(kernel):
    t, ref, port = _setup("order4-stash")
    norm = float(np.linalg.norm(t.values))
    streamed = StreamedPlan(port, queues=2, kernel=kernel, device="cpu")
    in_mem = InMemoryPlan(port, kernel=kernel, device="cpu")
    got = core.cp_als(streamed, t.dims, RANK, norm_x=norm, iters=5, seed=3,
                      tol=0.0, device="cpu")
    want = core.cp_als(in_mem, t.dims, RANK, norm_x=norm, iters=5, seed=3,
                       tol=0.0, device="cpu")
    ref_fits = rcore.cp_als(rengine.StreamedPlan(ref, queues=2), t.dims,
                            RANK, norm_x=norm, iters=5, seed=3,
                            tol=0.0).fits
    np.testing.assert_allclose(got.fits, want.fits, rtol=0, atol=FIT_TOL)
    np.testing.assert_allclose(got.fits, ref_fits, rtol=0, atol=FIT_TOL)
    assert streamed.stats().launches == 5 * t.order * len(port.launches)


@pytest.mark.parametrize("kernel", ["cuda", "torch"])
def test_oom_executor_matches_reference(kernel):
    t, ref, port = _setup("order4-stash")
    f = _factors(t.dims)
    ex = core.OOMExecutor(port, queues=3, kernel=kernel, device="cpu")
    rex = rcore.OOMExecutor(ref, queues=3)
    assert ex.reservation == rex.reservation
    for mode in range(t.order):
        out = ex.mttkrp([torch.from_numpy(x) for x in f], mode)
        assert _rel(out, np.asarray(rex.mttkrp(f, mode))) < F32_TOL
    for key in ("h2d_bytes", "launches", "mttkrp_calls"):
        assert getattr(ex.stats, key) == getattr(rex.stats, key), key
    assert ex.close() == ex.spec.bytes_in_flight(3) and ex.close() == 0


def test_zero_nnz_tensor():
    t = core.from_coo(np.zeros((0, 3), np.int64), np.zeros(0, np.float32),
                      (8, 6, 4))
    ex = core.OOMExecutor(core.build_blco(t), queues=2, device="cpu")
    out = ex.mttkrp([torch.ones(d, 5) for d in t.dims], 0)
    assert out.shape == (8, 5) and not out.any()
    assert ex.stats.launches == 0 and ex.stats.h2d_bytes == 0


def test_any_chunk_iterable_streams():
    """A chunk source without ``chunk_into`` (here a list of padded
    tuples) is copied into the ring; a chunk of another shape raises, and
    a ring with fewer sets than queues is refused."""
    t, _, port = _setup("order4-stash")
    spec = streaming.reservation_for(port)
    listed = core.LaunchChunks(port, spec.nnz)
    ft = [torch.from_numpy(x) for x in _factors(t.dims)]
    ring = streaming.StreamBuffers(spec, 2, port.values.dtype, device="cpu")
    for mode in range(t.order):
        got = core.stream_mttkrp(list(listed), port, ft, mode, queues=2,
                                 buffers=ring)
        want = core.stream_mttkrp(listed, port, ft, mode, queues=2)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    short = [tuple(a[:-1] for a in c[:4]) + (c[4],) for c in listed]
    with pytest.raises(ValueError, match="does not fill"):
        core.stream_mttkrp(short, port, ft, 0, queues=2, buffers=ring)
    with pytest.raises(ValueError, match="in flight"):
        core.stream_mttkrp(listed, port, ft, 0, queues=3, buffers=ring)
    assert ring.close() == spec.bytes_in_flight(2)
    with pytest.raises(RuntimeError, match="closed"):
        ring.host_set(0)
