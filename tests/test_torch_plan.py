"""The port's engine front door: ``plan_for`` and ``InMemoryPlan``."""
import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro import engine as rengine  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.engine import (AUTO_BACKENDS, UNPORTED_BACKENDS,  # noqa: E402
                                ExecutionPlan, InMemoryPlan, factor_bytes,
                                in_memory_bytes, plan_for)

BUDGET = 1 << 30


def _blcos(dims=(13, 7, 29, 5), nnz=499, tb=8, mx=64):
    ref = rcore.build_blco(rcore.random_tensor(dims, nnz, seed=3,
                                               dist="powerlaw"),
                           target_bits=tb, max_nnz_per_block=mx)
    port = core.build_blco(core.random_tensor(dims, nnz, seed=3,
                                              dist="powerlaw"),
                           target_bits=tb, max_nnz_per_block=mx)
    return ref, port


def _factors(dims, rank=6):
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.standard_normal((d, rank)).astype(
        np.float32)) for d in dims]


@pytest.mark.parametrize("kernel", ["cuda", "torch"])
def test_plan_for_cpu_gives_in_memory_plan(kernel):
    ref, port = _blcos()
    plan = plan_for(port, BUDGET, rank=6, kernel=kernel, device="cpu")
    assert isinstance(plan, InMemoryPlan) and isinstance(plan, ExecutionPlan)
    assert plan.backend == "in_memory" and plan.kernel == kernel
    assert plan.resident.device.type == "cpu"
    rplan = rengine.plan_for(ref, BUDGET, rank=6)
    f = _factors(port.dims)
    for mode in range(port.order):
        want = np.asarray(rplan.mttkrp([x.numpy() for x in f], mode))
        got = plan.mttkrp(f, mode)
        assert np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)) \
            < 5e-4


def test_one_counted_launch_per_call():
    """``kernel="cuda"`` is one dispatch per call whatever the launch count;
    the plain path is one per BLCO launch."""
    _, port = _blcos()
    assert len(port.launches) > 1
    f = _factors(port.dims)
    fused = plan_for(port, BUDGET, rank=6, device="cpu")
    plain = plan_for(port, BUDGET, rank=6, kernel="torch", device="cpu")
    for mode in range(port.order):
        c0 = core.dispatch_count()
        fused.mttkrp(f, mode)
        assert core.dispatch_count() - c0 == 1
        c0 = core.dispatch_count()
        plain.mttkrp(f, mode)
        assert core.dispatch_count() - c0 == len(port.launches)
    assert fused.stats().launches == fused.stats().mttkrp_calls == port.order
    assert plain.stats().launches == port.order * len(port.launches)


def test_device_bytes_match_reference():
    ref, port = _blcos()
    plan = plan_for(port, BUDGET, rank=6, device="cpu")
    assert plan.device_bytes() == rengine.in_memory_bytes(ref) == \
        in_memory_bytes(port)
    assert plan.stats().h2d_bytes == plan.device_bytes()
    # one reservation-padded launch buffer per launch, as the reference counts
    cache = plan.resident.cache
    spec = core.ReservationSpec(nnz=cache.reservation, order=port.order,
                                value_itemsize=4)
    assert spec.bytes_per_launch * cache.num_launches == plan.device_bytes()
    assert factor_bytes(port.dims, 6, torch.float32) == \
        rengine.factor_bytes(ref.dims, 6, np.float32)
    assert factor_bytes(port.dims, 6, torch.float64) == \
        rengine.factor_bytes(ref.dims, 6, np.float64)


def test_stats_snapshot_has_reference_scalar_keys():
    ref, port = _blcos()
    plan = plan_for(port, BUDGET, rank=6, device="cpu")
    plan.mttkrp(_factors(port.dims), 0)
    snap = plan.stats().snapshot()
    want = rengine.plan_for(ref, BUDGET, rank=6).stats().snapshot()
    # the histograms wait for the port's observability slice
    assert list(snap) == [k for k in want if k != "hist"]
    s = plan.stats()
    assert s.mttkrp_calls == 1 and s.device_time_s >= s.dispatch_time_s > 0


def test_unported_and_unknown_backends_raise():
    _, port = _blcos()
    assert set(AUTO_BACKENDS) == set(rengine.AUTO_BACKENDS)
    for backend in UNPORTED_BACKENDS:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            plan_for(port, BUDGET, rank=6, backend=backend, device="cpu")
    with pytest.raises(ValueError):
        plan_for(port, BUDGET, rank=6, backend="bogus", device="cpu")
    with pytest.raises(ValueError):
        plan_for(port, BUDGET, rank=6, kernel="pallas", device="cpu")
    with pytest.raises(ValueError, match="streamed"):
        plan_for(port, 1000, rank=6, device="cpu")
    plan = plan_for(port, BUDGET, rank=6, backend="in_memory", device="cpu")
    assert plan.backend == "in_memory"


def test_default_device_is_the_card():
    """Without device="cpu" the plan goes to the card: where there is none
    it raises, and nothing runs on the CPU instead."""
    _, port = _blcos()
    if torch.cuda.is_available():
        plan = plan_for(port, BUDGET, rank=6)
        assert plan.resident.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_for(port, BUDGET, rank=6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InMemoryPlan(port)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        core.init_factors(port.dims, 4)


def test_close_releases_and_shared_resident():
    _, port = _blcos()
    plan = plan_for(port, BUDGET, rank=6, device="cpu")
    shared = InMemoryPlan(port, kernel="torch", resident=plan.resident,
                          owns_resident=False)
    assert shared.stats().h2d_bytes == 0
    f = _factors(port.dims)
    torch.testing.assert_close(shared.mttkrp(f, 2), plan.mttkrp(f, 2),
                               rtol=1e-5, atol=1e-5)
    nbytes = plan.device_bytes()
    assert shared.close() == nbytes and shared.close() == 0
    assert plan.resident.cache.closed is False       # not owned by `shared`
    assert plan.close() == nbytes and plan.close() == 0
    with pytest.raises(RuntimeError):
        plan.mttkrp(f, 0)


def test_empty_tensor_plan():
    t = core.from_coo(np.zeros((0, 3), np.int64), np.zeros(0, np.float32),
                      (4, 5, 6))
    plan = plan_for(core.build_blco(t), BUDGET, rank=3, device="cpu")
    assert plan.device_bytes() == 0
    out = plan.mttkrp([torch.ones(d, 3) for d in (4, 5, 6)], 2)
    assert out.shape == (6, 3) and not out.any()
