"""The observability tier on the card: exact conservation of the bandwidth
ledger against ``EngineStats`` in every regime, and the streamed copies
timed by CUDA events on the copy stream (the put is the copy alone: its
rate cannot exceed the link's).

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips where no card is present.  This file imports only the port:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_obs_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import core, obs
from repro_torch.engine import StreamedPlan, plan_for
from repro_torch.obs import ledger

pytestmark = pytest.mark.gpu

RANK = 32
DIMS, NNZ, MAX_BLOCK = (183, 24, 1140, 1717), 60_000, 3_000
# slots per streamed chunk: 2^20 x 32 B = 33.5 MB per copy at order 4, long
# enough for a copy's rate to be the link's
RESERVATION = 1 << 20
# the copies of a streamed call may not beat the best pinned copy of the
# same size by more than the spread between copies
RATE_SLACK = 1.05


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.disable()
    obs.clear()
    ledger.disable()
    ledger.clear()
    yield
    obs.disable()
    obs.clear()
    ledger.disable()
    ledger.clear()


def _tensor():
    return core.random_tensor(DIMS, NNZ, seed=2, dist="powerlaw")


def _factors(dev):
    return core.init_factors(DIMS, RANK, seed=1, device=dev)


def _pinned_gb_per_s(nbytes, dev) -> float:
    """The best of 10 pinned host-to-device copies of ``nbytes``, timed by
    CUDA events, in GB/s."""
    src = torch.ones(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop))
    return nbytes / best / 1e6


def test_conservation_is_exact_on_the_card(cuda, tmp_path):
    t = _tensor()
    b = core.build_blco(t, max_nnz_per_block=MAX_BLOCK)
    fs = _factors(cuda)
    ledger.enable()
    pairs = []
    for backend, kernel in (("in_memory", "cuda"), ("streamed", "cuda"),
                            ("disk_streamed", "cuda"), ("coo", "torch")):
        plan = plan_for(b, 1 << 34, rank=RANK, backend=backend,
                        kernel=kernel, device=cuda, tensor=t,
                        store_path=str(tmp_path / "t.blco"))
        for mode in range(len(DIMS)):
            plan.mttkrp(fs, mode)
        pairs.append((plan.backend, plan.stats()))
        plan.close()
    ledger.disable()
    report = ledger.verify_conservation(pairs)
    assert report["max_rel_err"] == 0.0
    snap = ledger.snapshot()["regimes"]
    for regime in ("streamed", "disk_streamed"):
        hd = snap[regime][ledger.HOST_DEVICE]
        assert hd["ops"] == len(DIMS) * len(b.launches) and hd["seconds"] > 0
    hbm = snap["in_memory"][ledger.DEVICE_HBM]
    assert hbm["bytes"] == sum(ledger.hbm_model_bytes(
        b.nnz, order=4, rank=RANK, value_itemsize=4, kernel="cuda",
        dims=DIMS, mode=m) for m in range(len(DIMS)))


def test_streamed_copies_are_timed_by_events_at_the_link_rate(cuda):
    """The host-to-device edge of a streamed call reads at most the best
    pinned copy's rate (x 1.05): the put times the copy, not its issue or
    the fill; each copy's trace event lies inside the call."""
    t = _tensor()
    b = core.build_blco(t, max_nnz_per_block=MAX_BLOCK)
    fs = _factors(cuda)
    plan = StreamedPlan(b, queues=2, reservation_nnz=RESERVATION,
                        kernel="cuda", device=cuda)
    plan.mttkrp(fs, 0)                       # warm-up: builds the kernel
    peak = _pinned_gb_per_s(plan.spec.bytes_per_launch, cuda)
    ledger.enable()
    obs.enable()
    for mode in range(len(DIMS)):
        plan.mttkrp(fs, mode)
    obs.disable()
    ledger.disable()
    hd = ledger.snapshot()["regimes"]["streamed"][ledger.HOST_DEVICE]
    assert hd["ops"] == len(DIMS) * len(b.launches)
    assert 0 < hd["gb_per_s"] <= peak * RATE_SLACK, (hd, peak)
    # the copies are event-timed: a copy of 33.5 MB takes hundreds of
    # microseconds, never the few microseconds of its asynchronous issue
    st = plan.stats()
    assert st.hist.put_chunk_s.min > 1e-4
    calls = [s for s in obs.spans() if s.name == "plan.mttkrp"]
    puts = [s for s in obs.spans() if s.name == "h2d.put"]
    assert len(calls) == len(DIMS) and len(puts) == len(DIMS) * len(b.launches)
    for p in puts:
        assert any(c.start_s - 1e-3 <= p.start_s and p.end_s <= c.end_s
                   + 1e-3 for c in calls), (p.start_s, p.end_s)
    plan.close()
