"""The CP-ALS sweep's spans on the card, read from a ``torch.profiler``
trace of one traced sweep (the second of two profiled, so that nothing the
profiler loses as it starts is read): the program's span names are in the
trace,
every kernel launched inside ``plan.mttkrp`` is matched to its launch by
correlation id, the host-sync counter grows by the runtime's synchronising
calls, and each call's ``device_ms`` is its kernel's time in the trace.

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips where no card is present.  This file imports only the port:

    PYTHONPATH=src python -m pytest -m gpu -s tests/test_torch_cp_als_spans_gpu.py
"""
import collections

import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.core.counters import host_sync_counts
from repro_torch.engine import plan_for
from repro_torch.obs import trace

pytestmark = pytest.mark.gpu

# NELL-2's dims at 20 M uniform non-zeros: K1 runs about 1.5 ms a mode,
# long against the launch latency that each call's device_ms carries (with
# the start event recorded from Python, 30-60 us: device_ms read 9-19% high
# at 4 M non-zeros, 0.32 ms a kernel)
DIMS, NNZ, RANK = (12092, 9184, 28818), 20_000_000, 32
PROGRAM = ("cp_als.sweep", "cp_als.update", "cp_als.pinv", "cp_als.fit",
           "plan.mttkrp")
# runtime calls that block the host on the card
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
DEVICE_MS_RTOL = 0.05


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def swept(cuda):
    """One traced sweep under the profiler, after warm sweeps: the
    profiler's events, the tracer's spans and the counter's growth."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t = core.random_tensor(DIMS, NNZ, seed=7, dist="uniform")
    plan = plan_for(core.build_blco(t), 1 << 34, rank=RANK, device=cuda,
                    sanitize=False)
    state = core.cp_als_init(DIMS, RANK, norm_x=float(np.linalg.norm(
        t.values.astype(np.float64))), seed=1, tol=0.0, device=cuda)
    for _ in range(2):
        core.cp_als_step(plan, state)
    with trace.enabled():
        core.cp_als_step(plan, state)
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            core.cp_als_step(plan, state)
            torch.cuda.synchronize(cuda)
            trace.clear()
            before = host_sync_counts()
            core.cp_als_step(plan, state)
            after = host_sync_counts()
    finally:
        trace.disable()
    spans = trace.spans()
    trace.clear()
    plan.close()
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.name not in PROGRAM]
    growth = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    return cpu, device, spans, growth


def _ranges(cpu, name):
    """The ranges of ``name`` inside the read (the last) sweep."""
    a, z = max((e.time_range.start, e.time_range.end) for e in cpu
               if e.name == "cp_als.sweep")
    return sorted((e.time_range.start, e.time_range.end) for e in cpu
                  if e.name == name and a <= e.time_range.start <= z)


def _launches_in(cpu, a, z):
    """Runtime calls that put work on the card, issued inside [a, z]."""
    return [e for e in cpu if e.name.startswith("cu") and e.id
            and ("Launch" in e.name or "Memset" in e.name)
            and a <= e.time_range.start <= z]


def test_program_spans_are_in_the_profilers_trace(swept):
    cpu, _, spans, _ = swept
    assert set(PROGRAM) <= {e.name for e in cpu}
    counts = collections.Counter(s.name for s in spans if s.name in PROGRAM)
    assert counts == {"cp_als.sweep": 1, "cp_als.update": 3,
                      "cp_als.pinv": 3, "plan.mttkrp": 3, "cp_als.fit": 1}
    assert len(_ranges(cpu, "plan.mttkrp")) == 3


def test_every_kernel_launched_in_the_call_is_matched(swept):
    cpu, device, _, _ = swept
    on_card = collections.defaultdict(list)
    for e in device:
        on_card[e.id].append(e.name)
    for a, z in _ranges(cpu, "plan.mttkrp"):
        launches = _launches_in(cpu, a, z)
        assert any("Launch" in e.name for e in launches)
        for e in launches:
            assert on_card.get(e.id), (e.name, e.id)
        names = [n for e in launches for n in on_card[e.id]]
        assert any("segment_kernel" in n or "stash_kernel" in n
                   for n in names), names


def test_host_syncs_equal_the_runtimes_synchronising_calls(swept):
    cpu, _, _, growth = swept
    (a, z), = _ranges(cpu, "cp_als.sweep")
    calls = collections.Counter(e.name for e in cpu if e.name in SYNC_CALLS
                                and a <= e.time_range.start <= z)
    print(f"host syncs by site {growth}; runtime calls {dict(calls)}")
    assert growth == {"plan.fence": 3, "cp_als.pinv": 6, "cp_als.fit": 1}
    assert sum(growth.values()) == sum(calls.values())


def test_device_ms_is_the_calls_kernel_time(swept):
    cpu, device, spans, _ = swept
    by_id = collections.defaultdict(float)
    for e in device:
        by_id[e.id] += (e.time_range.end - e.time_range.start) / 1e3
    calls = sorted((s for s in spans if s.name == "plan.mttkrp"),
                   key=lambda s: s.start_s)
    for s, (a, z) in zip(calls, _ranges(cpu, "plan.mttkrp")):
        kernel_ms = sum(by_id[e.id] for e in _launches_in(cpu, a, z)
                        if "Launch" in e.name)
        print(f"mode {s.attrs['mode']}: device_ms {s.attrs['device_ms']!r}"
              f" kernel ms in the trace {kernel_ms!r}")
        assert kernel_ms > 0.1
        assert s.attrs["device_ms"] == pytest.approx(kernel_ms,
                                                     rel=DEVICE_MS_RTOL)


def test_a_traced_call_carries_device_ms_and_every_fence_counts(cuda):
    t = core.random_tensor((60, 50, 70), 5000, seed=2, dist="powerlaw")
    plan = plan_for(core.build_blco(t), 1 << 30, rank=8, device=cuda,
                    sanitize=False)
    fs = core.init_factors(t.dims, 8, seed=0, device=cuda)
    before = host_sync_counts()
    plan.mttkrp(fs, 0)
    with trace.enabled():
        plan.mttkrp(fs, 1)
    spans = [s for s in trace.spans() if s.name == "plan.mttkrp"]
    trace.clear()
    plan.close()
    assert len(spans) == 1 and spans[0].attrs["device_ms"] > 0
    after = host_sync_counts()
    assert after["plan.fence"] - before.get("plan.fence", 0) == 2
