"""The reading of the program's own spans (``program_spans.py``) on made-up
input: the innermost span of a timeline, an idle gap split by overlap, the
buckets adding up to the idle time, kernels put down to the span that
launched them, the slices' runners on a stand-in tracer, and the seven
figures, each ``None`` where its slice is missing."""
import types

import pytest

from tdbench import program_spans as ps


def _ev(name, dev, a, z, corr=0, annotation=False):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if dev else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=a, end=z), id=corr,
        is_user_annotation=annotation)


def test_innermost_pieces_of_nested_spans():
    spans = [(0, 100, "cp_als.sweep"), (10, 30, "plan.mttkrp"),
             (30, 60, "cp_als.update"), (35, 50, "cp_als.pinv"),
             (80, 95, "cp_als.fit")]
    assert ps.innermost(spans) == [
        (0, 10, "cp_als.sweep"), (10, 30, "plan.mttkrp"),
        (30, 35, "cp_als.update"), (35, 50, "cp_als.pinv"),
        (50, 60, "cp_als.update"), (60, 80, "cp_als.sweep"),
        (80, 95, "cp_als.fit"), (95, 100, "cp_als.sweep")]
    assert ps.innermost([(0, 5, "a"), (8, 9, "b")]) == [(0, 5, "a"),
                                                         (8, 9, "b")]


def test_a_gap_across_pinv_and_update_is_split_by_overlap():
    pieces = ps.innermost([(0, 100, "cp_als.sweep"),
                           (20, 80, "cp_als.update"),
                           (20, 50, "cp_als.pinv")])
    got = ps.split_idle([(40, 70)], pieces)
    assert got["cp_als.pinv"] == pytest.approx(10)
    assert got["cp_als.update"] == pytest.approx(20)
    assert got["unattributed"] == 0
    # the midpoint (55) alone would have put all 30 on the update
    got = ps.split_idle([(10, 30), (90, 110)], pieces)
    assert got["cp_als.pinv"] == pytest.approx(10)
    assert got["unattributed"] == pytest.approx(10 + 20)


def _sweep_events(t0=0):
    """One sweep: K1 in the plan's call, the SVD in pinv, a GEMM in the
    update, the fit's readback; the card idles between them."""
    return [
        _ev("cp_als.sweep", False, t0, t0 + 100, annotation=True),
        _ev("plan.mttkrp", False, t0 + 5, t0 + 40, annotation=True),
        _ev("cudaLaunchKernel", False, t0 + 10, t0 + 11, corr=t0 + 1),
        _ev("segment_kernel", True, t0 + 12, t0 + 35, corr=t0 + 1),
        _ev("cudaDeviceSynchronize", False, t0 + 11, t0 + 36),
        _ev("cp_als.update", False, t0 + 40, t0 + 80, annotation=True),
        _ev("cp_als.pinv", False, t0 + 42, t0 + 60, annotation=True),
        _ev("cudaLaunchKernel", False, t0 + 43, t0 + 44, corr=t0 + 2),
        _ev("batched_svd", True, t0 + 45, t0 + 50, corr=t0 + 2),
        _ev("cudaStreamSynchronize", False, t0 + 51, t0 + 52),
        _ev("cudaLaunchKernel", False, t0 + 62, t0 + 63, corr=t0 + 3),
        _ev("gemm", True, t0 + 64, t0 + 70, corr=t0 + 3),
        _ev("cp_als.fit", False, t0 + 85, t0 + 98, annotation=True),
        _ev("cudaMemcpyAsync", False, t0 + 90, t0 + 91, corr=t0 + 4),
        _ev("Memcpy DtoH", True, t0 + 92, t0 + 93, corr=t0 + 4),
        _ev("cudaStreamSynchronize", False, t0 + 91, t0 + 94),
        _ev("cp_als.sweep", True, t0 + 12, t0 + 93, annotation=True),
    ]


def test_summary_puts_idle_and_kernels_down_to_program_spans():
    events = _sweep_events() + _sweep_events(200)
    s = ps.summarize_program(events)
    assert s["sweeps"] == 2 and s["matched_events"] == 8
    assert s["window_s"] == pytest.approx(300e-6)
    assert s["busy_s"] == pytest.approx(2 * 35e-6)
    idle = s["idle_by_span"]
    # per sweep: plan 5-12 and 35-40; pinv 42-45 and 50-60; update 40-42,
    # 60-64 and 70-80; fit 85-92 and 93-98; the sweep's own time 0-5,
    # 80-85 and 98-100
    assert idle["plan.mttkrp"] == pytest.approx(2 * 12e-6)
    assert idle["cp_als.pinv"] == pytest.approx(2 * 13e-6)
    assert idle["cp_als.update"] == pytest.approx(2 * 16e-6)
    assert idle["cp_als.fit"] == pytest.approx(2 * 12e-6)
    # between the sweeps (100-200) and the sweep's own time
    assert idle["unattributed"] == pytest.approx(100e-6 + 2 * 12e-6)
    assert sum(idle.values()) == pytest.approx(s["idle_s"])
    assert s["idle_s"] == pytest.approx(s["window_s"] - s["busy_s"])
    dev = s["device_by_span"]
    assert dev["plan.mttkrp"] == pytest.approx(2 * 23e-6)
    assert dev["cp_als.pinv"] == pytest.approx(2 * 5e-6)
    assert dev["cp_als.update"] == pytest.approx(2 * 6e-6)
    assert dev["cp_als.fit"] == pytest.approx(2 * 1e-6)
    assert s["sync_calls"] == {"cudaDeviceSynchronize": 2,
                               "cudaStreamSynchronize": 4}
    assert ps.summarize_program(events[:1]) is None
    assert ps.summarize_program([e for e in events
                                 if e.name != "cp_als.sweep"]) is None


def test_buckets_add_up_to_the_idle_time_on_a_ragged_timeline():
    """Busy intervals that straddle span edges and gaps that cross several
    spans: the five buckets still sum to the window less the busy time."""
    events = [_ev("cp_als.sweep", False, 0, 1000, annotation=True)]
    for k in range(10):
        t = 100 * k
        events += [
            _ev("plan.mttkrp", False, t + 3, t + 31),
            _ev("cp_als.update", False, t + 31, t + 77),
            _ev("cp_als.pinv", False, t + 40, t + 52),
            _ev("cp_als.fit", False, t + 80, t + 97),
            _ev("k", True, t + 17, t + 45), _ev("k", True, t + 50, t + 83),
        ]
    s = ps.summarize_program(events)
    total = sum(s["idle_by_span"].values())
    assert total == pytest.approx(s["window_s"] - s["busy_s"], rel=1e-12)
    assert s["idle_by_span"]["cp_als.pinv"] == pytest.approx(10 * 5e-6)


class _Tracer:
    """A stand-in for the program's tracer: spans recorded while on."""

    def __init__(self):
        self.on, self.buf, self.cleared = False, [], 0

    def enable(self):
        self.on = True

    def disable(self):
        self.on = False

    def clear(self):
        self.buf, self.cleared = [], self.cleared + 1

    def spans(self):
        return list(self.buf)

    def add(self, name, duration_s, **attrs):
        if self.on:
            self.buf.append(types.SimpleNamespace(
                name=name, duration_s=duration_s, attrs=attrs))


def test_traced_slice_reads_spans_events_and_the_counter():
    tracer, syncs = _Tracer(), {"plan.fence": 4}
    tracer.add("left over", 1.0)

    def step(plan, state):
        tracer.add("cp_als.sweep", 0.010)
        for mode in range(3):
            tracer.add("plan.mttkrp", 0.006, mode=mode, device_ms=5.5)
            tracer.add("device.fence", 0.006)
            tracer.add("cp_als.update", 0.001, mode=mode)
            syncs["plan.fence"] += 1
            syncs["cp_als.pinv"] = syncs.get("cp_als.pinv", 0) + 1
        tracer.add("cp_als.fit", 0.0005)
        syncs["cp_als.fit"] = syncs.get("cp_als.fit", 0) + 1
        state.append(1)

    state = []
    a = ps.traced_slice(step, None, state, 4, tracer, lambda: dict(syncs))
    assert len(state) == 4 and not tracer.on and tracer.cleared == 1
    assert a["host_syncs"] == {"plan.fence": 12, "cp_als.pinv": 12,
                               "cp_als.fit": 4}
    assert a["device_calls"] == 12
    assert a["device_ms"] == pytest.approx(12 * 5.5)
    assert "device.fence" not in a["span_s"]
    m = ps.program_metrics(a, None)
    assert m["host_syncs"] == 7
    assert m["cp_als_solve_ms"] == pytest.approx(3.5)
    assert m["mttkrp_device_ms"] == pytest.approx(16.5)
    assert all(m[k] is None for k in ps.IDLE_METRICS)


def test_profiled_slice_is_none_off_a_card():
    import torch
    tracer = _Tracer()
    assert ps.profiled_program_slice(lambda p, s: None, None, None, 2,
                                     torch.device("cpu"), tracer) is None
    assert not tracer.on


def test_every_figure_is_none_where_its_slice_is_missing():
    m = ps.program_metrics(None, None)
    assert list(m) == list(ps.METRICS) and set(m.values()) == {None}
    a = {"sweeps": 2, "span_s": {}, "device_ms": 0.0, "device_calls": 0,
         "host_syncs": {}}
    m = ps.program_metrics(a, None)
    assert m["host_syncs"] == 0 and m["cp_als_solve_ms"] == 0
    assert m["mttkrp_device_ms"] is None
    b = ps.summarize_program(_sweep_events())
    m = ps.program_metrics(None, b)
    assert m["host_syncs"] is None and m["cp_als_solve_ms"] is None
    assert m["plan_idle_ms"] == pytest.approx(12e-3)
    assert m["pinv_idle_ms"] == pytest.approx(13e-3)
    assert m["fit_idle_ms"] == pytest.approx(12e-3)
