"""The port's observability tier (``repro_torch.obs``: hist, ledger,
roofline, export, slo; ``EngineStats.hist``; the instrumentation sites)
against the JAX package's, on the CPU: the copies' code, exact
conservation of the ledger against the stats, the spans of each regime,
and the repair of the streamed put time (the copy alone, not the fill)."""
import ast
import collections
import importlib.util
import time
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro import engine as rengine  # noqa: E402
from repro import obs as robs  # noqa: E402
from repro_torch import core, obs  # noqa: E402
from repro_torch.core.streaming import EngineStats, LaunchChunks  # noqa: E402
from repro_torch.engine import (DiskStreamedPlan, StreamedPlan,  # noqa: E402
                                plan_for)
from repro_torch.obs import ledger  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANK = 4
BUDGET = 1 << 30
DIMS = (30, 24, 18)
# the sleep a slowed fill or store read adds per chunk
SLEEP_S = 0.02


def _code(path: Path, pkg: str, drop=()) -> str:
    """The module's AST without docstrings and without the top-level
    functions named in ``drop``, with absolute imports of ``pkg`` renamed
    to one placeholder package."""
    tree = ast.parse(path.read_text())
    tree.body = [n for n in tree.body
                 if not (isinstance(n, ast.FunctionDef) and n.name in drop)]
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[0] == pkg:
            node.module = "PKG" + node.module[len(pkg):]
    return ast.dump(tree)


def _function(path: Path, name: str) -> str:
    tree = ast.parse(path.read_text())
    return ast.dump(next(n for n in tree.body
                         if isinstance(n, ast.FunctionDef) and n.name == name))


# each module's deliberate differences from the reference, by name
DIFFERENCES = {
    "obs/hist.py": (),
    "obs/ledger.py": ("hbm_model_bytes",),
    "obs/roofline.py": (),
    "obs/export.py": (),
    "obs/slo.py": (),
}


@pytest.mark.parametrize("module", DIFFERENCES)
def test_copies_identical_to_reference_but_named_differences(module):
    """The port's ``obs`` modules are the reference's code: the same
    statements but for imports, docstrings and the functions named in
    ``DIFFERENCES`` (the ledger's HBM model, keyed by the port's kernel
    names), each of which does differ."""
    port = ROOT / "src" / "repro_torch" / module
    ref = ROOT / "src" / "repro" / module
    drop = DIFFERENCES[module]
    assert _code(port, "repro_torch", drop) == _code(ref, "repro", drop)
    for name in drop:
        assert _function(port, name) != _function(ref, name)


def test_copy_check_sees_a_changed_statement(tmp_path):
    ref = ROOT / "src" / "repro" / "obs" / "hist.py"
    bad = tmp_path / "hist.py"
    bad.write_text(ref.read_text().replace("self.count += 1",
                                           "self.count += 2"))
    assert _code(bad, "repro") != _code(ref, "repro")


def test_obs_exports_match_reference():
    assert obs.__all__ == robs.__all__


# ----------------------------------------------------------- the HBM model
def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dims,nnz", [((12092, 9184, 28818), 76_879_419),
                                      ((183, 24, 1140, 1717), 3_309_490),
                                      ((5, 6, 7), 0)])
def test_cuda_model_equals_the_smoke_bound_bytes(dims, nnz):
    """The ``"cuda"`` model is the byte count of the smoke's kernel bound:
    the real nnz x (hi + lo + value + N int32 bases), each non-target
    factor matrix once and the output once (f32)."""
    smoke = _smoke()
    n = len(dims)
    for mode in range(n):
        want = nnz * (4 + 4 + 4 + 4 * n) + sum(
            d * 32 * 4 for m, d in enumerate(dims) if m != mode) \
            + dims[mode] * 32 * 4
        got = ledger.hbm_model_bytes(nnz, order=n, rank=32, value_itemsize=4,
                                     factor_itemsize=4, kernel="cuda",
                                     dims=dims, mode=mode)
        assert got == want == smoke.fused_bytes(nnz, dims, mode, 32)
        ms, by = smoke.bound(nnz, dims, mode, 32)
        assert ms == pytest.approx(max(
            want / smoke.HBM_BYTES_PER_S,
            nnz * 32 * n / smoke.F32_FLOPS) * 1e3, rel=1e-12)


def test_torch_model_is_the_reference_non_fused_model():
    for nnz, order, rank, vi, fi in ((1000, 3, 8, 4, 4), (77, 4, 32, 8, 4),
                                     (0, 5, 3, 4, 8)):
        got = ledger.hbm_model_bytes(nnz, order=order, rank=rank,
                                     value_itemsize=vi, factor_itemsize=fi,
                                     kernel="torch")
        want = robs.hbm_model_bytes(nnz, order=order, rank=rank,
                                    value_itemsize=vi, factor_itemsize=fi,
                                    kernel="xla")
        assert got == want
    with pytest.raises(ValueError, match="dims and mode"):
        ledger.hbm_model_bytes(10, order=3, rank=2, value_itemsize=4)
    with pytest.raises(ValueError, match="no HBM model"):
        ledger.hbm_model_bytes(10, order=3, rank=2, value_itemsize=4,
                               kernel="pallas")


# ------------------------------------------------------------ EngineStats
@pytest.fixture(autouse=True)
def _clean_obs():
    """Every test starts and ends with tracing and the ledgers off and
    empty, in both packages."""
    for mod in (obs, robs):
        mod.disable()
        mod.clear()
        mod.ledger.disable()
        mod.ledger.clear()
    yield
    for mod in (obs, robs):
        mod.disable()
        mod.clear()
        mod.ledger.disable()
        mod.ledger.clear()


def _tensor():
    t = rcore.random_tensor(DIMS, 2000, seed=1)
    return t, core.from_coo(t.indices, t.values, DIMS)


def _blcos(block=256):
    rt, pt = _tensor()
    return (rcore.build_blco(rt, max_nnz_per_block=block),
            core.build_blco(pt, max_nnz_per_block=block))


def _factors(dims=DIMS):
    rng = np.random.default_rng(0)
    return [rng.standard_normal((d, RANK)).astype(np.float32) for d in dims]


def _torch(fs):
    return [torch.from_numpy(x) for x in fs]


def test_engine_stats_hist_and_compute_time_alias(tmp_path):
    _, b = _blcos()
    plan = plan_for(b, BUDGET, rank=RANK, backend="disk_streamed",
                    kernel="torch", device="cpu",
                    store_path=str(tmp_path / "t.blco"))
    fs = _torch(_factors())
    for mode in range(3):
        plan.mttkrp(fs, mode)
    st = plan.stats()
    chunks = len(b.launches)
    assert st.compute_time_s == st.device_time_s > 0
    with pytest.raises(AttributeError):
        st.compute_time_s = 1.0
    h = st.hist
    assert h.put_chunk_s.count == h.disk_read_s.count == h.launch_nnz.count \
        == h.dispatch_s.count == st.launches == 3 * chunks
    assert h.put_chunk_s.sum == st.put_time_s
    assert h.disk_read_s.sum == st.disk_time_s
    assert h.dispatch_s.sum == st.dispatch_time_s
    assert int(h.launch_nnz.sum) == 3 * b.nnz
    snap = st.snapshot()
    assert list(snap["hist"]) == ["dispatch_s", "put_chunk_s",
                                  "disk_read_s", "launch_nnz"]
    assert snap["hist"]["put_chunk_s"]["count"] == 3 * chunks
    plan.close()
    fresh = EngineStats()
    assert fresh.hist.put_chunk_s.count == 0
    assert fresh.hist is not EngineStats().hist


def test_in_memory_plan_records_a_dispatch_sample_per_call():
    _, b = _blcos()
    plan = plan_for(b, BUDGET, rank=RANK, kernel="torch", device="cpu")
    fs = _torch(_factors())
    for mode in (0, 1, 2, 0):
        plan.mttkrp(fs, mode)
    st = plan.stats()
    assert st.hist.dispatch_s.count == st.mttkrp_calls == 4
    assert st.hist.dispatch_s.sum == st.dispatch_time_s


# -------------------------------------------------- the put-time repair
class _SlowChunks(LaunchChunks):
    """A host chunk source whose fill sleeps ``SLEEP_S`` per chunk."""

    def chunk_into(self, i, bufs):
        time.sleep(SLEEP_S)
        return super().chunk_into(i, bufs)


def _slow_store_reads(plan):
    """Slow the plan's store reads by ``SLEEP_S`` per chunk."""
    stored = plan.stored
    read = stored.chunk_into

    def chunk_into(i, bufs):
        time.sleep(SLEEP_S)
        return read(i, bufs)

    stored.chunk_into = chunk_into


@pytest.mark.parametrize("regime", ["streamed", "disk_streamed"])
def test_put_time_is_the_copy_alone(regime, tmp_path):
    """``put_time_s`` times the host-to-device copy alone: a fill or a
    store read that sleeps 20 ms per chunk stays out of it, and the parts
    of a call add up to no more than the call."""
    _, b = _blcos()
    chunks = len(b.launches)
    assert chunks >= 4
    if regime == "streamed":
        plan = StreamedPlan(b, queues=2, kernel="torch", device="cpu",
                            chunks=_SlowChunks(b, 256))
    else:
        plan = DiskStreamedPlan.spill(b, str(tmp_path / "t.blco"), queues=2,
                                      kernel="torch", device="cpu")
        _slow_store_reads(plan)
    fs = _torch(_factors())
    for mode in range(3):
        plan.mttkrp(fs, mode)
    st = plan.stats()
    sleeps = 3 * chunks * SLEEP_S
    assert st.put_time_s < sleeps / 4
    assert st.put_time_s + st.disk_time_s + st.dispatch_time_s \
        <= st.total_time_s
    if regime == "disk_streamed":
        assert st.disk_time_s >= sleeps
    plan.close()


# -------------------------------------------------------- conservation
def _run_regimes(tmp_path, calls=(0, 1, 2)):
    """One plan per regime (baselines: all three), each called on ``calls``
    with the ledger on; returns ``[(regime, stats)]``."""
    rt, pt = _tensor()
    b = core.build_blco(pt, max_nnz_per_block=256)
    fs = _torch(_factors())
    pairs = []
    ledger.enable()
    plans = [plan_for(b, BUDGET, rank=RANK, backend=backend, kernel="torch",
                      device="cpu", store_path=str(tmp_path / "t.blco"),
                      tensor=pt)
             for backend in ("in_memory", "streamed", "disk_streamed",
                             "coo", "fcoo", "csf")]
    for plan in plans:
        for mode in calls:
            plan.mttkrp(fs, mode)
        pairs.append((plan.backend, plan.stats()))
        plan.close()
    ledger.disable()
    return pairs


def test_conservation_is_exact_for_every_port_plan(tmp_path):
    pairs = _run_regimes(tmp_path)
    assert [r for r, _ in pairs] == ["in_memory", "streamed",
                                     "disk_streamed", "coo", "fcoo", "csf"]
    report = ledger.verify_conservation(pairs)
    assert report["max_rel_err"] == 0.0
    assert len(report["checks"]) == 5 * len(pairs)
    snap = ledger.snapshot()["regimes"]
    # every regime moved bytes host -> device; the streamed ones per chunk
    for regime, st in pairs:
        assert snap[regime][ledger.HOST_DEVICE]["bytes"] == st.h2d_bytes > 0
    assert snap["streamed"][ledger.HOST_DEVICE]["seconds"] > 0
    assert snap["in_memory"][ledger.HOST_DEVICE]["seconds"] == 0.0
    assert snap["disk_streamed"][ledger.DISK_HOST]["bytes"] \
        == snap["disk_streamed"][ledger.HOST_DEVICE]["bytes"]
    for regime in ("in_memory", "streamed", "disk_streamed"):
        hbm = snap[regime][ledger.DEVICE_HBM]
        assert hbm["ops"] == 3 and hbm["flops"] > 0 and hbm["bytes"] > 0
    for kind in ("coo", "fcoo", "csf"):
        assert ledger.DEVICE_HBM not in snap[kind]


def test_conservation_check_sees_a_dropped_record(tmp_path):
    pairs = _run_regimes(tmp_path, calls=(0,))
    regime, st = pairs[1]
    st.put_time_s += 1e-9
    assert ledger.verify_conservation([(regime, st)])["max_rel_err"] > 0


def test_hbm_records_use_the_cuda_and_torch_models(tmp_path):
    _, b = _blcos()
    fs = _torch(_factors())
    ledger.enable()
    plan = plan_for(b, BUDGET, rank=RANK, backend="streamed", kernel="torch",
                    device="cpu")
    plan.mttkrp(fs, 1)
    got = ledger.snapshot()["regimes"]["streamed"][ledger.DEVICE_HBM]
    assert got["bytes"] == ledger.hbm_model_bytes(
        b.nnz, order=3, rank=RANK, value_itemsize=4, kernel="torch")
    assert got["flops"] == ledger.mttkrp_flops(b.nnz, order=3, rank=RANK)
    plan.close()


def test_roofline_report_over_the_port_ledger(tmp_path):
    _run_regimes(tmp_path, calls=(0,))
    peaks = {ledger.HOST_DEVICE: 50.0, ledger.DISK_HOST: 10.0,
             ledger.DEVICE_HBM: 3000.0}
    rep = obs.roofline_report(peaks=peaks, peak_flops=67e12)
    want = robs.roofline_report(ledger.snapshot(), peaks=peaks,
                                peak_flops=67e12)
    assert rep == want
    streamed = rep["regimes"]["streamed"]
    assert streamed["bound"] in ("memory_bound", "compute_bound")
    assert streamed["saturated_edge"] in ledger.EDGES
    for e in streamed["edges"].values():
        assert e["achieved_fraction"] == e["gb_per_s"] / e["peak_gb_per_s"]


# ----------------------------------------------------------------- trace
def _trace_calls(pkg, tmp_path):
    """(name, track) of every span of plan_for + one mode-0 call per
    regime, in package ``pkg`` (the reference or the port)."""
    port = pkg == "port"
    trace, engine = (obs.trace, None) if port else (robs.trace, rengine)
    rt, pt = _tensor()
    if port:
        b = core.build_blco(pt, max_nnz_per_block=256)
        kw = dict(kernel="torch", device="cpu", tensor=pt)
        build = plan_for
    else:
        b = rcore.build_blco(rt, max_nnz_per_block=256)
        kw = dict(tensor=rt)
        build = engine.plan_for
    fs = _factors()
    fs = _torch(fs) if port else fs
    out = {}
    for backend in ("in_memory", "streamed", "disk_streamed", "coo"):
        trace.enable()
        trace.clear()
        plan = build(b, BUDGET, rank=RANK, backend=backend,
                     store_path=str(tmp_path / f"{pkg}-{backend}.blco"), **kw)
        plan.mttkrp(fs, 0)
        plan.close()
        out[backend] = collections.Counter((s.name, s.track)
                                           for s in trace.spans())
        trace.disable()
    return out


def test_spans_match_the_reference_plans(tmp_path):
    port = _trace_calls("port", tmp_path)
    ref = _trace_calls("ref", tmp_path)
    assert port == ref
    chunks = len(_blcos()[1].launches)
    assert port["streamed"][("h2d.put", "h2d")] == chunks
    assert port["disk_streamed"][("store.read", "store")] == chunks
    assert port["in_memory"][("launch_cache.scan", "dispatch")] == 1
    assert port["in_memory"][("device.fence", "device")] == 1


def test_track_totals_equal_the_stats(tmp_path):
    _, b = _blcos()
    obs.enable()
    plan = plan_for(b, BUDGET, rank=RANK, backend="disk_streamed",
                    kernel="torch", device="cpu",
                    store_path=str(tmp_path / "t.blco"))
    fs = _torch(_factors())
    for mode in range(3):
        plan.mttkrp(fs, mode)
    st = plan.stats()
    plan.close()
    obs.disable()
    tot = obs.track_totals()
    for track, total in (("store", st.disk_time_s), ("h2d", st.put_time_s),
                         ("dispatch", st.dispatch_time_s),
                         ("device", st.device_time_s)):
        assert tot[track] == pytest.approx(total, rel=1e-12, abs=0), track
    doc = obs.write_chrome_trace(str(tmp_path / "trace.json"))
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"store.read", "h2d.put", "dispatch.launch", "device.fence",
            "plan.mttkrp", "engine.plan_for"} <= names


# ------------------------------------------------------------ prometheus
def _metrics(hists_cls):
    """A duck-typed service metrics object with the attributes
    ``render_prometheus`` reads."""
    m = types.SimpleNamespace()
    from repro_torch.obs import export
    for i, key in enumerate(export._COUNTER_KEYS):
        setattr(m, key, i)
    for i, key in enumerate(export._GAUGE_KEYS):
        setattr(m, key, 0.5 * i)
    m.tenant_iterations = {"a": 4, "b": 3}
    m.iterations_per_sec = lambda: 3.5
    m.hist = hists_cls()
    m.hist.record_quantum("a", 0.5)
    m.hist.record_queue_wait("b", 2.0)
    m.hist.dispatch_s.record(1e-4)
    return m


def test_render_prometheus_on_a_duck_typed_metrics_object():
    text = obs.render_prometheus(_metrics(obs.ServiceHists))
    assert text == robs.render_prometheus(_metrics(robs.ServiceHists))
    assert "repro_iterations_per_busy_sec 3.5" in text
    assert 'repro_tenant_iterations_total{tenant="a"} 4' in text
    assert 'repro_quantum_s_bucket{le="+Inf"} 1' in text
    assert 'repro_tenant_queue_wait_s_count{tenant="b"} 1' in text
    assert "repro_ledger_enabled 0" in text


def test_slo_report_matches_the_reference():
    hists = [obs.ServiceHists(), robs.ServiceHists()]
    for h in hists:
        for v in (0.1, 0.5, 3.0):
            h.record_queue_wait("a", v)
            h.record_quantum("b", 5.0 * v)
    assert obs.slo_report(hists[0]) == robs.slo_report(hists[1])
