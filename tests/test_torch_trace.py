"""The port's trace tier (``repro_torch.analysis.trace``) against the JAX
package's, on the CPU.

* the encoding proofs are the reference's, snapshot for snapshot, on its
  default sweep, on hand-broken layouts and on BLCOs each package builds
  from the same seed;
* ``conflict_report`` equals the reference's dict for dict on BLCOs built
  from the same seed by each package, and K4's plain version writes
  exactly the report's runs per launch;
* the reservation roundings and the kernels' occupancy keys are bounded
  and tenant-invariant (and known-bad ones are caught);
* the op recorder flags its three fixtures (a host transfer, narrowing
  into ``index_add_``, duplicate indices in a non-accumulating write),
  and every registered hot path runs clean;
* the plain fused variants keep their write structure, and the whole
  tier runs clean.
"""
import json
import math

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from conftest import hypothesis_or_stub  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro.analysis import trace as rtrace  # noqa: E402
from repro.analysis.trace.cachekeys import \
    audit_rounding as ref_audit_rounding  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.analysis import run_trace_tier  # noqa: E402
from repro_torch.analysis import trace  # noqa: E402
from repro_torch.analysis.trace import cachekeys, op_audit  # noqa: E402
from repro_torch.core import linearize as lin  # noqa: E402
from repro_torch.core.launches import LaunchCache  # noqa: E402
from repro_torch.core.padding import LANE, pad_multiple  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.obs.export import render_prometheus_analysis  # noqa: E402

given, settings, st = hypothesis_or_stub()

F32_TOL = 5e-4


def _pair(dims, nnz, seed=1, dist="powerlaw", **kw):
    """The same tensor as a reference BLCO and a port BLCO."""
    r = rcore.random_tensor(dims, nnz, seed=seed, dist=dist)
    p = core.SparseTensor(dims=tuple(r.dims), indices=np.array(r.indices),
                          values=np.array(r.values))
    return r, rcore.build_blco(r, **kw), p, core.build_blco(p, **kw)


# (dims, nnz, build kwargs): the reference's demo tensor (forced blocking,
# many launches), an order-4 tensor with a 24-row mode, one launch
TENSORS = {
    "demo": ((40, 25, 30), 2000, dict(target_bits=12,
                                      max_nnz_per_block=256)),
    "order4": ((183, 24, 114, 17), 3000, dict(max_nnz_per_block=700)),
    "one-launch": ((60, 90, 9), 1500, {}),
}


# ------------------------------------------------------- encoding proofs
def test_default_configs_are_the_reference_sweep():
    assert trace.DEFAULT_CONFIGS == rtrace.DEFAULT_CONFIGS


@pytest.mark.parametrize("config", trace.DEFAULT_CONFIGS,
                         ids=lambda c: f"{'x'.join(map(str, c[0]))}@{c[1]}")
def test_encoding_proofs_equal_reference(config):
    dims, target = config
    proof, fs = trace.prove_encoding(dims, target_bits=target)
    rproof, rfs = rtrace.prove_encoding(dims, target_bits=target)
    assert fs == rfs == []
    assert proof.snapshot() == rproof.snapshot()


@pytest.mark.parametrize("name", TENSORS)
def test_encoding_proofs_of_built_tensors_equal_reference(name):
    dims, nnz, kw = TENSORS[name]
    _, rb, _, pb = _pair(dims, nnz, **kw)
    target = kw.get("target_bits", 64)
    proof, fs = trace.prove_encoding(pb.dims, target_bits=target)
    rproof, _ = rtrace.prove_encoding(rb.dims, target_bits=target)
    assert fs == [] and proof.snapshot() == rproof.snapshot()
    assert (proof.field_bits, proof.field_shift) == \
        (pb.re.field_bits, pb.re.field_shift)
    assert trace.verify_layout(pb.dims, pb.spec, pb.re,
                               target_bits=target) == []


def _broken_layouts():
    spec = lin.LinearSpec.make((8, 6, 4))
    re = lin.reencode_spec(spec, 64)
    return {
        "lossy": (spec, lin.ReencodeSpec((2,) + re.field_bits[1:],
                                         re.field_shift, re.block_bits)),
        "overlap": (spec, lin.ReencodeSpec(re.field_bits, (0, 0, 6),
                                           re.block_bits)),
        "wrap": (spec, lin.ReencodeSpec(re.field_bits, (0, 3, 63),
                                        re.block_bits)),
        "bijection": (lin.LinearSpec(spec.dims, spec.bits,
                                     ((0, 1, 2), (0, 4, 5), (6, 7)),
                                     spec.total_bits), re),
    }


@pytest.mark.parametrize("name", ["lossy", "overlap", "wrap", "bijection"])
def test_broken_layouts_flagged_as_the_reference_flags_them(name):
    spec, re = _broken_layouts()[name]
    fs = trace.verify_layout((8, 6, 4), spec, re, symbol=name)
    rfs = rtrace.verify_layout((8, 6, 4), spec, re, symbol=name)
    assert fs and [f.message for f in fs] == [f.message for f in rfs]
    assert all(f.path == "src/repro_torch/core/linearize.py" for f in fs)


def test_construction_guard_witnessed_like_the_reference():
    proof, fs = trace.prove_encoding((2**31 + 1, 4))
    _, rfs = rtrace.prove_encoding((2**31 + 1, 4))
    assert proof is None and [f.message for f in fs] == \
        [f.message for f in rfs]


@given(data=st.data())
@settings(max_examples=25, deadline=None)
def test_property_proofs_equal_reference(data):
    n_modes = data.draw(st.integers(min_value=2, max_value=4))
    dims = tuple(data.draw(st.integers(min_value=1, max_value=2**31))
                 for _ in range(n_modes))
    target = data.draw(st.sampled_from((8, 16, 32, 64)))
    proof, fs = trace.prove_encoding(dims, target_bits=target)
    rproof, rfs = rtrace.prove_encoding(dims, target_bits=target)
    assert [f.message for f in fs] == [f.message for f in rfs]
    assert (proof is None) == (rproof is None)
    if proof is not None:
        assert proof.snapshot() == rproof.snapshot()
        # the bounds the plain path's int64 field extraction relies on
        assert all(w <= 32 and s + w <= 64 for w, s in
                   zip(proof.field_bits, proof.field_shift))


# ------------------------------------------------------- conflict report
@pytest.mark.parametrize("tile", [256, 96, 1])
@pytest.mark.parametrize("name", TENSORS)
def test_conflict_report_equals_reference(name, tile):
    dims, nnz, kw = TENSORS[name]
    _, rb, _, pb = _pair(dims, nnz, **kw)
    for mode in range(len(dims)):
        got = trace.conflict_report(pb, mode, tile=tile)
        assert got == rtrace.conflict_report(rb, mode, tile=tile)
        json.dumps(got)


def test_conflict_free_tensor_reported_sound():
    idx = np.stack([np.arange(256), np.zeros(256, np.int64),
                    np.zeros(256, np.int64)], axis=1)
    b = core.build_blco(core.from_coo(idx, np.ones(256, np.float32),
                                      (256, 2, 2)))
    report = trace.conflict_report(b, 0)
    assert report["unique_indices_sound"] is True
    assert report["launches"][0]["padding_segments"] == 0


def _factors(dims, rank=8, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((d, rank)).astype(
        np.float32)) for d in dims]


@pytest.mark.parametrize("name", TENSORS)
def test_plain_k4_runs_equal_the_report(name):
    """K4's plain version on the launch cache's flat stream at the
    report's tile writes exactly ``segments + padding_segments`` runs per
    launch: padding slots target row 0 and open runs of their own."""
    dims, nnz, kw = TENSORS[name]
    _, _, _, pb = _pair(dims, nnz, **kw)
    cache = LaunchCache.from_blco(pb, device="cpu")
    fs = _factors(dims)
    for mode in range(len(dims)):
        report = trace.conflict_report(pb, mode)
        assert report["reservation"] == cache.reservation
        runs = trace.k4_runs(cache, fs, mode, tile=report["tile"])
        assert runs == trace.report_runs(report)
        pads = [l["padding_segments"] for l in report["launches"]]
        assert sum(pads) > 0        # the padding runs are really counted
        assert runs != [l["segments"] for l in report["launches"]]


def test_k4_runs_see_a_dropped_run():
    """The hold is exact: one run fewer in K4's output is a mismatch."""
    dims, nnz, kw = TENSORS["demo"]
    _, _, _, pb = _pair(dims, nnz, **kw)
    cache = LaunchCache.from_blco(pb, device="cpu")
    report = trace.conflict_report(pb, 0)
    hi, lo, vals, bases = cache.flat()
    tgt = kref.delinearize_ref(hi, lo, bases, field_bits=cache.re_fields,
                               field_shifts=cache.re_shifts)[:, 0]
    seg_tgt, _ = kref.segments_ref(tgt, vals[:, None], tile=report["tile"])
    seg_tgt[int(torch.nonzero(seg_tgt >= 0)[0])] = -1
    runs = (seg_tgt.view(cache.num_launches, -1) >= 0).sum(1).tolist()
    assert runs != trace.report_runs(report)


def test_segmented_reduction_invariant():
    """The report proves duplicate writers; the segment variant's final
    apply accumulates (so the claim is sound), and under that conflict
    structure the plain fused output reproduces the dense oracle."""
    dims, nnz, kw = TENSORS["demo"]
    _, _, pt, pb = _pair(dims, nnz, **kw)
    report = trace.conflict_report(pb, 0)
    assert report["max_writers_per_row_per_step"] >= 2
    assert report["unique_indices_sound"] is False
    facts, fs = trace.prove_variant("segment")
    assert fs == []
    assert [f["accumulate"] for f in facts if f["into_output"]] == [True]
    from repro_torch.kernels import fused_cache_mttkrp
    factors = _factors(dims)
    out = fused_cache_mttkrp(LaunchCache.from_blco(pb, device="cpu"),
                             factors, 0, resolution="register")
    oracle = core.mttkrp_dense_oracle(pt, [f.numpy() for f in factors], 0)
    err = np.max(np.abs(out.numpy().astype(np.float64) - oracle)) / \
        np.max(np.abs(oracle))
    assert err < F32_TOL


# ------------------------------------------------- roundings and keys
def test_shipped_roundings_bounded_and_tenant_invariant():
    assert trace.audit_reservation_churn() == []
    assert trace.audit_tenant_invariance() == []
    assert trace.audit_tenant_invariance(n_tenants=5000) == []


def test_roundings_judged_as_the_reference_judges_them():
    for regime, fn in cachekeys.shipped_roundings().items():
        assert cachekeys.audit_rounding(regime, fn) == []
    fs = cachekeys.audit_rounding("raw_lane", pad_multiple)
    rfs = ref_audit_rounding("raw_lane", pad_multiple)
    assert [f.message for f in fs] == [f.message for f in rfs]
    assert fs[0].path == "src/repro_torch/core/padding.py"
    fs = cachekeys.audit_rounding("sawtooth",
                                  lambda n: 2 * LANE if n % 2 else 4 * LANE)
    assert fs and "not monotone" in fs[0].message


def test_occupancy_keys_bounded_and_tenant_invariant():
    assert trace.audit_occupancy_keys() == []
    assert trace.audit_occupancy_keys(n_tenants=3000) == []


def test_occupancy_keys_name_what_the_kernels_ask_under():
    keys = cachekeys.launch_keys((12092, 9184, 28818), 76_879_419, 32,
                                 ("float32", "float32"))
    # K1 (segment) on every mode, K4 once: no nnz, no extent in any key
    assert ("segment", 0, 3, 0, 0) in keys
    assert any(k[0] == "segments" for k in keys) and len(keys) == 2
    assert all(76_879_419 not in k and 28818 not in k for k in keys)
    uber = cachekeys.launch_keys((183, 24, 1140, 1717), 3_309_490, 32,
                                 ("float32", "float32"))
    # K2's stash key carries its shared memory: 24 rows x 32 x 4 B
    assert ("stash", 0, 4, 24 * 32 * 4, 0) in uber


def test_occupancy_key_depending_on_nnz_rejected():
    def leaky(dims, nnz, rank, pair, device=0):
        return cachekeys.launch_keys(dims, nnz, rank, pair) | {("t", nnz)}

    fs = trace.audit_occupancy_keys(20, key_fn=leaky)
    assert len(fs) == 1 and "launch size enters the key" in fs[0].message


def test_occupancy_key_depending_on_a_long_extent_rejected():
    def leaky(dims, nnz, rank, pair, device=0):
        return cachekeys.launch_keys(dims, nnz, rank, pair) | {max(dims)}

    fs = trace.audit_occupancy_keys(200, key_fn=leaky)
    assert len(fs) == 1 and "long mode's extent" in fs[0].message


# ------------------------------------------------------------ the recorder
def _record(fn):
    with op_audit.OpRecorder(path="tests/fixture.py", symbol="fixture") as rec:
        fn()
    return rec


@pytest.mark.parametrize("what", ["item", "tolist", "cpu", "bool", "numpy",
                                  "to-cpu"])
def test_recorder_flags_host_transfers(what):
    x = torch.arange(8.0)
    calls = {"item": lambda: x.sum().item(), "tolist": lambda: x.tolist(),
             "cpu": lambda: x.cpu(), "bool": lambda: bool(x.any()),
             "numpy": lambda: np.asarray(x), "to-cpu": lambda: x.to("cpu")}
    rec = _record(calls[what])
    assert [f.pass_id for f in rec.findings] == [trace.PASS_CALLBACK]
    assert "host transfer" in rec.findings[0].message


def test_recorder_ignores_conversions_that_stay_put():
    x = torch.arange(8.0)
    rec = _record(lambda: (x.to(torch.float64), x.to(x), x.double() * 2))
    assert rec.findings == []


def test_recorder_flags_narrowing_into_index_add():
    vals = torch.randn(32, dtype=torch.float64)
    idx = torch.randint(0, 16, (32,))

    def bad():
        small = vals.to(torch.float32)
        return torch.zeros(16).index_add_(0, idx, small)

    rec = _record(bad)
    assert [f.pass_id for f in rec.findings] == [trace.PASS_NARROWING]
    assert "index_add_" in rec.findings[0].message


@pytest.mark.parametrize("sink", ["sum", "cumsum", "matmul", "scatter_add_"])
def test_recorder_taint_survives_rewidening(sink):
    vals = torch.randn(16, 4, dtype=torch.float64)

    def bad():
        laundered = vals.float().double() * 2.0
        if sink == "sum":
            return laundered.sum()
        if sink == "cumsum":
            return torch.cumsum(laundered, 0)
        if sink == "matmul":
            return laundered.T @ laundered
        return torch.zeros(16, 4, dtype=torch.float64).scatter_add_(
            0, torch.zeros(16, 4, dtype=torch.int64), laundered)

    assert [f.pass_id for f in _record(bad).findings] == \
        [trace.PASS_NARROWING]


def test_recorder_ignores_integer_narrowing_and_promotion():
    vals = torch.randn(32)
    idx = torch.randint(0, 16, (32,))

    def fine():
        i = idx.to(torch.int32).to(torch.int64)
        wide = vals.to(torch.promote_types(vals.dtype, torch.float64))
        return torch.zeros(16, dtype=torch.float64).index_add_(0, i, wide)

    assert _record(fine).findings == []


@pytest.mark.parametrize("op", ["index_put_", "setitem", "scatter_",
                                "index_copy_", "put_"])
def test_recorder_flags_duplicate_index_writes(op):
    out = torch.zeros(8)
    dup = torch.tensor([1, 3, 3, 5])
    src = torch.ones(4)

    def write(idx):
        if op == "index_put_":
            out.index_put_((idx,), src, accumulate=False)
        elif op == "setitem":
            out[idx] = src
        elif op == "scatter_":
            out.scatter_(0, idx, src)
        elif op == "index_copy_":
            out.index_copy_(0, idx, src)
        else:
            out.put_(idx, src)

    rec = _record(lambda: write(dup))
    assert [f.pass_id for f in rec.findings] == [trace.PASS_CONFLICT]
    assert rec.writes[0]["duplicates"] is True
    rec = _record(lambda: write(torch.tensor([1, 3, 4, 5])))
    assert rec.findings == [] and rec.writes[0]["duplicates"] is False


def test_recorder_accepts_accumulating_duplicate_writes():
    out = torch.zeros(8)
    dup = torch.tensor([1, 3, 3, 5])
    rec = _record(lambda: (out.index_put_((dup,), torch.ones(4),
                                          accumulate=True),
                           out.index_add_(0, dup, torch.ones(4)),
                           out.__setitem__(slice(0, 2), 1.0)))
    assert rec.findings == []
    assert [w["accumulate"] for w in rec.writes] == [True, True]


def test_recorder_duplicates_across_two_index_columns():
    out = torch.zeros(4, 4)
    rows, cols = torch.tensor([0, 1, 0]), torch.tensor([2, 2, 2])
    rec = _record(lambda: out.index_put_((rows, cols), torch.ones(3)))
    assert [f.pass_id for f in rec.findings] == [trace.PASS_CONFLICT]
    rec = _record(lambda: out.index_put_((rows, torch.tensor([2, 2, 3])),
                                         torch.ones(3)))
    assert rec.findings == []


def test_registered_hot_paths_audit_clean():
    paths = trace.registered_hot_paths(device="cpu")
    assert [hp.name for hp in paths] == [
        "stacked_mttkrp[register]", "stacked_mttkrp[hierarchical]",
        "launch_mttkrp_impl[streamed]", "fused_mttkrp_flat[segment]",
        "fused_mttkrp_flat[stash]", "sweep_mode_update"]
    for hp in paths:
        rec = op_audit.OpRecorder(path=hp.path, symbol=hp.name)
        assert trace.audit_hot_path(hp, recorder=rec) == [], hp.name
        assert rec.calls > 0 and rec.suppressed == []


@pytest.mark.parametrize("name", ["demo", "order4"])
def test_hot_paths_over_a_launch_cache_audit_clean(name):
    dims, nnz, kw = TENSORS[name]
    _, _, _, pb = _pair(dims, nnz, **kw)
    cache = LaunchCache.from_blco(pb, device="cpu")
    paths = trace.registered_hot_paths(cache=cache, factors=_factors(dims))
    names = [hp.name for hp in paths]
    assert ("fused_mttkrp_flat[stash]" in names) == (min(dims) <= 128)
    for hp in paths:
        assert trace.audit_hot_path(hp) == [], hp.name


def test_hot_path_outputs_match_the_plain_paths():
    """What the registry runs is the real dataflow: the stacked paths and
    the fused wrapper agree with each other on the representative
    stream."""
    paths = {hp.name: hp for hp in trace.registered_hot_paths(device="cpu")}
    reg = paths["stacked_mttkrp[register]"].run()
    fused = paths["fused_mttkrp_flat[segment]"].run()
    assert reg.shape == fused.shape
    assert float((reg - fused).abs().max() / reg.abs().max()) < F32_TOL


def test_refusal_site_honours_inline_disables(tmp_path):
    src = tmp_path / "site.py"
    src.write_text("def f():  # repro-lint: disable=trace-host-callback\n"
                   "    return 1\n"
                   "def g():\n"
                   "    return 2  # repro-lint: disable=all\n"
                   "def h():\n"
                   "    return 3\n")
    assert op_audit._site(str(src), 2, 1)[2] is True
    assert op_audit._site(str(src), 4, 3)[2] is True
    assert op_audit._site(str(src), 6, 5)[2] is False
    rec = op_audit.OpRecorder(path="p", symbol="s")
    rec.refused("'pinv'", ("src/x.py", 9, True))
    rec.refused("'nonzero'", ("src/x.py", 12, False))
    assert rec.suppressed == ["src/x.py:9: 'pinv'"]
    assert [(f.pass_id, f.path, f.line) for f in rec.findings] == \
        [(trace.PASS_CALLBACK, "src/x.py", 12)]


# ---------------------------------------------------- write structure
def test_fused_variants_prove_clean():
    for variant in ("segment", "stash"):
        facts, fs = trace.prove_variant(variant)
        assert fs == [], (variant, [f.message for f in fs])
        assert sum(f["into_output"] for f in facts) == 1


def test_stated_write_structure():
    """The segment variant: per-slot run sums and targets, then ONE
    accumulating ``index_add_`` into the output, last; the stash variant:
    its one stash update."""
    seg, _ = trace.prove_variant("segment")
    assert [(f["op"], f["into_output"]) for f in seg] == [
        ("index_add_", False), ("scatter_reduce_", False),
        ("index_add_", True)]
    stash, _ = trace.prove_variant("stash")
    assert [(f["op"], f["accumulate"], f["into_output"]) for f in stash] \
        == [("index_add_", True, True)]


def _w(op="index_add_", accumulate=True, into_output=True, dup=None):
    return {"op": op, "accumulate": accumulate, "out_shape": (8, 16),
            "duplicates": dup, "into_output": into_output}


def test_write_structure_fixtures_rejected():
    cw = trace.check_write_structure
    fs = cw([_w(into_output=False)], variant="segment", symbol="s")
    assert any("computes nothing" in f.message for f in fs)
    fs = cw([_w(into_output=False), _w()], variant="stash", symbol="s")
    assert any("stash variant makes 2" in f.message for f in fs)
    fs = cw([_w(), _w()], variant="segment", symbol="s")
    assert any("expected exactly one" in f.message for f in fs)
    fs = cw([_w(), _w(into_output=False)], variant="segment", symbol="s")
    assert any("after its per-run apply" in f.message for f in fs)
    fs = cw([_w(op="index_put_", accumulate=False)], variant="stash",
            symbol="s")
    assert any("without accumulating" in f.message for f in fs)
    assert cw([_w()], variant="warp", symbol="s")
    assert all(f.pass_id == trace.PASS_CONFLICT for f in fs)
    assert cw([_w(into_output=False), _w()], variant="segment",
              symbol="s") == []
    assert cw([_w()], variant="stash", symbol="s") == []


def test_scatter_claims_fixture_rejected():
    claim = [_w(op="index_put_", accumulate=False, dup=False)]
    assert len(trace.check_scatter_claims(claim, duplicates_possible=True,
                                          path="p", symbol="s")) == 1
    assert trace.check_scatter_claims(claim, duplicates_possible=False,
                                      path="p", symbol="s") == []
    met = [_w(op="index_put_", accumulate=False, dup=True)]
    assert trace.check_scatter_claims(met, duplicates_possible=False,
                                      path="p", symbol="s")
    assert trace.check_scatter_claims([_w()], duplicates_possible=True,
                                      path="p", symbol="s") == []


# --------------------------------------------------- tier integration
def test_trace_tier_clean_on_committed_tree():
    findings, bundle, m = run_trace_tier(device="cpu")
    assert findings == [], [f.message for f in findings]
    assert m.hot_paths_traced == 6
    assert m.encodings_verified == len(trace.DEFAULT_CONFIGS)
    assert m.jaxpr_eqns_walked > 0 and m.launches_analyzed > 0
    assert m.findings_total == 0
    assert set(bundle) == {"conflict_report", "encoding_proofs", "metrics",
                           "hot_paths"}
    assert [h["name"] for h in bundle["hot_paths"]] == \
        [hp.name for hp in trace.registered_hot_paths(device="cpu")]
    assert bundle["conflict_report"] == rtrace.conflict_report(
        rcore.build_blco(rcore.random_tensor((40, 25, 30), 2000, seed=1,
                                             dist="powerlaw"),
                         target_bits=12, max_nnz_per_block=256), 0)
    json.dumps(bundle)
    assert trace.TRACE_PASS_IDS == rtrace.TRACE_PASS_IDS


@pytest.mark.parametrize("entry", ["registered_hot_paths",
                                   "representative_stream",
                                   "run_trace_tier"])
def test_hot_path_entries_default_to_the_card(entry, monkeypatch):
    """Like every entry point of the port, the hot-path audit runs on the
    card unless asked for the CPU, and raises where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"registered_hot_paths": trace.registered_hot_paths,
          "representative_stream": trace.hotpaths.representative_stream,
          "run_trace_tier": run_trace_tier}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()


def test_metrics_are_the_reference_metrics():
    m = trace.TraceVerifyMetrics()
    assert m.snapshot().keys() == rtrace.TraceVerifyMetrics().snapshot() \
        .keys()
    _, _, m = run_trace_tier(hot_paths=[])
    text = render_prometheus_analysis(m)
    assert "repro_analysis" in text and math.isfinite(m.runtime_total_s)
