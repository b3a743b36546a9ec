"""The port's scripts (``repro_torch.scripts``) against the JAX package's
on the CPU.

* ``chaos_soak``: the same ``REPRO_FAULTS`` plans through both soaks, in
  this process, with ``REPRO_SANITIZE=1``: the same job states (a failed
  job with the same exception type), the same counters and the same
  ledger bytes, and every done job bit-identical to its fault-free run
  (the port's plain path is bitwise on the CPU).
* ``lint``: exit 0 on the tree, exit 1 on a seeded finding, the
  reference's pass ids under ``--list``, its JSON keys under ``--format
  json``, a baseline written, judged stale and pruned, and the trace tier
  on the CPU.
"""
import contextlib
import importlib.util
import io
import json
import os
import re
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from repro import faults as rfaults  # noqa: E402
from repro.obs import trace as robs_trace  # noqa: E402
from repro_torch.faults import inject  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.scripts import chaos_soak, lint  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# seed:rule;rule (``repro.faults``' spec); the first is the chaos lane's own
PLANS = {
    "docstring": "1234:store.read@n=2:transient;runtime.quantum@n=3:crash",
    # every soak job admits straight from the store (host_budget_bytes=1),
    # so no resident or streamed plan is made and plan.alloc is never
    # probed: both packages finish with no demotion
    "alloc": "1234:plan.alloc@n=1",
    "quantum-exception": "1234:runtime.quantum@n=2:exception",
    "store-corruption": "1234:store.read@p=1:corrupt",
}
# The jobs are submitted one by one to a runtime whose worker already
# sweeps: which job's quantum is the second one, and how many bytes it
# moved before it failed, depend on how far the worker got between two
# submits, in either package.  Under this plan only the states (as a
# multiset) and the counters are compared across the packages; each soak
# still holds its own ledger against its own stats.
TIMING_DEPENDENT = {"quantum-exception"}
JOB = re.compile(r"^  job (\d+): (done|failed)"
                 r"(?:, (bit-identical|within tolerance|DIVERGED))?"
                 r"(?: \((\w+): )?", re.M)
COUNTER = re.compile(r"^  (\w+) = (\d+)$", re.M)
LEDGER = re.compile(r"^  ledger\[(\w+)\]\.bytes = (\d+)  \((\w+) = (\d+)\)$",
                    re.M)
# one finding of the span-hygiene pass, in either package's spelling
SEEDED = '''from repro_torch.obs import trace as obs_trace


def leak():
    sp = obs_trace.span("x", "main")
    return sp
'''


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_soak():
    return _load(os.path.join(REPO, "scripts", "chaos_soak.py"),
                 "ref_chaos_soak")


@pytest.fixture(scope="module")
def ref_lint():
    return _load(os.path.join(REPO, "scripts", "lint.py"), "ref_lint")


@pytest.fixture
def soak_env(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    yield
    inject.uninstall()
    rfaults.inject.uninstall()
    robs_trace.disable()        # the reference's soak leaves it on
    robs_trace.clear()
    obs_trace.clear()


def _capture(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args)
    return rc, out.getvalue()


def _soak_report(text):
    return ({int(n): (state, exc) for n, state, _, exc in JOB.findall(text)},
            dict(COUNTER.findall(text)), LEDGER.findall(text))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_soak_matches_reference_under_plan(name, ref_soak, soak_env,
                                           monkeypatch, tmp_path):
    spec = PLANS[name]
    rfaults.inject.install(spec)
    monkeypatch.setattr(sys, "argv", ["chaos_soak.py", "--trace-out",
                                      str(tmp_path / "ref_trace.json")])
    ref_rc, ref_out = _capture(ref_soak.main)
    inject.install(spec)
    rc, out = _capture(chaos_soak.main, ["--device", "cpu", "--trace-out",
                                         str(tmp_path / "trace.json")])
    assert rc == ref_rc == 0, (out, ref_out)
    assert "chaos soak clean" in out
    assert not obs_trace.is_enabled()        # on for the soak only
    jobs, counters, ledger = _soak_report(out)
    ref_jobs, ref_counters, ref_ledger = _soak_report(ref_out)
    if name in TIMING_DEPENDENT:
        assert sorted(jobs.values()) == sorted(ref_jobs.values())
        assert counters == ref_counters
        assert all(lv == sv for _, lv, _, sv in ledger)
    else:
        assert (jobs, counters, ledger) == (ref_jobs, ref_counters,
                                            ref_ledger)
    assert len(jobs) == len(chaos_soak.WORKLOAD)
    assert set(counters) == {"retries_total", "giveups_total",
                             "demotions_total", "watchdog_restarts",
                             "store_rebuilds", "jobs_failed"}
    done = [m for m in JOB.findall(out) if m[1] == "done"]
    assert all(tag == "bit-identical" for _, _, tag, _ in done)
    assert out.count("max |dfit| 0.000e+00, max |dfactor| 0.000e+00") \
        == len(done)
    assert int(counters["jobs_failed"]) == len(jobs) - len(done)
    if name == "quantum-exception":
        assert sorted(jobs.values()) == [("done", ""), ("done", ""),
                                         ("failed", "RuntimeError")]
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]


def test_soak_deltas_of_a_differing_job():
    f = [np.zeros((2, 3), np.float32)]
    g = [np.full((2, 3), 0.25, np.float32)]
    ref = ("done", [0.1, 0.2], f, None)
    assert chaos_soak._largest_deltas([0.1, 0.2], f, ref) == (0.0, 0.0)
    dfit, dfac = chaos_soak._largest_deltas([0.1, 0.5], g, ref)
    assert dfit == pytest.approx(0.3) and dfac == 0.25
    assert chaos_soak._largest_deltas([0.1], f, ref) == \
        (float("inf"), float("inf"))


def test_lint_cli_tree_is_clean():
    rc, out = _capture(lint.main, [])
    assert rc == 0, out
    assert out.strip() == ("repro-lint[ast]: 0 finding(s), 0 "
                           "baseline-suppressed, 0 stale baseline entries")


def test_lint_cli_seeded_finding_exits_one(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(SEEDED)
    rc, out = _capture(lint.main, [str(bad), "--baseline",
                                   str(tmp_path / "none.json")])
    assert rc == 1
    assert "[span-hygiene] leak:" in out
    assert "repro-lint[ast]: 1 finding(s)" in out


@pytest.mark.parametrize("tier", ["ast", "trace", "all"])
def test_lint_cli_list_matches_reference(tier, ref_lint):
    rc, out = _capture(lint.main, ["--list", "--tier", tier])
    ref_rc, ref_out = _capture(ref_lint.main, ["--list", "--tier", tier])
    assert rc == ref_rc == 0
    ids = [line.split()[0] for line in out.splitlines()]
    assert ids == [line.split()[0] for line in ref_out.splitlines()]
    assert len(ids) == (6 if tier == "ast" else 11)


def test_lint_cli_json_keys_match_reference(tmp_path, ref_lint):
    bad = tmp_path / "bad.py"
    bad.write_text(SEEDED)
    args = [str(bad), "--format", "json", "--baseline",
            str(tmp_path / "none.json")]
    rc, out = _capture(lint.main, args)
    ref_rc, ref_out = _capture(ref_lint.main, args)
    assert rc == ref_rc == 1
    got, want = json.loads(out), json.loads(ref_out)
    assert set(got) == set(want) == {"findings", "suppressed",
                                     "stale_baseline_entries"}
    assert [set(f) for f in got["findings"]] == \
        [set(f) for f in want["findings"]]
    assert [(f["pass_id"], f["symbol"], f["line"]) for f in got["findings"]] \
        == [(f["pass_id"], f["symbol"], f["line"])
            for f in want["findings"]] == [("span-hygiene", "leak", 5)]


def test_lint_cli_write_stale_and_prune_baseline(tmp_path):
    bad, base = tmp_path / "bad.py", str(tmp_path / "baseline.json")
    bad.write_text(SEEDED)
    rc, out = _capture(lint.main, [str(bad), "--baseline", base,
                                   "--write-baseline"])
    assert rc == 0 and "wrote 1 finding(s)" in out
    entries = json.loads(open(base).read())["suppressions"]
    assert [e["pass"] for e in entries] == ["span-hygiene"]
    assert entries[0]["reason"].startswith("TODO")
    rc, out = _capture(lint.main, [str(bad), "--baseline", base])
    assert rc == 0 and "0 finding(s), 1 baseline-suppressed" in out
    bad.write_text(SEEDED.replace('sp = obs_trace.span("x", "main")',
                                  "sp = None"))
    rc, out = _capture(lint.main, [str(bad), "--baseline", base])
    assert rc == 1 and "error: stale baseline entry span-hygiene:" in out
    rc, out = _capture(lint.main, [str(bad), "--baseline", base,
                                   "--prune-baseline"])
    assert rc == 0 and "pruned 1 stale entry" in out
    assert json.loads(open(base).read())["suppressions"] == []
    rc, out = _capture(lint.main, [str(bad), "--baseline", base])
    assert rc == 0


def test_lint_cli_trace_tier_on_the_cpu(tmp_path):
    report = tmp_path / "report.json"
    rc, out = _capture(lint.main, ["--tier", "trace", "--device", "cpu",
                                   "--report-out", str(report)])
    assert rc == 0, out
    assert "repro-lint[trace]: 0 finding(s)" in out
    bundle = json.loads(report.read_text())
    assert set(bundle) == {"conflict_report", "encoding_proofs",
                           "hot_paths", "metrics"}
    assert bundle["hot_paths"] and \
        {hp["device"] for hp in bundle["hot_paths"]} == {"cpu"}
