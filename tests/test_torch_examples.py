"""The port's TD examples (``repro_torch.examples``) against the JAX
package's scripts on the CPU: quickstart, oom_decomposition and
distributed_cpals, each at the reference's own sizes and seeds, with
``--device cpu`` (the plain ``kernel="torch"`` path).

Each reference script runs in this process (its module globals kept, so
its fits are read at full precision), except the distributed one, which
needs eight fake XLA devices and runs in a subprocess.  The port's fits
are caught by a spy on ``cp_als`` (or read from each rank's JSON line).
Every departure of the port from the reference's asserts or prints is
named in ``DIFFERENCES`` with its reason, and a test holds each name to
the port's source."""
import ast
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("jax")

from repro_torch import core  # noqa: E402
from repro_torch.examples import (distributed_cpals,  # noqa: E402
                                  oom_decomposition, quickstart)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# per-sweep fit, port (plain path) against the reference: the two add in
# another order, never bit for bit
FIT_TOL = 1e-4
# the reference's distributed example: JAX on eight fake devices
REF_TIMEOUT_S = 300

# Where a port entry point departs from its reference script, keyed by
# the module's path (under src/repro_torch/ for the port, under the root
# for the reference) and a name that the port's source holds and the
# reference's does not.
DIFFERENCES = {
    "examples/quickstart.py": {
        "device_parser": "--device: the card by default; cpu runs the "
                         "plain kernel='torch' path (the port's device=)",
        'kernel=kernel': "plan_for's kernel is 'cuda' (K1/K2) or 'torch' "
                         "in place of the reference's 'xla'",
    },
    "examples/oom_decomposition.py": {
        "device_parser": "--device, as above",
        "require(": "checks that python -O keeps, in place of assert",
    },
    "examples/serve_td.py": {
        "device_parser": "--device, as above",
        "RESUME_TOL": "act 3's fits == ref_fits (serve_td.py:215): the "
                      "resumed run disk-streams and the uninterrupted one "
                      "ran in memory, and the reference itself misses "
                      "equality across the two regimes; each fit within "
                      "1e-4 on the CPU, 1e-3 on the card (K1's atomics)",
        "SOLO_TOL": "act 1's solo check keeps the reference's rtol 1e-5, "
                    "atol 1e-6 on the CPU; on the card K1's atomics "
                    "reorder additions from run to run beyond that bound, "
                    "so the factors are held within 1e-3 there",
        "TemporaryDirectory": "act 3's store and snapshot are deleted "
                              "even when a check fails",
    },
    "examples/distributed_cpals.py": {
        "device_parser": "--device, as above",
        "factor placement": "NamedSharding(P(None, 'model')) has no "
                            "counterpart: the factors are whole on every "
                            "rank (ShardedPlan takes the column block), so "
                            "each rank prints its factors' device and shape",
        "backend_for": "eight ranks are processes (FileStore rendezvous): "
                       "NCCL where each has a card, else gloo (on one "
                       "card, every rank on cuda:0)",
        "array_equal": "the parent holds the ranks' factors bitwise equal",
    },
    "examples/serve_lm.py": {
        "device_parser": "--device, as above; the model's weights are "
                         "drawn on it (tests/test_torch_models.py::"
                         "DIFFERENCES)",
    },
    "scripts/chaos_soak.py": {
        "device_parser": "--device, as above",
        "FIT_TOL": "a done job is bit-identical on the CPU; on the card "
                   "it is held within 1e-3 of the fault-free run (K1's "
                   "atomics and K2's stashes reorder additions; ROADMAP "
                   "item 4a), the largest |dfit| and |dfactor| printed",
        "obs_trace.enabled()": "tracing is on for the soak only, so a "
                               "caller in the same process finds it as it "
                               "was",
    },
    "scripts/lint.py": {
        "device_parser": "--device: the trace tier's hot paths run on the "
                         "card by default",
        "DEFAULT_PATHS": "src/repro_torch and chip_smoke.py against "
                         "src/repro_torch/analysis/lint_baseline.json",
    },
}

@pytest.mark.parametrize("module", sorted(DIFFERENCES))
def test_each_difference_is_in_the_port_and_not_the_reference(module):
    port = open(os.path.join(REPO, "src", "repro_torch", module)).read()
    ref = open(os.path.join(REPO, module)).read()
    for name in DIFFERENCES[module]:
        assert name in port, name
        assert name not in ref, name


@pytest.mark.parametrize("module", sorted(DIFFERENCES))
def test_entry_point_has_main_and_a_docstring_naming_its_command(module):
    name = "repro_torch." + module[:-3].replace("/", ".")
    tree = ast.parse(open(os.path.join(REPO, "src", "repro_torch",
                                       module)).read())
    mains = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name == "main"]
    assert len(mains) == 1 and mains[0].args.args[0].arg == "argv"
    assert f"python -m {name}" in " ".join(ast.get_docstring(tree).split())


def _run_reference(path) -> tuple[dict, str]:
    """Execute a reference script in this process: its globals and what it
    printed."""
    g = {"__name__": "__main__", "__file__": path}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        exec(compile(open(path).read(), path, "exec"), g)
    return g, out.getvalue()


def _run_port(module, monkeypatch, spied=()) -> tuple[int, str, dict]:
    """``module.main(["--device", "cpu"])``: its exit code, what it
    printed, and what each spied callable of the module returned."""
    got = {}
    for owner, name in spied:
        real = getattr(owner, name)
        got[name] = []

        def spy(*a, _real=real, _out=got[name], **k):
            res = _real(*a, **k)
            _out.append(res)
            return res
        monkeypatch.setattr(owner, name, spy)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main(["--device", "cpu"])
    return rc, out.getvalue(), got


def _field(pattern, text):
    m = re.search(pattern, text, re.M)
    assert m, (pattern, text)
    return m.groups()


def _assert_fits(port, ref):
    assert len(port) == len(ref)
    assert max(abs(float(a) - float(b)) for a, b in zip(port, ref)) \
        <= FIT_TOL


def test_quickstart_matches_reference(monkeypatch):
    """Dims, nnz, blocks, launches, index bits, the backend, one dispatch
    per call, all 15 fits and the engine's bytes and launches."""
    g, ref_out = _run_reference(os.path.join(REPO, "examples",
                                             "quickstart.py"))
    rc, out, got = _run_port(quickstart, monkeypatch,
                             [(core, "cp_als"), (quickstart, "plan_for")])
    assert rc == 0
    for pat in (r"^tensor dims=(.*) nnz=([\d,]+) density=(\S+)$",
                r"^BLCO: (\d+) block\(s\), (\d+) launch\(es\), (\d+) index "
                r"bits, ([\d.]+) MB",
                r"^engine chose backend='(\w+)'",
                r"^one MTTKRP call = (\d+) device dispatch across (\d+)"):
        assert _field(pat, out) == _field(pat, ref_out), pat
    assert _field(r"kernel='(\w+)'", out) == ("torch",)
    (res,), (plan,) = got["cp_als"], got["plan_for"]
    _assert_fits(res.fits, g["res"].fits)
    assert res.iterations == g["res"].iterations == 15
    for key in ("h2d_bytes", "launches", "mttkrp_calls"):
        assert plan.stats().snapshot()[key] == \
            g["plan"].stats().snapshot()[key], key


def test_oom_decomposition_matches_reference(monkeypatch):
    """The budget, the streamed backend, launches per call and their
    reservation, all 8 fits, and the engine's bytes and launches."""
    g, ref_out = _run_reference(os.path.join(REPO, "examples",
                                             "oom_decomposition.py"))
    rc, out, got = _run_port(oom_decomposition, monkeypatch,
                             [(core, "cp_als"),
                              (oom_decomposition, "plan_for")])
    assert rc == 0
    for pat in (r"^tensor dims=(.*) nnz=([\d,]+)$",
                r"^budget ([\d.]+) MB cannot hold the ([\d.]+) MB tensor "
                r"\+ factors -> backend='(\w+)': (\d+) launches of "
                r"<= ([\d,]+) nnz, ([\d.]+) MB in flight",
                r"^engine stats: (\d+) launches, ([\d.]+) MB H2D"):
        assert _field(pat, out) == _field(pat, ref_out), pat
    (res,), (plan,) = got["cp_als"], got["plan_for"]
    _assert_fits(res.fits, g["res"].fits)
    s, rs = plan.stats(), g["s"]
    assert (s.backend, s.h2d_bytes, s.launches, s.mttkrp_calls) == \
        (rs.backend, rs.h2d_bytes, rs.launches, rs.mttkrp_calls) == \
        ("streamed", rs.h2d_bytes, 288, 24)


_REF_DISTRIBUTED = """
import json, runpy, sys
g = runpy.run_path(sys.argv[1], run_name="__main__")
print(json.dumps({"fits": [float(f) for f in g["res"].fits],
                  "stats": g["plan"].stats().snapshot(),
                  "dims": list(g["t"].dims), "nnz": g["t"].nnz,
                  "blocks": len(g["b"].blocks)}))
"""


def test_distributed_cpals_eight_gloo_ranks_match_reference(capsys):
    """Eight gloo ranks on a (4, 2) mesh: every rank's 10 fits within
    1e-4 of the reference's on eight fake XLA devices, the ranks' factors
    bitwise equal (held by ``main``), every rank's dispatches equal the
    reference's, and the ranks' shard bytes sum to the reference's
    mesh-wide upload."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=8")
    ref = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REF_DISTRIBUTED),
         os.path.join(REPO, "examples", "distributed_cpals.py")],
        env=env, capture_output=True, text=True, timeout=REF_TIMEOUT_S)
    assert ref.returncode == 0, ref.stderr[-4000:]
    want = json.loads(ref.stdout.splitlines()[-1])
    assert want["stats"]["backend"] == "sharded"

    assert distributed_cpals.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "gloo on cpu" in out
    assert "factors bitwise equal across the 8 ranks" in out
    assert _field(r"\[rank 0\] tensor dims=(.*) nnz=([\d,]+); BLCO "
                  r"blocks=(\d+)$", out) == \
        (str(tuple(want["dims"])), f"{want['nnz']:,}", str(want["blocks"]))
    assert "[rank 0] factor placement: whole on every rank, cpu (300, 16)" \
        in out
    reports = [json.loads(line.split("] ", 1)[1])
               for line in out.splitlines()
               if re.match(r"^\[rank \d\] \{", line)]
    assert [r["rank"] for r in reports] == list(range(8))
    for r in reports:
        _assert_fits(r["fits"], want["fits"])
        assert r["fits"] == reports[0]["fits"]
        assert r["dispatches"] == want["stats"]["launches"] == 30
        assert r["device"] == "cpu"
        assert not any(r["launches"].values())     # no kernel on the CPU
    assert sum(r["h2d_bytes"] for r in reports) == \
        want["stats"]["h2d_bytes"]


def test_entry_points_refuse_an_absent_card():
    """``--device`` defaults to the card; without one the entry point
    raises rather than falling back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for module in (quickstart, oom_decomposition):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main([])


def test_device_parser_and_kernel_for():
    from repro_torch.examples import device_parser, kernel_for
    ap = device_parser("Title line.\n\nMore.")
    assert ap.description == "Title line."
    assert ap.parse_args([]).device == "cuda"
    assert ap.parse_args(["--device", "cpu"]).device == "cpu"
    assert kernel_for("cpu") == "torch"
    assert kernel_for("cuda") == kernel_for("cuda:0") == "cuda"



def test_ranks_stop_waiting_once_one_fails(tmp_path):
    """A rank that exits non-zero ends the wait at once: the others, which
    would wait for it in a collective, are killed, not waited for."""
    import time
    argvs = [[sys.executable, "-c", "import sys; sys.exit(3)"],
             [sys.executable, "-c", "import time; time.sleep(120)"]]
    t0 = time.monotonic()
    results = distributed_cpals._run_ranks(argvs, dict(os.environ),
                                           str(tmp_path))
    assert time.monotonic() - t0 < 60
    assert results[0][0] == 3 and results[1][0] != 0
