"""The dry run's tools (``repro_torch.launch.{run_matrix,report,perf,
gen_perf}``) against the JAX package's, on the CPU.

Each is the reference's module but for ``SUBSTITUTIONS``: applied to the
reference's source, it parses to the port's AST (docstrings aside).  The
tables of ``report`` over the same synthetic records equal the
reference's (its TPU peak patched in), ``run_matrix`` resumes over
``ok``/``skipped`` files and runs the port's dry run for the rest, and
``perf``/``gen_perf`` read the same records.
"""
import ast
import json
import os
import subprocess
import sys

import pytest

from repro.launch import gen_perf as ref_gen_perf
from repro.launch import report as ref_report
from repro_torch.launch import gen_perf, perf, report, roofline, run_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (reference text, port text) per module: the named substitutions
SUBSTITUTIONS = {
    "run_matrix.py": [
        ('"repro.launch.dryrun"', '"repro_torch.launch.dryrun"'),
        ('default="results/dryrun"', 'default="build/dryrun"')],
    "report.py": [
        ('default="results/dryrun"', 'default="build/dryrun"'),
        # the repo has no EXPERIMENTS.md: the markers are in PERF.md
        ('default="EXPERIMENTS.md"', 'default="PERF.md"'),
        # no TPU number in the port: the H100's bf16 peak
        ("import os\n", "import os\n\nfrom repro_torch.launch import "
                        "roofline\n"),
        ("mf / chips / 197e12", "mf / chips / roofline.PEAK_FLOPS"),
        # a cell records its trace seconds in place of its compile's
        ("s.get('compile_s', 0)", "s.get('trace_s', 0)"),
        ('s.get("compile_s")', 's.get("trace_s")'),
        ("compile(s)", "trace(s)")],
    "perf.py": [
        ('"repro.launch.dryrun"', '"repro_torch.launch.dryrun"'),
        ('out_dir="results/perf"', 'out_dir="build/perf"')],
    "gen_perf.py": [
        ('"results/dryrun_baseline/', '"build/dryrun_baseline/'),
        ('"results/dryrun/', '"build/dryrun/'),
        ('"results/perf/', '"build/perf/')],
}


def _dump(source: str) -> str:
    """The module's AST without docstrings."""
    tree = ast.parse(source)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("module", sorted(SUBSTITUTIONS))
def test_tool_is_the_reference_after_the_substitutions(module):
    ref = open(os.path.join(REPO, "src", "repro", "launch", module)).read()
    port = open(os.path.join(REPO, "src", "repro_torch", "launch",
                             module)).read()
    for old, new in SUBSTITUTIONS[module]:
        assert ref.count(old) == 1, old
        ref = ref.replace(old, new)
    assert _dump(port) == _dump(ref)
    assert "197e12" not in port and "results/" not in port


def _record(arch, shape, mesh, status, *, trace_key, i=0):
    """A synthetic dry-run record, its seconds under ``trace_key``."""
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": status}
    if status == "skipped":
        rec["reason"] = "full-attention arch: 500k-token decode KV does not"
        return rec
    if status != "ok":
        return rec
    step = 0.5 + 0.25 * i
    rec.update({
        trace_key: 12.0 + i, "chips": 512 if mesh == "multi" else 256,
        "hbm_per_device_bytes": (3 + i) * 2**30,
        "rolled_analysis": {"collectives": {"counts": {
            "all-gather": 10 + i, "all-reduce": 4}}},
        "roofline": {"compute_s": 0.01 * (i + 1), "memory_s": step,
                     "collective_s": 2e-5 * (i + 1), "dominant": "memory",
                     "step_time_s": step},
        "useful_flops_ratio": 0.05 * (i + 1),
        "model_flops_global": 1e16 * (i + 1)})
    return rec


def _records(trace_key):
    cells = {}
    statuses = ["ok", "ok", "ok", "skipped", "error", "timeout"]
    i = 0
    for arch in report.ARCH_ORDER[:4]:
        for shape in report.SHAPE_ORDER:
            for mesh in ("single", "multi"):
                status = statuses[i % len(statuses)] \
                    if shape != "long_500k" else "skipped"
                if (arch, shape, mesh) != ("minicpm-2b", "train_4k", "multi"):
                    cells[(arch, shape, mesh)] = _record(
                        arch, shape, mesh, status, trace_key=trace_key, i=i)
                i += 1
    return cells


def test_report_tables_match_the_reference(monkeypatch):
    port_cells = _records("trace_s")
    ref_cells = _records("compile_s")
    want = ref_report.dryrun_table(ref_cells)
    assert report.dryrun_table(port_cells) == want.replace("compile(s)",
                                                           "trace(s)")
    assert report.ARCH_ORDER == ref_report.ARCH_ORDER
    assert report.SHAPE_ORDER == ref_report.SHAPE_ORDER
    monkeypatch.setattr(roofline, "PEAK_FLOPS", 197e12)
    assert report.roofline_table(port_cells) == \
        ref_report.roofline_table(ref_cells)


def test_report_main_fills_the_markers(tmp_path, monkeypatch, capsys):
    cells = _records("trace_s")
    for (arch, shape, mesh), rec in cells.items():
        json.dump(rec, open(tmp_path / f"{arch}.{shape}.{mesh}.json", "w"))
    doc = tmp_path / "PERF.md"
    doc.write_text("# x\n\n<!-- DRYRUN_TABLE -->\n\n| old |\n|---|\n\n"
                   "text\n\n<!-- ROOFLINE_TABLE -->\n\nrest\n")
    for _ in range(2):                 # idempotent regeneration
        monkeypatch.setattr(sys, "argv", ["report", "--dir", str(tmp_path),
                                          "--experiments", str(doc)])
        report.main()
    text = doc.read_text()
    assert "| old |" not in text and "text\n" in text and "rest\n" in text
    assert text.count("| arch | shape | 16x16") == 1
    assert text.count("| arch | shape | compute") == 1
    assert report.dryrun_table(report.load(str(tmp_path))) in text
    assert "total recorded" in capsys.readouterr().out


def test_run_matrix_resumes_and_runs_the_ports_dry_run(tmp_path, monkeypatch):
    arch = "minicpm-2b"
    done = {("train_4k", "single"): "ok", ("prefill_32k", "single"): "ok",
            ("long_500k", "single"): "skipped",
            ("train_4k", "multi"): "ok", ("long_500k", "multi"): "skipped"}
    for (shape, mesh), status in done.items():
        json.dump({"status": status}, open(
            run_matrix.cell_path(str(tmp_path), arch, shape, mesh), "w"))
    json.dump({"status": "error"}, open(run_matrix.cell_path(
        str(tmp_path), arch, "decode_32k", "single"), "w"))
    ran = []

    def fake_run(cmd, **kw):
        ran.append(cmd)
        out = cmd[cmd.index("--out") + 1]
        json.dump({"status": "ok"}, open(out, "w"))
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(run_matrix.subprocess, "run", fake_run)
    monkeypatch.setattr(sys, "argv", ["run_matrix", "--out-dir",
                                      str(tmp_path), "--only-arch", arch])
    run_matrix.main()
    cells = {(c[c.index("--shape") + 1], c[c.index("--mesh") + 1])
             for c in ran}
    assert cells == {(s, m) for s in run_matrix.SHAPES
                     for m in ("single", "multi")} - set(done)
    for c in ran:
        assert c[1:3] == ["-m", "repro_torch.launch.dryrun"]
        assert ("--skip-cost-model" in c) == (c[c.index("--mesh") + 1]
                                              == "multi")
    assert all(run_matrix.done(run_matrix.cell_path(str(tmp_path), arch, s,
                                                    m))
               for s in run_matrix.SHAPES for m in ("single", "multi"))
    ran.clear()
    run_matrix.main()                  # everything done: nothing runs
    assert ran == []


def test_perf_runs_a_cell_and_summarizes_it(tmp_path, monkeypatch):
    rec = _record("zamba2-1.2b", "train_4k", "single", "ok",
                  trace_key="trace_s")

    def fake_run(cmd, **kw):
        assert cmd[1:3] == ["-m", "repro_torch.launch.dryrun"]
        assert cmd[-2:] == ["--override", "ssd_chunk=64"]
        json.dump(rec, open(cmd[cmd.index("--out") + 1], "w"))
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(perf.subprocess, "run", fake_run)
    got = perf.run("zamba2-1.2b", "train_4k", "chunk64", ["ssd_chunk=64"],
                   out_dir=str(tmp_path))
    assert got == rec
    summary = perf.summarize(got)
    assert summary["step_s"] == rec["roofline"]["step_time_s"]
    assert summary["hbm_gib"] == 3.0


def test_gen_perf_rows_match_the_reference(tmp_path, monkeypatch):
    rec = _record("stablelm-12b", "train_4k", "single", "ok",
                  trace_key="trace_s")
    assert gen_perf.row("tag", rec) == ref_gen_perf.row("tag", rec)
    assert gen_perf.row("tag", None) == ref_gen_perf.row("tag", None)
    assert gen_perf.HEADER == ref_gen_perf.HEADER
    monkeypatch.chdir(tmp_path)
    os.makedirs("build/dryrun")
    json.dump(rec, open("build/dryrun/stablelm-12b.train_4k.single.json",
                        "w"))
    table = gen_perf.cell_table("stablelm-12b", "train_4k", [("x", "X")])
    assert gen_perf.row("iter-1..3 global fixes (see narrative)", rec) \
        in table
    assert gen_perf.row("iter-0 paper-faithful baseline (naive GSPMD)",
                        None) in table
    assert gen_perf.row("X", None) in table
