"""``BENCHMARK.json`` against the contract's characters and limits, every
entry resolved to its files, and the harness's imports: no JAX and no
JAX package in a run, nothing of the program in the yardstick."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from tdbench import manifest

ROOT = manifest.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _text_ok(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["tdbench"]
    assert BENCH["command"][1].startswith("tdbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_text():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text_ok(c["source"])
        assert _text_ok(c["why"]) and c["file"].startswith("tdbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _text_ok(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text_ok(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    names = [x["name"] for x in BENCH["configs"]]
    names += [x["name"] for x in BENCH["workloads"]]
    metrics = [x["name"] for x in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    assert len(set(metrics)) == len(metrics)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    spec = manifest.cell(cell)
    conf = [c for c in BENCH["configs"]
            if c["name"] == spec["cell"]["config"]][0]
    cfg = spec["config"]
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"]
    assert {"dims", "nnz", "dist", "rank", "dtype", "pinv_rtol", "assumed",
            "limits"} <= set(cfg)
    assert {"regime", "warmup_sweeps"} <= set(spec["traffic"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert callable(manifest.reader(m["name"]))


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


def _imports(path: Path) -> set:
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            found.add(node.module.split(".")[0])
    return found


def test_yardstick_imports_nothing_of_the_program():
    here = ROOT / "tdbench"
    for path in [*here.glob("*.py"), *here.glob("metrics/*.py")]:
        got = _imports(path)
        assert not got & {"jax", "jaxlib", "flax", "repro"}, path
        if path.name not in ("run.py", "test_tdbench_gen.py",
                             "test_tdbench_faults.py"):
            assert "repro_torch" not in got, path


def test_a_run_loads_no_jax_nor_the_jax_package():
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from tdbench import manifest, run\n"
        "spec = manifest.cell('nell2-cpals-r32')\n"
        "spec['config'] = dict(spec['config'], dims=[20, 16, 24], nnz=800)\n"
        "r = run.run_cell('nell2-cpals-r32', 2**31 + 3, 0.05, True,\n"
        "                 device='cpu', spec=spec)\n"
        "print(json.dumps({'found': run.forbidden_modules(),\n"
        "                  'port': 'repro_torch' in sys.modules,\n"
        "                  'correct': r['correct']}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"found": [], "port": True, "correct": True}
