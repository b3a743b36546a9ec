"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs`` entry -> its ``file``) and a
traffic mix (``tdbench/traffic/<traffic>.json``); a per-layer metric is
read by ``tdbench/metrics/<name>.py``.  A metric with a ``workloads`` list
belongs to those cells only, one without to every cell.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str) -> dict:
    """The cell's entry with its configuration, traffic and metrics."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    work = found[0]
    conf = [c for c in bench["configs"] if c["name"] == work["config"]][0]
    return {
        "cell": work,
        "config": json.loads((ROOT / conf["file"]).read_text()),
        "traffic": json.loads(
            (HERE / "traffic" / f"{work['traffic']}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"]
                       if _applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if _applies(m, name)],
    }


def reader(name: str):
    """The ``read(run) -> float | None`` of per-layer metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"tdbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
