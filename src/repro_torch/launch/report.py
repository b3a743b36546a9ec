"""Generate PERF.md's dry-run and roofline tables from the dry run's
JSONs: the port's counterpart of ``repro.launch.report``.

    PYTHONPATH=src python -m repro_torch.launch.report --dir build/dryrun

Each table replaces what follows its marker (``<!-- DRYRUN_TABLE -->``,
``<!-- ROOFLINE_TABLE -->``); the roofline fraction is the model's useful
compute at the H100's bf16 peak (``roofline.PEAK_FLOPS``) over the step's
lower bound.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch import roofline

ARCH_ORDER = ["stablelm-12b", "qwen2.5-14b", "minicpm-2b", "h2o-danube-3-4b",
              "mamba2-370m", "internvl2-2b", "seamless-m4t-large-v2",
              "zamba2-1.2b", "dbrx-132b", "deepseek-v2-236b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(d):
    cells = {}
    for p in glob.glob(os.path.join(d, "*.json")):
        try:
            r = json.load(open(p))
        except Exception:
            continue
        cells[(r.get("arch"), r.get("shape"), r.get("mesh"))] = r
    return cells


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/2**30:.2f}"


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 0.1:
        return f"{x:.2f}s"
    if x >= 1e-4:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def dryrun_table(cells) -> str:
    rows = ["| arch | shape | 16x16 | 2x16x16 | HBM/dev (GiB) | trace(s) "
            "| collectives (single-pod) |",
            "|---|---|---|---|---|---|---|"]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            s = cells.get((arch, shape, "single"))
            m = cells.get((arch, shape, "multi"))

            def stat(r):
                if r is None:
                    return "PENDING"
                return {"ok": "PASS", "skipped": "SKIP",
                        "error": "FAIL", "timeout": "TIMEOUT"}.get(
                            r.get("status"), "?")
            hbm = fmt_bytes(s.get("hbm_per_device_bytes")) if s else "-"
            comp = f"{s.get('trace_s', 0):.0f}" if s and s.get("trace_s") \
                else "-"
            coll = "-"
            if s and s.get("status") == "ok":
                c = (s.get("rolled_analysis") or {}).get("collectives", {})
                coll = " ".join(f"{k}:{v}" for k, v in
                                sorted(c.get("counts", {}).items())) or "none"
            if s and s.get("status") == "skipped":
                coll = s.get("reason", "")[:60]
            rows.append(f"| {arch} | {shape} | {stat(s)} | {stat(m)} | "
                        f"{hbm} | {comp} | {coll} |")
    return "\n".join(rows)


def roofline_table(cells) -> str:
    rows = ["| arch | shape | compute | memory | collective | dominant | "
            "step lower-bound | useful flops | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = cells.get((arch, shape, "single"))
            if r is None or r.get("status") != "ok":
                if r is not None and r.get("status") == "skipped":
                    rows.append(f"| {arch} | {shape} | SKIP (full-attention; "
                                f"assignment rule) ||||||||")
                continue
            rf = r.get("roofline", {})
            ufr = r.get("useful_flops_ratio")
            # roofline fraction: useful compute time / step lower bound
            mf = r.get("model_flops_global", 0.0)
            chips = r.get("chips", 256)
            useful_compute_s = mf / chips / roofline.PEAK_FLOPS
            frac = useful_compute_s / rf["step_time_s"] if rf.get(
                "step_time_s") else None
            rows.append(
                f"| {arch} | {shape} | {fmt_s(rf.get('compute_s'))} | "
                f"{fmt_s(rf.get('memory_s'))} | "
                f"{fmt_s(rf.get('collective_s'))} | {rf.get('dominant')} | "
                f"{fmt_s(rf.get('step_time_s'))} | "
                f"{ufr:.2f} | {frac*100:.1f}% |" if frac is not None else
                f"| {arch} | {shape} | - | - | - | - | - | - | - |")
    return "\n".join(rows)


def _replace_block(text: str, marker: str, table: str) -> str:
    """Replace everything between ``marker`` and the next blank-line-followed
    non-table line with the fresh table (idempotent regeneration)."""
    import re
    pattern = re.compile(
        re.escape(marker) + r"(?:\n+(?:\|[^\n]*\n)+)?", re.M)
    return pattern.sub(marker + "\n\n" + table + "\n", text, count=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--experiments", default="PERF.md")
    args = ap.parse_args()
    cells = load(args.dir)
    dt = dryrun_table(cells)
    rt = roofline_table(cells)
    text = open(args.experiments).read()
    text = _replace_block(text, "<!-- DRYRUN_TABLE -->", dt)
    text = _replace_block(text, "<!-- ROOFLINE_TABLE -->", rt)
    open(args.experiments, "w").write(text)
    ok = sum(1 for r in cells.values() if r.get("status") == "ok")
    sk = sum(1 for r in cells.values() if r.get("status") == "skipped")
    er = sum(1 for r in cells.values()
             if r.get("status") in ("error", "timeout"))
    print(f"cells: {ok} ok, {sk} skipped, {er} failed, "
          f"{len(cells)} total recorded")


if __name__ == "__main__":
    main()
