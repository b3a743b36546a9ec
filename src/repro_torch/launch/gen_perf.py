"""Generate a perf log from recorded dry-run/perf JSONs: the port's
counterpart of ``repro.launch.gen_perf``, over ``build/``.

    PYTHONPATH=src python -m repro_torch.launch.gen_perf >> section.md
"""
from __future__ import annotations

import json
import os


def _load(path):
    if not os.path.exists(path):
        return None
    r = json.load(open(path))
    return r if r.get("status") == "ok" else None


def row(tag, rec):
    if rec is None:
        return f"| {tag} | - | - | - | - | - | - |"
    rf = rec["roofline"]
    hbm = rec.get("hbm_per_device_bytes", 0) / 2**30
    return (f"| {tag} | {rf['compute_s']:.2f} | {rf['memory_s']:.2f} | "
            f"{rf['collective_s']:.2f} | **{rf['step_time_s']:.2f}** "
            f"({rf['dominant']}) | {hbm:.1f} | "
            f"{rec.get('useful_flops_ratio', 0) or 0:.2f} |")


HEADER = ("| config | compute(s) | memory(s) | collective(s) | step bound | "
          "HBM GiB/dev | useful |\n|---|---|---|---|---|---|---|")


def cell_table(arch, shape, tags):
    lines = [HEADER]
    base = _load(f"build/dryrun_baseline/{arch}.{shape}.single.json")
    cur = _load(f"build/dryrun/{arch}.{shape}.single.json")
    lines.append(row("iter-0 paper-faithful baseline (naive GSPMD)", base))
    lines.append(row("iter-1..3 global fixes (see narrative)", cur))
    for tag, label in tags:
        rec = _load(f"build/perf/{arch}.{shape}.{tag}.json")
        lines.append(row(label, rec))
    return "\n".join(lines)


def main():
    print("### Pair A — zamba2-1.2b x train_4k (worst roofline fraction; "
          "memory-bound)\n")
    print(cell_table("zamba2-1.2b", "train_4k", [
        ("chunk128", "iter-A1 ssd_chunk 256->128"),
        ("chunk64", "iter-A2 ssd_chunk 256->64"),
        ("split", "iter-A3 split z/x/B/C/dt projections"),
        ("chunk64split", "iter-A4 chunk64 + split"),
        ("chunk64split_bf16", "iter-A5 chunk64 + split + bf16 params"),
    ]))
    print("\n### Pair B — stablelm-12b x train_4k (most collective-bound)\n")
    print(cell_table("stablelm-12b", "train_4k", [
        ("bf16params", "iter-B2 bf16 param storage (halves AG/RS wire)"),
        ("dots_remat", "iter-B3 remat dots_saveable (less recompute)"),
        ("bf16_dots", "iter-B4 bf16 + dots_saveable"),
    ]))
    print("\n### Pair C — minicpm-2b x train_4k (paper-technique cell)\n")
    print(cell_table("minicpm-2b", "train_4k", [
        ("scatter", "iter-C1 embed_grad=scatter (naive baseline)"),
        ("segment_bf16", "iter-C2 segment + bf16 params"),
    ]))


if __name__ == "__main__":
    main()
