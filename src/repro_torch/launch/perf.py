"""Perf hillclimb runner: A/B config overrides against a dry-run cell,
the port's counterpart of ``repro.launch.perf``.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch mamba2-370m \
        --shape train_4k --tag chunk64 --override ssd_chunk=64

Each run is a subprocess (its own fake process group); results accumulate
in build/perf/<arch>.<shape>.<tag>.json.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def run(arch, shape, tag, overrides, out_dir="build/perf", mesh="single",
        timeout=3600):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}.{shape}.{tag}.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--mesh", mesh, "--out", path]
    for ov in overrides:
        cmd += ["--override", ov]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if not os.path.exists(path):
        raise RuntimeError(r.stderr[-2000:])
    rec = json.load(open(path))
    return rec


def summarize(rec):
    if rec.get("status") != "ok":
        return rec.get("status"), rec.get("traceback", "")[-500:]
    rf = rec["roofline"]
    return {
        "compute_s": rf["compute_s"], "memory_s": rf["memory_s"],
        "collective_s": rf["collective_s"], "dominant": rf["dominant"],
        "step_s": rf["step_time_s"],
        "hbm_gib": rec.get("hbm_per_device_bytes", 0) / 2**30,
        "useful": rec.get("useful_flops_ratio"),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--override", action="append", default=[])
    args = ap.parse_args()
    rec = run(args.arch, args.shape, args.tag, args.override, mesh=args.mesh)
    print(json.dumps(summarize(rec), indent=1, default=str))


if __name__ == "__main__":
    main()
