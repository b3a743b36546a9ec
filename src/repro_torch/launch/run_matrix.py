"""Drive the full dry-run matrix as sequential subprocesses (resumable):
the port's counterpart of ``repro.launch.run_matrix``.

    PYTHONPATH=src python -m repro_torch.launch.run_matrix --out-dir build/dryrun

Each cell runs ``python -m repro_torch.launch.dryrun`` in its own process
(the fake process group of the mesh's size lives as long as the cell).
Existing ok/skipped results are not recomputed, so the matrix can be
re-driven after fixes.  Multi-pod cells skip the depth-point traces; they
still trace the full per-rank program.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ARCHS = ["mamba2-370m", "zamba2-1.2b", "minicpm-2b", "internvl2-2b",
         "h2o-danube-3-4b", "seamless-m4t-large-v2", "stablelm-12b",
         "qwen2.5-14b", "dbrx-132b", "deepseek-v2-236b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def cell_path(out_dir, arch, shape, mesh):
    return os.path.join(out_dir, f"{arch}.{shape}.{mesh}.json")


def done(path):
    if not os.path.exists(path):
        return False
    try:
        return json.load(open(path)).get("status") in ("ok", "skipped")
    except Exception:
        return False


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="build/dryrun")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--only-arch")
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)

    cells = []
    for mesh in args.meshes.split(","):
        for arch in ARCHS:
            if args.only_arch and arch != args.only_arch:
                continue
            for shape in SHAPES:
                cells.append((arch, shape, mesh))

    for i, (arch, shape, mesh) in enumerate(cells):
        path = cell_path(args.out_dir, arch, shape, mesh)
        if done(path):
            print(f"[{i+1}/{len(cells)}] skip-done {arch} {shape} {mesh}",
                  flush=True)
            continue
        t0 = time.time()
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh,
               "--out", path]
        if mesh == "multi":
            cmd.append("--skip-cost-model")
        print(f"[{i+1}/{len(cells)}] run {arch} {shape} {mesh} ...",
              flush=True)
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            status = json.load(open(path)).get("status") \
                if os.path.exists(path) else f"rc={r.returncode}"
        except subprocess.TimeoutExpired:
            status = "timeout"
            with open(path, "w") as f:
                json.dump({"arch": arch, "shape": shape, "mesh": mesh,
                           "status": "timeout"}, f)
        print(f"    -> {status} in {time.time()-t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
