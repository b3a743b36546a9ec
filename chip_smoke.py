#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

1. build: nvcc compiles the kernels from the checkout's sources (build
   seconds and the ``-Xptxas -v`` register/spill report are printed);
2. kernels: K1 (segment) and K2 (stash) against their plain PyTorch
   versions on the card, at orders 3-5, a field that straddles the two index
   words, forced blocking (many launches), ragged nnz, R > 32 and the three
   (values, factors) dtype pairs;
3. main path: NELL-2 and Uber at their FROSTT dims and nnz (synthesised
   from a seed), rank 32, through ``plan_for(kernel="cuda")`` and five
   CP-ALS sweeps, each held against the plain ``kernel="torch"`` path on
   the card; the kernels' launch counters are zeroed just before and read
   just after;
4. timing: each kernel and mode with CUDA events, beside the plain
   version's time and the card's bound.

The last two lines are the kernel JSON line and the ``ok`` line.  Without a
CUDA device, or outside a checkout, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
RANK = 32
SWEEPS = 5
# the paper's Table 2 tensors at their FROSTT dims and nnz; the data is
# synthesised (a powerlaw random_tensor topped up with uniform coordinates
# by top_up_uniform), the .tns files are not in the repo
TENSORS = {
    "nell-2": ((12092, 9184, 28818), 76_879_419),
    "uber": ((183, 24, 1140, 1717), 3_309_490),
}
# NVIDIA H100 SXM data sheet: HBM3 rate and the f32 rate outside the
# tensor cores (the main path runs in f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# both max |kernel - plain| / max |plain| and ||kernel - plain||_F /
# ||plain||_F: the JAX package's tests bound f32 at 5e-4; atomics only
# reorder float additions, so f64 agrees to ~1e-15.  The Frobenius ratio
# catches lost updates that the max-based one hides under a large output
# (dropping the last update of every K1 chunk gives about 1e-2 at FROSTT
# scale)
REL_TOL = {"float32": 5e-4, "float64": 1e-10}
# per-sweep CP-ALS fit, fused kernel vs plain path, both on the card in f32:
# the pseudo-inverse amplifies the reordered additions of the atomics
FIT_TOL = 1e-3
SOURCE = "src/repro_torch/kernels/csrc/fused_mttkrp.cu"
KERNELS = {
    "segment": ("K1 fused segment (segment_kernel)",
                "src/repro/kernels/fused.py:82"),
    "stash": ("K2 fused stash (stash_kernel)",
              "src/repro/kernels/fused.py:106"),
}
# (dims, nnz, target_bits, max_nnz_per_block, rank)
KERNEL_CASES = [
    ((70, 40, 30), 1777, 12, 512, RANK),             # order 3
    ((13, 7, 29, 5), 499, 8, 64, RANK),              # order 4, many launches
    ((128, 4, 256, 8, 3), 801, 16, 128, RANK),       # order 5
    ((2048, 2048, 2048), 20011, 64, 1 << 27, 40),    # straddling field, R > 32
    ((600, 90, 9), 5003, 64, 1 << 27, 8),            # long mode, narrow rank
]


def say(*parts) -> None:
    print(*parts, flush=True)


def check_err(what, a, b) -> tuple[float, float, float]:
    """(max |a - b| / max |b|, ||a - b||_F / ||b||_F, max |a - b|), in
    float64; raises unless both relative errors are below the tolerance of
    ``b``'s dtype."""
    a64, b64 = a.double(), b.double()
    d = a64 - b64
    diff = float(d.abs().max())
    rel = diff / max(float(b64.abs().max()), 1e-30)
    fro = float(d.norm()) / max(float(b64.norm()), 1e-30)
    tol = REL_TOL[str(b.dtype).replace("torch.", "")]
    if not (rel < tol and fro < tol):
        raise AssertionError(f"{what}: max-rel {rel:.3e}, Frobenius-rel "
                             f"{fro:.3e}, tolerance {tol:.0e}")
    return rel, fro, diff


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return proc.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events,
    after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# --------------------------------------------------------------- phase 1
def build_phase() -> None:
    from repro_torch.kernels.build import load_library
    kl = load_library()
    say(f"[build] {'built' if kl.built else 'loaded'} {kl.path.name} in "
        f"{kl.seconds:.2f} s")
    for line in kl.log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"[build] ptxas: {line.strip()}")


# --------------------------------------------------------------- phase 2
def kernel_phase(dev) -> None:
    """Every kernel against its plain version on small cases."""
    import torch
    from repro_torch.core import build_blco, choose_resolution, random_tensor
    from repro_torch.core.launches import LaunchCache
    from repro_torch.kernels import fused, ref

    worst: dict = {}
    pairs = [(torch.float32, torch.float32), (torch.float64, torch.float64),
             (torch.float64, torch.float32)]
    for dims, nnz, tb, mx, rank in KERNEL_CASES:
        t = random_tensor(dims, nnz, seed=7, dist="powerlaw")
        b = build_blco(t, target_bits=tb, max_nnz_per_block=mx)
        cache = LaunchCache.from_blco(b, device=dev)
        hi, lo, vals, bases = cache.flat()
        rng = np.random.default_rng(SEED)
        host = [rng.standard_normal((d, rank)) for d in dims]
        for vdt, fdt in pairs:
            v = vals.to(vdt)
            fs = [torch.as_tensor(h).to(device=dev, dtype=fdt) for h in host]
            for mode in range(len(dims)):
                for res in ("register", "hierarchical"):
                    kw = dict(field_bits=b.re.field_bits,
                              field_shifts=b.re.field_shift, mode=mode)
                    out = fused.fused_mttkrp_flat(
                        hi, lo, v, bases, fs, out_rows=dims[mode],
                        resolution=res, **kw)
                    variant = fused._variant_for(
                        res, dims[mode], rank=rank, itemsize=out.element_size())
                    if variant == "stash":
                        plain = ref.fused_stash_ref(hi, lo, v, bases, fs,
                                                    out_rows=dims[mode], **kw)
                    else:
                        plain = ref.fused_segment_mttkrp_ref(
                            hi, lo, v, bases, fs, out_rows=dims[mode],
                            tile=math.gcd(hi.shape[0], 256), **kw)
                    torch.cuda.synchronize()
                    if out.shape != (dims[mode], rank) or out.dtype != \
                            torch.promote_types(vdt, fdt):
                        raise AssertionError(f"bad output {out.shape} "
                                             f"{out.dtype}")
                    rel, fro, _ = check_err(
                        f"{variant} kernel vs its plain version: dims {dims} "
                        f"mode {mode} {vdt}x{fdt}", out, plain)
                    key = (variant, str(out.dtype).replace("torch.", ""))
                    worst[key] = max(worst.get(key, 0.0), rel, fro)
        say(f"[kernels] dims {dims} nnz {b.nnz} fields {b.re.field_bits} "
            f"shifts {b.re.field_shift} launches {len(b.launches)} R {rank}: "
            f"ok (resolution {[choose_resolution(d) for d in dims]})")
    for (variant, dname), rel in sorted(worst.items()):
        say(f"[kernels] worst rel err (max-rel or Frobenius-rel) {variant} "
            f"{dname}: {rel:.3e}")
    if {v for v, _ in worst} != set(KERNELS):
        raise AssertionError("the kernel phase did not reach both kernels")


# --------------------------------------------------------------- phase 3
def mean_run_length(cache, mode) -> float:
    """Non-zeros per run of equal target index in the stream's (ALTO)
    order: K1 issues one update per column per run."""
    from repro_torch.core import u64
    hi, lo, vals, bases = cache.flat()
    tgt = u64.extract_field(hi, lo, cache.re_shifts[mode],
                            cache.re_fields[mode]) + bases[:, mode]
    tgt = tgt[vals != 0]                  # padding slots hold the value 0
    runs = 1 + int((tgt[1:] != tgt[:-1]).sum())
    return tgt.numel() / runs


def run_tensor(name, dims, nnz, dev) -> dict:
    """One tensor through the main path; returns what the timing needs."""
    import torch
    from repro_torch.core import (build_blco, choose_resolution, cp_als_init,
                                  cp_als_step, init_factors, random_tensor,
                                  top_up_uniform)
    from repro_torch.engine import InMemoryPlan, plan_for
    from repro_torch.kernels import fused

    t0 = time.perf_counter()
    head = random_tensor(dims, nnz, seed=SEED, dist="powerlaw")
    head_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    t = top_up_uniform(head, nnz, seed=SEED)
    top_s = time.perf_counter() - t0
    head_nnz = head.nnz
    del head
    t0 = time.perf_counter()
    b = build_blco(t)
    build_s = time.perf_counter() - t0
    norm_x = float(np.sqrt(np.sum(t.values.astype(np.float64) ** 2)))
    del t
    say(f"[main] {name}: dims {dims} nnz {b.nnz}, of which the powerlaw "
        f"head {head_nnz} ({head_nnz / b.nnz:.4f}) and the uniform top-up "
        f"{b.nnz - head_nnz}; host generation: head {head_s:.1f} s, top-up "
        f"{top_s:.1f} s; build_blco {build_s:.1f} s "
        f"({ {k: round(v, 2) for k, v in b.construction_stats.items()} }); "
        f"fields {b.re.field_bits} shifts {b.re.field_shift} blocks "
        f"{len(b.blocks)} launches {len(b.launches)}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = plan_for(b, torch.cuda.mem_get_info()[0], rank=RANK,
                    kernel="cuda", device=dev)
    torch.cuda.synchronize()
    say(f"[main] {name}: plan_for -> backend {plan.backend}, resident "
        f"{plan.device_bytes() / 1e9:.3f} GB, reservation "
        f"{plan.resident.cache.reservation}, upload "
        f"{time.perf_counter() - t0:.1f} s")
    plain = InMemoryPlan(b, kernel="torch", resident=plan.resident,
                         owns_resident=False)
    factors = init_factors(dims, RANK, seed=SEED, device=dev)
    modes = []
    for mode, d in enumerate(dims):
        res = choose_resolution(d)
        variant = fused._variant_for(res, d, rank=RANK, itemsize=4)
        out = plan.mttkrp(factors, mode)
        want = plain.mttkrp(factors, mode)
        if out.shape != (d, RANK) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name} mode {mode}: bad output")
        rel, fro, diff = check_err(f"{name} mode {mode}", out, want)
        say(f"[main] {name} mode {mode} (I={d}, {res}) -> {variant}: vs "
            f"kernel='torch' max-rel {rel:.3e}, Frobenius-rel {fro:.3e} "
            f"(max abs {diff:.3e}); mean run of equal target "
            f"{mean_run_length(plan.resident.cache, mode):.4f} non-zeros")
        modes.append((mode, d, variant, res))

    torch.linalg.pinv(torch.eye(RANK, device=dev))      # loads cuSOLVER
    torch.cuda.synchronize()
    fits = {}
    for label, p in (("cuda", plan), ("torch", plain)):
        state = cp_als_init(dims, RANK, norm_x=norm_x, tol=0.0, seed=SEED,
                            device=dev)
        for sweep in range(SWEEPS):
            dev0 = p.stats().device_time_s
            t0 = time.perf_counter()
            cp_als_step(p, state)
            torch.cuda.synchronize()
            sweep_s = time.perf_counter() - t0
            share = (p.stats().device_time_s - dev0) / sweep_s
            say(f"[main] {name} cp_als kernel={label} sweep {sweep}: "
                f"{sweep_s:.4f} s, MTTKRP share {share:.3f}, fit "
                f"{state.fits[-1]:.6f}")
        fits[label] = state.fits
    diffs = [abs(a - c) for a, c in zip(fits["cuda"], fits["torch"])]
    if not all(math.isfinite(f) for f in fits["cuda"] + fits["torch"]) \
            or max(diffs) > FIT_TOL:
        raise AssertionError(f"{name}: fits disagree {fits}")
    say(f"[main] {name}: fits cuda {fits['cuda']}")
    say(f"[main] {name}: fits torch {fits['torch']} (max diff "
        f"{max(diffs):.2e})")
    snap = plan.stats().snapshot()
    if snap["launches"] != snap["mttkrp_calls"]:
        raise AssertionError(f"{name}: not one launch per call: {snap}")
    say(f"[main] {name}: EngineStats {json.dumps(snap)}")
    say(f"[main] {name}: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    return {"name": name, "plan": plan, "dims": dims, "nnz": b.nnz,
            "modes": modes, "factors": factors}


# --------------------------------------------------------------- phase 4
def bound(nnz, dims, mode, rank) -> tuple[float, str]:
    """Least milliseconds for one f32 call (each input read once, the output
    written once; nnz * R * N operations) and what bounds it."""
    item = 4
    n = len(dims)
    stream = nnz * (4 + 4 + item + 4 * n)
    facs = sum(d * rank * item for m, d in enumerate(dims) if m != mode)
    out = dims[mode] * rank * item
    t_bytes = (stream + facs + out) / HBM_BYTES_PER_S
    t_ops = nnz * rank * n / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def timing_phase(runs) -> dict:
    import torch
    from repro_torch.kernels import fused, ref
    rows = {v: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
                "max_abs_err": 0.0, "calls": 0} for v in KERNELS}
    for run in runs:
        cache = run["plan"].resident.cache
        hi, lo, vals, bases = cache.flat()
        fs = run["factors"]
        for mode, d, variant, res in run["modes"]:
            kw = dict(field_bits=cache.re_fields, field_shifts=cache.re_shifts,
                      mode=mode, out_rows=d)
            kernel = lambda: fused.fused_mttkrp_flat(hi, lo, vals, bases, fs,
                                                     resolution=res, **kw)
            if variant == "stash":
                plain = lambda: ref.fused_stash_ref(hi, lo, vals, bases, fs,
                                                    **kw)
            else:
                plain = lambda: ref.fused_segment_mttkrp_ref(
                    hi, lo, vals, bases, fs, tile=math.gcd(hi.shape[0], 256),
                    **kw)
            ms = time_ms(kernel, 20)
            plain_ms = time_ms(plain, 3)
            rel, fro, diff = check_err(
                f"{run['name']} mode {mode}: {variant} kernel", kernel(),
                plain())
            b_ms, by = bound(run["nnz"], run["dims"], mode, RANK)
            say(f"[timing] {run['name']} mode {mode} {variant}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({by}), {b_ms / ms:.3f} of the bound; max-rel {rel:.3e}, "
                f"Frobenius-rel {fro:.3e}; "
                f"library_ms null (no single PyTorch call computes a sparse "
                f"MTTKRP)")
            row = rows[variant]
            row["ms"] += ms
            row["plain_ms"] += plain_ms
            row["bound_ms"] += b_ms
            row["bytes_ms"] += b_ms if by == "bytes" else 0.0
            row["max_abs_err"] = max(row["max_abs_err"], diff)
            row["calls"] += 1
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 Gram/pinv
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    say(smi)                      # the card's name and power limit, as is
    say(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"numpy {np.__version__}, {os.cpu_count()} host CPUs, "
        f"{torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")

    build_phase()
    kernel_phase(dev)

    reset_launch_counts()
    runs = [run_tensor(name, dims, nnz, dev)
            for name, (dims, nnz) in TENSORS.items()]
    launches = dict(launch_counts)
    say(f"[main] kernel launches on the main path: {launches}")
    if not all(launches[v] > 0 for v in KERNELS):
        raise AssertionError(f"a kernel of the path never ran: {launches}")

    rows = timing_phase(runs)
    entries = []
    for variant, (name, replaces) in KERNELS.items():
        row = rows[variant]
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[variant],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": "bytes" if row["bytes_ms"] * 2 >= row["bound_ms"]
            else "operations",
            "library_ms": None})
    say(f"[timing] ms, plain_ms and bound_ms below are sums over one call "
        f"per (tensor, mode) that the kernel serves; "
        f"{ {v: rows[v]['calls'] for v in KERNELS} } calls")
    say(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
