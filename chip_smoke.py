#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

1. build: one nvcc per source, side by side, compiles the kernels from the
   checkout (build seconds and every kernel's ``-Xptxas -v`` register/spill
   report are printed);
2. kernels: K1 (segment), K2 (stash), K3 (delinearize), K4 (segments) and
   K5 (stash_phases) against their plain PyTorch versions on the card, at
   orders 3-5 and 8, a field that straddles the two index words, forced
   blocking (many launches), ragged nnz, R in {1, 8, 16, 32, 33, 40, 64},
   target modes of 1 and 2 rows (runs longer than a batch and a piece) and
   the three (values, factors) dtype pairs; K1 and K2 also over a stream
   whose length is no multiple of 32; K3 and K4's run targets must match
   exactly, K4 also at a non-power-of-two tile over a ragged stream and at
   tile 1, through both of the ways it fills its stages (bulk copies where
   every span is 16-byte aligned, cp.async where not: a stream of 63
   slots, tensors that start one slot into their storage);
3. main path: NELL-2 and Uber at their FROSTT dims and nnz (synthesised
   from a seed), rank 32, through ``plan_for(kernel="cuda")`` and five
   CP-ALS sweeps, each held against the plain ``kernel="torch"`` path on
   the card; then every mode through the three-phase pipeline
   ``cuda_mttkrp_phases`` (K3, gather, K4 + scatter or K5), held against
   the fused and the plain outputs.  The launch counters are zeroed just
   before each of the two paths and read just after it;
[stream] the out-of-memory regime: each tensor rebuilt with smaller blocks
   (NELL-2 in 5 chunks, Uber in 7), planned by ``plan_for(backend="auto")``
   under a device budget that the streamed regime fits and the in-memory
   regime does not, so it streams through a ring of pinned buffers and one
   K1/K2 launch per chunk; every mode held against the in-memory fused
   output, five CP-ALS sweeps held against the in-memory fits, and the
   streamed path's K1/K2 launches counted (zeroed just before, read just
   after) and checked against chunks x calls;
[disk] the disk tier, on [stream]'s rebuilt tensors: ``plan_for(auto)``
   under a host budget below the tensor's host bytes (and above the ring's
   host window) spills each to a ``.blco`` store under ``build/disk/`` and
   streams it from the file through the ring, one K1/K2 launch per chunk;
   every mode held against the in-memory fused output, five CP-ALS sweeps
   against the in-memory fits; then, with Uber, the degradation ladder:
   injected ``plan.alloc`` faults (one, then two) demote to the streamed
   and the disk tier, and a genuine ``torch.cuda.OutOfMemoryError`` (the
   caching allocator capped below the in-memory need) demotes to the
   streamed tier; each demoted plan computes mode 0 within tolerance.  The
   K1/K2 launches of the phase are counted and checked against chunks x
   calls;
4. timing: each kernel and mode with CUDA events, beside the plain
   version's time and the card's bound; for K1 and K2 also their launch
   geometry (waves, resident warps per SM, batch depth), the L2 bytes their
   gathers and updates move, the rate they reach and the share of the
   updates that the hottest row takes; for K4 its launch geometry (CTAs,
   stages, bytes in flight per SM, the fill) and the HBM rate its bound's
   bytes reach; K1 also on every mode of a stream
   without hot rows (NELL-2's dims and nnz drawn uniformly), held against
   its plain version; the phases path per mode, phase by phase, beside the
   fused kernel on the same mode; the streamed regime: pinned and pageable
   host-to-device GB/s, each mode's streamed time beside the host fill per
   chunk, the copy floor and K1's in-memory time, NELL-2 mode 0 at 1, 2, 4
   and 8 queues; the disk tier: each mode's disk-streamed time beside the
   host-streamed one, the read of a chunk from the store by both routes
   (the store's memmap copy into the pinned ring, ``os.preadv`` into it)
   beside the host fill, and one cold call by each route after the file's
   pages are dropped; and a
   ``torch.profiler`` split of one fused and one streamed CP-ALS sweep per
   tensor (K1/K2, the other kernels, the copies and the device's idle
   time);
5. dispatch: the card's counterpart of ``benchmarks/run.py::bench_dispatch``
   — five ``paper_like`` tensors built with 512 non-zeros per block (many
   launches), mode 0, rank 32: microseconds and dispatches per call of the
   per-launch loop, the cached plain path, ``cuda_mttkrp`` and
   ``cuda_mttkrp_phases``, each held against the cached plain output.

The last two lines are the kernel JSON line and the ``ok`` line.  Without a
CUDA device, or outside a checkout, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import shutil
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
# 32-bit integer instructions (shift, mask, add) for K3: 64 INT32 lanes per
# SM (half the 128 FP32 lanes behind the 67 TFLOP/s, which counts an FMA as
# two) x 132 SMs x 1.98 GHz boost (Hopper architecture white paper)
INT32_OPS = 64 * 132 * 1.98e9
# both max |kernel - plain| / max |plain| and ||kernel - plain||_F /
# ||plain||_F: the JAX package's tests bound f32 at 5e-4; atomics only
# reorder float additions, so f64 agrees to ~1e-15.  The Frobenius ratio
# catches lost updates that the max-based one hides under a large output
# (dropping the last update of every K1 piece gives about 1e-2 at FROSTT
# scale)
REL_TOL = {"float32": 5e-4, "float64": 1e-10}
# per-sweep CP-ALS fit, fused kernel vs plain path, both on the card in f32:
# the pseudo-inverse amplifies the reordered additions of the atomics
FIT_TOL = 1e-3
# [stream]: max_nnz_per_block of the rebuild (one launch per block, so
# NELL-2 streams in 5 chunks and Uber in 7) and the device budget, which
# lies between the streamed need (queues x reservation + factors) and the
# in-memory need, so plan_for(backend="auto") must pick the streamed regime
STREAM = {"nell-2": (1 << 24, 1.8e9), "uber": (1 << 19, 80e6)}
QUEUES = 4
QUEUE_SWEEP = (1, 2, 4, 8)
# [disk]: where the stores are written (build/ is not committed)
STORE_DIR = os.path.join(ROOT, "build", "disk")
# the ladder's tensor (the one whose in-memory need is small enough to
# cap the allocator below it)
LADDER = "uber"
# the profiler's annotation around one CP-ALS sweep
SWEEP_MARK = "cp_als_sweep"
# one NELL-2 chunk (2^24 slots x 24 B): the buffer of the H2D rate probe
H2D_PROBE_BYTES = (1 << 24) * 24
FUSED_SOURCE = "src/repro_torch/kernels/csrc/fused_mttkrp.cu"
PHASES_SOURCE = "src/repro_torch/kernels/csrc/phases.cu"
# launch-counter name -> (name in the JSON line, source, TPU kernel)
KERNELS = {
    "segment": ("K1 fused segment (segment_kernel)", FUSED_SOURCE,
                "src/repro/kernels/fused.py:82"),
    "stash": ("K2 fused stash (stash_kernel)", FUSED_SOURCE,
              "src/repro/kernels/fused.py:106"),
    "delinearize": ("K3 delinearize (delinearize_kernel)", PHASES_SOURCE,
                    "src/repro/kernels/delinearize.py:44"),
    "segments": ("K4 segments (segments_kernel)", PHASES_SOURCE,
                 "src/repro/kernels/blco_mttkrp.py:49"),
    "stash_phases": ("K5 stash (stash_phases_kernel)", PHASES_SOURCE,
                     "src/repro/kernels/blco_mttkrp.py:96"),
}
FUSED = ("segment", "stash")
PHASES = ("delinearize", "segments", "stash_phases")
# the phases path's kernel per (tensor, mode): Uber's mode 1 (24 rows) is
# the one hierarchical mode whose stash fits, so it alone takes K5
PHASES_STASH_MODES = {("uber", 1)}
# phase 5: benchmarks/run.py's SUITE and DISPATCH_BLOCK
DISPATCH_SUITE = ("uber-like", "chicago-like", "vast-like", "darpa-like",
                  "nell2-like")
DISPATCH_BLOCK = 1 << 9
# rows per slice when two large outputs are compared in float64
CHECK_ELEMENTS = 1 << 24
# (dims, nnz, target_bits, max_nnz_per_block, rank)
KERNEL_CASES = [
    ((70, 40, 30), 1777, 12, 512, RANK),             # order 3
    ((13, 7, 29, 5), 499, 8, 64, RANK),              # order 4, many launches
    ((128, 4, 256, 8, 3), 801, 16, 128, RANK),       # order 5
    ((2048, 2048, 2048), 20011, 64, 1 << 27, 40),    # straddling field, R > 32
    ((600, 90, 9), 5003, 64, 1 << 27, 8),            # long mode, narrow rank
    ((70, 40, 30), 1777, 12, 512, 1),                # R = 1
    ((1, 2, 300, 200), 3000, 64, 1 << 27, 16),       # 1- and 2-row modes
    ((600, 90, 9), 1500, 64, 1 << 27, 33),           # R = 33
    ((2, 3, 5, 4, 3, 2, 6, 7), 3000, 64, 1 << 27, 64),   # order 8, R = 64
    # 196,608 slots: thousands of pieces, one run over the stream at mode 0
    ((1, 1 << 16, 1 << 16), 1_000_000, 64, 1 << 27, RANK),
]
# slots cut off the stream's end for K1/K2's second run: no multiple of 32
RAGGED = 7


def say(*parts) -> None:
    print(*parts, flush=True)


def check_err(what, a, b) -> tuple[float, float, float]:
    """(max |a - b| / max |b|, ||a - b||_F / ||b||_F, max |a - b|), in
    float64 over slices of rows (a (T, R) output of K4 is 10.7 GB in f32 at
    NELL-2 size); raises unless both relative errors are below the tolerance
    of ``b``'s dtype."""
    if a.shape != b.shape:
        raise AssertionError(f"{what}: shapes {tuple(a.shape)} and "
                             f"{tuple(b.shape)}")
    diff = b_max = d_sq = b_sq = 0.0
    rows = max(1, CHECK_ELEMENTS // max(1, b[0].numel())) if b.dim() else 1
    for s in range(0, b.shape[0] if b.dim() else 1, rows):
        b64 = b[s:s + rows].double()
        d = a[s:s + rows].double() - b64
        diff = max(diff, float(d.abs().max()))
        b_max = max(b_max, float(b64.abs().max()))
        d_sq += float((d * d).sum())
        b_sq += float((b64 * b64).sum())
    rel = diff / max(b_max, 1e-30)
    fro = math.sqrt(d_sq) / max(math.sqrt(b_sq), 1e-30)
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
def demangle(names: list[str]) -> list[str]:
    """C++ names as the source spells them (``cu++filt`` beside ``nvcc``);
    the mangled ones where it is missing."""
    from repro_torch.kernels.build import nvcc_path
    tool = os.path.join(os.path.dirname(nvcc_path()), "cu++filt")
    if not names or not os.path.isfile(tool):
        return names
    proc = subprocess.run([tool], input="\n".join(names), capture_output=True,
                          text=True)
    out = proc.stdout.splitlines()
    return out if proc.returncode == 0 and len(out) == len(names) else names


def build_phase() -> None:
    from repro_torch.kernels.build import load_libraries
    for name, kl in load_libraries().items():
        say(f"[build] {'built' if kl.built else 'loaded'} {kl.path.name} "
            f"(all libraries in {kl.seconds:.2f} s)")
        lines = kl.log.splitlines()
        entries = demangle([line.split(chr(39))[1] for line in lines
                            if "Compiling entry function" in line])
        for line in lines:
            if "Compiling entry function" in line:
                say(f"[build] {name}: {entries.pop(0)}")
            elif "registers" in line or "spill" in line:
                say(f"[build] {name}:   {line.strip()}")


# --------------------------------------------------------------- phase 2
def plain_fused(variant, hi, lo, vals, bases, fs, **kw):
    """The plain version of K1 or K2 on the same inputs."""
    from repro_torch.kernels import ref
    if variant == "stash":
        return ref.fused_stash_ref(hi, lo, vals, bases, fs, **kw)
    return ref.fused_segment_mttkrp_ref(hi, lo, vals, bases, fs,
                                        tile=math.gcd(hi.shape[0], 256), **kw)


def kernel_phase(dev) -> None:
    """Every kernel against its plain version on small cases."""
    import torch
    from repro_torch.core import build_blco, choose_resolution, random_tensor
    from repro_torch.core.launches import LaunchCache
    from repro_torch.kernels import fused

    worst: dict = {}
    pairs = [(torch.float32, torch.float32), (torch.float64, torch.float64),
             (torch.float64, torch.float32)]
    for dims, nnz, tb, mx, rank in KERNEL_CASES:
        t = random_tensor(dims, nnz, seed=7, dist="powerlaw")
        b = build_blco(t, target_bits=tb, max_nnz_per_block=mx)
        flat = LaunchCache.from_blco(b, device=dev).flat()
        rng = np.random.default_rng(SEED)
        host = [rng.standard_normal((d, rank)) for d in dims]
        for vdt, fdt in pairs:
            fs = [torch.as_tensor(h).to(device=dev, dtype=fdt) for h in host]
            for cut, mode, res in itertools.product(
                    (0, RAGGED), range(len(dims)), ("register",
                                                    "hierarchical")):
                hi, lo, v, bases = (x[:x.shape[0] - cut] for x in flat)
                v = v.to(vdt)
                kw = dict(field_bits=b.re.field_bits,
                          field_shifts=b.re.field_shift, mode=mode,
                          out_rows=dims[mode])
                out = fused.fused_mttkrp_flat(hi, lo, v, bases, fs,
                                              resolution=res, **kw)
                variant = fused._variant_for(res, dims[mode], rank=rank,
                                             itemsize=out.element_size())
                plain = plain_fused(variant, hi, lo, v, bases, fs, **kw)
                torch.cuda.synchronize()
                if out.shape != (dims[mode], rank) or out.dtype != \
                        torch.promote_types(vdt, fdt):
                    raise AssertionError(f"bad output {out.shape} "
                                         f"{out.dtype}")
                rel, fro, _ = check_err(
                    f"{variant} kernel vs its plain version: dims {dims} "
                    f"mode {mode} {vdt}x{fdt}, T {hi.shape[0]}", out, plain)
                key = (variant, str(out.dtype).replace("torch.", ""))
                worst[key] = max(worst.get(key, 0.0), rel, fro)
                geo = fused.kernel_geometry(variant, vdt, fdt, len(dims),
                                            dims[mode], rank, hi.shape[0],
                                            dev)
                if geo.waves != 1:
                    raise AssertionError(f"{variant} launched in "
                                         f"{geo.waves} waves: {geo}")
        geo = fused.kernel_geometry("segment", torch.float32, torch.float32,
                                    len(dims), dims[0], rank,
                                    flat[0].shape[0], dev)
        say(f"[kernels] dims {dims} nnz {b.nnz} T {flat[0].shape[0]} (and "
            f"T - {RAGGED}) fields {b.re.field_bits} shifts "
            f"{b.re.field_shift} launches {len(b.launches)} R {rank}: ok "
            f"(resolution {[choose_resolution(d) for d in dims]}; f32 K1 "
            f"{geo.blocks} CTAs, pieces of {geo.chunk}, batch {geo.batch})")
    for (variant, dname), rel in sorted(worst.items()):
        say(f"[kernels] worst rel err (max-rel or Frobenius-rel) {variant} "
            f"{dname}: {rel:.3e}")
    if {v for v, _ in worst} != set(FUSED):
        raise AssertionError("the kernel phase did not reach both kernels")


def phase_kernels_phase(dev) -> None:
    """K3, K4 and K5 against their plain versions on small cases."""
    import torch
    from repro_torch.core import build_blco, random_tensor
    from repro_torch.core.launches import LaunchCache
    from repro_torch.kernels import (STASH_MAX_BYTES, blco_mttkrp,
                                     delinearize, mttkrp_segments,
                                     mttkrp_stash, ref)

    worst: dict = {}
    fills = dict(blco_mttkrp.segments_fills)
    pairs = [(torch.float32, torch.float32), (torch.float64, torch.float64),
             (torch.float64, torch.float32)]
    for dims, nnz, tb, mx, rank in KERNEL_CASES:
        t = random_tensor(dims, nnz, seed=7, dist="powerlaw")
        b = build_blco(t, target_bits=tb, max_nnz_per_block=mx)
        hi, lo, vals, bases = LaunchCache.from_blco(b, device=dev).flat()
        kw = dict(field_bits=b.re.field_bits, field_shifts=b.re.field_shift)
        coords = delinearize(hi, lo, bases, **kw)
        cut = hi.shape[0] - 160          # a ragged stream decodes alike
        if not (torch.equal(coords, ref.delinearize_ref(hi, lo, bases, **kw))
                and torch.equal(delinearize(hi[:cut], lo[:cut], bases[:cut],
                                            **kw), coords[:cut])):
            raise AssertionError(f"K3 differs from its plain version: dims "
                                 f"{dims}")
        worst[("delinearize", "int32")] = 0.0
        t_all = hi.shape[0]
        ragged = (t_all // 96) * 96 - 96     # gcd(ragged, 256) < 256
        rng = np.random.default_rng(SEED)
        host = [rng.standard_normal((d, rank)) for d in dims]
        for vdt, fdt in pairs:
            v = vals.to(vdt)
            fs = [torch.as_tensor(h).to(device=dev, dtype=fdt) for h in host]
            for mode, d in enumerate(dims):
                g = tuple(fs[m].index_select(0, coords[:, m])
                          for m in range(len(dims)) if m != mode)
                tgt = coords[:, mode].contiguous()
                what = f"dims {dims} mode {mode} {vdt}x{fdt}"
                # (tile, first slot, end): the last two take the cp.async
                # fill (63 slots; tensors one slot into their storage)
                for tile, lo, n in ((math.gcd(t_all, 256), 0, t_all),
                                    (96, 0, ragged), (1, 0, 64), (1, 0, 63),
                                    (96, 1, ragged + 1)):
                    args = (v[lo:n], tgt[lo:n], tuple(x[lo:n] for x in g))
                    seg_tgt, seg_sums = mttkrp_segments(*args, tile=tile)
                    want_tgt, want_sums = ref.mttkrp_segments_ref(*args,
                                                                  tile=tile)
                    torch.cuda.synchronize()
                    if not torch.equal(seg_tgt, want_tgt):
                        raise AssertionError(f"K4 seg_tgt differs from its "
                                             f"plain version: {what} tile "
                                             f"{tile}")
                    rel, fro, _ = check_err(f"K4 {what} tile {tile}",
                                            seg_sums, want_sums)
                    key = ("segments", str(seg_sums.dtype)[6:])
                    worst[key] = max(worst.get(key, 0.0), rel, fro)
                out_dtype = torch.promote_types(vdt, fdt)
                if d * rank * out_dtype.itemsize <= STASH_MAX_BYTES:
                    out = mttkrp_stash(v, tgt, g, out_rows=d)
                    want = ref.mttkrp_stash_ref(v, tgt, g, out_rows=d)
                    torch.cuda.synchronize()
                    rel, fro, _ = check_err(f"K5 {what}", out, want)
                    key = ("stash_phases", str(out.dtype)[6:])
                    worst[key] = max(worst.get(key, 0.0), rel, fro)
        say(f"[kernels] K3/K4/K5 dims {dims} nnz {b.nnz} T {t_all} R {rank}: "
            f"ok (K4 tiles {math.gcd(t_all, 256)}, 96 over {ragged} slots "
            f"from slot 0 and from slot 1, 1 over 64 and over 63)")
    for (kernel, dname), rel in sorted(worst.items()):
        say(f"[kernels] worst rel err (max-rel or Frobenius-rel) {kernel} "
            f"{dname}: {rel:.3e}" + (" (exact)" if kernel == "delinearize"
                                     else ""))
    if {k for k, _ in worst} != set(PHASES):
        raise AssertionError("the kernel phase did not reach K3, K4 and K5")
    ran = {f: blco_mttkrp.segments_fills[f] - fills[f]
           for f in blco_mttkrp.FILLS}
    say(f"[kernels] K4 launches by fill: {ran}")
    if not all(ran.values()):
        raise AssertionError(f"a fill of K4 never ran: {ran}")


# --------------------------------------------------------------- phase 3
def stream_targets(cache, mode):
    """Every slot's target index in the padded stream's (ALTO) order."""
    from repro_torch.core import u64
    hi, lo, _, bases = cache.flat()
    return u64.extract_field(hi, lo, cache.re_shifts[mode],
                             cache.re_fields[mode]) + bases[:, mode]


def mean_run_length(cache, mode) -> float:
    """Non-zeros per run of equal target index in the stream's (ALTO)
    order: K1 issues one update per column per run."""
    tgt = stream_targets(cache, mode)
    tgt = tgt[cache.flat()[2] != 0]       # padding slots hold the value 0
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
    t0 = time.perf_counter()
    bs = build_blco(t, max_nnz_per_block=STREAM[name][0])
    say(f"[stream] {name}: build_blco(max_nnz_per_block="
        f"{STREAM[name][0]}) {time.perf_counter() - t0:.1f} s, launches "
        f"{[l.nnz for l in bs.launches]}")
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
    outs = []
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
        outs.append((out, want))

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
    return {"name": name, "plan": plan, "blco": b, "dims": dims,
            "nnz": b.nnz, "modes": modes, "outs": outs, "factors": factors,
            "stream_blco": bs, "norm_x": norm_x, "fits": fits["cuda"]}


def phases_path(run) -> None:
    """Every mode of one tensor through the three-phase pipeline, held
    against the fused and the plain outputs of the same mode; the launch
    counters show which compute kernel each mode took."""
    import torch
    from repro_torch.kernels import cuda_mttkrp_phases, launch_counts
    cache = run["plan"].resident.cache
    torch.cuda.reset_peak_memory_stats()
    for (mode, d, _, res), (fused_out, plain_out) in zip(run["modes"],
                                                          run["outs"]):
        before = dict(launch_counts)
        t0 = time.perf_counter()
        out = cuda_mttkrp_phases(run["blco"], run["factors"], mode,
                                 cache=cache)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        took = {k: launch_counts[k] - before[k] for k in KERNELS}
        stash = (run["name"], mode) in PHASES_STASH_MODES
        want = {"segment": 0, "stash": 0, "delinearize": 1,
                "segments": 0 if stash else 1, "stash_phases": int(stash)}
        if took != want:
            raise AssertionError(f"{run['name']} mode {mode}: the phases "
                                 f"path launched {took}, expected {want}")
        if out.shape != (d, RANK) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{run['name']} mode {mode}: bad phases "
                                 f"output")
        rel_f, fro_f, _ = check_err(f"{run['name']} mode {mode}: phases vs "
                                    f"fused", out, fused_out)
        rel_p, fro_p, _ = check_err(f"{run['name']} mode {mode}: phases vs "
                                    f"plain", out, plain_out)
        say(f"[phases] {run['name']} mode {mode} (I={d}, {res}) -> K3 + "
            f"gather + {'K5' if stash else 'K4 + scatter'} in {secs:.3f} s "
            f"(first call): vs fused max-rel {rel_f:.3e}, Frobenius-rel "
            f"{fro_f:.3e}; vs kernel='torch' max-rel {rel_p:.3e}, "
            f"Frobenius-rel {fro_p:.3e}")
    say(f"[phases] {run['name']}: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB (cache "
        f"{cache.device_bytes() / 1e9:.3f} GB)")


# -------------------------------------------------------------- [stream]
def stream_path(run, dev) -> dict:
    """One tensor's streamed regime, rebuilt with smaller blocks: picked by
    ``plan_for(backend="auto")`` under a budget the in-memory regime does
    not fit, every mode held against the in-memory fused output, and
    ``SWEEPS`` CP-ALS sweeps held against the in-memory fits.  Returns the
    K1/K2 launches the path should have made, per variant."""
    import torch
    from repro_torch.core import cp_als_init, cp_als_step
    from repro_torch.engine import factor_bytes, in_memory_bytes, plan_for
    name, dims, fs = run["name"], run["dims"], run["factors"]
    bs = run["stream_blco"]
    budget = STREAM[name][1]
    plan = plan_for(bs, budget, rank=RANK, backend="auto", queues=QUEUES,
                    kernel="cuda", device=dev)
    if plan.backend != "streamed":
        raise AssertionError(f"{name}: plan_for picked {plan.backend} under "
                             f"a budget of {budget:.0f} B")
    run["stream_plan"] = plan
    chunks = len(bs.launches)
    spec = plan.spec
    working = factor_bytes(dims, RANK, torch.float32)
    say(f"[stream] {name}: plan_for(auto, budget {budget:.0f} B) -> "
        f"{plan.backend}; {chunks} launches {[l.nnz for l in bs.launches]}, "
        f"reservation {spec.nnz}, {spec.bytes_per_launch} B per launch, "
        f"H2D per mode {chunks * spec.bytes_per_launch / 1e9:.4f} GB, in "
        f"flight at queues={QUEUES} {plan.device_bytes() / 1e9:.4f} GB "
        f"(+ factors {working / 1e6:.2f} MB = "
        f"{(plan.device_bytes() + working) / 1e9:.4f} GB), in memory "
        f"{in_memory_bytes(bs) / 1e9:.4f} GB (+ factors = "
        f"{(in_memory_bytes(bs) + working) / 1e9:.4f} GB), host window "
        f"{plan.host_window_bytes() / 1e9:.4f} GB")
    calls = {v: 0 for v in FUSED}
    for (mode, d, variant, _), (fused_out, _) in zip(run["modes"],
                                                     run["outs"]):
        t0 = time.perf_counter()
        out = plan.mttkrp(fs, mode)
        secs = time.perf_counter() - t0
        calls[variant] += 1 + SWEEPS
        if out.shape != (d, RANK) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name} mode {mode}: bad streamed output")
        rel, fro, diff = check_err(f"{name} mode {mode}: streamed vs "
                                   f"in-memory fused", out, fused_out)
        say(f"[stream] {name} mode {mode} -> {variant} x {chunks} chunks in "
            f"{secs:.3f} s (first call): vs in-memory fused max-rel "
            f"{rel:.3e}, Frobenius-rel {fro:.3e} (max abs {diff:.3e})")
    state = cp_als_init(dims, RANK, norm_x=run["norm_x"], tol=0.0, seed=SEED,
                        device=dev)
    for sweep in range(SWEEPS):
        t0 = time.perf_counter()
        cp_als_step(plan, state)
        torch.cuda.synchronize()
        say(f"[stream] {name} cp_als streamed sweep {sweep}: "
            f"{time.perf_counter() - t0:.4f} s, fit {state.fits[-1]:.6f}")
    diffs = [abs(a - c) for a, c in zip(state.fits, run["fits"])]
    if not all(math.isfinite(f) for f in state.fits) or max(diffs) > FIT_TOL:
        raise AssertionError(f"{name}: streamed fits {state.fits} disagree "
                             f"with in-memory fits {run['fits']}")
    say(f"[stream] {name}: streamed fits {state.fits} (max diff from the "
        f"in-memory fits {max(diffs):.2e})")
    say(f"[stream] {name}: EngineStats {json.dumps(plan.stats().snapshot())}")
    return {v: chunks * c for v, c in calls.items()}


# ---------------------------------------------------------------- [disk]
def disk_path(run, dev) -> dict:
    """One tensor's disk tier on [stream]'s rebuilt BLCO: ``plan_for(auto)``
    under a host budget below the tensor's host bytes spills it to a store
    and streams it from the file; every mode held against the in-memory
    fused output and ``SWEEPS`` CP-ALS sweeps against the in-memory fits.
    Returns the K1/K2 launches the path should have made, per variant."""
    import torch
    from repro_torch.core import cp_als_init, cp_als_step, format_bytes
    from repro_torch.core.streaming import reservation_for
    from repro_torch.engine import plan_for
    name, dims, fs = run["name"], run["dims"], run["factors"]
    bs = run["stream_blco"]
    os.makedirs(STORE_DIR, exist_ok=True)
    usage = shutil.disk_usage(STORE_DIR)
    window = QUEUES * reservation_for(bs).bytes_per_launch
    host_budget = (format_bytes(bs) + window) // 2
    path = os.path.join(STORE_DIR, f"{name}.blco")
    say(f"[disk] {name}: {STORE_DIR} has {usage.free / 1e9:.1f} GB free of "
        f"{usage.total / 1e9:.1f} GB; host budget {host_budget} B (tensor "
        f"{format_bytes(bs)} B, ring's host window {window} B)")
    t0 = time.perf_counter()
    plan = plan_for(bs, STREAM[name][1], rank=RANK, backend="auto",
                    queues=QUEUES, kernel="cuda", device=dev,
                    host_budget_bytes=host_budget, store_path=path)
    spill_s = time.perf_counter() - t0
    if plan.backend != "disk_streamed":
        raise AssertionError(f"{name}: plan_for picked {plan.backend} under "
                             f"a host budget of {host_budget} B")
    t0 = time.perf_counter()
    plan.stored.verify()
    verify_s = time.perf_counter() - t0
    run["disk_plan"] = plan
    chunks = plan.stored.num_launches
    say(f"[disk] {name}: plan_for(auto, host budget) -> {plan.backend} in "
        f"{spill_s:.2f} s (save_blco of {plan.disk_bytes()} B, open, ring); "
        f"verify() {verify_s:.2f} s; {chunks} chunks of "
        f"{plan.spec.bytes_per_launch} B, host window "
        f"{plan.host_window_bytes()} B, device bytes {plan.device_bytes()} B")
    calls = {v: 0 for v in FUSED}
    for (mode, d, variant, _), (fused_out, _) in zip(run["modes"],
                                                     run["outs"]):
        t0 = time.perf_counter()
        out = plan.mttkrp(fs, mode)
        secs = time.perf_counter() - t0
        calls[variant] += 1 + SWEEPS
        if out.shape != (d, RANK) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name} mode {mode}: bad disk output")
        rel, fro, diff = check_err(f"{name} mode {mode}: disk-streamed vs "
                                   f"in-memory fused", out, fused_out)
        say(f"[disk] {name} mode {mode} -> {variant} x {chunks} chunks in "
            f"{secs:.3f} s (first call): vs in-memory fused max-rel "
            f"{rel:.3e}, Frobenius-rel {fro:.3e} (max abs {diff:.3e})")
    state = cp_als_init(dims, RANK, norm_x=run["norm_x"], tol=0.0, seed=SEED,
                        device=dev)
    for sweep in range(SWEEPS):
        t0 = time.perf_counter()
        cp_als_step(plan, state)
        torch.cuda.synchronize()
        say(f"[disk] {name} cp_als disk-streamed sweep {sweep}: "
            f"{time.perf_counter() - t0:.4f} s, fit {state.fits[-1]:.6f}")
    diffs = [abs(a - c) for a, c in zip(state.fits, run["fits"])]
    if not all(math.isfinite(f) for f in state.fits) or max(diffs) > FIT_TOL:
        raise AssertionError(f"{name}: disk-streamed fits {state.fits} "
                             f"disagree with in-memory fits {run['fits']}")
    say(f"[disk] {name}: disk-streamed fits {state.fits} (max diff from the "
        f"in-memory fits {max(diffs):.2e})")
    say(f"[disk] {name}: EngineStats {json.dumps(plan.stats().snapshot())}")
    return {v: chunks * c for v, c in calls.items()}


def ladder_path(run, dev) -> dict:
    """plan_for(auto)'s degradation ladder on the card: injected plan.alloc
    faults at the first, then the first two allocations give the streamed
    and the disk tier; a genuine OutOfMemoryError from the in-memory upload
    (the caching allocator capped between the streamed and the in-memory
    need) gives the streamed tier.  Each demoted plan computes mode 0,
    held against the in-memory fused output.  Returns the K1/K2 launches
    the ladder's plans should have made."""
    import torch
    from repro_torch.core.streaming import reservation_for
    from repro_torch.engine import in_memory_bytes, plan_for
    from repro_torch.faults import FaultPlan, FaultRule, inject
    name, fs, bs = run["name"], run["factors"], run["stream_blco"]
    want_out = run["outs"][0][0]
    variant = run["modes"][0][2]
    path = os.path.join(STORE_DIR, f"{name}-ladder.blco")
    kw = dict(rank=RANK, backend="auto", queues=QUEUES, kernel="cuda",
              device=dev, store_path=path)

    def check(plan, tier, demotions, what):
        if plan.backend != tier or plan.stats().demotions != demotions:
            raise AssertionError(f"{name} ladder, {what}: {plan.backend} "
                                 f"after {plan.stats().demotions} demotions, "
                                 f"expected {tier} after {demotions}")
        rel, fro, _ = check_err(f"{name} ladder, {what}: mode 0",
                                plan.mttkrp(fs, 0), want_out)
        plan.close()
        say(f"[disk] {name} ladder, {what}: -> {tier}, demotions "
            f"{demotions}; mode 0 vs in-memory fused max-rel {rel:.3e}, "
            f"Frobenius-rel {fro:.3e}")

    for nths, tier in (((1,), "streamed"), ((1, 2), "disk_streamed")):
        rules = tuple(FaultRule("plan.alloc", nth=n) for n in nths)
        with inject.active(FaultPlan(seed=SEED, rules=rules)):
            plan = plan_for(bs, torch.cuda.mem_get_info()[0], **kw)
        check(plan, tier, len(nths), f"injected plan.alloc at allocations "
              f"{list(nths)}")
    os.unlink(path)
    in_need = in_memory_bytes(bs)
    st_need = reservation_for(bs).bytes_in_flight(QUEUES)
    total = torch.cuda.get_device_properties(dev).total_memory
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    cap = reserved + (in_need + st_need) // 2
    say(f"[disk] {name} ladder: allocated {torch.cuda.memory_allocated(dev)} "
        f"B, reserved {reserved} B; in-memory need {in_need} B, streamed "
        f"need {st_need} B; allocator capped at {cap} B "
        f"({cap / total:.6f} of {total} B)")
    torch.cuda.set_per_process_memory_fraction(cap / total, dev)
    try:
        plan = plan_for(bs, torch.cuda.mem_get_info()[0], **kw)
        check(plan, "streamed", 1, "a real OutOfMemoryError at the "
              "in-memory upload")
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        torch.cuda.empty_cache()
    chunks = len(bs.launches)
    return {v: 3 * chunks * (v == variant) for v in FUSED}


# --------------------------------------------------------------- phase 4
def roof(nbytes, ops, ops_per_s) -> tuple[float, str]:
    """max(bytes / HBM rate, ops / peak rate) in ms, and which bounds."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bound(nnz, dims, mode, rank) -> tuple[float, str]:
    """Least milliseconds for one f32 fused call (each input read once, the
    output written once; nnz * R * N operations) and what bounds it."""
    item = 4
    n = len(dims)
    stream = nnz * (4 + 4 + item + 4 * n)
    facs = sum(d * rank * item for m, d in enumerate(dims) if m != mode)
    out = dims[mode] * rank * item
    return roof(stream + facs + out, nnz * rank * n, F32_FLOPS)


def phase_bound(kernel, t, dims, mode, rank) -> tuple[float, str]:
    """Least milliseconds for one f32 call of K3, K4 or K5 over the padded
    stream of ``t`` slots, which is what these kernels read and write.

    K3 reads hi + lo + N bases and writes N coordinates (4 B each) per slot,
    three integer operations (shift, mask, add) per field.  K4 and K5 read
    the value, the target and N-1 gathered rows of R values per slot and do
    N*R operations (N-1 multiplies and an add per column); K4 writes seg_tgt
    and a (T, R) seg_sums, K5 the (I_mode, R) output."""
    item = 4
    n = len(dims)
    if kernel == "delinearize":
        return roof(t * (8 + 4 * n) + t * 4 * n, 3 * t * n, INT32_OPS)
    reads = t * (item + 4) + (n - 1) * t * rank * item
    writes = t * (4 + rank * item) if kernel == "segments" \
        else dims[mode] * rank * item
    return roof(reads + writes, t * rank * n, F32_FLOPS)


def add_row(rows, kernel, ms, plain_ms, bound_ms, by, diff) -> None:
    row = rows[kernel]
    row["ms"] += ms
    row["plain_ms"] += plain_ms
    row["bound_ms"] += bound_ms
    row["bytes_ms"] += bound_ms if by == "bytes" else 0.0
    row["max_abs_err"] = max(row["max_abs_err"], diff)
    row["calls"] += 1


def update_count(cache, mode, chunk) -> tuple[int, int]:
    """Updates of one K1/K2 call, one per run of equal target in each piece
    of the padded stream (padding slots included, as the kernel walks
    them), and how many of them the hottest row takes."""
    import torch
    tgt = stream_targets(cache, mode)
    starts = torch.ones_like(tgt, dtype=torch.bool)
    starts[1:] = tgt[1:] != tgt[:-1]
    starts[::chunk] = True
    return (int(starts.sum()),
            int(torch.bincount(tgt[starts].long()).max()))


def geometry_line(name, cache, dims, mode, variant, ms) -> str:
    """K1/K2's launch geometry, the L2 bytes its gathers and updates move
    (for K1 an upper bound: runs whose target holds a slot of the CTA's
    table are summed in shared memory), the rate they reach in ``ms`` and
    the hottest row's share of the updates."""
    import torch
    from repro_torch.kernels import fused
    t = cache.flat()[0].shape[0]
    n = len(dims)
    d = dims[mode]
    geo = fused.kernel_geometry(variant, torch.float32, torch.float32, n, d,
                                RANK, t, cache.device)
    if geo.waves != 1:
        raise AssertionError(f"{name} mode {mode}: {variant} takes "
                             f"{geo.waves} waves: {geo}")
    row = RANK * 4
    most = "at most " if variant == "segment" else ""
    gathers = t * (n - 1) * row
    updates, hottest = update_count(cache, mode, geo.chunk)
    if variant == "stash":       # runs go to shared memory; the merge to L2
        l2 = gathers + geo.blocks * d * row
        upd = (f"{updates} shared-memory updates, merge <= {geo.blocks} x "
               f"{d} rows ({row} B each)")
    else:           # a run whose target holds a slot of the CTA's table
        l2 = gathers + updates * row        # goes to shared memory: at most
        upd = f"<= {updates} updates ({row} B each)"
    return (f"[geometry] {name} mode {mode} {variant}: {geo.waves} wave, "
            f"{geo.blocks} CTAs x {geo.threads} threads, "
            f"{geo.warps_per_sm} resident warps per SM ({geo.blocks_per_sm} "
            f"CTAs), batch depth B {geo.batch}, {cdiv(t, geo.chunk)} pieces "
            f"of {geo.chunk} slots; L2 bytes per call: gathers "
            f"{gathers / 1e9:.4f} GB + {upd} = {most}{l2 / 1e9:.4f} GB, "
            f"{most}{l2 / ms / 1e9:.3f} TB/s; the hottest row takes "
            f"{hottest} updates ({hottest / updates:.4f} of them)")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def timing_phase(runs) -> dict:
    from repro_torch.kernels import fused
    rows = {v: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
                "max_abs_err": 0.0, "calls": 0} for v in KERNELS}
    for run in runs:
        cache = run["plan"].resident.cache
        hi, lo, vals, bases = cache.flat()
        fs = run["factors"]
        run["fused_ms"] = {}
        for mode, d, variant, res in run["modes"]:
            kw = dict(field_bits=cache.re_fields, field_shifts=cache.re_shifts,
                      mode=mode, out_rows=d)
            kernel = lambda: fused.fused_mttkrp_flat(hi, lo, vals, bases, fs,
                                                     resolution=res, **kw)
            plain = lambda: plain_fused(variant, hi, lo, vals, bases, fs,
                                        **kw)
            ms = time_ms(kernel, 20)
            plain_ms = time_ms(plain, 3)
            rel, fro, diff = check_err(
                f"{run['name']} mode {mode}: {variant} kernel", kernel(),
                plain())
            b_ms, by = bound(run["nnz"], run["dims"], mode, RANK)
            say(geometry_line(run["name"], cache, run["dims"], mode, variant,
                              ms))
            say(f"[timing] {run['name']} mode {mode} {variant}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({by}), {b_ms / ms:.3f} of the bound; max-rel {rel:.3e}, "
                f"Frobenius-rel {fro:.3e}; "
                f"library_ms null (no single PyTorch call computes a sparse "
                f"MTTKRP)")
            add_row(rows, variant, ms, plain_ms, b_ms, by, diff)
            run["fused_ms"][mode] = ms
    return rows


def uniform_timing(dev) -> None:
    """K1 on every mode of a stream without hot rows: NELL-2's dims and nnz,
    every coordinate drawn uniformly (the main path's tensors have a
    powerlaw head, whose hottest rows K1's per-CTA table takes off L2)."""
    import torch
    from repro_torch.core import (SparseTensor, build_blco, choose_resolution,
                                  init_factors, top_up_uniform)
    from repro_torch.core.launches import LaunchCache
    from repro_torch.kernels import fused
    name = "nell-2-uniform"
    dims, nnz = TENSORS["nell-2"]
    t0 = time.perf_counter()
    empty = SparseTensor(dims, np.zeros((0, len(dims)), np.int64),
                         np.zeros(0, np.float32))
    b = build_blco(top_up_uniform(empty, nnz, seed=SEED))
    cache = LaunchCache.from_blco(b, device=dev)
    hi, lo, vals, bases = cache.flat()
    fs = init_factors(dims, RANK, seed=SEED, device=dev)
    say(f"[uniform] {name}: dims {dims} nnz {b.nnz}, T {hi.shape[0]}, "
        f"host generation + build_blco + upload "
        f"{time.perf_counter() - t0:.1f} s")
    for mode, d in enumerate(dims):
        variant = fused._variant_for(choose_resolution(d), d, rank=RANK,
                                     itemsize=4)
        kw = dict(field_bits=cache.re_fields, field_shifts=cache.re_shifts,
                  mode=mode, out_rows=d)
        kernel = lambda: fused.fused_mttkrp_flat(hi, lo, vals, bases, fs,
                                                 **kw)
        ms = time_ms(kernel, 20)
        rel, fro, _ = check_err(f"{name} mode {mode}: {variant} kernel",
                                kernel(), plain_fused(variant, hi, lo, vals,
                                                      bases, fs, **kw))
        say(geometry_line(name, cache, dims, mode, variant, ms))
        say(f"[uniform] {name} mode {mode} {variant}: kernel {ms:.4f} ms; "
            f"max-rel {rel:.3e}, Frobenius-rel {fro:.3e}; mean run of equal "
            f"target {mean_run_length(cache, mode):.4f} non-zeros")
    del hi, lo, vals, bases
    cache.delete()
    torch.cuda.empty_cache()


def phases_timing(runs, rows) -> None:
    """K3, K4 and K5 on every mode beside their plain versions and bounds,
    and the whole phases path phase by phase beside the fused kernel."""
    import torch
    from repro_torch.kernels import (blco_mttkrp, cuda_mttkrp_phases,
                                     delinearize, mttkrp_segments,
                                     mttkrp_stash, ref)
    for run in runs:
        cache = run["plan"].resident.cache
        hi, lo, vals, bases = cache.flat()
        t = hi.shape[0]
        tile = math.gcd(t, 256)
        dims, fs, name = run["dims"], run["factors"], run["name"]
        n = len(dims)
        kw = dict(field_bits=cache.re_fields, field_shifts=cache.re_shifts)
        for mode, d, _, _ in run["modes"]:
            path_ms = time_ms(lambda: cuda_mttkrp_phases(
                run["blco"], fs, mode, cache=cache), 20)
            torch.cuda.empty_cache()

            k3_ms = time_ms(lambda: delinearize(hi, lo, bases, **kw), 20)
            k3_plain_ms = time_ms(lambda: ref.delinearize_ref(hi, lo, bases,
                                                              **kw), 3)
            coords = delinearize(hi, lo, bases, **kw)
            if not torch.equal(coords, ref.delinearize_ref(hi, lo, bases,
                                                           **kw)):
                raise AssertionError(f"{name}: K3 differs from its plain "
                                     f"version")
            b_ms, by = phase_bound("delinearize", t, dims, mode, RANK)
            add_row(rows, "delinearize", k3_ms, k3_plain_ms, b_ms, by, 0.0)
            say(f"[timing] {name} mode {mode} delinearize: kernel "
                f"{k3_ms:.4f} ms, plain {k3_plain_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({by}), {b_ms / k3_ms:.3f} of the bound; "
                f"exact; library_ms null (no PyTorch call extracts bit "
                f"fields)")

            def gather():
                return tuple(fs[m].index_select(0, coords[:, m])
                             for m in range(n) if m != mode)
            gather_ms = time_ms(gather, 20)
            g = gather()
            tgt = coords[:, mode].contiguous()
            del coords
            kernel = "stash_phases" if (name, mode) in PHASES_STASH_MODES \
                else "segments"
            if kernel == "stash_phases":
                ms = time_ms(lambda: mttkrp_stash(vals, tgt, g, out_rows=d),
                             20)
                plain_ms = time_ms(lambda: ref.mttkrp_stash_ref(
                    vals, tgt, g, out_rows=d), 3)
                rel, fro, diff = check_err(
                    f"{name} mode {mode}: K5", mttkrp_stash(
                        vals, tgt, g, out_rows=d),
                    ref.mttkrp_stash_ref(vals, tgt, g, out_rows=d))
                scatter_ms = 0.0
                lib_note = ("no single PyTorch call multiplies the gathered "
                            "rows and scatter-adds them")
            else:
                ms = time_ms(lambda: mttkrp_segments(vals, tgt, g,
                                                     tile=tile), 20)
                plain_ms = time_ms(lambda: ref.mttkrp_segments_ref(
                    vals, tgt, g, tile=tile), 3)
                seg_tgt, seg_sums = mttkrp_segments(vals, tgt, g, tile=tile)
                want_tgt, want_sums = ref.mttkrp_segments_ref(vals, tgt, g,
                                                              tile=tile)
                if not torch.equal(seg_tgt, want_tgt):
                    raise AssertionError(f"{name} mode {mode}: K4 seg_tgt "
                                         f"differs from its plain version")
                rel, fro, diff = check_err(f"{name} mode {mode}: K4",
                                           seg_sums, want_sums)
                geo = blco_mttkrp.segments_geometry(vals, tgt, g, tile=tile)
                lay = geo.layout
                if geo.waves != 1:
                    raise AssertionError(f"{name} mode {mode}: K4 takes "
                                         f"{geo.waves} waves: {geo}")
                del want_tgt, want_sums, g
                scatter_ms = time_ms(lambda: ref.scatter_segments_ref(
                    seg_tgt, seg_sums, d), 20)
                del seg_tgt, seg_sums
                lib_note = "no PyTorch call finds per-tile runs"
            b_ms, by = phase_bound(kernel, t, dims, mode, RANK)
            add_row(rows, kernel, ms, plain_ms, b_ms, by, diff)
            if kernel == "segments":
                # by == "bytes": the bound's bytes over the kernel's time
                say(f"[geometry] {name} mode {mode} segments: 1 wave, "
                    f"{geo.blocks} CTAs x {blco_mttkrp.K4_WARPS} warps, "
                    f"{geo.blocks_per_sm} resident CTAs per SM, "
                    f"{lay.stages} stages per warp of "
                    f"{lay.rows} rows ({lay.stage_bytes} B), "
                    f"{lay.tasks} tasks of {lay.pieces_per_task} pieces, "
                    f"{geo.bytes_in_flight_per_sm / 1e3:.1f} KB in flight "
                    f"per SM, fill {lay.fill}; the bound's bytes at "
                    f"{b_ms / ms * HBM_BYTES_PER_S / 1e12:.3f} TB/s")
            say(f"[timing] {name} mode {mode} {kernel}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), "
                f"{b_ms / ms:.3f} of the bound; max-rel {rel:.3e}, "
                f"Frobenius-rel {fro:.3e}; library_ms null ({lib_note})")
            parts = k3_ms + gather_ms + ms + scatter_ms
            fused_ms = run["fused_ms"][mode]
            say(f"[timing] {name} mode {mode} phases path: {path_ms:.4f} ms "
                f"per call (K3 {k3_ms:.4f} + gather {gather_ms:.4f} + "
                f"{kernel} {ms:.4f} + scatter {scatter_ms:.4f} = "
                f"{parts:.4f} ms timed apart; T = {t} padded slots) vs the "
                f"fused kernel {fused_ms:.4f} ms: phases / fused = "
                f"{path_ms / fused_ms:.3f}")
            torch.cuda.empty_cache()


def h2d_rates(dev) -> dict:
    """Pinned and pageable host-to-device GB/s: one copy of
    ``H2D_PROBE_BYTES`` timed by CUDA events, median of 10 after 2."""
    import statistics

    import torch
    dst = torch.empty(H2D_PROBE_BYTES, dtype=torch.uint8, device=dev)
    rates = {}
    for label, pinned in (("pinned", True), ("pageable", False)):
        src = torch.ones(H2D_PROBE_BYTES, dtype=torch.uint8,
                         pin_memory=pinned)
        for _ in range(2):
            dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        ms = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            stop.record()
            stop.synchronize()
            ms.append(start.elapsed_time(stop))
        rates[label] = H2D_PROBE_BYTES / statistics.median(ms) / 1e6
        del src
    say(f"[stream] H2D of {H2D_PROBE_BYTES} B, median of 10 by CUDA events: "
        f"pinned {rates['pinned']:.3f} GB/s, pageable "
        f"{rates['pageable']:.3f} GB/s")
    return rates


def host_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``reps`` calls, each ended by a synchronize,
    after one warm-up call, by the host clock."""
    import statistics

    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def stream_timing(runs, rates, dev) -> None:
    """Each mode's streamed call beside its parts: the host fill per chunk
    (``chunk_into`` alone), the copy floor at the pinned rate, and K1/K2's
    in-memory time (the paper's Fig. 10 comparison); then NELL-2 mode 0 at
    each queue depth of ``QUEUE_SWEEP``."""
    from repro_torch.engine import StreamedPlan
    for run in runs:
        plan, name = run["stream_plan"], run["name"]
        chunks = len(run["stream_blco"].launches)
        per_call = chunks * plan.spec.bytes_per_launch
        floor_ms = per_call / rates["pinned"] / 1e6
        for mode, _, variant, _ in run["modes"]:
            put0 = plan.stats().put_time_s
            calls0 = plan.stats().mttkrp_calls
            ms = host_ms(lambda: plan.mttkrp(run["factors"], mode))
            put = (plan.stats().put_time_s - put0) / (
                plan.stats().mttkrp_calls - calls0) / chunks * 1e3
            bufs = plan.buffers.host_set(0)
            fill_ms = host_ms(lambda: [plan.chunks.chunk_into(i, bufs)
                                       for i in range(chunks)]) / chunks
            mem_ms = run["fused_ms"][mode]
            run.setdefault("stream_ms", {})[mode] = ms
            run.setdefault("fill_ms", {})[mode] = fill_ms
            say(f"[stream] {name} mode {mode} {variant}: streamed "
                f"{ms:.3f} ms per call (median of 5, queues={plan.queues}, "
                f"{chunks} chunks); fill {fill_ms:.3f} ms per chunk "
                f"(chunk_into alone; fill + issue + waits in the loop "
                f"{put:.3f} ms); H2D floor {per_call / 1e9:.4f} GB / "
                f"{rates['pinned']:.3f} GB/s = {floor_ms:.3f} ms; in-memory "
                f"{variant} {mem_ms:.4f} ms; streamed / in-memory "
                f"{ms / mem_ms:.2f}; streamed / H2D floor "
                f"{ms / floor_ms:.2f}")
    run = runs[0]
    sweep = []
    for q in QUEUE_SWEEP:
        p = StreamedPlan(run["stream_blco"], queues=q, kernel="cuda",
                         device=dev)
        sweep.append(f"queues={q} "
                     f"{host_ms(lambda: p.mttkrp(run['factors'], 0)):.3f} ms")
        p.close()
    say(f"[stream] {run['name']} mode 0 queue sweep (median of 5): "
        + ", ".join(sweep))


def drop_pages(path) -> None:
    """Ask the host to drop the file's pages from its cache (a hint)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


class PreadvChunks:
    """The read the store's is held against: each section's rows of a
    launch read with ``os.preadv`` straight into the ring's host set (the
    store reads by copying its memmap slices, which measured faster)."""

    def __init__(self, stored):
        self.stored = stored
        self.offsets = [stored._header["sections"][name]["offset"]
                        for name in ("hi", "lo", "vals", "bases")]

    def __len__(self) -> int:
        return self.stored.num_launches

    def chunk_into(self, i, bufs) -> int:
        fd = os.open(self.stored.path, os.O_RDONLY)
        try:
            for off, buf in zip(self.offsets, bufs):
                view = memoryview(buf.reshape(-1).view(np.uint8))
                done = 0
                while done < view.nbytes:
                    got = os.preadv(fd, [view[done:]],
                                    off + i * view.nbytes + done)
                    if got == 0:
                        raise EOFError(f"{self.stored.path}: short read")
                    done += got
        finally:
            os.close(fd)
        return self.stored.chunk(i)[4]


def disk_timing(runs, dev) -> None:
    """Each mode's disk-streamed call beside the host-streamed one; the read
    of a chunk by both routes (``StoredBLCO.chunk_into``, a copy out of the
    memmap slices into the pinned ring, which the plan takes; ``os.preadv``
    into the same ring) beside the host fill of [stream]; mode 0 through
    both routes; and one cold call by each route after the file's pages
    are dropped."""
    import torch
    from repro_torch.core import stream_mttkrp
    from repro_torch.engine import DiskStreamedPlan
    for run in runs:
        name, fs = run["name"], run["factors"]
        # a fresh plan: the old one's memmaps keep the file's pages mapped,
        # and mapped pages are not dropped
        path = run["disk_plan"].stored.path
        run["disk_plan"].close()
        plan = run["disk_plan"] = DiskStreamedPlan(path, queues=QUEUES,
                                                   device=dev)
        stored = plan.stored
        chunks = stored.num_launches
        pread = PreadvChunks(stored)

        def by_preadv(mode):
            return stream_mttkrp(pread, stored, fs, mode, queues=plan.queues,
                                 kernel="cuda", buffers=plan.buffers)

        cold = {}
        for route, call in (("preadv", lambda: by_preadv(0)),
                            ("memmap", lambda: plan.mttkrp(fs, 0))):
            drop_pages(path)
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            cold[route] = (time.perf_counter() - t0) * 1e3
        say(f"[disk] {name} mode 0 cold call (after fsync and "
            f"POSIX_FADV_DONTNEED; a hint the host may ignore): memmap "
            f"{cold['memmap']:.3f} ms, preadv {cold['preadv']:.3f} ms")
        bufs = plan.buffers.host_set(0)
        mmap_ms = host_ms(lambda: [stored.chunk_into(i, bufs)
                                   for i in range(chunks)]) / chunks
        read_ms = host_ms(lambda: [pread.chunk_into(i, bufs)
                                   for i in range(chunks)]) / chunks
        fill = run["fill_ms"]
        say(f"[disk] {name}: read per chunk ({plan.spec.bytes_per_launch} "
            f"B, median of 5, warm): memmap copy into the pinned ring "
            f"(chunk_into) {mmap_ms:.3f} ms, preadv {read_ms:.3f} ms; host "
            f"fill (LaunchChunks.chunk_into) {min(fill.values()):.3f}-"
            f"{max(fill.values()):.3f} ms")
        for mode, _, variant, _ in run["modes"]:
            disk0 = plan.stats().disk_time_s
            calls0 = plan.stats().mttkrp_calls
            ms = host_ms(lambda: plan.mttkrp(fs, mode))
            per_chunk = (plan.stats().disk_time_s - disk0) / (
                plan.stats().mttkrp_calls - calls0) / chunks * 1e3
            host = run["stream_ms"][mode]
            say(f"[disk] {name} mode {mode} {variant}: disk-streamed "
                f"{ms:.3f} ms per call (median of 5, queues={plan.queues}, "
                f"{chunks} chunks; disk_time_s {per_chunk:.3f} ms per "
                f"chunk), host-streamed {host:.3f} ms; disk / host "
                f"{ms / host:.3f}")
        mm_call = host_ms(lambda: plan.mttkrp(fs, 0))
        pr_call = host_ms(lambda: by_preadv(0))
        say(f"[disk] {name} mode 0 by route (median of 5): memmap "
            f"{mm_call:.3f} ms, preadv {pr_call:.3f} ms per call")


def device_split(prof, window) -> dict:
    """Device milliseconds of a profiled sweep by kind, and the time in the
    sweep's host span ``window`` (µs) when the device ran nothing.  The
    profiler also puts synchronisations (stream waits, event and context
    syncs) and the sweep's own annotation on the device's rows; they are
    not work, and not counted."""
    from torch.autograd import DeviceType
    kinds = {"K1/K2": 0.0, "other kernels": 0.0, "H2D copies": 0.0,
             "other copies": 0.0}
    others: dict = {}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False) \
                or e.name == SWEEP_MARK or "Sync" in e.name \
                or "Wait" in e.name:
            continue
        a, z = e.time_range.start, e.time_range.end
        spans.append((a, z))
        if "segment_kernel" in e.name or "stash_kernel" in e.name:
            kinds["K1/K2"] += z - a
        elif "HtoD" in e.name:
            kinds["H2D copies"] += z - a
        elif "Memcpy" in e.name or "Memset" in e.name:
            kinds["other copies"] += z - a
        else:
            kinds["other kernels"] += z - a
            others[e.name[:60]] = others.get(e.name[:60], 0.0) + z - a
    busy, end = 0.0, window[0]
    for a, z in sorted(spans):
        a, z = max(a, end), min(z, window[1])
        if z > a:
            busy += z - a
            end = z
    out = {k: v / 1e3 for k, v in kinds.items()}
    out["device busy"] = busy / 1e3
    out["device idle"] = (window[1] - window[0] - busy) / 1e3
    out["events"] = len(spans)
    out["top other kernels"] = sorted(others.items(),
                                      key=lambda kv: -kv[1])[:4]
    return out


def profile_sweeps(runs, dev) -> None:
    """One fused and one streamed CP-ALS sweep per tensor under
    ``torch.profiler``: device time of K1/K2, of the other kernels (the
    dense (R, R) steps, output zeroing, the accumulation of chunks), of
    the copies, and the device's idle time in the sweep."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core import cp_als_init, cp_als_step
    for run in runs:
        for label, plan in (("fused", run["plan"]),
                            ("streamed", run["stream_plan"])):
            state = cp_als_init(run["dims"], RANK, norm_x=run["norm_x"],
                                tol=0.0, seed=SEED, device=dev)
            cp_als_step(plan, state)                    # warm-up sweep
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                with record_function(SWEEP_MARK):
                    cp_als_step(plan, state)
                    torch.cuda.synchronize()
                sweep_ms = (time.perf_counter() - t0) * 1e3
            marks = [e.time_range for e in prof.events()
                     if e.name == SWEEP_MARK
                     and e.device_type == DeviceType.CPU]
            split = device_split(prof, (marks[0].start, marks[0].end)) \
                if marks else {"events": 0}
            if not split["events"]:
                say(f"[profile] {run['name']} {label} sweep: {sweep_ms:.3f} "
                    f"ms; the profiler recorded no device events, so the "
                    f"split is not measured")
                continue
            top = "; ".join(f"{n} {us / 1e3:.3f}"
                            for n, us in split.pop("top other kernels"))
            say(f"[profile] {run['name']} {label} sweep: {sweep_ms:.3f} ms "
                f"by the host clock under the profiler; device ms: " +
                ", ".join(f"{k} {v:.3f}" for k, v in split.items()
                          if k != "events") +
                f" ({split['events']} device events; the other kernels' "
                f"largest: {top})")


# --------------------------------------------------------------- phase 5
def dispatch_phase(dev) -> None:
    """µs and dispatches per mode-0 call of four paths over the five
    ``paper_like`` tensors with many launches, each held against the cached
    plain output (``benchmarks/run.py::bench_dispatch`` on the card)."""
    import statistics

    import torch
    from repro_torch.core import (build_blco, clear_launch_cache,
                                  dispatch_count, mttkrp_per_launch,
                                  paper_like)
    from repro_torch.engine import plan_for
    from repro_torch.kernels import cuda_mttkrp, cuda_mttkrp_phases

    def host_us(fn) -> float:
        """Median of 5 calls, each fenced by a synchronize, after 2."""
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts) * 1e6

    for name in DISPATCH_SUITE:
        t = paper_like(name, seed=SEED)
        b = build_blco(t, max_nnz_per_block=DISPATCH_BLOCK)
        rng = np.random.default_rng(SEED)
        fs = [torch.as_tensor(rng.standard_normal((d, RANK)).astype(
            np.float32), device=dev) for d in t.dims]
        plan = plan_for(b, 1 << 40, rank=RANK, backend="in_memory",
                        kernel="torch", device=dev)
        want = plan.mttkrp(fs, 0)
        paths = {
            "per_launch_loop": lambda: mttkrp_per_launch(b, fs, 0,
                                                         device=dev),
            "cached_torch": lambda: plan.mttkrp(fs, 0),
            "cuda_mttkrp": lambda: cuda_mttkrp(b, fs, 0, device=dev),
            "cuda_mttkrp_phases": lambda: cuda_mttkrp_phases(b, fs, 0,
                                                             device=dev),
        }
        parts = []
        for label, fn in paths.items():
            c0 = dispatch_count()
            out = fn()
            calls = dispatch_count() - c0
            torch.cuda.synchronize()
            rel, fro, _ = check_err(f"{name} {label} vs the cached plain "
                                    f"path", out, want)
            parts.append(f"{label} {host_us(fn):.1f} us ({calls} "
                         f"dispatches/call, max-rel {rel:.1e})")
        say(f"[dispatch] {name}: dims {t.dims} nnz {t.nnz} launches "
            f"{len(b.launches)}, mode 0, R {RANK}: " + "; ".join(parts))
        clear_launch_cache(b)
        plan.close()


def main() -> int:
    # the phases path allocates and frees tens of GB of (T, R) tensors of
    # several sizes per call; growable segments keep the cache from
    # fragmenting (read when the allocator starts, before any allocation)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
    phase_kernels_phase(dev)

    reset_launch_counts()
    runs = [run_tensor(name, dims, nnz, dev)
            for name, (dims, nnz) in TENSORS.items()]
    launches = dict(launch_counts)
    say(f"[main] kernel launches on the main path: {launches}")
    if not all(launches[v] > 0 for v in FUSED):
        raise AssertionError(f"a kernel of the path never ran: {launches}")

    torch.cuda.empty_cache()        # the plain path's temporaries
    reset_launch_counts()
    for run in runs:
        phases_path(run)
    phase_launches = dict(launch_counts)
    say(f"[phases] kernel launches on the phases path: {phase_launches}")
    if not all(phase_launches[v] > 0 for v in PHASES):
        raise AssertionError(f"a kernel of the phases path never ran: "
                             f"{phase_launches}")
    launches.update({k: phase_launches[k] for k in PHASES})

    reset_launch_counts()
    want = {v: 0 for v in FUSED}
    for run in runs:
        for v, n in stream_path(run, dev).items():
            want[v] += n
    stream_launches = dict(launch_counts)
    say(f"[stream] kernel launches on the streamed path: {stream_launches} "
        f"(chunks x calls: {want})")
    if stream_launches != {k: want.get(k, 0) for k in KERNELS}:
        raise AssertionError(f"the streamed path launched "
                             f"{stream_launches}, expected {want}")
    for v in FUSED:
        launches[v] += stream_launches[v]

    t_disk = time.perf_counter()
    reset_launch_counts()
    want = {v: 0 for v in FUSED}
    for run in runs:
        for v, n in disk_path(run, dev).items():
            want[v] += n
    for run in runs:
        if run["name"] == LADDER:
            for v, n in ladder_path(run, dev).items():
                want[v] += n
    disk_launches = dict(launch_counts)
    say(f"[disk] kernel launches on the disk path and the ladder: "
        f"{disk_launches} (chunks x calls: {want}); "
        f"{time.perf_counter() - t_disk:.1f} s")
    if disk_launches != {k: want.get(k, 0) for k in KERNELS}:
        raise AssertionError(f"the disk path launched {disk_launches}, "
                             f"expected {want}")
    for v in FUSED:
        launches[v] += disk_launches[v]

    rows = timing_phase(runs)
    uniform_timing(dev)
    phases_timing(runs, rows)
    stream_timing(runs, h2d_rates(dev), dev)
    t_disk = time.perf_counter()
    disk_timing(runs, dev)
    for run in runs:
        path = run["disk_plan"].stored.path
        run["disk_plan"].close()
        os.unlink(path)
    say(f"[disk] timing {time.perf_counter() - t_disk:.1f} s; store files "
        f"deleted")
    profile_sweeps(runs, dev)
    dispatch_phase(dev)
    entries = []
    for kernel, (name, source, replaces) in KERNELS.items():
        row = rows[kernel]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kernel],
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
