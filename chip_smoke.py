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
[baselines] the JAX package's baselines (COO, F-COO, CSF) in plain PyTorch
   on both tensors at full size: each format's host build and upload
   seconds, device bytes beside the BLCO launch cache's, peak device
   memory (one format resident at a time), and per mode the ms of COO,
   F-COO, CSF from the mode's own tree and from another root, beside the
   fused K1/K2 call on the same mode (CUDA events, median of 5), each
   output held against the fused one;
[obs] the observability tier, with tracing and the bandwidth ledger on:
   one CP-ALS sweep per regime (in memory, streamed and disk-streamed with
   [stream]'s and [disk]'s set-ups, and COO) per tensor; the ledger held
   exactly (relative error 0.0) against each plan's ``EngineStats``; the
   roofline per regime and edge against peaks measured on the card (a
   device-to-device copy, the best pinned host-to-device copy, the
   store's best chunk read, an f32 GEMM), every achieved fraction at most
   1.05; the Chrome trace written to ``build/obs_trace.json`` and its
   track totals; and the in-memory call with tracing and the ledger on
   against both off (printed, not gated);
[service] the multi-tenant service (``repro_torch.service``) on both
   tensors: three jobs of two tenants (NELL-2 twice, Uber) under one 8 GB
   budget share one resident NELL-2 copy (registry hits and misses, pooled
   and admitted bytes, ``memory_allocated``), each job's fits held against
   a solo run, one ``MTTKRPQuery``, K1/K2 launches = sweeps x modes, and
   the first job rerun on a fresh service (its spread printed, not
   gated); two NELL-2 jobs admitted streamed under 1.8 GB hold ONE pooled
   ring (pool, ``memory_allocated``, pinned bytes), launches = chunks x
   calls; a ``ServiceRuntime`` job on Uber snapshotted from the caller's
   thread after sweep 2, restored (adopted, disk-streamed) and finished
   against an uninterrupted run; five of tests/test_chaos.py's scenarios
   on Uber at full size; per-sweep seconds per regime, the Prometheus
   exposition and the SLO report; ``build/service/`` is deleted at the
   end;
[sharded] the MTTKRP sharded over a ``torch.distributed`` mesh
   (``plan_for(backend="auto", mesh=...)``, K1/K2 on each rank's shard,
   one ``all_reduce`` over the data axis and one ``all_gather`` over the
   model axis per call): both tensors on an NCCL group of one rank, mesh
   (1, 1), every mode held against the in-memory fused output, five
   CP-ALS sweeps against the in-memory fits, launches = modes x calls,
   device bytes against the rise of ``memory_allocated``, ms per mode
   beside the in-memory call and the collectives alone; then NELL-2 on a
   gloo group of two worker processes on the one card (NCCL refuses two
   ranks on one GPU; ``chip_smoke.py --sharded-worker RANK``), each
   building only its own shard from ``[disk]``'s store, on the meshes
   (2, 1) and (1, 2): every mode against the parent's in-memory output,
   two sweeps with factors bitwise equal across the ranks, ms per mode
   and collective ms per rank, launches reported by each worker and
   checked by the parent;
[analysis] the port's analysis tier on the card, over what the earlier
   phases built: the AST lint passes over ``src/repro_torch/`` and this
   script against ``src/repro_torch/analysis/lint_baseline.json`` (no
   finding outside it, no stale entry); ``prove_encoding`` and
   ``verify_layout`` for NELL-2's and Uber's BLCOs and their ``[stream]``
   rebuilds (no finding; fields and shifts printed, NELL-2 mode 2's
   straddling field among them); ``conflict_report`` for every (tensor,
   mode), and K4 launched on the launch cache's flat stream at the
   report's tile, its runs per launch (``seg_tgt >= 0``) equal to the
   report's segments + padding segments; and ``run_trace_tier`` with the
   registered hot paths over both tensors' launch caches at full width,
   under the op recorder and ``torch.cuda.set_sync_debug_mode("error")``: no
   finding outside an inline disable.  K4's launches and the audit's
   K1/K2 launches are counted;
[examples] the port's entry points on the card, each ``main`` at its
   reference script's sizes and seeds with its output printed under the
   phase's tag: ``repro_torch.examples.quickstart``,
   ``oom_decomposition``, ``serve_td`` (all three acts), the chaos soak
   (``repro_torch.scripts.chaos_soak``) under the chaos lane's
   ``REPRO_FAULTS`` plan and under one ``plan.alloc`` fault with
   ``REPRO_SANITIZE=1``, ``repro_torch.scripts.lint --tier all``, and
   ``distributed_cpals`` (eight gloo ranks on the one card, each a process
   that prints its K1/K2 launches as a JSON line); each must return 0 and
   leave the pinned rings and the allocated device bytes as it found
   them; seconds, K1/K2 launches and the largest |dfit| and |dfactor|
   printed (where a tolerance replaces a bitwise check), and K1 and K2
   must both have run in the phase; ``serve_lm`` (the reduced LM) too;
[serve] the served dense LM (``repro_torch.models``, ``.serving``): minicpm-2b
   at full width and depth (40 layers, 2,725,173,504 parameters in f32,
   drawn on the card from a seeded generator): decode against the
   teacher-forced forward in f32 (B 2, S 16, within 2e-3),
   ``Server.generate`` at serve_lm's sizes (batch 4, prompt 12, 24 new
   tokens; bf16, greedy) twice with bitwise equal tokens, row 0 alone
   beside the batch (agreement printed), the time to first token, the
   median decode step by CUDA events, tokens/s, the cache and parameter
   bytes, the cost of the f32 -> bf16 weight casts each step makes, the
   peak device memory, and the first 2 layers' logits on the card against
   the CPU on the same weights (1e-4 in f32, 2e-2 in bf16); qwen2.5-14b at
   full width with its depth cut to 4 layers (GQA G = 5, QKV bias, the
   untied head, rope theta 1e6) through the same decode and serving
   checks at batch 2, prompt 6, 8 new tokens; ``embed_grad`` at
   minicpm's 122,880 x 2304 table with (8, 2048) Zipf(1.3) ids: segment
   against scatter within 2e-4, the autograd backward bitwise equal to
   ``_grad_segment``, ms of each; device memory back where it was and no
   kernel of K1-K5 launched;
[train] the trained dense LM (``repro_torch.launch.steps``, ``.optim``,
   ``.train``): minicpm-2b at full width and depth (40 layers, f32
   parameters, m and v, the WSD schedule, ``embed_grad="segment"``) takes
   6 in-place steps (``make_train_step(donate=True)``) on SyntheticLM
   batches at (B, S) = (1, 4096), the reference's train_4k sequence with
   its batch of 256 cut to 1: parameter and state bytes, each step's
   loss, grad norm and lr (finite; lr the host's schedule within 1e-6),
   step ms by the host clock fenced by the loss read and by CUDA events,
   tokens/s, matmul TFLOP per step, the peak device memory, one profiled
   step (device busy and idle ms, device events, the aten ops with the
   most device time) and one step split in its forward, backward and
   AdamW by CUDA events; the table's gradient of one full-depth step by
   segment and by scatter (within 2e-4) with each backward's ms; one f32
   out-of-place step over the first 2 layers on the card and on the host
   from the same weights (loss and grad norm within 1e-5, parameters
   within a tenth of lr); the ``Trainer`` over 2 layers at full width:
   6 steps with async checkpoints every 3 under ``build/train/``, a
   restart from step 3 ending within rtol = atol = 1e-6 of the straight
   run, the state saved and restored alone (seconds), a poisoned batch
   the NaN guard skips, the directory deleted and the held bytes back;
   ``python -m repro_torch.examples.train_lm`` at its reference sizes;
   no kernel of K1-K5 launched;
[families] the MoE (with MLA), SSM, hybrid and enc-dec families: mamba2-370m,
   zamba2-1.2b and seamless-m4t-large-v2 at full width and depth,
   deepseek-v2-236b (MLA, all 160 experts) and dbrx-132b at full width
   over 2 layers, each drawn on the card: decode against the forward in
   f32 (2e-3; the MoE at capacity_factor E / k), ``Server.generate`` in
   bf16 twice (tokens bitwise equal), the time to first token (seamless's
   memory prefilled from (2, 64, 1024) seeded frames), the median decode
   step by CUDA events, one step under ``set_sync_debug_mode("error")``,
   parameter, cache and peak bytes; one config per family at 2 layers
   (zamba2 4 at every 2, deepseek 32 experts) on the card against the
   CPU (1e-4 f32, 2e-2 bf16, the router's differing picks counted); four
   trained 3 in-place steps (mamba2, zamba2, seamless at (1, 4096),
   deepseek with 32 experts at (1, 2048)): loss, grad norm, lr against
   the host's cosine, step ms, tokens/s, peak; zamba2's train state at 4
   layers saved and restored through ``train/checkpoint.py`` bitwise;
   device memory back where it was and no kernel of K1-K5 launched;
[mesh] the mesh substrate (``repro_torch.dist``, the sharded
   ``launch.steps`` step, the ``Trainer``'s mesh, ``moe_apply_sharded``,
   ``launch/train.py --mesh``): (1) deepseek-v2-236b at full width over 2
   layers with 32 routed experts, two in-place sharded steps at (1, 2048)
   through a ``Trainer`` on an NCCL world-1 (1, 1) mesh against the
   unsharded steps from the same draws, under deterministic algorithms
   (loss and grad norm within 1e-5 relative, parameters within 0.1 lr);
   (2) ZeRO over data: deepseek in f32 with 16 routed experts and the int8
   second moment (its scale the max over each leaf's blocks), one step
   by a ``Trainer`` on a gloo (2, 1) mesh in two worker processes on the
   one card (``chip_smoke.py --mesh-worker zero RANK``) at (2, 512),
   against the same step unsharded here (the gradients of the two row
   blocks averaged): loss and grad norm within 1e-5; (3) expert
   parallelism: one MoE layer at full width with all 160 experts, 80 per
   rank on a gloo (1, 2) mesh (``--mesh-worker ep``, the weights read in
   place through CUDA IPC), forward and backward on (2, 256) tokens
   against ``moe_apply`` here: output, aux and every gradient within
   1e-5; (4) part 2's state, written by rank 0 as the Trainer's
   checkpoint, restored by a ``Trainer`` on the world-1 mesh: every
   tensor's fingerprint equal to the workers', the parameters within
   5e-3 of the unsharded step's; (5) ``python -m torch.distributed.run
   --nproc-per-node 8 -m repro_torch.launch.train --arch dbrx-132b
   --reduced --mesh test --steps 3`` (eight gloo ranks on the card): exit
   0, finite losses, every rank's final state digest equal; each part's
   seconds, each rank's peak memory and the step ms by CUDA events; no
   kernel of K1-K5 launched;
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
import atexit
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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


def event_times(fn, reps: int) -> list[float]:
    """Milliseconds of each of ``reps`` calls, each between two CUDA events
    on the current stream, after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        ms.append(start.elapsed_time(stop))
    return ms


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


def timed(fn, *args, **kw):
    """``(fn(*args, **kw), its seconds)``."""
    t0 = time.perf_counter()
    return fn(*args, **kw), time.perf_counter() - t0


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
    # both builds at once: host numpy sorts, which release the GIL
    with ThreadPoolExecutor(max_workers=2) as pool:
        whole = pool.submit(timed, build_blco, t)
        streamed = pool.submit(timed, build_blco, t,
                               max_nnz_per_block=STREAM[name][0])
        (b, build_s), (bs, stream_s) = whole.result(), streamed.result()
    norm_x = float(np.sqrt(np.sum(t.values.astype(np.float64) ** 2)))
    say(f"[stream] {name}: build_blco(max_nnz_per_block="
        f"{STREAM[name][0]}) {stream_s:.1f} s (its thread, beside the "
        f"main build), launches {[l.nnz for l in bs.launches]}")
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
            "stream_blco": bs, "norm_x": norm_x, "fits": fits["cuda"],
            "tensor": t}


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


def fused_bytes(nnz, dims, mode, rank) -> float:
    """Bytes one f32 fused call must move: each input read once (nnz x (hi
    + lo + value + N bases), the N-1 factor matrices), the output written
    once — the bandwidth ledger's ``"cuda"`` model, so the kernel table and
    the roofline count the same bytes."""
    from repro_torch.obs.ledger import hbm_model_bytes
    return hbm_model_bytes(nnz, order=len(dims), rank=rank, value_itemsize=4,
                           factor_itemsize=4, kernel="cuda", dims=dims,
                           mode=mode)


def bound(nnz, dims, mode, rank) -> tuple[float, str]:
    """Least milliseconds for one f32 fused call (``fused_bytes``; nnz * R *
    N operations) and what bounds it."""
    return roof(fused_bytes(nnz, dims, mode, rank), nnz * rank * len(dims),
                F32_FLOPS)


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


def uniform_blco():
    """The uniform stream's BLCO, built on the host: NELL-2's dims and nnz,
    every coordinate drawn uniformly."""
    from repro_torch.core import SparseTensor, build_blco, top_up_uniform
    dims, nnz = TENSORS["nell-2"]
    empty = SparseTensor(dims, np.zeros((0, len(dims)), np.int64),
                         np.zeros(0, np.float32))
    return build_blco(top_up_uniform(empty, nnz, seed=SEED))


def uniform_timing(built, dev) -> None:
    """K1 on every mode of a stream without hot rows (the main path's
    tensors have a powerlaw head, whose hottest rows K1's per-CTA table
    takes off L2).  ``built``: the future of ``timed(uniform_blco)``,
    which a host thread runs beside the earlier phases."""
    import torch
    from repro_torch.core import choose_resolution, init_factors
    from repro_torch.core.launches import LaunchCache
    from repro_torch.kernels import fused
    name = "nell-2-uniform"
    dims, _ = TENSORS["nell-2"]
    t0 = time.perf_counter()
    b, host_s = built.result()
    wait_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cache = LaunchCache.from_blco(b, device=dev)
    hi, lo, vals, bases = cache.flat()
    fs = init_factors(dims, RANK, seed=SEED, device=dev)
    torch.cuda.synchronize()
    say(f"[uniform] {name}: dims {dims} nnz {b.nnz}, T {hi.shape[0]}, "
        f"host generation + build_blco {host_s:.1f} s (a thread beside the "
        f"phases, stream and disk paths; {wait_s:.1f} s waited for it), "
        f"upload {time.perf_counter() - t0:.1f} s")
    del b
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
    ``H2D_PROBE_BYTES`` timed by CUDA events, median of 10 after 2 (and
    the best of the 10, ``"<label> best"``)."""
    import statistics

    import torch
    dst = torch.empty(H2D_PROBE_BYTES, dtype=torch.uint8, device=dev)
    rates = {}
    for label, pinned in (("pinned", True), ("pageable", False)):
        src = torch.ones(H2D_PROBE_BYTES, dtype=torch.uint8,
                         pin_memory=pinned)
        ms = event_times(lambda: dst.copy_(src, non_blocking=True), 10)
        rates[label] = H2D_PROBE_BYTES / statistics.median(ms) / 1e6
        rates[f"{label} best"] = H2D_PROBE_BYTES / min(ms) / 1e6
        del src
    say(f"[stream] H2D of {H2D_PROBE_BYTES} B, median of 10 by CUDA events: "
        f"pinned {rates['pinned']:.3f} GB/s, pageable "
        f"{rates['pageable']:.3f} GB/s (best of 10: pinned "
        f"{rates['pinned best']:.3f}, pageable "
        f"{rates['pageable best']:.3f} GB/s)")
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
                f"(chunk_into alone); copy {put:.3f} ms per chunk "
                f"(put_time_s: CUDA events on the copy stream); H2D floor "
                f"{per_call / 1e9:.4f} GB / "
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


# ----------------------------------------------------------- [baselines]
# calls timed per (format, mode), each between two CUDA events
MEDIAN_OF = 5


def event_ms(fn, reps: int = MEDIAN_OF) -> float:
    """Median milliseconds of ``reps`` calls (``event_times``)."""
    import statistics
    return statistics.median(event_times(fn, reps))


def baselines_phase(runs, dev) -> None:
    """The paper's comparison formats on both tensors at full size: each
    format's host build and upload seconds, device bytes beside the BLCO
    launch cache, peak device memory (one format resident at a time), and
    per mode its ms beside the fused K1/K2 call, each output held against
    the fused one."""
    import torch
    from repro_torch.core import baselines
    from repro_torch.engine import BaselinePlan
    formats = {"coo": (baselines.COOFormat, baselines.DeviceCOO),
               "fcoo": (baselines.FCOOFormat, baselines.DeviceFCOO),
               "csf": (baselines.CSFFormat, baselines.DeviceCSF)}
    for run in runs:
        name, t, fs, dims = run["name"], run["tensor"], run["factors"], \
            run["dims"]
        fused, cache_bytes = run["plan"], run["plan"].device_bytes()
        say(f"[baselines] {name}: the JAX package's COO, F-COO and CSF "
            f"ported as plain PyTorch (index_select, index_add_, "
            f"scatter_reduce), not MM-CSF: the ratios to the fused call "
            f"below are not the paper's 2.12-2.6x claim")
        fused_ms = {mode: event_ms(lambda: fused.mttkrp(fs, mode))
                    for mode in range(len(dims))}
        for kind, (host_cls, dev_cls) in formats.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            fmt = host_cls.build(t)
            build_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            dev_fmt = dev_cls(fmt, device=dev)
            torch.cuda.synchronize()
            upload_s = time.perf_counter() - t0
            plan = BaselinePlan(dev_fmt, kind)
            say(f"[baselines] {name} {kind}: host build {build_s:.2f} s, "
                f"upload {upload_s:.2f} s; device bytes "
                f"{plan.device_bytes()} B (host format "
                f"{fmt.device_bytes()} B), BLCO launch cache {cache_bytes} "
                f"B: {plan.device_bytes() / cache_bytes:.3f}x")
            del fmt
            for mode, d, variant, _ in run["modes"]:
                calls = [(kind, lambda: plan.mttkrp(fs, mode))]
                if kind == "csf":
                    other = (mode + 1) % len(dims)
                    calls = [("csf from its root", calls[0][1]),
                             (f"csf from root {other}",
                              lambda: dev_fmt.mttkrp(fs, mode, root=other))]
                for label, fn in calls:
                    out = fn()
                    if out.shape != (d, RANK) \
                            or not bool(torch.isfinite(out).all()):
                        raise AssertionError(f"{name} mode {mode}: bad "
                                             f"{label} output")
                    rel, fro, _ = check_err(
                        f"{name} mode {mode}: {label} vs fused", out,
                        run["outs"][mode][0])
                    del out
                    ms = event_ms(fn)
                    say(f"[baselines] {name} mode {mode} (I={d}) {label}: "
                        f"{ms:.3f} ms, fused {variant} {fused_ms[mode]:.3f} ms"
                        f" (CUDA events, median of {MEDIAN_OF}): "
                        f"{ms / fused_ms[mode]:.2f}x the fused call; vs fused "
                        f"max-rel {rel:.3e}, Frobenius-rel {fro:.3e}")
            peak = torch.cuda.max_memory_allocated(dev) - base
            plan.close()
            del plan, dev_fmt
            torch.cuda.empty_cache()
            say(f"[baselines] {name} {kind}: peak device memory {peak} B "
                f"above the {base} B already allocated "
                f"({peak / cache_bytes:.3f}x the BLCO launch cache)")


# ----------------------------------------------------------------- [obs]
# bytes of the device-to-device copy whose rate is the HBM peak
HBM_PROBE_BYTES = 1 << 31
# the f32 GEMM whose rate is the FLOP peak (TF32 off)
GEMM_N = 8192
# the guard on the roofline: no edge may beat its measured peak by more
# than the spread between measurements
FRACTION_LIMIT = 1.05
TRACE_PATH = os.path.join(ROOT, "build", "obs_trace.json")


def best_ms(fn, reps: int = 10) -> float:
    """The least milliseconds of ``reps`` calls (``event_times``)."""
    return min(event_times(fn, reps))


def device_peaks(rates, dev) -> tuple[dict, float]:
    """The HBM and host-to-device peaks (GB/s) and the f32 FLOP peak
    (FLOP/s), measured on this card: a device-to-device copy of
    ``HBM_PROBE_BYTES`` (bytes read and written), the best pinned copy of
    ``H2D_PROBE_BYTES`` (``h2d_rates`` and once more here), an f32 GEMM of
    ``GEMM_N`` with TF32 off."""
    import torch
    from repro_torch.obs import ledger
    src = torch.empty(HBM_PROBE_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    hbm = 2 * HBM_PROBE_BYTES / best_ms(lambda: dst.copy_(src)) / 1e6
    del src, dst
    host = torch.ones(H2D_PROBE_BYTES, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(H2D_PROBE_BYTES, dtype=torch.uint8, device=dev)
    h2d = max(rates["pinned best"], H2D_PROBE_BYTES / best_ms(
        lambda: dst.copy_(host, non_blocking=True)) / 1e6)
    del host, dst
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the f32 FLOP peak needs TF32 off")
    a = torch.randn(GEMM_N, GEMM_N, device=dev)
    b = torch.randn(GEMM_N, GEMM_N, device=dev)
    flops = 2 * GEMM_N ** 3 / best_ms(lambda: a @ b) * 1e3
    del a, b
    torch.cuda.empty_cache()
    say(f"[obs] peaks on the card: HBM {hbm:.1f} GB/s (device-to-device "
        f"copy of {HBM_PROBE_BYTES} B, read + written, best of 10; data "
        f"sheet 3350), host-to-device {h2d:.3f} GB/s (pinned copy of "
        f"{H2D_PROBE_BYTES} B, best of 20), f32 GEMM {flops / 1e12:.2f} "
        f"TFLOP/s ({GEMM_N}^3, TF32 off, best of 10; data sheet 67)")
    return {ledger.DEVICE_HBM: hbm, ledger.HOST_DEVICE: h2d}, flops


def store_read_peak(plan) -> float:
    """GB/s of the store's best chunk read (``StoredBLCO.chunk_into``, the
    memmap copy into the plan's pinned ring) as the sweep reads: chunk i
    into host set i mod queues, every set of the ring in turn, over as
    many passes as a sweep makes (one per mode)."""
    stored, ring = plan.stored, plan.buffers
    best = math.inf
    for _ in range(stored.order):
        for i in range(stored.num_launches):
            bufs = ring.host_set(i % ring.queues)
            t0 = time.perf_counter()
            stored.chunk_into(i, bufs)
            best = min(best, time.perf_counter() - t0)
    return plan.spec.bytes_per_launch / best / 1e9


def obs_phase(runs, rates, dev) -> dict:
    """One CP-ALS sweep per regime and tensor with tracing and the ledger
    on: the ledger held exactly against each plan's stats, the roofline
    against the card's measured peaks (every achieved fraction at most
    ``FRACTION_LIMIT``), the Chrome trace and its track totals.  Returns
    the K1/K2 launches the sweeps should have made, per variant."""
    import torch
    from repro_torch import obs
    from repro_torch.core import cp_als_init, cp_als_step
    from repro_torch.engine import DiskStreamedPlan, InMemoryPlan, plan_for
    from repro_torch.obs import ledger
    peaks, peak_flops = device_peaks(rates, dev)
    want = {v: 0 for v in FUSED}
    obs.trace.clear()
    obs.trace.enable()
    for run in runs:
        name, dims = run["name"], run["dims"]
        bs = run["stream_blco"]
        store = run["disk_plan"].stored.path
        # on before the plans are made: the COO plan records its upload
        ledger.clear()
        ledger.enable()
        plans = [
            InMemoryPlan(run["blco"], kernel="cuda", resident=run["plan"]
                         .resident, owns_resident=False),
            plan_for(bs, STREAM[name][1], rank=RANK, backend="auto",
                     queues=QUEUES, kernel="cuda", device=dev),
            DiskStreamedPlan(store, queues=QUEUES, device=dev),
            plan_for(run["blco"], torch.cuda.mem_get_info()[0], rank=RANK,
                     backend="coo", kernel="torch", device=dev,
                     tensor=run["tensor"]),
        ]
        if [p.backend for p in plans] != ["in_memory", "streamed",
                                          "disk_streamed", "coo"]:
            raise AssertionError(f"{name}: [obs] plans {plans}")
        disk_peak = store_read_peak(plans[2])
        for plan in plans:
            state = cp_als_init(dims, RANK, norm_x=run["norm_x"], tol=0.0,
                                seed=SEED, device=dev)
            t0 = time.perf_counter()
            cp_als_step(plan, state)
            torch.cuda.synchronize()
            say(f"[obs] {name} {plan.backend} sweep: "
                f"{time.perf_counter() - t0:.4f} s, fit {state.fits[-1]:.6f}")
        ledger.disable()
        chunks = len(bs.launches)
        for _, _, variant, _ in run["modes"]:
            want[variant] += 1 + 2 * chunks
        disk_peak = max(disk_peak, store_read_peak(plans[2]))
        pairs = [(p.backend, p.stats()) for p in plans]
        report = ledger.verify_conservation(pairs)
        say(f"[obs] {name}: conservation over {len(report['checks'])} "
            f"(regime, edge, field) checks, max relative error "
            f"{report['max_rel_err']!r}")
        if report["max_rel_err"] != 0.0:
            bad = [c for c in report["checks"] if c["rel_err"]]
            raise AssertionError(f"{name}: the ledger disagrees with the "
                                 f"stats: {bad}")
        tensor_peaks = dict(peaks)
        tensor_peaks[ledger.DISK_HOST] = disk_peak
        say(f"[obs] {name}: disk-to-host peak {disk_peak:.3f} GB/s (the "
            f"store's best chunk read into each set of the pinned ring in "
            f"turn, one pass per mode before and after the sweeps)")
        roof = obs.roofline_report(peaks=tensor_peaks, peak_flops=peak_flops)
        worst = 0.0
        for regime, rep in roof["regimes"].items():
            for edge, e in sorted(rep["edges"].items()):
                frac = e.get("achieved_fraction")
                worst = max(worst, frac or 0.0)
                say(f"[obs] {name} {regime} {edge}: {e['bytes']} B in "
                    f"{e['seconds']:.6f} s over {e['ops']} records, "
                    f"{e['gb_per_s']:.3f} GB/s"
                    + (f" = {frac:.4f} of {e['peak_gb_per_s']:.3f}"
                       if frac is not None else ""))
            say(f"[obs] {name} {regime}: saturated edge "
                f"{rep['saturated_edge']}, {rep['bound']}, arithmetic "
                f"intensity {rep['arithmetic_intensity']:.4f} flop/B, "
                f"{rep['gflops_per_s']:.3f} GFLOP/s")
        if worst > FRACTION_LIMIT:
            raise AssertionError(f"{name}: an edge reads {worst:.4f} of its "
                                 f"measured peak (limit {FRACTION_LIMIT})")
        for plan in plans:
            plan.close()
        torch.cuda.empty_cache()
    obs.trace.disable()
    doc = obs.write_chrome_trace(TRACE_PATH)
    totals = obs.track_totals()
    say(f"[obs] Chrome trace {os.path.relpath(TRACE_PATH, ROOT)}: "
        f"{len(doc['traceEvents'])} events, dropped "
        f"{doc['otherData']['dropped_spans']}; seconds per track "
        + ", ".join(f"{k} {v:.6f}" for k, v in sorted(totals.items())))
    obs.trace.clear()
    return want


# ------------------------------------------------------------- [service]
# the multi-tenant service: its own device budgets, the jobs' sweeps, the
# snapshot's directory (build/ is not committed; deleted at the end), the
# chaos runs' rank, sweeps and scenarios (tests/test_chaos.py's SCENARIOS)
SERVICE_DIR = os.path.join(ROOT, "build", "service")
SERVICE_BUDGET = int(8e9)
SERVICE_STREAM_SWEEPS = 3
SERVICE_DISK_SWEEPS = 6
CHAOS_RANK, CHAOS_SWEEPS = 8, 3
CHAOS = {
    "alloc-failure": ("mem", (("plan.alloc", None, 1),)),
    "h2d-failure": ("disk", (("stream.h2d", None, 2), ("stream.h2d", None, 6))),
    "nan-poison": ("mem", (("factors.nan", None, 3),)),
    "quantum-exception": ("mem", (("runtime.quantum", "exception", 2),)),
    "worker-death": ("mem", (("runtime.quantum", "crash", 3),)),
}
MIB = 1 << 20
# every service of the phase: the smoke's queue depth, on the card
SERVICE_KW = {"queues": QUEUES, "device": "cuda"}


def fresh_service(registry=None, **kw):
    """A ``DecompositionService`` on the card; ``registry`` shares another
    service's registry (its BLCO builds), so a second service on the same
    tensor does not run ``build_blco`` again."""
    from repro_torch.service import DecompositionService
    svc = DecompositionService(**SERVICE_KW, **kw)
    if registry is not None:
        svc.registry = registry
    return svc


def drive(svc, regimes) -> dict:
    """``svc.run()`` one quantum at a time; returns each job's quantum
    seconds (fenced) and adds them to ``regimes[(backend, tensor)]``."""
    import torch
    names = {dims: name for name, (dims, _) in TENSORS.items()}
    per_job = {}
    more = True
    while more:
        n = len(svc.scheduler.trace)
        t0 = time.perf_counter()
        more = svc.step()
        torch.cuda.synchronize()
        if len(svc.scheduler.trace) > n:
            job = svc.scheduler.jobs[svc.scheduler.trace[-1]]
            secs = time.perf_counter() - t0
            per_job.setdefault(job.job_id, []).append(secs)
            regimes.setdefault((job.metrics.backend,
                                names[tuple(job.handle.dims)]),
                               []).append(secs)
    return per_job


def fused_launches(run, calls_per_mode, chunks=1) -> dict:
    """K1/K2 launches of ``calls_per_mode`` calls of every mode of one
    tensor, ``chunks`` launches per call."""
    want = {v: 0 for v in FUSED}
    for _, _, variant, _ in run["modes"]:
        want[variant] += calls_per_mode * chunks
    return want


def counted(fn, want, what, tag="[service]") -> dict:
    """Run ``fn``; its K1/K2 launches (counted just before and just after)
    must equal ``want``; returns them."""
    from repro_torch.kernels import launch_counts
    before = dict(launch_counts)
    fn()
    took = {k: launch_counts[k] - before[k] for k in KERNELS}
    if took != {k: want.get(k, 0) for k in KERNELS}:
        raise AssertionError(f"{tag} {what} launched {took}, expected "
                             f"{want}")
    say(f"{tag} {what}: K1/K2 launches {took} (sweeps x modes x "
        f"chunks)")
    return took


def add_launches(total, took) -> None:
    for k, n in took.items():
        total[k] = total.get(k, 0) + n


def state_bytes(cp) -> int:
    return sum(x.numel() * x.element_size()
               for x in list(cp.factors) + list(cp.grams) + [cp.lam])


def solo_fits(run, seed, sweeps, norm_x, dev) -> list:
    """``sweeps`` CP-ALS sweeps of one tensor over ``plan_for(kernel=
    "cuda")``'s in-memory plan (the main path's), from ``seed``."""
    from repro_torch.core import cp_als_init, cp_als_step
    state = cp_als_init(run["dims"], RANK, norm_x=norm_x, tol=0.0, seed=seed,
                        device=dev)
    for _ in range(sweeps):
        cp_als_step(run["plan"], state)
    return state.fits


def check_fits(what, got, want, tol=FIT_TOL, tag="[service]") -> float:
    diff = max(abs(a - b) for a, b in zip(got, want))
    if len(got) != len(want) or not all(math.isfinite(f) for f in got) \
            or diff > tol:
        raise AssertionError(f"{tag} {what}: fits {got} vs {want}")
    return diff


def service_resident(runs, dev, launches, regimes) -> dict:
    """Three jobs of two tenants on NELL-2 (twice) and Uber under one 8 GB
    budget: one resident NELL-2 copy, fits against solo runs, a one-shot
    query, the launches, and a rerun of the first job on a fresh service
    (its spread printed: the evidence a deterministic option would need)."""
    import torch
    from repro_torch.engine import factor_bytes, in_memory_bytes
    from repro_torch.service import MTTKRPQuery, SubmitDecomposition
    nell, uber = runs
    svc = fresh_service(device_budget_bytes=SERVICE_BUDGET)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    jobs = ((nell, 1, "acme", 2.0), (nell, 2, "umbrella", 1.0),
            (uber, 3, "umbrella", 1.0))
    t0 = time.perf_counter()
    ids = [svc.submit(SubmitDecomposition(
        tensor=run["tensor"], rank=RANK, iters=SWEEPS, tol=0.0, seed=seed,
        tenant=tenant, weight=weight)) for run, seed, tenant, weight in jobs]
    torch.cuda.synchronize()
    submit_s = time.perf_counter() - t0
    rise = torch.cuda.memory_allocated(dev) - mem0
    reg = svc.registry
    handles = [svc.scheduler.jobs[j].handle for j in ids]
    caches = in_memory_bytes(handles[0].blco) + in_memory_bytes(
        handles[2].blco)
    working = sum(factor_bytes(run["dims"], RANK, torch.float32)
                  for run, *_ in jobs)
    states = sum(state_bytes(svc.scheduler.jobs[j].cp) for j in ids)
    m = svc.service_metrics()
    say(f"[service] resident pool: 3 jobs submitted in {submit_s:.1f} s "
        f"(the registry's build_blco of NELL-2 and Uber and the uploads); "
        f"registry misses {reg.misses} hits {reg.hits}; backends "
        f"{[svc.status(j).backend for j in ids]}; resident copies "
        f"{svc.engine.resident_count}, pooled {svc.engine.pooled_bytes()} B "
        f"(launch caches {caches} B); admitted "
        f"{m['admitted_reservation_bytes']} B (+ working sets {working} B); "
        f"memory_allocated rose {rise} B (caches + job states {states} B = "
        f"{caches + states} B)")
    if (reg.misses, reg.hits) != (2, 1) or svc.engine.resident_count != 2 \
            or [svc.status(j).backend for j in ids] != ["in_memory"] * 3 \
            or svc.engine.pooled_bytes() != caches \
            or m["admitted_reservation_bytes"] != caches + working \
            or abs(rise - (caches + states)) > MIB:
        raise AssertionError("[service] resident pool accounting")
    t0 = time.perf_counter()
    got = svc.mttkrp(MTTKRPQuery(tensor=nell["tensor"],
                                 factors=nell["factors"], mode=2))
    torch.cuda.synchronize()
    query_s = time.perf_counter() - t0
    rel, fro, _ = check_err("[service] MTTKRPQuery NELL-2 mode 2", got,
                            nell["plan"].mttkrp(nell["factors"], 2))
    say(f"[service] MTTKRPQuery NELL-2 mode 2 on {got.device}: {query_s:.3f} "
        f"s, vs InMemoryPlan.mttkrp max-rel {rel:.3e}, Frobenius-rel "
        f"{fro:.3e}")
    want = {v: 0 for v in FUSED}
    for run, *_ in jobs:
        add_launches(want, fused_launches(run, SWEEPS))
    per_job = {}
    add_launches(launches, counted(
        lambda: per_job.update(drive(svc, regimes)), want,
        "resident pool, 3 jobs x 5 sweeps"))
    fits = {}
    for (run, seed, tenant, _), j in zip(jobs, ids):
        res = svc.result(j).result
        solo = solo_fits(run, seed, SWEEPS, handles[0 if run is nell else 2]
                         .norm_x, dev)
        diff = check_fits(f"{run['name']} seed {seed}", res.fits, solo)
        fits[(run["name"], seed)] = res
        per = per_job[j]
        say(f"[service] job {j} ({run['name']}, seed {seed}, {tenant}, "
            f"{svc.status(j).backend}): sweeps {[round(s, 4) for s in per]} "
            f"s (mean {sum(per) / len(per):.4f} s); fits {res.fits}; max "
            f"|dfit| from a solo plan_for(kernel='cuda') run {diff:.2e}")
    say(f"[service] tenant iterations {m['tenant_iterations']} -> "
        f"{svc.service_metrics()['tenant_iterations']}; trace "
        f"{svc.scheduler.trace}")
    rerun = fresh_service(registry=reg, device_budget_bytes=SERVICE_BUDGET)
    j = rerun.submit(SubmitDecomposition(tensor=nell["tensor"], rank=RANK,
                                         iters=SWEEPS, tol=0.0, seed=1,
                                         tenant="acme", weight=2.0))
    took = counted(lambda: drive(rerun, regimes),
                   fused_launches(nell, SWEEPS),
                   "rerun of job 0 on a fresh service")
    add_launches(launches, took)
    a, b = fits[("nell-2", 1)], rerun.result(j).result
    same = a.fits == b.fits and all(torch.equal(x, y) for x, y in
                                    zip(a.factors, b.factors))
    dfit = max(abs(x - y) for x, y in zip(a.fits, b.fits))
    dfac = max(float((x - y).abs().max()) for x, y in zip(a.factors,
                                                          b.factors))
    say(f"[service] rerun spread (NELL-2, seed 1, two fresh services): "
        f"bit-identical {same}; max |dfit| {dfit:.3e}; max |dfactor| "
        f"{dfac:.3e}")
    return {"service": svc, "fits": fits}


def service_streamed(runs, dev, launches, regimes, first) -> None:
    """Two NELL-2 jobs admitted streamed under 1.8 GB with [stream]'s
    build: ONE pooled ring for both, by the pool, ``memory_allocated`` and
    the rings' pinned bytes; fits against the resident pool's; launches
    chunks x calls."""
    import torch
    from repro_torch.core.streaming import StreamBuffers
    from repro_torch.service import BuildParams, SubmitDecomposition
    nell = runs[0]
    build = BuildParams(max_nnz_per_block=STREAM["nell-2"][0])
    svc = fresh_service(device_budget_bytes=int(STREAM["nell-2"][1]))
    torch.cuda.synchronize()
    mem0, pinned0 = torch.cuda.memory_allocated(dev), \
        StreamBuffers.pinned_bytes()
    t0 = time.perf_counter()
    ids = [svc.submit(SubmitDecomposition(
        tensor=nell["tensor"], rank=RANK, iters=SERVICE_STREAM_SWEEPS,
        tol=0.0, seed=seed, build=build, tenant=tenant))
        for seed, tenant in ((1, "acme"), (2, "umbrella"))]
    torch.cuda.synchronize()
    submit_s = time.perf_counter() - t0
    rise = torch.cuda.memory_allocated(dev) - mem0
    pinned = StreamBuffers.pinned_bytes() - pinned0
    jobs = [svc.scheduler.jobs[j] for j in ids]
    spec = jobs[0].handle.spec
    ring = spec.bytes_in_flight(QUEUES)
    states = sum(state_bytes(j.cp) for j in jobs)
    chunks = len(jobs[0].handle.blco.launches)
    say(f"[service] stream pool: 2 jobs submitted in {submit_s:.1f} s "
        f"(build_blco with max_nnz_per_block={build.max_nnz_per_block}); "
        f"backends {[j.metrics.backend for j in jobs]}; pool size "
        f"{svc.engine.pool_size}, pooled {svc.engine.pooled_bytes()} B "
        f"(one ring: {QUEUES} x {spec.bytes_per_launch} B = {ring} B); one "
        f"ring object {jobs[0].plan.buffers is jobs[1].plan.buffers}; "
        f"memory_allocated rose {rise} B (ring + job states {states} B = "
        f"{ring + states} B; two rings would be {2 * ring + states} B); "
        f"pinned host bytes of open rings rose {pinned} B; admitted "
        f"{svc.service_metrics()['admitted_reservation_bytes']} B")
    if [j.metrics.backend for j in jobs] != ["streamed"] * 2 \
            or svc.engine.pool_size != 1 or svc.engine.pooled_bytes() != ring \
            or jobs[0].plan.buffers is not jobs[1].plan.buffers \
            or abs(rise - (ring + states)) > MIB or pinned != ring:
        raise AssertionError("[service] the two streamed jobs do not hold "
                             "one ring")
    per_job = {}
    took = counted(lambda: per_job.update(drive(svc, regimes)),
                   fused_launches(nell, 2 * SERVICE_STREAM_SWEEPS, chunks),
                   f"stream pool, 2 jobs x {SERVICE_STREAM_SWEEPS} sweeps x "
                   f"{chunks} chunks")
    add_launches(launches, took)
    for j, seed in zip(ids, (1, 2)):
        res = svc.result(j).result
        diff = check_fits(f"streamed NELL-2 seed {seed}", res.fits,
                          first["fits"][("nell-2", seed)].fits[
                              :SERVICE_STREAM_SWEEPS])
        per = per_job[j]
        say(f"[service] job {j} (nell-2, seed {seed}, streamed): sweeps "
            f"{[round(s, 4) for s in per]} s (mean {sum(per) / len(per):.4f}"
            f" s); max |dfit| from the resident pool's {diff:.2e}")
    if svc.engine.pool_size or StreamBuffers.pinned_bytes() != pinned0:
        raise AssertionError("[service] the ring outlived its jobs")


def service_snapshot(runs, dev, launches, regimes) -> None:
    """One Uber job on a ``ServiceRuntime`` with a store: snapshotted from
    this (the caller's) thread after sweep 2 while the worker sweeps,
    restored in a fresh runtime (adopted, not rebuilt; disk-streamed) and
    finished; fits against an uninterrupted run."""
    import torch
    from repro_torch.service import ServiceRuntime, SubmitDecomposition
    uber = runs[1]
    store, snap = os.path.join(SERVICE_DIR, "store"), \
        os.path.join(SERVICE_DIR, "snap")
    kw = dict(device_budget_bytes=SERVICE_BUDGET, store_dir=store,
              **SERVICE_KW)
    req = SubmitDecomposition(tensor=uber["tensor"], rank=RANK,
                              iters=SERVICE_DISK_SWEEPS, tol=0.0, seed=3,
                              tenant="umbrella")
    ref = fresh_service(device_budget_bytes=SERVICE_BUDGET, store_dir=store)
    rj = ref.submit(req)
    add_launches(launches, counted(
        lambda: drive(ref, regimes),
        fused_launches(uber, SERVICE_DISK_SWEEPS),
        f"uninterrupted Uber job ({SERVICE_DISK_SWEEPS} sweeps, in memory)"))
    ref_fits = ref.result(rj).result.fits
    from repro_torch.kernels import launch_counts
    before = dict(launch_counts)
    # the runtime's service shares the uninterrupted run's registry: the
    # job runs in memory until the snapshot persists the tensor
    with ServiceRuntime(fresh_service(registry=ref.registry,
                                      device_budget_bytes=SERVICE_BUDGET,
                                      store_dir=store)) as rt:
        jid = rt.submit(req)
        feed = rt.subscribe(jid)
        while True:
            ev = feed.get(timeout=600)
            if ev is None:
                raise AssertionError("[service] no sweep event in 600 s")
            if ev.kind == "iteration" and ev.iteration >= 2:
                break
        rt.unsubscribe(feed)
        t0 = time.perf_counter()
        manifest = rt.snapshot(snap)
        snap_s = time.perf_counter() - t0
    [rec] = manifest["jobs"]
    t0 = time.perf_counter()
    rt2 = ServiceRuntime.restore(snap, **kw)
    restore_s = time.perf_counter() - t0
    st = rt2.status(jid)
    say(f"[service] snapshot of the running Uber job from the caller's "
        f"thread at sweep {rec['iteration']} in {snap_s:.3f} s (tensor "
        f"persisted to {os.path.relpath(store, ROOT)}); restore in "
        f"{restore_s:.3f} s: registry misses {rt2.service.registry.misses}, "
        f"state {st.state}, iteration {st.iteration}, backend {st.backend}")
    if rt2.service.registry.misses != 0 or st.backend != "disk_streamed" \
            or st.iteration != rec["iteration"]:
        raise AssertionError("[service] restore")
    with rt2:
        t0 = time.perf_counter()
        done = rt2.wait(jid, timeout=600)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        fits = rt2.result(jid).result.fits
    took = {k: launch_counts[k] - before[k] for k in KERNELS}
    add_launches(launches, took)
    left = SERVICE_DISK_SWEEPS - rec["iteration"]
    say(f"[service] resumed job {done.state} in {resume_s:.2f} s "
        f"({left} disk-streamed sweeps, {resume_s / max(left, 1):.4f} s "
        f"each); K1/K2 launches of the runtime's sweeps {took}")
    diff = check_fits("restored Uber job", fits, ref_fits)
    say(f"[service] restored fits {fits}; uninterrupted {ref_fits}; "
        f"largest |dfit| {diff:.3e}")
    regimes.setdefault(("disk_streamed (resumed, runtime)", "uber"),
                       []).extend([resume_s / max(left, 1)] * left)


def chaos_run(uber, kind, store, registry, rules=()) -> tuple:
    """Two Uber jobs through a ``ServiceRuntime`` (rank 8, 3 sweeps) under
    the fault rules; ``kind`` "disk" spills every registration (a 1-byte
    host budget)."""
    from repro_torch.faults import FaultPlan, FaultRule, inject
    from repro_torch.service import ServiceRuntime, SubmitDecomposition
    kw = {"host_budget_bytes": 1, "store_dir": store} if kind == "disk" \
        else {}
    svc = fresh_service(registry=registry if kind == "mem" else None,
                        device_budget_bytes=SERVICE_BUDGET, **kw)
    plan = FaultPlan(seed=1234, rules=tuple(
        FaultRule(site, kind=k, nth=n) for site, k, n in rules))
    out = {}
    with inject.active(plan if rules else None):
        with ServiceRuntime(svc) as rt:
            ids = [rt.submit(SubmitDecomposition(
                tensor=uber["tensor"], rank=CHAOS_RANK, iters=CHAOS_SWEEPS,
                tol=0.0, seed=seed, tenant=tenant, weight=w))
                for seed, tenant, w in ((1, "acme", 1.0),
                                        (2, "umbrella", 2.0))]
            if not rt.drain(timeout=600):
                raise AssertionError("[service] chaos workload did not drain")
            for n, j in enumerate(ids):
                st = rt.status(j)
                out[n] = (st.state, st.backend, st.error_payload,
                          rt.result(j).result.fits if st.state == "done"
                          else None)
            metrics = rt.service_metrics()
            alive = rt._error is None
    return out, metrics, alive, svc.registry


def service_chaos(runs, launches) -> None:
    """tests/test_chaos.py's scenarios on Uber at full size: every job done
    (fits within FIT_TOL of the fault-free run) or failed with a payload,
    the worker alive, the admission ledger released."""
    from repro_torch.analysis.sanitize import sanitized
    from repro_torch.kernels import launch_counts
    uber = runs[1]
    store = os.path.join(SERVICE_DIR, "chaos")
    before = dict(launch_counts)
    with sanitized():
        refs, registry = {}, None
        for kind in ("mem", "disk"):
            t0 = time.perf_counter()
            out, _, alive, reg = chaos_run(uber, kind, store, registry)
            registry = registry or reg
            if not alive or any(v[0] != "done" for v in out.values()):
                raise AssertionError(f"[service] fault-free {kind} run: {out}")
            refs[kind] = out
            say(f"[service] chaos reference ({kind}): backends "
                f"{[v[1] for v in out.values()]}, {time.perf_counter() - t0:.2f}"
                f" s")
        for name, (kind, rules) in CHAOS.items():
            t0 = time.perf_counter()
            out, m, alive, _ = chaos_run(uber, kind, store, registry, rules)
            diffs = []
            for n, (state, backend, payload, fits) in out.items():
                if state == "done":
                    diffs.append(check_fits(f"chaos {name} job {n}", fits,
                                            refs[kind][n][3]))
                elif state != "failed" or not payload or not {
                        "type", "message", "where", "transient",
                        "injected"} <= set(payload):
                    raise AssertionError(f"[service] chaos {name}: job {n} "
                                         f"{state} {payload}")
            if not alive or m["admitted_reservation_bytes"] != 0:
                raise AssertionError(f"[service] chaos {name}: worker alive "
                                     f"{alive}, admitted "
                                     f"{m['admitted_reservation_bytes']}")
            say(f"[service] chaos {name} ({kind}): "
                f"{[(v[0], v[1], v[2]['type'] if v[2] else None) for v in out.values()]}; "
                f"retries {m['retries_total']}, demotions "
                f"{m['demotions_total']}, watchdog restarts "
                f"{m['watchdog_restarts']}; max |dfit| of done jobs "
                f"{max(diffs, default=0.0):.2e}; "
                f"{time.perf_counter() - t0:.2f} s")
    add_launches(launches, {k: launch_counts[k] - before[k]
                            for k in KERNELS})


def service_phase(runs, dev) -> dict:
    """The ``[service]`` phase; returns the K1/K2 launches made through the
    service (the solo runs the fits are held against are not counted)."""
    from repro_torch.service import GetMetrics
    t_phase = time.perf_counter()
    shutil.rmtree(SERVICE_DIR, ignore_errors=True)
    launches, regimes = {}, {}
    try:
        first = service_resident(runs, dev, launches, regimes)
        service_streamed(runs, dev, launches, regimes, first)
        service_snapshot(runs, dev, launches, regimes)
        service_chaos(runs, launches)
    finally:
        shutil.rmtree(SERVICE_DIR, ignore_errors=True)
    for (regime, name), secs in sorted(regimes.items()):
        say(f"[service] per-sweep seconds, {name} {regime}: mean "
            f"{sum(secs) / len(secs):.4f} s over {len(secs)} sweeps (min "
            f"{min(secs):.4f}, max {max(secs):.4f})")
    svc = first["service"]
    prom = svc.get_metrics(GetMetrics(format="prometheus"))
    lines = prom.splitlines()
    say(f"[service] render_prometheus: {len(lines)} lines, "
        f"{sum(1 for x in lines if x and not x.startswith('#'))} samples")
    say(f"[service] slo_report: {json.dumps(svc.get_slo(), sort_keys=True)}")
    say(f"[service] {os.path.relpath(SERVICE_DIR, ROOT)} deleted; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------- [sharded]
SHARDED_DIR = os.path.join(ROOT, "build", "sharded")
# the gloo world-2 meshes (data, model) on the one card, and the sweeps
# each worker runs on each
SHARDED_MESHES = ((2, 1), (1, 2))
SHARDED_W2_SWEEPS = 2
SHARDED_W2_TENSOR = "nell-2"
# seconds the parent waits for both workers (each starts torch on the
# card, reads the 2 GB store and runs 18 calls per mesh: under 20 s)
SHARDED_W2_TIMEOUT = 240


def collective_ms(mesh, rows, width, dev) -> float:
    """Median ms of the sharded path's two collectives alone (``all_reduce``
    over the data axis, ``all_gather`` over the model axis) on an (rows,
    width) f32 block, by CUDA events."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.distributed import axis_size
    x = torch.zeros((rows, width), device=dev)
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, "model"))]

    def both():
        dist.all_reduce(x, group=mesh.get_group("data"))
        dist.all_gather(parts, x, group=mesh.get_group("model"))

    return float(np.median(event_times(both, MEDIAN_OF)))


def sharded_world1(run, mesh, dev) -> dict:
    """One tensor through ``plan_for(auto, mesh=(1, 1))`` on an NCCL group
    of one rank: every mode against the in-memory fused output, ``SWEEPS``
    CP-ALS sweeps against the in-memory fits, the launches counted, then
    ms per mode beside the in-memory call and the collectives alone.
    Returns the counted launches."""
    import torch
    from repro_torch.core import cp_als_init, cp_als_step
    from repro_torch.engine import plan_for
    name, dims, fs = run["name"], run["dims"], run["factors"]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    plan = plan_for(run["blco"], torch.cuda.mem_get_info()[0], rank=RANK,
                    mesh=mesh, kernel="cuda", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rise = torch.cuda.memory_allocated() - before
    if plan.backend != "sharded":
        raise AssertionError(f"{name}: plan_for(auto, mesh) picked "
                             f"{plan.backend}")
    say(f"[sharded] {name}: plan_for(auto, mesh (1, 1), NCCL world 1) -> "
        f"{plan.backend} in {build_s:.2f} s; sharded_bytes "
        f"{plan.device_bytes()} B ({plan.device_bytes() / 1e9:.4f} GB), "
        f"memory_allocated rise {rise} B, h2d_bytes "
        f"{plan.stats().h2d_bytes} B; in-memory launch cache "
        f"{run['plan'].device_bytes()} B")

    def body():
        for (mode, d, variant, _), (fused_out, _) in zip(run["modes"],
                                                         run["outs"]):
            out = plan.mttkrp(fs, mode)
            if out.shape != (d, RANK) or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{name} mode {mode}: bad sharded "
                                     f"output")
            rel, fro, diff = check_err(f"{name} mode {mode}: sharded vs "
                                       f"in-memory fused", out, fused_out)
            say(f"[sharded] {name} mode {mode} -> {variant}: vs in-memory "
                f"fused max-rel {rel:.3e}, Frobenius-rel {fro:.3e} (max abs "
                f"{diff:.3e})")
        state = cp_als_init(dims, RANK, norm_x=run["norm_x"], tol=0.0,
                            seed=SEED, device=dev)
        for sweep in range(SWEEPS):
            t0 = time.perf_counter()
            cp_als_step(plan, state)
            torch.cuda.synchronize()
            say(f"[sharded] {name} cp_als sharded sweep {sweep}: "
                f"{time.perf_counter() - t0:.4f} s, fit "
                f"{state.fits[-1]:.6f}")
        diff = check_fits(f"{name} sharded world 1", state.fits, run["fits"],
                          tag="[sharded]")
        say(f"[sharded] {name}: fits {state.fits} (max diff from the "
            f"in-memory fits {diff:.2e})")

    took = counted(body, fused_launches(run, 1 + SWEEPS),
                   f"{name} sharded world 1", tag="[sharded]")
    for mode, d, variant, _ in run["modes"]:
        ms = float(np.median(event_times(lambda: plan.mttkrp(fs, mode),
                                         MEDIAN_OF)))
        mem_ms = float(np.median(event_times(
            lambda: run["plan"].mttkrp(fs, mode), MEDIAN_OF)))
        coll = collective_ms(mesh, d, RANK, dev)
        # one model rank's column block on a (1, 2) mesh: half of each
        # warp's 32 lanes have no column
        half = [f[:, :RANK // 2].contiguous() for f in fs]
        half_ms = float(np.median(event_times(
            lambda: run["plan"].mttkrp(half, mode), MEDIAN_OF)))
        say(f"[sharded] {name} mode {mode} ({variant}): sharded "
            f"{ms:.4f} ms, in memory {mem_ms:.4f} ms, sharded / in memory "
            f"{ms / mem_ms:.3f}; collectives alone {coll:.4f} ms "
            f"({coll / ms:.3f} of the sharded call); in memory at R = "
            f"{RANK // 2} {half_ms:.4f} ms ({half_ms / mem_ms:.3f} of R = "
            f"{RANK})")
    say(f"[sharded] {name}: EngineStats "
        f"{json.dumps(plan.stats().snapshot())}")
    plan.close()
    return took


def sharded_world2(run, dev) -> dict:
    """Two gloo ranks on the one card (NCCL refuses two ranks on one GPU),
    each a worker process (``chip_smoke.py --sharded-worker RANK``) that
    opens ``[disk]``'s store of ``run`` and builds only its own shard, on
    the meshes ``SHARDED_MESHES``; the factors and the in-memory fused
    outputs are handed over as files under ``build/sharded/``.  Checks the
    workers' exits, their factors bitwise across ranks and their launches;
    returns the launches both made."""
    name, dims = run["name"], run["dims"]
    factors, outs = [], []
    for m, f in enumerate(run["factors"]):
        factors.append(os.path.join(SHARDED_DIR, f"factor{m}.npy"))
        np.save(factors[-1], f.cpu().numpy())
    for mode, (fused_out, _) in enumerate(run["outs"]):
        outs.append(os.path.join(SHARDED_DIR, f"out{mode}.npy"))
        np.save(outs[-1], fused_out.cpu().numpy())
    cfg = {"store": run["disk_plan"].stored.path, "dims": list(dims),
           "norm_x": run["norm_x"], "fits": run["fits"],
           "factors": factors, "outs": outs,
           "variants": [v for _, _, v, _ in run["modes"]]}
    with open(os.path.join(SHARDED_DIR, "config.json"), "w") as f:
        json.dump(cfg, f)
    logs = [os.path.join(SHARDED_DIR, f"worker{r}.log") for r in range(2)]
    t0 = time.perf_counter()
    procs = []
    try:
        for r in range(2):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--sharded-worker", str(r)], stdout=log,
                    stderr=subprocess.STDOUT))
        deadline = time.perf_counter() + SHARDED_W2_TIMEOUT
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for path in logs:
            if os.path.isfile(path):
                with open(path) as f:
                    for line in f.read().splitlines():
                        say(line)
    codes = [p.returncode for p in procs]
    if codes != [0, 0]:
        raise AssertionError(f"[sharded] world-2 workers exited {codes}")
    took = {}
    reports = []
    for r in range(2):
        with open(os.path.join(SHARDED_DIR, f"report{r}.json")) as f:
            reports.append(json.load(f))
        add_launches(took, reports[-1]["launches"])
    for shape in SHARDED_MESHES:
        tag = f"{shape[0]}x{shape[1]}"
        for m in range(len(dims)):
            a, b = (np.load(os.path.join(SHARDED_DIR,
                                         f"{tag}_factor{m}_r{r}.npy"))
                    for r in range(2))
            if not np.array_equal(a, b):
                raise AssertionError(f"[sharded] mesh {shape}: factor {m} "
                                     f"differs between the ranks")
    per_rank = fused_launches(run, len(SHARDED_MESHES)
                              * (1 + SHARDED_W2_SWEEPS))
    want = {k: 2 * n for k, n in per_rank.items()}
    if took != {k: want.get(k, 0) for k in KERNELS}:
        raise AssertionError(f"[sharded] world-2 workers launched {took}, "
                             f"expected {want}")
    say(f"[sharded] {name} gloo world 2: both workers exited 0 in "
        f"{time.perf_counter() - t0:.1f} s; factors bitwise equal across "
        f"the ranks on {list(SHARDED_MESHES)}; K1/K2 launches {took} "
        f"(2 ranks x meshes x modes x (1 + {SHARDED_W2_SWEEPS}) calls)")
    return took


def sharded_worker(rank: int) -> int:
    """One rank of ``sharded_world2``: returns 0 when every check held."""
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import cp_als_init, cp_als_step
    from repro_torch.dist import make_mesh
    from repro_torch.engine import plan_for
    from repro_torch.kernels import launch_counts
    from repro_torch.store import open_blco
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with open(os.path.join(SHARDED_DIR, "config.json")) as f:
        cfg = json.load(f)
    dims = tuple(cfg["dims"])
    t0 = time.perf_counter()
    with open_blco(cfg["store"]) as stored:
        b = stored.to_blco()
    load_s = time.perf_counter() - t0
    fs = [torch.from_numpy(np.load(p)).to(dev) for p in cfg["factors"]]
    wants = [torch.from_numpy(np.load(p)).to(dev) for p in cfg["outs"]]
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(SHARDED_DIR, 'store2')}",
        rank=rank, world_size=2)
    pre = f"[sharded] rank {rank}:"
    say(f"{pre} open_blco(...).to_blco() {load_s:.2f} s, nnz {b.nnz}")
    took = {k: 0 for k in KERNELS}
    try:
        for shape in SHARDED_MESHES:
            mesh = make_mesh(shape)
            tag = f"{shape[0]}x{shape[1]}"
            t0 = time.perf_counter()
            plan = plan_for(b, torch.cuda.mem_get_info()[0], rank=RANK,
                            mesh=mesh, kernel="cuda", device=dev)
            torch.cuda.synchronize()
            say(f"{pre} mesh {shape}: plan_for -> {plan.backend} in "
                f"{time.perf_counter() - t0:.2f} s, this rank's shard "
                f"{plan.stats().h2d_bytes} B of {plan.device_bytes()} B "
                f"mesh-wide")
            if plan.backend != "sharded":
                raise AssertionError(f"plan_for picked {plan.backend}")
            before = dict(launch_counts)
            for mode, want in enumerate(wants):
                out = plan.mttkrp(fs, mode)
                rel, fro, _ = check_err(f"{pre} mesh {shape} mode {mode}",
                                        out, want)
                say(f"{pre} mesh {shape} mode {mode}: vs the parent's "
                    f"in-memory fused output max-rel {rel:.3e}, "
                    f"Frobenius-rel {fro:.3e}")
            state = cp_als_init(dims, RANK, norm_x=cfg["norm_x"], tol=0.0,
                                seed=SEED, device=dev)
            for _ in range(SHARDED_W2_SWEEPS):
                cp_als_step(plan, state)
            diff = check_fits(f"mesh {shape}", state.fits,
                              cfg["fits"][:SHARDED_W2_SWEEPS], tag=pre)
            say(f"{pre} mesh {shape}: fits {state.fits} (max diff from "
                f"the in-memory fits {diff:.2e})")
            for k in KERNELS:
                took[k] += launch_counts[k] - before[k]
            for m, f in enumerate(state.factors):
                np.save(os.path.join(SHARDED_DIR,
                                     f"{tag}_factor{m}_r{rank}.npy"),
                        f.cpu().numpy())
            for mode, d in enumerate(dims):
                ms = float(np.median(event_times(
                    lambda: plan.mttkrp(fs, mode), MEDIAN_OF)))
                coll = collective_ms(mesh, d, RANK // shape[1], dev)
                say(f"{pre} mesh {shape} mode {mode} ({cfg['variants'][mode]}"
                    f", R/M = {RANK // shape[1]}): sharded {ms:.4f} ms, "
                    f"collectives alone {coll:.4f} ms ({coll / ms:.3f})")
            plan.close()
            dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(SHARDED_DIR, f"report{rank}.json"), "w") as f:
        json.dump({"launches": took}, f)
    return 0


def sharded_phase(runs, dev) -> dict:
    """The ``[sharded]`` phase: both tensors at NCCL world 1 in this
    process, then NELL-2 at gloo world 2 in two workers; returns the K1/K2
    launches of their main-path calls."""
    import torch.distributed as dist
    from repro_torch.dist import make_mesh
    t_phase = time.perf_counter()
    shutil.rmtree(SHARDED_DIR, ignore_errors=True)
    os.makedirs(SHARDED_DIR)
    launches = {}
    try:
        dist.init_process_group(
            "nccl",
            init_method=f"file://{os.path.join(SHARDED_DIR, 'store1')}",
            rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1))
            for run in runs:
                add_launches(launches, sharded_world1(run, mesh, dev))
        finally:
            dist.destroy_process_group()
        for run in runs:
            if run["name"] == SHARDED_W2_TENSOR:
                add_launches(launches, sharded_world2(run, dev))
    finally:
        shutil.rmtree(SHARDED_DIR, ignore_errors=True)
    say(f"[sharded] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------ [analysis]
def lint_check() -> None:
    """The AST tier over the port and this script against the port's
    baseline: no finding outside it and no stale entry."""
    from repro_torch.analysis import BASELINE_PATH, Baseline, lint_paths
    t0 = time.perf_counter()
    findings = lint_paths([os.path.join(ROOT, "src", "repro_torch"),
                           os.path.abspath(__file__)], root=ROOT)
    baseline = Baseline.load(BASELINE_PATH)
    loose = [f.render() for f in findings if not baseline.suppresses(f)]
    stale = baseline.stale_entries(findings)
    say(f"[analysis] lint: {len(findings)} findings, "
        f"{len(findings) - len(loose)} in the baseline of "
        f"{len(baseline.entries)} entries, {len(loose)} outside it, "
        f"{len(stale)} stale; {time.perf_counter() - t0:.2f} s")
    if loose or stale:
        raise AssertionError(f"[analysis] lint: {loose} outside the "
                             f"baseline, stale {stale}")


def encoding_check(runs) -> None:
    """``prove_encoding`` for every BLCO the smoke built (the main path's
    and ``[stream]``'s rebuilds), and ``verify_layout`` of each one's own
    layout: no finding, and the proven fields are the BLCO's."""
    from repro_torch.analysis.trace import prove_encoding, verify_layout
    for run in runs:
        for tag, b in (("main", run["blco"]),
                       (f"max_nnz_per_block={STREAM[run['name']][0]}",
                        run["stream_blco"])):
            t0 = time.perf_counter()
            symbol = f"encoding[{run['name']} {tag}]"
            proof, found = prove_encoding(b.dims, target_bits=64,
                                          symbol=symbol)
            found += verify_layout(b.dims, b.spec, b.re, symbol=symbol)
            if found or proof is None or \
                    (proof.field_bits, proof.field_shift) != \
                    (b.re.field_bits, b.re.field_shift):
                raise AssertionError(f"[analysis] {symbol}: "
                                     f"{[f.message for f in found]}")
            straddle = [m for m, (w, s) in enumerate(zip(
                proof.field_bits, proof.field_shift)) if s < 32 < s + w]
            say(f"[analysis] {symbol}: proven in "
                f"{time.perf_counter() - t0:.3f} s, 0 findings; fields "
                f"{proof.field_bits} shifts {proof.field_shift} (stored "
                f"{proof.stored_bits} of 64 bits), block bits "
                f"{proof.block_bits}, modes straddling the word pair "
                f"{straddle}, max coordinates {proof.max_coord}")


def conflict_check(runs) -> dict:
    """``conflict_report`` for every (tensor, mode) of the main path, and
    K4 launched on the launch cache's flat stream at the report's tile:
    its runs per launch must equal the report's segments + padding
    segments exactly.  Returns K4's launches."""
    import torch
    from repro_torch.analysis.trace import (conflict_report, k4_runs,
                                            report_runs)
    from repro_torch.kernels import launch_counts
    # the reports are host numpy, which releases the GIL: one thread per
    # (tensor, mode), all at once
    pairs = [(run, mode) for run in runs for mode, *_ in run["modes"]]
    t_reports = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(pairs)) as pool:
        reports = dict(zip(
            [(run["name"], mode) for run, mode in pairs],
            pool.map(lambda rm: timed(conflict_report, rm[0]["blco"], rm[1]),
                     pairs)))
    say(f"[analysis] {len(pairs)} conflict reports in "
        f"{time.perf_counter() - t_reports:.2f} s, one thread each")
    took = {}
    for run in runs:
        cache = run["plan"].resident.cache
        for mode, d, _, _ in run["modes"]:
            report, secs = reports[(run["name"], mode)]
            if report["reservation"] != cache.reservation:
                raise AssertionError(f"[analysis] {run['name']} mode {mode}:"
                                     f" the report's reservation "
                                     f"{report['reservation']}, the cache's "
                                     f"{cache.reservation}")
            want = report_runs(report)
            before = dict(launch_counts)
            t0 = time.perf_counter()
            got = k4_runs(cache, run["factors"], mode, tile=report["tile"])
            torch.cuda.synchronize()
            k4_s = time.perf_counter() - t0
            add_launches(took, {k: launch_counts[k] - before[k]
                                for k in KERNELS})
            pad = sum(l["padding_segments"] for l in report["launches"])
            say(f"[analysis] {run['name']} mode {mode} (I={d}): report "
                f"{secs:.2f} s (its thread), tile {report['tile']}, "
                f"reservation "
                f"{report['reservation']} x {len(report['launches'])} "
                f"launches, segments {report['total_segments']} + padding "
                f"segments {pad}, max writers per row "
                f"{report['max_writers_per_row_per_step']}, unique sound "
                f"{report['unique_indices_sound']}; K4 runs per launch "
                f"{got} ({k4_s:.2f} s)")
            if got != want:
                raise AssertionError(f"[analysis] {run['name']} mode {mode}:"
                                     f" K4 wrote {got} runs per launch, the "
                                     f"report counts {want}")
            torch.cuda.empty_cache()
    return took


def hot_path_check(runs) -> dict:
    """``run_trace_tier`` with the registered hot paths built over each
    tensor's launch cache and factors at full width: the recorder and the
    card's sync debug mode find nothing outside an inline disable.
    Returns the kernel launches the paths made."""
    import torch
    from repro_torch.analysis.trace import (registered_hot_paths,
                                            run_trace_tier)
    from repro_torch.kernels import launch_counts
    torch.cuda.empty_cache()
    before = dict(launch_counts)
    paths = []
    for run in runs:
        paths += registered_hot_paths(cache=run["plan"].resident.cache,
                                      factors=run["factors"])
    t0 = time.perf_counter()
    found, bundle, m = run_trace_tier(hot_paths=paths)
    secs = time.perf_counter() - t0
    names = [r["name"] for r in runs]
    for hp in bundle["hot_paths"]:
        say(f"[analysis] hot path {hp['name']} on {hp['device']} "
            f"({hp['dims']}): {hp['calls']} torch calls recorded, "
            f"{hp['writes']} indexed writes, {hp['findings']} findings, "
            f"refused under an inline disable {hp['suppressed']}; "
            f"{hp['seconds']:.3f} s")
    say(f"[analysis] run_trace_tier over {len(paths)} full-width paths of "
        f"{names}: {len(found)} findings; {json.dumps(m.snapshot())}; "
        f"{secs:.2f} s")
    if found:
        raise AssertionError(f"[analysis] trace tier: "
                             f"{[f.render() for f in found]}")
    return {k: launch_counts[k] - before[k] for k in KERNELS}


def analysis_phase(runs) -> dict:
    """The ``[analysis]`` phase; returns the kernel launches it made (K4
    held against the reports, K1/K2 under the hot-path audit)."""
    import torch
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    lint_check()
    encoding_check(runs)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    held = conflict_check(runs)
    if dict(launch_counts) != {k: held.get(k, 0) for k in KERNELS} or \
            held.get("segments", 0) != sum(len(r["modes"]) for r in runs):
        raise AssertionError(f"[analysis] K4 launches {dict(launch_counts)}"
                             f", expected one per (tensor, mode)")
    reset_launch_counts()
    audited = hot_path_check(runs)
    if dict(launch_counts) != {k: audited.get(k, 0) for k in KERNELS}:
        raise AssertionError(f"[analysis] the hot-path audit launched "
                             f"{dict(launch_counts)}")
    say(f"[analysis] kernel launches: K4 against the reports {held}; the "
        f"hot-path audit {audited}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    launches = {}
    add_launches(launches, held)
    add_launches(launches, audited)
    return launches


# ------------------------------------------------------------ [examples]
# the chaos lane's plan (scripts/chaos_soak.py's docstring), then one
# allocation fault
SOAK_PLANS = ("1234:store.read@n=2:transient;runtime.quantum@n=3:crash",
              "1234:plan.alloc@n=1")
EXAMPLES_DIR = os.path.join(ROOT, "build", "examples")
DELTA = re.compile(r"max \|d(fit|factor)\| ([0-9.e+-]+)")


def held_bytes() -> tuple[int, int]:
    """The pinned bytes of the port's open rings and the device bytes
    allocated, after a collection.  cuBLAS keeps a workspace per thread's
    handle in the caching allocator (32 MiB on the H100), and every
    service runtime sweeps on a thread of its own: the workspaces are
    freed first, as they are the library's, not the port's."""
    import gc
    import torch
    from repro_torch.core.streaming import StreamBuffers
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return StreamBuffers.pinned_bytes(), torch.cuda.memory_allocated()


def entry_point(name, main, argv) -> tuple[str, dict]:
    """``main(argv)`` on the card, its output captured and then printed:
    it must return 0 and leave the pinned rings and the allocated device
    bytes where they were.  Returns its output and the K1/K2 launches this
    process made in it."""
    import contextlib
    import io
    import torch
    from repro_torch.kernels import launch_counts
    held = held_bytes()
    before = dict(launch_counts)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        torch.cuda.synchronize()
    finally:
        for line in buf.getvalue().splitlines():
            say(f"[examples] {name}: {line}")
    secs = time.perf_counter() - t0
    took = {k: launch_counts[k] - before[k] for k in KERNELS}
    after = held_bytes()
    deltas = {}
    for kind, value in DELTA.findall(buf.getvalue()):
        deltas[kind] = max(deltas.get(kind, 0.0), float(value))
    say(f"[examples] {name}: exit {rc} in {secs:.2f} s; K1/K2 launches in "
        f"this process {took['segment']}/{took['stash']}; largest "
        f"|dfit| {deltas.get('fit', 'not printed')}, |dfactor| "
        f"{deltas.get('factor', 'not printed')}; pinned and allocated "
        f"bytes {held} before, {after} after")
    if rc != 0:
        raise AssertionError(f"[examples] {name} exited {rc}")
    if after != held:
        raise AssertionError(f"[examples] {name} left pinned and allocated "
                             f"bytes {after}, found {held}")
    return buf.getvalue(), took


def restore_env(name, value) -> None:
    """Set ``name`` back to ``value`` (None: unset)."""
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def examples_phase() -> tuple[dict, dict]:
    """The ``[examples]`` phase: every entry point of the port at its
    reference script's sizes on the card (the soak under each plan of
    ``SOAK_PLANS`` with the sanitizer on); returns the K1/K2 launches
    made in this process and those the distributed example's ranks
    reported."""
    from repro_torch.examples import (distributed_cpals, oom_decomposition,
                                      quickstart, serve_lm, serve_td)
    from repro_torch.faults import inject
    from repro_torch.scripts import chaos_soak, lint
    t_phase = time.perf_counter()
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    os.makedirs(EXAMPLES_DIR)
    launches = {}
    sanitize = os.environ.get("REPRO_SANITIZE")
    try:
        for name, module in (("quickstart", quickstart),
                             ("oom_decomposition", oom_decomposition),
                             ("serve_td", serve_td),
                             ("serve_lm", serve_lm)):
            add_launches(launches, entry_point(name, module.main, [])[1])
        os.environ["REPRO_SANITIZE"] = "1"
        for i, spec in enumerate(SOAK_PLANS):
            inject.install(spec)
            _, took = entry_point(
                f"chaos_soak[{i}]", chaos_soak.main,
                ["--trace-out",
                 os.path.join(EXAMPLES_DIR, f"chaos_trace{i}.json")])
            inject.uninstall()
            add_launches(launches, took)
        restore_env("REPRO_SANITIZE", sanitize)
        add_launches(launches, entry_point("lint --tier all", lint.main,
                                           ["--tier", "all"])[1])
        out, _ = entry_point("distributed_cpals", distributed_cpals.main, [])
        ranks = [json.loads(line) for line in
                 re.findall(r"^\[rank \d+\] (\{.*\})$", out, re.M)]
        if len(ranks) != distributed_cpals.WORLD:
            raise AssertionError(f"[examples] distributed_cpals: "
                                 f"{len(ranks)} rank reports")
        in_ranks = {}
        for rep in ranks:
            add_launches(in_ranks, rep["launches"])
        say(f"[examples] distributed_cpals: K1/K2 launches of the "
            f"{len(ranks)} ranks {in_ranks['segment']}/{in_ranks['stash']}")
    finally:
        inject.uninstall()
        restore_env("REPRO_SANITIZE", sanitize)
        shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    say(f"[examples] phase {time.perf_counter() - t_phase:.1f} s")
    return ({k: launches.get(k, 0) for k in KERNELS},
            {k: in_ranks.get(k, 0) for k in KERNELS})


# --------------------------------------------------------------- [serve]
# the served LM at full width and depth; serve_lm's default request sizes
SERVE_ARCH, SERVE_LAYERS, SERVE_PARAMS = "minicpm-2b", 40, 2_725_173_504
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 12, 24
# GQA grouping (G = 5), QKV bias, an untied head and rope theta 1e6 at
# full width, the depth cut from 48 layers to 4 to fit beside the rest
SERVE_CUT = ("qwen2.5-14b", 4, 2_658_214_912)
CUT_BATCH, CUT_PROMPT, CUT_NEW = 2, 6, 8
CONSISTENCY = (2, 16)       # decode vs forward: batch, positions
CONSISTENCY_TOL = 2e-3      # the reference's own bound (tests/test_models.py)
# card vs CPU on the same weights, the first 2 layers at full width:
# f32 without TF32 differs only in the GEMMs' order of additions; bf16
# within the CPU tests' bf16 logits tolerance
CARD_CPU_LAYERS = 2
CARD_CPU_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
EMBED_IDS = (8, 2048)       # embed_grad's ids at minicpm's (V, D) table
EMBED_TOL = 2e-4            # segment vs scatter (tests/test_embed_grad.py)
DECODE_MARK = "decode_step"


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float64 on the host."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def decode_vs_forward(model, cfg, dev, tag) -> None:
    """f32 compute on the model's weights: each decode step's logits
    against the teacher-forced forward's; raises past the bound."""
    import dataclasses
    import torch
    from repro_torch.models import transformer
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    b, s = CONSISTENCY
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).to(dev)
    with torch.no_grad():
        ref, _ = transformer.forward(model, c32, {"tokens": toks})
    cache = transformer.init_cache(c32, b, s, torch.float32, device=dev)
    dec = torch.cat([transformer.decode_step(model, c32, cache,
                                             toks[:, t:t + 1], t)[0]
                     for t in range(s)], dim=1)
    rel = rel_err(dec, ref)
    say(f"[serve] {tag}: decode vs forward, f32, B {b}, S {s}: max|d|/max|"
        f"ref| {rel:.3e} (bound {CONSISTENCY_TOL})")
    if not rel < CONSISTENCY_TOL:
        raise AssertionError(f"[serve] {tag}: decode vs forward {rel:.3e}")


def serve_requests(model, cfg, dev, tag, batch, plen, n_new) -> np.ndarray:
    """``Server.generate`` (bf16, greedy) twice on the same prompts: the
    tokens must be equal; then row 0 alone.  Prints each run's seconds
    and tokens/s and the agreement of the solo run."""
    import torch
    from repro_torch.serving import ServeConfig, Server
    srv = Server(cfg, ServeConfig(max_len=plen + n_new), model, device=dev)
    prompts = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (batch, plen)).astype(np.int32)
    outs = []
    for run in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(srv.generate(prompts, n_new))
        dt = time.perf_counter() - t0
        say(f"[serve] {tag}: generate {batch} x ({plen} + {n_new}) run "
            f"{run}: {dt:.3f} s, {batch * n_new / dt:.1f} new tokens/s, "
            f"{batch * (plen + n_new) / dt:.1f} steps x rows/s")
    if not np.array_equal(outs[0], outs[1]):
        raise AssertionError(f"[serve] {tag}: two greedy runs differ: "
                             f"{outs[0].tolist()} vs {outs[1].tolist()}")
    if outs[0].shape != (batch, n_new) or not (
            (outs[0] >= 0) & (outs[0] < cfg.padded_vocab)).all():
        raise AssertionError(f"[serve] {tag}: tokens {outs[0].tolist()}")
    solo = srv.generate(prompts[:1], n_new)
    say(f"[serve] {tag}: greedy tokens bitwise equal across the two runs; "
        f"row 0 alone agrees with the batch on "
        f"{int((solo[0] == outs[0][0]).sum())} of {n_new} tokens; row 0: "
        f"{outs[0][0].tolist()}")
    return prompts


def decode_timing(model, cfg, dev, prompts, n_new) -> dict:
    """The server's loop, timed: the prefill to the first token on the
    host (time to first token), each later decode step between CUDA
    events (median), and the casts of the f32 weights to bf16 that every
    step makes (all of them, timed alone)."""
    import statistics
    import torch
    b, plen = prompts.shape
    cache = model.init_cache(b, plen + n_new)
    toks = torch.from_numpy(prompts).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for t in range(plen):
            logits, _ = model.decode_step(cache, toks[:, t:t + 1], t)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        tok.cpu()
        ttft = time.perf_counter() - t0
        steps, issue = [], []
        for i in range(n_new):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            t1 = time.perf_counter()
            logits, _ = model.decode_step(cache, tok, plen + i)
            issue.append((time.perf_counter() - t1) * 1e3)
            stop.record()
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            tok.cpu()
            steps.append(start.elapsed_time(stop))
        split = profile_decode_step(model, cache, tok, plen + n_new - 1)
        pos = plen + n_new - 1
        cal, _ = measured_step(
            lambda m, c, t: m.decode_step(c, t, pos), (model, cache, tok),
            dev)
        CALIBRATION["decode"] = dict(
            cal, cfg=cfg, step_ms=statistics.median(steps), pos=pos,
            cache=(b, plen + n_new), tok=(tuple(tok.shape), tok.dtype))
    weights = [p for p in model.parameters() if p.dim() == 2]
    cast_ms = event_ms(lambda: [w.to(torch.bfloat16) for w in weights])
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    del cache
    return {"ttft_s": ttft, "step_ms": statistics.median(steps),
            "step_min_ms": min(steps), "issue_ms": statistics.median(issue),
            "cast_ms": cast_ms, "cache_bytes": cache_bytes,
            "cast_bytes": sum(w.numel() * 6 for w in weights),
            "split": split}


def profile_decode_step(model, cache, tok, pos) -> str:
    """One decode step under ``torch.profiler``: device busy and idle ms
    in the step's host span, the device events and the largest kernels
    (``device_split``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(DECODE_MARK):
            model.decode_step(cache, tok, pos)
            torch.cuda.synchronize()
    marks = [e.time_range for e in prof.events()
             if e.name == DECODE_MARK and e.device_type == DeviceType.CPU]
    split = device_split(prof, (marks[0].start, marks[0].end)) \
        if marks else {"events": 0}
    if not split["events"]:
        return "the profiler recorded no device events: not measured"
    top = "; ".join(f"{n} {us / 1e3:.3f}"
                    for n, us in split.pop("top other kernels"))
    return (f"{(marks[0].end - marks[0].start) / 1e3:.3f} ms under the "
            f"profiler, device busy {split['device busy']:.3f}, idle "
            f"{split['device idle']:.3f} ms, {split['events']} device "
            f"events; largest kernels (ms): {top}")


def card_vs_cpu(model, cfg, dev) -> None:
    """The embedding, the first ``CARD_CPU_LAYERS`` layers and ``ln_f``
    copied to the CPU: the forward's logits on both, f32 and bf16."""
    import dataclasses
    import torch
    from repro_torch.models import transformer
    c2 = dataclasses.replace(cfg, num_layers=CARD_CPU_LAYERS)
    card = transformer.init_params(c2, device=dev)
    keys = set(card.state_dict())
    card.load_state_dict({k: v for k, v in model.state_dict().items()
                          if k in keys})
    cpu = transformer.init_params(c2, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    b, s = CONSISTENCY
    toks = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32))
    for cd, tol in CARD_CPU_TOL.items():
        c = dataclasses.replace(c2, compute_dtype=cd)
        t0 = time.perf_counter()
        with torch.no_grad():
            got, _ = transformer.forward(card, c, {"tokens": toks.to(dev)})
            want, _ = transformer.forward(cpu, c, {"tokens": toks})
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rel = rel_err(got, want)
        say(f"[serve] {cfg.name} first {CARD_CPU_LAYERS} layers, {cd}: card "
            f"vs CPU logits max|d|/max|ref| {rel:.3e} (bound {tol}; both "
            f"forwards {secs:.2f} s)")
        if not rel <= tol:
            raise AssertionError(f"[serve] card vs CPU, {cd}: {rel:.3e}")


def serve_model(arch, layers, params_want, dev, sizes, full) -> None:
    """One config on the card: build it from the port's generator, check
    its parameter count, decode vs forward, serve; for the full config
    also time the loop and hold the card against the CPU."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, param_count
    cfg = get_config(arch)
    if layers != cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    tag = f"{cfg.name} x {layers} layers"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n = param_count(model)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    say(f"[serve] {tag}: d_model {cfg.d_model}, heads {cfg.num_heads} (kv "
        f"{cfg.num_kv_heads}), d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
        f"padded to {cfg.padded_vocab}, tied head {cfg.tie_embeddings}: "
        f"{n:,} parameters, {nbytes:,} B ({cfg.param_dtype}), drawn on the "
        f"card in {time.perf_counter() - t0:.2f} s")
    if n != params_want:
        raise AssertionError(f"[serve] {tag}: {n} parameters, expected "
                             f"{params_want}")
    decode_vs_forward(model, cfg, dev, tag)
    batch, plen, n_new = sizes
    prompts = serve_requests(model, cfg, dev, tag, batch, plen, n_new)
    if full:
        tm = decode_timing(model, cfg, dev, prompts, n_new)
        say(f"[serve] {tag}: time to first token ({plen}-token prefill, "
            f"batch {batch}) {tm['ttft_s'] * 1e3:.2f} ms; decode step median "
            f"{tm['step_ms']:.3f} ms (min {tm['step_min_ms']:.3f}; CUDA "
            f"events, {n_new} steps), {batch * 1e3 / tm['step_ms']:.1f} "
            f"tokens/s at that step time; cache {tm['cache_bytes']:,} B "
            f"(bf16); host issue of a step median {tm['issue_ms']:.3f} ms; "
            f"the f32 -> bf16 casts of the weights alone "
            f"{tm['cast_ms']:.3f} ms per step ({tm['cast_bytes']:,} B read "
            f"and written, {tm['cast_bytes'] / tm['cast_ms'] / 1e6:.1f} "
            f"GB/s)")
        say(f"[serve] {tag}: one decode step: {tm['split']}")
        card_vs_cpu(model, cfg, dev)
    say(f"[serve] {tag}: peak max_memory_allocated "
        f"{torch.cuda.max_memory_allocated():,} B")
    del model


def embed_grad_check(dev) -> None:
    """embed_grad at minicpm's (V, D) table: ids of Zipf(1.3) ranks, the
    segment resolution against the scatter, the autograd backward equal
    to ``_grad_segment`` (index_add_'s deterministic form), ms of each."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import embedding_lookup
    from repro_torch.core.embed_grad import _grad_scatter, _grad_segment
    cfg = get_config(SERVE_ARCH)
    vocab, d = cfg.padded_vocab, cfg.d_model
    ids_np = (np.random.default_rng(SEED).zipf(1.3, size=EMBED_IDS)
              % vocab).astype(np.int32)
    ids = torch.from_numpy(ids_np).to(dev)
    g = torch.randn(EMBED_IDS + (d,), device=dev,
                    generator=torch.Generator(dev).manual_seed(SEED))
    seg = _grad_segment(ids, g, vocab)
    sc = _grad_scatter(ids.reshape(-1), g.reshape(-1, d), vocab)
    diff = float((seg - sc).abs().max())
    rel = diff / float(sc.abs().max())
    if not torch.allclose(seg, sc, rtol=EMBED_TOL, atol=EMBED_TOL):
        raise AssertionError(f"[serve] embed_grad segment vs scatter: max "
                             f"|d| {diff:.3e}")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        table = torch.zeros((vocab, d), device=dev, requires_grad=True)
        embedding_lookup(table, ids, "segment").backward(g)
        want = _grad_segment(ids, g, vocab)
    finally:
        torch.use_deterministic_algorithms(False)
    if not torch.equal(table.grad, want):
        raise AssertionError("[serve] embed_grad: the autograd backward "
                             "differs from _grad_segment")
    del table, want
    seg_ms = event_ms(lambda: _grad_segment(ids, g, vocab))
    sc_ms = event_ms(lambda: _grad_scatter(ids.reshape(-1),
                                           g.reshape(-1, d), vocab))
    distinct = sum(len(np.unique(row)) for row in ids_np)
    say(f"[serve] embed_grad ({vocab} x {d} f32 table, ids {EMBED_IDS} "
        f"Zipf(1.3)): segment vs scatter within rtol = atol = {EMBED_TOL}"
        f" (max |d| {diff:.3e}, max |d| / max |scatter| {rel:.3e}); autograd backward bitwise equal to _grad_segment; "
        f"segment {seg_ms:.3f} ms, scatter {sc_ms:.3f} ms (CUDA events, "
        f"median of {MEDIAN_OF}); {distinct:,} distinct (row, token) "
        f"updates against {ids_np.size:,} occurrences")


def serve_phase(dev) -> None:
    """The ``[serve]`` phase: the served LM at full width and depth, the
    depth-cut qwen, ``embed_grad``; device memory back where it was."""
    t_phase = time.perf_counter()
    held = held_bytes()
    serve_model(SERVE_ARCH, SERVE_LAYERS, SERVE_PARAMS, dev,
                (SERVE_BATCH, SERVE_PROMPT, SERVE_NEW), full=True)
    arch, layers, want = SERVE_CUT
    serve_model(arch, layers, want, dev, (CUT_BATCH, CUT_PROMPT, CUT_NEW),
                full=False)
    embed_grad_check(dev)
    after = held_bytes()
    if after != held:
        raise AssertionError(f"[serve] left pinned and allocated bytes "
                             f"{after}, found {held}")
    say(f"[serve] phase {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------------- [train]
# minicpm-2b at full width and depth, trained in place (donate=True) on
# SyntheticLM batches at the reference's train_4k sequence (4096), its
# global batch of 256 cut to 1: the card holds the f32 parameters,
# gradients, m and v (43.6 GB) beside the step's activations
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_PARAMS = "minicpm-2b", 40, 2_725_173_504
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 1, 4096, 6
# AdamW as the launcher's (peak 3e-4) with the config's WSD schedule over
# the phase's 6 steps: warmup at step 1, the plateau at 2-5, the decay's
# last step at 6
TRAIN_OPT = dict(peak_lr=3e-4, warmup=2, total_steps=TRAIN_STEPS)
LR_TOL = 1e-6               # the device schedule against the host's
# card vs CPU: one out-of-place f32 step at full width over 2 layers on
# (1, 128); the loss and the grad norm differ only in the order of the
# GEMMs' additions, the parameters by at most a tenth of lr (AdamW's
# normalisation moves an element whose gradient is at the rounding noise
# by up to 2 lr: tests/test_torch_trainer.py holds the reference so)
CARD_CPU_TRAIN = (2, 1, 128)
CARD_CPU_LOSS_TOL = 1e-5
CARD_CPU_PARAM_LR = 0.1
# the Trainer at full width over 2 layers: ckpt_dir under build/train/
TRAINER_DIR = os.path.join(ROOT, "build", "train")
TRAINER_LAYERS, TRAINER_STEPS, TRAINER_EVERY = 2, 6, 3
RESUME_TOL = 1e-6           # tests/test_trainer.py::test_resume_bit_exact
TRAIN_MARK = "train_step"
GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")
# the ops of core/embed_grad.py::_grad_segment, which nothing else in the
# step calls
LOOKUP_OPS = ("aten::sort", "aten::gather", "aten::cumsum",
              "aten::index_add_", "aten::scatter_reduce_")
BF16_PEAK_FLOPS = 989e12    # H100 SXM, dense bf16 (NVIDIA's data sheet)


def host_wsd(step, *, peak_lr, warmup, total_steps, decay_frac=0.1,
             final_frac=0.01) -> float:
    """The WSD schedule in float64 on the host (the device's is f32)."""
    decay_steps = max(1, total_steps * decay_frac)
    decay_start = total_steps - decay_steps
    if step < warmup:
        return peak_lr * step / max(1, warmup)
    if step < decay_start:
        return peak_lr
    t = min(max((step - decay_start) / decay_steps, 0.0), 1.0)
    return peak_lr * math.exp(math.log(final_frac) * t)


def train_flops(cfg, b, s) -> float:
    """Matmul FLOPs of one train step with each layer recomputed: the
    layers' forward twice (once more in the backward) and their backward
    (twice a forward); the head once forward and its backward."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    proj = 2 * b * s * (d * h * hd + 2 * d * kv * hd + h * hd * d
                        + 3 * d * cfg.d_ff)
    attn = 2 * 2 * b * h * s * s * hd           # scores and p @ v, full S
    head = 2 * b * s * d * cfg.padded_vocab
    return cfg.num_layers * (proj + attn) * 4 + head * 3


def train_state_bytes(state) -> tuple[int, int]:
    """(parameter bytes, optimizer state bytes)."""
    p = sum(t.numel() * t.element_size()
            for t in state["params"].parameters())
    o = sum(t.numel() * t.element_size()
            for k in ("m", "v") for t in state["opt"][k].values())
    return p, o


def profile_train_step(step_fn, state, batch) -> tuple[dict, dict, str]:
    """One train step under ``torch.profiler``: the new state, the step's
    metrics and a line with the device busy and idle ms in the step's
    host span, the device events, and the aten ops with the most device
    time (self, summed over calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(TRAIN_MARK):
            state, met = step_fn(state, batch)
            float(met["loss"])
            torch.cuda.synchronize()
    marks = [e.time_range for e in prof.events()
             if e.name == TRAIN_MARK and e.device_type == DeviceType.CPU]
    split = device_split(prof, (marks[0].start, marks[0].end)) \
        if marks else {"events": 0}
    if not split["events"]:
        return state, met, ("the profiler recorded no device events: not "
                            "measured")

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    gemm = sum(dev_us(e) for e in ops if e.key in GEMM_OPS)
    lookup = sum(dev_us(e) for e in ops if e.key in LOOKUP_OPS)
    top = "; ".join(f"{e.key} {dev_us(e) / 1e3:.3f} ms x {e.count}"
                    for e in sorted(ops, key=lambda e: -dev_us(e))[:12])
    return state, met, (
        f"{(marks[0].end - marks[0].start) / 1e3:.3f} ms under the "
        f"profiler, device busy {split['device busy']:.3f}, idle "
        f"{split['device idle']:.3f} ms, {split['events']} device events; "
        f"GEMMs ({', '.join(GEMM_OPS)}) {gemm / 1e3:.3f} ms; the lookup's "
        f"backward, _grad_segment ({', '.join(LOOKUP_OPS)}) "
        f"{lookup / 1e3:.3f} ms; aten ops by self device time: {top}")


def split_train_step(cfg, opt_cfg, state, batch) -> dict:
    """The train step's three parts as ``make_train_step(donate=True)``
    runs them (the loss, ``torch.autograd.grad``, the in-place AdamW),
    with CUDA events between them and the host's issue time of each."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    host = []
    model = state["params"]
    named = dict(model.named_parameters())
    torch.cuda.synchronize()
    ev[0].record()
    t0 = time.perf_counter()
    with torch.enable_grad():
        loss, _ = transformer.loss_fn(model, cfg, batch)
        host.append(time.perf_counter() - t0)
        ev[1].record()
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        host.append(time.perf_counter() - t0 - sum(host))
        ev[2].record()
    adamw.apply_updates(named, dict(zip(named, grads)), state["opt"],
                        opt_cfg, inplace=True)
    host.append(time.perf_counter() - t0 - sum(host))
    ev[3].record()
    float(loss.detach())
    torch.cuda.synchronize()
    parts = ("forward", "backward (with the recompute)", "AdamW")
    return {p: (ev[i].elapsed_time(ev[i + 1]), host[i] * 1e3)
            for i, p in enumerate(parts)}


def full_depth_steps(dev) -> None:
    """``TRAIN_STEPS`` in-place steps of minicpm-2b at full width and
    depth: bytes, each step's loss, grad norm and lr (held against the
    host's schedule), step ms by the host clock (fenced by the loss read)
    and by CUDA events, tokens/s, the peak memory; then one step split in
    its three parts and one profiled step; then the table gradient by
    segment and by scatter."""
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import build_model, param_count
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import put_batch
    cfg = get_config(TRAIN_ARCH)
    if cfg.num_layers != TRAIN_LAYERS or cfg.embed_grad != "segment":
        raise AssertionError(f"[train] {cfg.name}: {cfg.num_layers} layers, "
                             f"embed_grad {cfg.embed_grad}")
    opt_cfg = adamw.AdamWConfig(schedule=cfg.schedule, **TRAIN_OPT)
    tag = f"{cfg.name} x {TRAIN_LAYERS} layers"
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED))
    state = {"params": model, "opt": adamw.init_state(model, opt_cfg)}
    torch.cuda.synchronize()
    pbytes, obytes = train_state_bytes(state)
    n = param_count(model)
    say(f"[train] {tag}: {n:,} parameters, {pbytes:,} B of f32 parameters "
        f"and {obytes:,} B of m and v, drawn and zeroed on the card in "
        f"{time.perf_counter() - t0:.2f} s; schedule {cfg.schedule} "
        f"{TRAIN_OPT}, embed_grad {cfg.embed_grad}, remat "
        f"{cfg.remat_policy}, compute {cfg.compute_dtype}")
    if n != TRAIN_PARAMS:
        raise AssertionError(f"[train] {tag}: {n} parameters")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  global_batch=TRAIN_BATCH,
                                  seq_len=TRAIN_SEQ))
    step_fn = steps.make_train_step(cfg, opt_cfg, donate=True)
    host_ms, dev_ms = [], []
    for i in range(TRAIN_STEPS - 1):
        batch = put_batch(data.batch_at(i), dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        new, met = step_fn(state, batch)
        stop.record()
        loss = float(met["loss"])
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        dev_ms.append(start.elapsed_time(stop))
        check_train_metrics(tag, i + 1, loss, met, opt_cfg)
        if new["params"] is not state["params"]:
            raise AssertionError("[train] the in-place step returned "
                                 "another model")
        state = new
    # the last step under the profiler
    state, met, prof_line = profile_train_step(
        step_fn, state, put_batch(data.batch_at(TRAIN_STEPS - 1), dev))
    check_train_metrics(tag, TRAIN_STEPS, float(met["loss"]), met, opt_cfg)
    if int(state["opt"]["step"]) != TRAIN_STEPS:
        raise AssertionError(f"[train] the step counter reads "
                             f"{int(state['opt']['step'])}")
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(dev).total_memory
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    med_host = statistics.median(host_ms[1:])
    med_dev = statistics.median(dev_ms[1:])
    say(f"[train] {tag}: step ms (steps 2-{TRAIN_STEPS - 1}) by the host "
        f"clock fenced by the loss read {[round(t, 3) for t in host_ms]} "
        f"(median {med_host:.3f}), by CUDA events "
        f"{[round(t, 3) for t in dev_ms]} (median {med_dev:.3f}); step 1 "
        f"includes the first calls' set-up")
    say(f"[train] {tag}: {TRAIN_BATCH * TRAIN_SEQ / med_host * 1e3:.1f} "
        f"tokens/s at (B, S) = ({TRAIN_BATCH}, {TRAIN_SEQ}); "
        f"{flops / 1e12:.2f} TFLOP of matmuls per step with the recompute, "
        f"{flops / med_dev / 1e9:.1f} TFLOP/s by the event time, bound "
        f"{flops / BF16_PEAK_FLOPS * 1e3:.3f} ms at the bf16 peak; peak "
        f"max_memory_allocated {peak:,} B of the card's {total:,} B "
        f"({(total - peak) / 2**30:.2f} GiB free), {peak - before:,} B of "
        f"it the phase's (above the {before:,} B allocated before it)")
    say(f"[train] {tag}: one profiled step (step {TRAIN_STEPS}): "
        f"{prof_line}")
    weights = [p for p in model.parameters() if p.dim() == 2]
    cast_ms = event_ms(lambda: [w.to(torch.bfloat16) for w in weights])
    say(f"[train] {tag}: one f32 -> bf16 cast of every weight alone "
        f"{cast_ms:.3f} ms (CUDA events, median of {MEDIAN_OF}); a step "
        f"casts each twice (the forward and its recompute) and casts its "
        f"gradient back once")
    parts = split_train_step(cfg, opt_cfg, state,
                             put_batch(data.batch_at(TRAIN_STEPS), dev))
    say(f"[train] {tag}: one more step in its parts, device ms by CUDA "
        f"events (host issue ms): " + "; ".join(
            f"{p} {d:.3f} ({h:.3f})" for p, (d, h) in parts.items()))
    batch = put_batch(data.batch_at(TRAIN_STEPS + 1), dev)
    cal, (state, met) = measured_step(step_fn, (state, batch), dev)
    CALIBRATION["train"] = dict(
        cal, cfg=cfg, opt_cfg=opt_cfg, step_ms=med_dev,
        batch={k: (tuple(v.shape), v.dtype) for k, v in batch.items()})
    say(f"[train] {tag}: one more step for [dryrun]'s calibration: "
        f"{cal['flops']:,} flops (FlopCounterMode), its peak "
        f"{cal['peak']:,} B (max_memory_allocated less the "
        f"{cal['base'] - cal['held']:,} B held outside its arguments)")
    embed_grads(model, cfg, put_batch(data.batch_at(0), dev), tag)
    del state, model, new, met, batch, weights
    say(f"[train] {tag}: peak max_memory_allocated {peak:,} B, "
        f"{peak - before:,} B of it the phase's")


def check_train_metrics(tag, step, loss, met, opt_cfg) -> None:
    """The step's loss and grad norm finite, its lr the host's schedule."""
    gnorm, lr = float(met["grad_norm"]), float(met["lr"])
    want = host_wsd(step, **{k: getattr(opt_cfg, k) for k in
                             ("peak_lr", "warmup", "total_steps")})
    say(f"[train] {tag}: step {step}: loss {loss:.6f}, grad norm "
        f"{gnorm:.6f}, lr {lr:.6e} (host schedule {want:.6e})")
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        raise AssertionError(f"[train] step {step}: loss {loss}, grad norm "
                             f"{gnorm}")
    if not abs(lr - want) <= LR_TOL * want:
        raise AssertionError(f"[train] step {step}: lr {lr}, the host's "
                             f"schedule {want}")


def embed_grads(model, cfg, batch, tag) -> None:
    """The table's gradient of one full-depth loss by ``segment`` and by
    ``scatter`` (the head's part and the lookup's), within rtol = atol =
    ``EMBED_TOL``; each backward timed by CUDA events."""
    import dataclasses
    import torch
    from repro_torch.models import transformer
    out, ms = {}, {}
    for method in ("segment", "scatter"):
        c = dataclasses.replace(cfg, embed_grad=method)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        with torch.enable_grad():
            loss, _ = transformer.loss_fn(model, c, batch)
            start.record()
            (out[method],) = torch.autograd.grad(loss, [model.embed.table])
            stop.record()
        torch.cuda.synchronize()
        ms[method] = start.elapsed_time(stop)
    seg, sc = out["segment"], out["scatter"]
    diff = float((seg - sc).abs().max())
    if not torch.allclose(seg, sc, rtol=EMBED_TOL, atol=EMBED_TOL):
        raise AssertionError(f"[train] table gradient segment vs scatter: "
                             f"max |d| {diff:.3e}")
    say(f"[train] {tag}: the table's gradient of one step by segment vs "
        f"scatter within rtol = atol = {EMBED_TOL} (max |d| {diff:.3e}, "
        f"max |d| / max |scatter| {diff / float(sc.abs().max()):.3e}); "
        f"backward {ms['segment']:.3f} ms by segment, {ms['scatter']:.3f} "
        f"ms by scatter (CUDA events, one each)")


def card_vs_cpu_step(dev) -> None:
    """One out-of-place f32 step at full width over ``CARD_CPU_TRAIN``'s
    layers on the card and on the host from the same weights: the loss,
    the grad norm and every updated parameter."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import build_model, transformer
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import put_batch
    layers, b, s = CARD_CPU_TRAIN
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=layers,
                              compute_dtype="float32")
    opt_cfg = adamw.AdamWConfig(schedule=cfg.schedule, **TRAIN_OPT)
    card = build_model(cfg, device=dev,
                       generator=torch.Generator(dev).manual_seed(SEED + 1))
    cpu = transformer.init_params(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    host = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  global_batch=b, seq_len=s)).batch_at(0)
    step = steps.make_train_step(cfg, opt_cfg)
    out = {}
    for where, model in (("card", card), ("cpu", cpu)):
        t0 = time.perf_counter()
        new, met = step({"params": model,
                         "opt": adamw.init_state(model, opt_cfg)},
                        put_batch(host, model.embed.table.device))
        loss = float(met["loss"])
        out[where] = (new, met, time.perf_counter() - t0)
        if not math.isfinite(loss):
            raise AssertionError(f"[train] card vs CPU: {where} loss {loss}")
    (cn, cm, ct), (hn, hm, ht) = out["card"], out["cpu"]
    lr = float(hm["lr"])
    loss_rel = abs(float(cm["loss"]) - float(hm["loss"])) / \
        abs(float(hm["loss"]))
    norm_rel = abs(float(cm["grad_norm"]) - float(hm["grad_norm"])) / \
        float(hm["grad_norm"])
    hp = dict(hn["params"].named_parameters())
    worst = max(float((p.detach().cpu() - hp[k].detach()).abs().max())
                for k, p in cn["params"].named_parameters())
    say(f"[train] card vs CPU, {cfg.name} x {layers} layers, f32, (B, S) = "
        f"({b}, {s}), one out-of-place step: loss {float(cm['loss']):.6f} "
        f"vs {float(hm['loss']):.6f} (rel {loss_rel:.3e}, bound "
        f"{CARD_CPU_LOSS_TOL}), grad norm rel {norm_rel:.3e} (bound "
        f"{CARD_CPU_LOSS_TOL}), largest parameter difference "
        f"{worst:.3e} = {worst / lr:.4f} lr (bound {CARD_CPU_PARAM_LR} lr); "
        f"the card's step {ct:.2f} s, the host's {ht:.2f} s")
    if not (loss_rel <= CARD_CPU_LOSS_TOL and norm_rel <= CARD_CPU_LOSS_TOL
            and worst <= CARD_CPU_PARAM_LR * lr):
        raise AssertionError("[train] card vs CPU step out of bounds")


def trainer_run(cfg, opt_cfg, data, ckpt_dir, dev, total, *, every=100,
                step=None, data_source=None):
    """A ``Trainer`` of ``total`` steps on the card; returns it, its run's
    output and its seconds (construction, with any restore, apart)."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.train import Trainer, TrainerConfig
    t0 = time.perf_counter()
    tr = Trainer(TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir,
                               ckpt_every=every, ckpt_async=True,
                               log_every=1),
                 cfg, opt_cfg, step or steps.make_train_step(cfg, opt_cfg),
                 data_source or data,
                 init_generator=torch.Generator(dev).manual_seed(SEED + 2),
                 device=dev)
    made = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = tr.run()
    return tr, out, made, time.perf_counter() - t0


def trainer_checks(dev) -> None:
    """The Trainer at full width over ``TRAINER_LAYERS`` layers.  Under
    ``torch.use_deterministic_algorithms``: a straight run with async
    saves, and a restart from step 3 (3 steps and a blocking save, then a
    new Trainer that restores it) that must end within ``RESUME_TOL`` of
    it.  In the default mode: the same 6 steps again, their distance from
    the deterministic run printed (index_add_'s atomics), and a poisoned
    batch the NaN guard skips.  Then the directory deleted and the held
    bytes back."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as ckpt
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=TRAINER_LAYERS)
    opt_cfg = adamw.AdamWConfig(schedule=cfg.schedule, **TRAIN_OPT)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  global_batch=TRAIN_BATCH,
                                  seq_len=TRAIN_SEQ))
    tag = f"{cfg.name} x {TRAINER_LAYERS} layers"
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    held = held_bytes()
    resumed_dir = os.path.join(TRAINER_DIR, "resumed")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        straight, out, made, secs = trainer_run(
            cfg, opt_cfg, data, os.path.join(TRAINER_DIR, "straight"), dev,
            TRAINER_STEPS, every=TRAINER_EVERY)
        _, first, _, first_s = trainer_run(cfg, opt_cfg, data, resumed_dir,
                                           dev, TRAINER_EVERY)
        resumed, out2, restore_s, _ = trainer_run(
            cfg, opt_cfg, data, resumed_dir, dev, TRAINER_STEPS)
    finally:
        torch.use_deterministic_algorithms(False)
    losses = [round(h["loss"], 5) for h in out["history"]]
    nbytes = sum(train_state_bytes(straight.state))
    say(f"[train] Trainer {tag}: {TRAINER_STEPS} steps in {secs:.2f} s "
        f"(built in {made:.2f} s), checkpoints of {nbytes:,} B every "
        f"{TRAINER_EVERY} steps written on a thread: steps on disk "
        f"{ckpt.list_steps(os.path.join(TRAINER_DIR, 'straight'))}; losses "
        f"{losses}; step s "
        f"{[round(h['step_time_s'], 4) for h in out['history']]}")
    if out["final_step"] != TRAINER_STEPS or not losses[-1] < losses[0]:
        raise AssertionError(f"[train] Trainer: {out}")
    if resumed.start_step != TRAINER_EVERY or \
            out2["final_step"] != TRAINER_STEPS:
        raise AssertionError(f"[train] the restart began at "
                             f"{resumed.start_step}: {out2}")
    d = state_difference(straight.state, resumed.state)
    save_s = first_s - sum(h["step_time_s"] for h in first["history"])
    say(f"[train] Trainer {tag}, deterministic algorithms: a restart from "
        f"step {TRAINER_EVERY} ends within rtol = atol = {RESUME_TOL} of the "
        f"straight run: largest parameter difference {d['max']:.3e}, "
        f"{d['over']} of {d['of']:,} elements beyond; the blocking save "
        f"{save_s:.2f} s (the run's seconds less its steps'), the restore "
        f"{restore_s:.2f} s (the Trainer's construction)")
    if d["over"]:
        raise AssertionError(f"[train] the restart is off by {d}")
    del resumed
    rerun, _, _, _ = trainer_run(cfg, opt_cfg, data,
                                 os.path.join(TRAINER_DIR, "rerun"), dev,
                                 TRAINER_STEPS)
    d = state_difference(straight.state, rerun.state)
    lr = max(h["lr"] for h in out["history"])
    say(f"[train] Trainer {tag}: the same {TRAINER_STEPS} steps in the "
        f"default mode against the deterministic run (index_add_'s atomics "
        f"order the embedding gradient's sums): largest parameter "
        f"difference {d['max']:.3e} = {d['max'] / lr:.3f} lr in "
        f"{d['leaf']}, {d['over']} of {d['of']:,} elements beyond rtol = "
        f"atol = {RESUME_TOL} (printed, not gated)")
    del straight, rerun
    # the NaN guard: a poisoned batch at step 2 is skipped
    poison = PoisonedSource(data, 2)
    nan_tr, out3, _, _ = trainer_run(
        cfg, opt_cfg, data, os.path.join(TRAINER_DIR, "nan"), dev, 4,
        step=poison.step(steps.make_train_step(cfg, opt_cfg)),
        data_source=poison)
    if out3["nan_skipped"] != [2] or int(nan_tr.state["opt"]["step"]) != 3:
        raise AssertionError(f"[train] the NaN guard: {out3}")
    say(f"[train] Trainer {tag}: the NaN guard skipped the poisoned step "
        f"{out3['nan_skipped']}; the step counter reads "
        f"{int(nan_tr.state['opt']['step'])} after 4 steps")
    del nan_tr
    shutil.rmtree(TRAINER_DIR)
    after = held_bytes()
    if after != held:
        raise AssertionError(f"[train] the Trainer left pinned and allocated "
                             f"bytes {after}, found {held}")
    say(f"[train] Trainer: {TRAINER_DIR} deleted; pinned and allocated bytes "
        f"back at {after}")


def state_difference(a, b) -> dict:
    """How far train state ``b``'s parameters lie from ``a``'s: the largest
    element difference and its parameter, and the elements beyond rtol =
    atol = ``RESUME_TOL`` of all of them."""
    import torch
    pa = dict(a["params"].named_parameters())
    out = {"max": 0.0, "leaf": None, "over": 0, "of": 0}
    with torch.no_grad():
        for k, p in b["params"].named_parameters():
            d = (p - pa[k]).abs()
            if float(d.max()) > out["max"]:
                out["max"], out["leaf"] = float(d.max()), k
            out["over"] += int((d > RESUME_TOL * (1 + pa[k].abs())).sum())
            out["of"] += p.numel()
    return out


class PoisonedSource:
    """A data source whose batch at ``at`` carries a ``poison`` mark, and
    the step that reports a NaN loss for it (``tests/test_trainer.py``'s
    NaN guard test)."""

    def __init__(self, inner, at):
        self.inner, self.at = inner, at

    def batch_at(self, step):
        b = self.inner.batch_at(step)
        return dict(b, poison=None) if step == self.at else b

    @staticmethod
    def step(inner):
        import torch

        def poisoned(state, batch):
            nan = "poison" in batch
            new, met = inner(state, {k: v for k, v in batch.items()
                                     if k != "poison"})
            if nan:
                met = dict(met, loss=torch.full_like(met["loss"],
                                                     float("nan")))
            return new, met
        return poisoned


def train_lm_example() -> None:
    """``python -m repro_torch.examples.train_lm`` at its reference sizes
    on the card, in this process: exit 0 and the final step."""
    import contextlib
    import io
    import torch
    from repro_torch.examples import train_lm
    d = os.path.join(TRAINER_DIR, "train_lm")
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = train_lm.main(["--ckpt-dir", d])
        torch.cuda.synchronize()
    finally:
        for line in buf.getvalue().splitlines():
            say(f"[train] train_lm: {line}")
    secs = time.perf_counter() - t0
    shutil.rmtree(d, ignore_errors=True)
    say(f"[train] train_lm: exit {rc} in {secs:.2f} s")
    if rc != 0 or "done at step 300" not in buf.getvalue():
        raise AssertionError("[train] train_lm did not finish")


def train_phase(dev) -> None:
    """The ``[train]`` phase: minicpm-2b trained at full width and depth,
    the card against the CPU, the Trainer, ``train_lm``."""
    import torch
    t_phase = time.perf_counter()
    held = held_bytes()
    full_depth_steps(dev)
    torch.cuda.empty_cache()
    card_vs_cpu_step(dev)
    trainer_checks(dev)
    train_lm_example()
    after = held_bytes()
    if after != held:
        raise AssertionError(f"[train] left pinned and allocated bytes "
                             f"{after}, found {held}")
    say(f"[train] phase {time.perf_counter() - t_phase:.1f} s")


# -------------------------------------------------------------- [families]
# the MoE (with MLA), SSM, hybrid and enc-dec families on the card.
# Served: (arch, layers or None for full depth, expected parameters).
# deepseek and dbrx keep their full widths with the depth cut to 2 layers
# (deepseek: the dense first layer, then one MoE layer of all 160 experts
# with MLA); the others run at full width and depth
FAMILY_SERVE = (("mamba2-370m", None, 368_494_080),
                ("zamba2-1.2b", None, 1_097_597_824),
                ("seamless-m4t-large-v2", None, 1_370_875_904),
                ("deepseek-v2-236b", 2, 5_358_679_040),
                ("dbrx-132b", 2, 7_751_301_120))
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_NEW = 2, 8, 16
ENC_FRAMES = 64             # seamless's memory: (B, 64, 1024) seeded frames
# card vs CPU on the same weights, one config per family at 2 layers: the
# hybrid at 4 layers every 2 (at 2 layers and every 6 it has no group,
# hence no shared block: 4 at every 2 is the least cut with two groups of
# two, both stacking axes above 1), the MoE with its routed experts cut
# from 160 to 32
FAMILY_CARD_CPU = (("mamba2-370m", dict(num_layers=2)),
                   ("zamba2-1.2b", dict(num_layers=4, shared_attn_every=2)),
                   ("seamless-m4t-large-v2", dict(num_layers=2,
                                                  encoder_layers=2)),
                   ("deepseek-v2-236b", dict(num_layers=2, num_experts=32)))
# trained in place (donate=True) at the reference's train_4k sequence with
# its global batch cut to 1; deepseek at 2 layers with 32 routed experts
# (with all 160 its f32 parameters, gradients, m and v are 85.7 GB, above
# the card's 80 GB) and at 2048 positions (MLA's 128 materialized f32
# score heads are 2.1 GB a tensor there); dbrx is served only (its train
# state at 2 layers is 124 GB)
FAMILY_TRAIN = (("mamba2-370m", {}, (1, 4096)),
                ("zamba2-1.2b", {}, (1, 4096)),
                ("seamless-m4t-large-v2", {}, (1, 4096)),
                ("deepseek-v2-236b", dict(num_layers=2, num_experts=32),
                 (1, 2048)))
FAMILY_STEPS = 3
FAMILY_OPT = dict(peak_lr=3e-4, warmup=2, total_steps=FAMILY_STEPS)
HYBRID_CUT = dict(num_layers=4, shared_attn_every=2)
FAMILY_CKPT_DIR = os.path.join(ROOT, "build", "families")


def host_cosine(step, *, peak_lr, warmup, total_steps,
                final_frac=0.1) -> float:
    """The cosine schedule in float64 on the host (the device's is f32)."""
    if step < warmup:
        return peak_lr * step / max(1, warmup)
    frac = min(max((step - warmup) / max(1, total_steps - warmup), 0.0), 1.0)
    return peak_lr * (final_frac + (1 - final_frac) * 0.5
                      * (1 + math.cos(math.pi * frac)))


def family_cfg(arch, **changes):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, **changes) if changes else cfg


def family_batch(cfg, b, s, dev, seed=SEED) -> dict:
    """Seeded tokens (and, for the enc-dec, ``ENC_FRAMES`` frame
    embeddings) on ``dev``."""
    import torch
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).to(dev)}
    if cfg.is_encdec:
        out["embeds"] = torch.from_numpy(rng.standard_normal(
            (b, ENC_FRAMES, cfg.frontend_dim)).astype(np.float32)).to(dev)
    return out


def family_cache(model, cfg, b, max_len, dtype, batch):
    """``cfg``'s decode cache for ``model`` (the enc-dec's memory filled by
    ``prefill_memory`` from the batch's frames)."""
    from repro_torch.models import encdec, transformer
    dev = model.embed.table.device
    if cfg.is_encdec:
        cache = encdec.init_cache(cfg, b, max_len, ENC_FRAMES, dtype,
                                  device=dev)
        return encdec.prefill_memory(model, cfg, cache, batch["embeds"])
    return transformer.init_cache(cfg, b, max_len, dtype, device=dev)


def consistency_cfg(cfg):
    """f32 compute and, for the MoE, a capacity no expert's load can pass
    (capacity_factor >= E / k gives cap >= t at decode's t = B tokens as
    in the forward), the reference's consistency settings."""
    import dataclasses
    changes = dict(compute_dtype="float32")
    if cfg.moe:
        changes["capacity_factor"] = max(cfg.capacity_factor,
                                         cfg.num_experts / cfg.top_k)
    return dataclasses.replace(cfg, **changes)


def family_decode_vs_forward(model, cfg, dev, tag) -> None:
    import torch
    from repro_torch.models.model import family
    c32 = consistency_cfg(cfg)
    b, s = CONSISTENCY
    batch = family_batch(cfg, b, s, dev)
    fam = family(cfg)
    with torch.no_grad():
        ref, _ = fam.forward(model, c32, batch)
    cache = family_cache(model, c32, b, s, torch.float32, batch)
    dec = torch.cat([fam.decode_step(model, c32, cache,
                                     batch["tokens"][:, t:t + 1], t)[0]
                     for t in range(s)], dim=1)
    rel = rel_err(dec, ref)
    say(f"[families] {tag}: decode vs forward, f32, B {b}, S {s}"
        f"{', capacity_factor ' + str(c32.capacity_factor) if cfg.moe else ''}"
        f": max|d|/max|ref| {rel:.3e} (bound {CONSISTENCY_TOL})")
    if not rel < CONSISTENCY_TOL:
        raise AssertionError(f"[families] {tag}: decode vs forward {rel:.3e}")


def family_generate(model, cfg, dev, tag) -> np.ndarray:
    """``Server.generate`` (the config's bf16, greedy) twice: the tokens
    must be equal bit for bit (the MoE's combine is gathers, no atomics)."""
    import torch
    from repro_torch.serving import ServeConfig, Server
    srv = Server(cfg, ServeConfig(max_len=FAMILY_PROMPT + FAMILY_NEW), model,
                 device=dev)
    prompts = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (FAMILY_BATCH, FAMILY_PROMPT)).astype(np.int32)
    outs, secs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(srv.generate(prompts, FAMILY_NEW))
        secs.append(time.perf_counter() - t0)
    if not np.array_equal(outs[0], outs[1]):
        raise AssertionError(f"[families] {tag}: two greedy runs differ: "
                             f"{outs[0].tolist()} vs {outs[1].tolist()}")
    if not ((outs[0] >= 0) & (outs[0] < cfg.padded_vocab)).all():
        raise AssertionError(f"[families] {tag}: tokens {outs[0].tolist()}")
    say(f"[families] {tag}: Server.generate {FAMILY_BATCH} x "
        f"({FAMILY_PROMPT} + {FAMILY_NEW}), {cfg.compute_dtype}, greedy"
        f"{' (the server zeroes the enc-dec memory)' if cfg.is_encdec else ''}"
        f", twice: {secs[0]:.3f} s and {secs[1]:.3f} s, tokens bitwise equal;"
        f" row 0: {outs[0][0].tolist()}")
    return prompts


def family_timing(model, cfg, dev, prompts) -> dict:
    """The serving loop over a cache of the config's bf16 (the enc-dec's
    memory filled from seeded frames first, inside the time to first
    token): the prefill to the first token on the host, each later decode
    step between CUDA events; then one decode step per config under
    ``torch.cuda.set_sync_debug_mode("error")``, which refuses any host
    read."""
    import statistics
    import torch
    b, plen = prompts.shape
    toks = torch.from_numpy(prompts).to(dev)
    batch = family_batch(cfg, b, plen, dev, seed=SEED + 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        cache = family_cache(model, cfg, b, plen + FAMILY_NEW, torch.bfloat16,
                             batch)
        for t in range(plen):
            logits, _ = model.decode_step(cache, toks[:, t:t + 1], t)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        tok.cpu()
        ttft = time.perf_counter() - t0
        steps = []
        for i in range(FAMILY_NEW - 1):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, _ = model.decode_step(cache, tok, plen + i)
            stop.record()
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            tok.cpu()
            steps.append(start.elapsed_time(stop))
        torch.cuda.set_sync_debug_mode("error")
        try:
            model.decode_step(cache, tok, plen + FAMILY_NEW - 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    cache_bytes = sum(t.numel() * t.element_size() for t in
                      _tensors(cache))
    return {"ttft_s": ttft, "step_ms": statistics.median(steps),
            "step_min_ms": min(steps), "cache_bytes": cache_bytes}


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        else:
            yield v


def family_serve(arch, layers, want, dev) -> None:
    import torch
    from repro_torch.models import build_model, param_count
    cfg = family_cfg(arch, **({"num_layers": layers} if layers else {}))
    tag = f"{cfg.name} x {cfg.num_layers} layers" + (
        f" (+ {cfg.encoder_layers} encoder)" if cfg.is_encdec else "")
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n = param_count(model)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    say(f"[families] {tag} ({cfg.family}): {n:,} parameters, {nbytes:,} B "
        f"({cfg.param_dtype}), drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    if n != want:
        raise AssertionError(f"[families] {tag}: {n} parameters, expected "
                             f"{want}")
    family_decode_vs_forward(model, cfg, dev, tag)
    prompts = family_generate(model, cfg, dev, tag)
    tm = family_timing(model, cfg, dev, prompts)
    peak = torch.cuda.max_memory_allocated()
    say(f"[families] {tag}: time to first token ({FAMILY_PROMPT}-token "
        f"prefill{', ' + str(ENC_FRAMES) + '-frame prefill_memory' if cfg.is_encdec else ''}, "
        f"batch {FAMILY_BATCH}) {tm['ttft_s'] * 1e3:.2f} ms; decode step "
        f"median {tm['step_ms']:.3f} ms (min {tm['step_min_ms']:.3f}; CUDA "
        f"events, {FAMILY_NEW - 1} steps), "
        f"{FAMILY_BATCH * 1e3 / tm['step_ms']:.1f} tokens/s at that step "
        f"time; one step under set_sync_debug_mode('error'): no host read; "
        f"parameters {nbytes:,} B, cache {tm['cache_bytes']:,} B (bf16"
        f"{'; the SSM conv ring and state f32' if cfg.ssm_state else ''}); "
        f"peak max_memory_allocated {peak:,} B "
        f"({peak - before:,} B above the {before:,} B before)")
    del model


def family_card_vs_cpu(arch, changes, dev) -> None:
    """One config at its cut drawn on the card and copied to the host:
    the forward's logits on both, f32 and bf16.  For the MoE in bf16, the
    router's picks are compared too (a last-bit difference can pick
    another expert: such flips are counted and printed)."""
    import dataclasses
    import torch
    from repro_torch.models import build_model, moe
    from repro_torch.models.model import family, init_params
    cfg = family_cfg(arch, **changes)
    tag = f"{cfg.name} {changes}"
    card = build_model(cfg, device=dev,
                       generator=torch.Generator(dev).manual_seed(SEED + 4))
    cpu = init_params(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    b, s = CONSISTENCY
    batch = family_batch(cfg, b, s, "cpu", seed=SEED + 2)
    fam = family(cfg)
    picks = {}
    apply = moe.moe_apply

    def recording(p, c, x):
        picks.setdefault(x.device.type, []).append(torch.topk(torch.softmax(
            x.reshape(-1, c.d_model).float() @ p.router.w.float(), dim=-1),
            c.top_k, dim=-1)[1].cpu())
        return apply(p, c, x)
    for cd, tol in CARD_CPU_TOL.items():
        c = dataclasses.replace(cfg, compute_dtype=cd)
        picks.clear()
        moe.moe_apply = recording
        t0 = time.perf_counter()
        try:
            with torch.no_grad():
                got, _ = fam.forward(card, c, {k: v.to(dev)
                                               for k, v in batch.items()})
                want, _ = fam.forward(cpu, c, batch)
            torch.cuda.synchronize()
        finally:
            moe.moe_apply = apply
        secs = time.perf_counter() - t0
        rel = rel_err(got, want)
        flips = sum(int((a != b_).any(dim=-1).sum()) for a, b_ in
                    zip(picks.get("cuda", []), picks.get("cpu", [])))
        note = f"; router picks differing in {flips} tokens" \
            if cfg.moe else ""
        say(f"[families] card vs CPU, {tag}, {cd}: logits max|d|/max|ref| "
            f"{rel:.3e} (bound {tol}{note}; both forwards {secs:.2f} s)")
        if not rel <= tol and not flips:
            raise AssertionError(f"[families] card vs CPU, {tag}, {cd}: "
                                 f"{rel:.3e}")
    del card, cpu


def family_train(arch, changes, shape, dev) -> None:
    """``FAMILY_STEPS`` in-place steps at full width: bytes, each step's
    loss, grad norm and lr (against the host's schedule), step ms by CUDA
    events, tokens/s, the peak memory."""
    import statistics
    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import build_model, param_count
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import put_batch
    cfg = family_cfg(arch, **changes)
    b, s = shape
    tag = f"{cfg.name} x {cfg.num_layers} layers" + (
        f" (+ {cfg.encoder_layers} encoder)" if cfg.is_encdec else "") + (
        f", {cfg.num_experts} routed experts" if cfg.moe else "")
    opt_cfg = adamw.AdamWConfig(schedule=cfg.schedule, **FAMILY_OPT)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED))
    state = {"params": model, "opt": adamw.init_state(model, opt_cfg)}
    pbytes, obytes = train_state_bytes(state)
    say(f"[families] train {tag}: {param_count(model):,} parameters, "
        f"{pbytes:,} B of f32 parameters and {obytes:,} B of m and v; "
        f"schedule {cfg.schedule} {FAMILY_OPT}, compute {cfg.compute_dtype},"
        f" remat {cfg.remat_policy}, (B, S) = ({b}, {s})")
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=b, seq_len=s,
        input_mode=cfg.input_mode, frontend_dim=cfg.frontend_dim
        or cfg.d_model, encdec=cfg.is_encdec))
    step_fn = steps.make_train_step(cfg, opt_cfg, donate=True)
    dev_ms = []
    for i in range(FAMILY_STEPS):
        batch = put_batch(data.batch_at(i), dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        state, met = step_fn(state, batch)
        stop.record()
        loss = float(met["loss"])
        torch.cuda.synchronize()
        dev_ms.append(start.elapsed_time(stop))
        gnorm, lr = float(met["grad_norm"]), float(met["lr"])
        want = host_cosine(i + 1, **{k: getattr(opt_cfg, k) for k in
                                     ("peak_lr", "warmup", "total_steps")})
        say(f"[families] train {tag}: step {i + 1}: loss {loss:.6f}, aux "
            f"{float(met['aux']):.6f}, grad norm {gnorm:.6f}, lr {lr:.6e} "
            f"(host schedule {want:.6e}), {dev_ms[-1]:.3f} ms")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"[families] {tag} step {i + 1}: loss "
                                 f"{loss}, grad norm {gnorm}")
        if not abs(lr - want) <= LR_TOL * want:
            raise AssertionError(f"[families] {tag} step {i + 1}: lr {lr}, "
                                 f"the host's {want}")
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(dev_ms[1:])
    say(f"[families] train {tag}: step ms by CUDA events "
        f"{[round(t, 3) for t in dev_ms]} (median of steps 2-{FAMILY_STEPS} "
        f"{med:.3f}; step 1 includes the first calls' set-up), "
        f"{b * s / med * 1e3:.1f} tokens/s; peak max_memory_allocated "
        f"{peak:,} B ({peak - before:,} B above the {before:,} B before)")
    del state, model, met, batch


def hybrid_round_trip(dev) -> None:
    """zamba2's train state at ``HYBRID_CUT`` after one in-place step,
    saved and restored through ``train/checkpoint.py`` (the reference's
    layout: ``group_layers`` stacked on two axes), bitwise."""
    import torch
    from repro_torch import convert
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import put_batch
    cfg = family_cfg("zamba2-1.2b", **HYBRID_CUT)
    opt_cfg = adamw.AdamWConfig(schedule=cfg.schedule, **FAMILY_OPT)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED + 5))
    state = {"params": model, "opt": adamw.init_state(model, opt_cfg)}
    batch = put_batch(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=1, seq_len=256)).batch_at(0),
        dev)
    state, _ = steps.make_train_step(cfg, opt_cfg, donate=True)(state, batch)
    shutil.rmtree(FAMILY_CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    host = convert.train_state_to_jax(state)
    ckpt.save(FAMILY_CKPT_DIR, 1, host)
    save_s = time.perf_counter() - t0
    stacked = host["params"]["group_layers"]["mamba"]["A_log"].shape
    meta = init_params(cfg, device="meta")
    like = convert.train_state_to_jax(
        {"params": meta, "opt": adamw.init_state(meta, opt_cfg)})
    t0 = time.perf_counter()
    step, restored = ckpt.restore_latest(FAMILY_CKPT_DIR, like)
    back = convert.train_state_from_jax(cfg, restored, device=dev)
    load_s = time.perf_counter() - t0
    restored_params = dict(back["params"].named_parameters())
    pairs = [(f"params.{k}", v, restored_params[k])
             for k, v in state["params"].named_parameters()]
    for kind in ("m", "v"):
        pairs += [(f"{kind}.{k}", v, back["opt"][kind][k])
                  for k, v in state["opt"][kind].items()]
    differ = [k for k, a, b_ in pairs if not torch.equal(a, b_)]
    nbytes = sum(a.numel() * a.element_size() for _, a, _ in pairs)
    say(f"[families] zamba2 train state {HYBRID_CUT} at full width, after "
        f"one step: saved ({nbytes:,} B in {save_s:.2f} s; group_layers' "
        f"mamba.A_log stacked {tuple(stacked)}) and "
        f"restored (step {step}, {load_s:.2f} s) through "
        f"train/checkpoint.py: {len(pairs)} tensors, {len(differ)} differ")
    if differ or step != 1 or int(back["opt"]["step"]) != 1:
        raise AssertionError(f"[families] the round trip differs: "
                             f"{differ[:5]}")
    del state, back, model
    shutil.rmtree(FAMILY_CKPT_DIR)


def families_phase(dev) -> None:
    """The ``[families]`` phase: the five configs of the MoE (with MLA),
    SSM, hybrid and enc-dec families served at full width, four of them
    trained, the card against the CPU for one config per family, the
    hybrid's checkpoint round trip; device memory back where it was."""
    import torch
    t_phase = time.perf_counter()
    held = held_bytes()
    for arch, layers, want in FAMILY_SERVE:
        t0 = time.perf_counter()
        family_serve(arch, layers, want, dev)
        torch.cuda.empty_cache()
        say(f"[families] serve {arch}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for arch, changes in FAMILY_CARD_CPU:
        family_card_vs_cpu(arch, changes, dev)
    torch.cuda.empty_cache()
    say(f"[families] card vs CPU: {time.perf_counter() - t0:.1f} s")
    for arch, changes, shape in FAMILY_TRAIN:
        t0 = time.perf_counter()
        family_train(arch, changes, shape, dev)
        torch.cuda.empty_cache()
        say(f"[families] train {arch}: {time.perf_counter() - t0:.1f} s")
    hybrid_round_trip(dev)
    after = held_bytes()
    if after != held:
        raise AssertionError(f"[families] left pinned and allocated bytes "
                             f"{after}, found {held}")
    say(f"[families] phase {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------------ [mesh]
# the mesh substrate on the card: the ZeRO-sharded train state, expert
# parallelism and the launcher.  NCCL refuses two ranks on one card, so
# world 2 is gloo with both ranks on cuda:0, each a worker process
# (``chip_smoke.py --mesh-worker PART RANK``) handed its inputs through
# files under ``build/mesh/`` (and CUDA IPC handles for part 3's tensors)
MESH_DIR = os.path.join(ROOT, "build", "mesh")
MESH_ARCH = "deepseek-v2-236b"
# part 1: [families]' deepseek training config (2 layers, 32 routed
# experts, (1, 2048)) at NCCL world 1 on a (1, 1) mesh, 2 steps
MESH_W1 = (dict(num_layers=2, num_experts=32), (1, 2048), 2)
# part 2: ZeRO over data on a (2, 1) gloo mesh in f32 with the int8
# second moment, the routed experts cut from 160 to 16: two ranks share
# the card, each holding its half of the parameters, m and v_q (8.8 GB),
# the gathered parameters (7.8 GB) and their gradients (7.8 GB)
MESH_ZERO = (dict(num_layers=2, num_experts=16, compute_dtype="float32"),
             (2, 512))
# part 3: one MoE layer at full width with all 160 experts, 80 per rank
# on a (1, 2) mesh, on (2, 256) tokens, forward and backward in f32
MESH_EP_TOKENS = (2, 256)
MESH_OPT = dict(peak_lr=3e-4, warmup=2, total_steps=3)
MESH_ZERO_OPT = dict(MESH_OPT, quantize_v="int8")
MESH_STEP_TOL = 1e-5        # loss and grad norm, relative
MESH_ZERO_TOL = 5e-3        # tests/test_distributed.py's parameter bound
MESH_EP_TOL = 1e-5          # the sharded MoE against moe_apply, f32
MESH_LAUNCH = ["--arch", "dbrx-132b", "--reduced", "--mesh", "test",
               "--steps", "3"]
MESH_WORKER_TIMEOUT = 300
AXES = ("data", "model")


def fingerprint(t) -> int:
    """An exact, order-free digest of a tensor's bits: the sum over its
    elements of the bit pattern times (index mod 65521 + 1), mod 2^64,
    in pieces of 2^26 elements on the tensor's device."""
    import torch
    flat = t.detach().reshape(-1)
    flat = flat.view({4: torch.int32, 2: torch.int16,
                      1: torch.int8}[flat.element_size()])
    total = 0
    for lo in range(0, flat.numel(), 1 << 26):
        piece = flat[lo:lo + (1 << 26)].to(torch.int64)
        weight = torch.arange(lo, lo + piece.numel(),
                              device=piece.device) % 65521 + 1
        total += int((piece * weight).sum())
    return total % (1 << 64)


def state_tensors(state) -> dict:
    """Every tensor of a train state by name (a ``DTensor``'s block)."""
    from torch.distributed.tensor import DTensor
    out = {f"params.{n}": p for n, p in state["params"].named_parameters()}
    for k, v in state["opt"].items():
        for n, t in (v.items() if isinstance(v, dict) else [("", v)]):
            out[f"{k}.{n}"] = t
    return {k: t.to_local() if isinstance(t, DTensor) else t
            for k, t in out.items()}


class MeshCoords:
    """A mesh's shape and one rank's coordinates on it, without a process
    group: enough for ``sharding.placements`` and ``sharding.block``."""

    def __init__(self, shape, axes, coords):
        self.mesh_dim_names, self.shape = tuple(axes), tuple(shape)
        self.coords = dict(zip(axes, coords))

    def size(self, i: int) -> int:
        return self.shape[i]

    def get_local_rank(self, axis: str) -> int:
        return self.coords[axis]


def timed_step(step_fn, ms: list):
    """``step_fn`` with each call's CUDA-event ms appended to ``ms``."""
    import torch

    def run(state, batch):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step_fn(state, batch)
        stop.record()
        stop.synchronize()
        ms.append(start.elapsed_time(stop))
        return out
    return run


def mesh_world1(mesh, dev) -> None:
    """Part 1: ``MESH_W1``'s steps through a ``Trainer`` on the NCCL
    world-1 (1, 1) mesh against the unsharded in-place step from the same
    draws and batches: loss and grad norm within ``MESH_STEP_TOL``
    relative, the parameters within 0.1 lr, under
    ``torch.use_deterministic_algorithms``."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.trainer import put_batch
    changes, (b, s), n_steps = MESH_W1
    cfg = family_cfg(MESH_ARCH, **changes)
    opt_cfg = adamw.AdamWConfig(schedule=cfg.schedule, **MESH_OPT)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  global_batch=b, seq_len=s))
    batches = [put_batch(data.batch_at(i), dev) for i in range(n_steps)]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        model = build_model(cfg, device=dev, generator=torch.Generator(
            dev).manual_seed(SEED + 6))
        state = {"params": model, "opt": adamw.init_state(model, opt_cfg)}
        plain = steps.make_train_step(cfg, opt_cfg, donate=True)
        want = []
        for batch in batches:
            state, met = plain(state, batch)
            want.append({k: float(met[k]) for k in ("loss", "grad_norm",
                                                    "lr")})
        want_params = dict(state["params"].named_parameters())
        del state, model
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tr = Trainer(TrainerConfig(total_steps=n_steps, donate=True,
                                   ckpt_dir=os.path.join(MESH_DIR, "w1")),
                     cfg, opt_cfg, steps.make_train_step(
                         cfg, opt_cfg, donate=True, mesh=mesh), data,
                     init_generator=torch.Generator(dev).manual_seed(
                         SEED + 6), device=dev, mesh=mesh)
        made = time.perf_counter() - t0
        ms = []
        step = timed_step(tr.train_step, ms)
        for i, batch in enumerate(batches):
            tr.state, met = step(tr.state, batch)
            got = {k: float(met[k]) for k in ("loss", "grad_norm", "lr")}
            rel = {k: abs(got[k] - want[i][k]) / abs(want[i][k])
                   for k in ("loss", "grad_norm")}
            say(f"[mesh] part 1 step {i + 1}: loss {got['loss']:.6f} "
                f"(unsharded {want[i]['loss']:.6f}, rel {rel['loss']:.3e}), "
                f"grad norm {got['grad_norm']:.6f} (rel "
                f"{rel['grad_norm']:.3e}), {ms[-1]:.3f} ms")
            if max(rel.values()) > MESH_STEP_TOL:
                raise AssertionError(f"[mesh] part 1 step {i + 1}: {rel}")
        lr = want[-1]["lr"]
        worst = max(float((p.to_local() - want_params[n]).detach().abs()
                          .max())
                    for n, p in tr.state["params"].named_parameters())
        peak = torch.cuda.max_memory_allocated() - before
        kept = sum(t.numel() * t.element_size()
                   for t in want_params.values())
    finally:
        torch.use_deterministic_algorithms(False)
    say(f"[mesh] part 1: {cfg.name} x {cfg.num_layers} layers, "
        f"{cfg.num_experts} routed experts, {cfg.compute_dtype}, (B, S) = "
        f"({b}, {s}), NCCL world 1, mesh (1, 1): Trainer made in "
        f"{made:.2f} s, step ms by CUDA events {[round(t, 3) for t in ms]}; "
        f"largest parameter difference from the unsharded steps "
        f"{worst:.3e} = {worst / lr:.4f} lr (bound 0.1 lr); peak "
        f"max_memory_allocated {peak:,} B above the {before:,} B before "
        f"the Trainer, which hold the unsharded steps' parameters kept "
        f"for the comparison ({kept:,} B)")
    if worst > 0.1 * lr:
        raise AssertionError(f"[mesh] part 1 parameters off by {worst}")
    del tr, want_params


def mesh_spawn(part: str, cfg: dict, env=None, meanwhile=None) -> list:
    """Two worker processes of ``part`` on the card (gloo world 2): writes
    their config, calls ``meanwhile(procs, deadline)`` while they run (if
    given), waits for both, prints their logs, returns their reports."""
    with open(os.path.join(MESH_DIR, f"{part}.json"), "w") as f:
        json.dump(cfg, f)
    logs = [os.path.join(MESH_DIR, f"{part}{r}.log") for r in range(2)]
    procs = []
    try:
        for r in range(2):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--mesh-worker", part, str(r)], stdout=log,
                    stderr=subprocess.STDOUT, env=env))
        deadline = time.perf_counter() + MESH_WORKER_TIMEOUT
        if meanwhile is not None:
            meanwhile(procs, deadline)
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for path in logs:
            if os.path.isfile(path):
                with open(path) as f:
                    for line in f.read().splitlines():
                        say(line)
    codes = [p.returncode for p in procs]
    if codes != [0, 0]:
        raise AssertionError(f"[mesh] {part} workers exited {codes}")
    reports = []
    for r in range(2):
        with open(os.path.join(MESH_DIR, f"{part}_report{r}.json")) as f:
            reports.append(json.load(f))
        if any(reports[-1]["launches"].values()):
            raise AssertionError(f"[mesh] {part} rank {r} launched "
                                 f"{reports[-1]['launches']}")
    return reports


def accumulated_step(cfg, opt_cfg, state, batch, n: int) -> dict:
    """The unsharded counterpart of a ZeRO step over ``n`` data ranks, in
    one process: the loss and gradients of each of the batch's ``n`` row
    blocks (the rows each rank takes, so the MoE's capacity and aux are
    per block, as the reference's sharded MoE has them), averaged, then
    one in-place AdamW update.  Returns the metrics."""
    import torch
    from repro_torch.models.model import family
    from repro_torch.optim import adamw
    named = dict(state["params"].named_parameters())
    rows = batch["tokens"].shape[0] // n
    total, losses = {}, []
    for i in range(n):
        part = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        with torch.enable_grad():
            loss, _ = family(cfg).loss_fn(state["params"], cfg, part)
            grads = torch.autograd.grad(loss, list(named.values()))
        losses.append(loss.detach())
        for k, g in zip(named, grads):
            total[k] = g if k not in total else total[k] + g
        del grads
    grads = {k: g / n for k, g in total.items()}
    _, _, met = adamw.apply_updates(named, grads, state["opt"], opt_cfg,
                                    inplace=True)
    return {"loss": float(torch.stack(losses).mean()), **{
        k: float(v) for k, v in met.items()}}


def mesh_zero(mesh, dev) -> None:
    """Parts 2 and 4: one step of ``MESH_ZERO`` by a ``Trainer`` on a gloo
    (2, 1) mesh in two workers, against its unsharded counterpart here
    (``accumulated_step``): loss and grad norm within ``MESH_STEP_TOL``
    relative; the workers' state, written by rank 0 as the Trainer's
    checkpoint, restored by a ``Trainer`` on this process's NCCL world-1
    mesh bitwise (every tensor's ``fingerprint`` equal to the workers'),
    its parameters within ``MESH_ZERO_TOL`` of the unsharded step's."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.trainer import put_batch
    changes, (b, s) = MESH_ZERO
    mesh_shape = (2, 1)
    cfg = family_cfg(MESH_ARCH, **changes)
    opt_cfg = adamw.AdamWConfig(schedule=cfg.schedule, **MESH_ZERO_OPT)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  global_batch=b, seq_len=s))
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator(
        dev).manual_seed(SEED + 7))
    state = {"params": model, "opt": adamw.init_state(model, opt_cfg)}
    met = accumulated_step(cfg, opt_cfg, state,
                           put_batch(data.batch_at(0), dev), mesh_shape[0])
    want_loss, want_norm, lr = met["loss"], met["grad_norm"], met["lr"]
    want = dict(state["params"].named_parameters())
    del state, model
    torch.cuda.empty_cache()
    say(f"[mesh] part 2: {torch.cuda.memory_allocated():,} B allocated and "
        f"{torch.cuda.memory_reserved():,} B reserved here beside the "
        f"workers; the unsharded step here (the gradients of the "
        f"batch's {mesh_shape[0]} row blocks averaged) in "
        f"{time.perf_counter() - t0:.2f} s: loss {want_loss:.6f}, grad "
        f"norm {want_norm:.6f}")
    t0 = time.perf_counter()
    reports = mesh_spawn("zero", {"ckpt": os.path.join(MESH_DIR, "zero"),
                                  "changes": changes, "batch": [b, s]})
    got = reports[0]
    rel = abs(got["loss"] - want_loss) / abs(want_loss)
    norm_rel = abs(got["grad_norm"] - want_norm) / want_norm
    say(f"[mesh] part 2: {cfg.name} x {cfg.num_layers} layers, "
        f"{cfg.num_experts} routed experts, f32, (B, S) = ({b}, {s}), gloo "
        f"world 2, mesh (2, 1): workers {time.perf_counter() - t0:.1f} s; "
        f"loss {got['loss']:.6f} (rel {rel:.3e}), grad norm rel "
        f"{norm_rel:.3e}; step ms by CUDA events "
        f"{[r['step_ms'] for r in reports]}, peak max_memory_allocated "
        f"{[r['peak'] for r in reports]} B, checkpoint by rank 0 "
        f"{got['save_s']:.2f} s")
    if max(rel, norm_rel) > MESH_STEP_TOL:
        raise AssertionError(f"[mesh] part 2: loss rel {rel}, grad norm "
                             f"rel {norm_rel}")
    # part 4: the elastic restart onto this process's world-1 mesh
    t0 = time.perf_counter()
    tr = Trainer(TrainerConfig(total_steps=1, ckpt_dir=os.path.join(
        MESH_DIR, "zero")), cfg, opt_cfg, steps.make_train_step(
            cfg, opt_cfg, mesh=mesh), data, device=dev, mesh=mesh)
    load_s = time.perf_counter() - t0
    # each worker's blocks, cut here from the restored whole tensors
    specs = steps.train_state_shardings(
        MeshCoords((2, 1), AXES, (0, 0)),
        steps.abstract_train_state(cfg, opt_cfg))
    spec_of = {f"params.{n}": sp for n, sp in specs["params"].items()}
    for k, v in specs["opt"].items():
        for n, sp in (v.items() if isinstance(v, dict) else [("", v)]):
            spec_of[f"{k}.{n}"] = sp
    whole = state_tensors(tr.state)
    differ = []
    for r, rep in enumerate(reports):
        at = MeshCoords((2, 1), AXES, (r, 0))
        for k, t in whole.items():
            part = shd.block(t, at, shd.placements(at, spec_of[k]))
            if fingerprint(part) != rep["fingerprints"][k]:
                differ.append((r, k))
    prints = whole
    worst = max(float((p.to_local() - want[n]).detach().abs().max())
                for n, p in tr.state["params"].named_parameters())
    scale = max(float(w.detach().abs().max()) for w in want.values())
    say(f"[mesh] part 4: rank 0's checkpoint restored onto the NCCL world-1 "
        f"mesh (1, 1) by a Trainer in {load_s:.2f} s (step "
        f"{tr.start_step}): {len(prints)} tensors, {len(differ)} of their "
        f"2 x {len(prints)} blocks differ from the workers' (by "
        f"fingerprint); its parameters against the unsharded "
        f"step: largest difference {worst:.3e} ({worst / lr:.3f} lr; bound "
        f"{MESH_ZERO_TOL})")
    if differ or tr.start_step != 1:
        raise AssertionError(f"[mesh] part 4: {differ[:5]}")
    if worst > MESH_ZERO_TOL * max(1.0, scale):
        raise AssertionError(f"[mesh] part 2 parameters off by {worst}")
    del tr, want


def ep_layer(cfg, dev, lo: int, hi: int):
    """deepseek's MoE layer for part 3 holding the experts ``[lo, hi)``:
    each weight a truncated normal times fan_in^-1/2, the router and the
    shared experts from one seeded generator, expert e's three matrices
    from generators seeded by e, so every process that holds an expert
    draws the same values for it."""
    import torch
    from torch import nn
    from repro_torch.models import moe
    from repro_torch.models.modules import normal_
    gen = torch.Generator(dev).manual_seed(SEED + 8)
    p = moe.moe_init(None, cfg, torch.float32, "meta")
    for k, (n, t) in enumerate(list(p.named_parameters())):
        mod, _, attr = n.rpartition(".")
        stack = mod in ("wi", "wg", "wo")
        w = torch.empty(((hi - lo,) + tuple(t.shape[1:])) if stack
                        else t.shape, device=dev)
        scale = t.shape[-2] ** -0.5
        if stack:
            for e in range(lo, hi):
                normal_(w[e - lo], torch.Generator(dev).manual_seed(
                    SEED + 1000 * k + e), scale)
        else:
            normal_(w, gen, scale)
        setattr(p.get_submodule(mod), attr, nn.Parameter(w))
    return p


def ep_inputs(cfg, dev):
    """Part 3's seeded (x, w) of ``MESH_EP_TOKENS`` positions."""
    import torch
    gen = torch.Generator(dev).manual_seed(SEED + 9)
    shape = MESH_EP_TOKENS + (cfg.d_model,)
    return (torch.randn(shape, generator=gen, device=dev),
            torch.randn(shape, generator=gen, device=dev))


def ep_run(layer, p, cfg, x, w):
    """``layer`` (``moe_apply`` or ``moe_layer``) forward and backward of
    ``sum(out * w) + aux``: (out, aux, x's gradient, ms by CUDA
    events)."""
    import torch
    for t in p.parameters():
        t.grad = None
    x = x.clone().requires_grad_()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out, aux = layer(p, cfg, x)
    ((out * w).sum() + aux).backward()
    stop.record()
    stop.synchronize()
    return out.detach(), aux.detach(), x.grad, start.elapsed_time(stop)


def mesh_ep(dev) -> None:
    """Part 3: ``moe_layer`` alone at full width with all 160 experts on a
    gloo (1, 2) mesh in two workers (80 experts each, drawn there as here
    by ``ep_layer``), forward and backward, against ``moe_apply`` here:
    output, aux and the gradients of x, the router, the experts and the
    shared experts within ``MESH_EP_TOL``.  Each worker hands its results
    over in place through CUDA IPC (its allocator without expandable
    segments, which a process cannot open on this kernel, for want of
    ``pidfd_open``) and keeps them until this process has compared them."""
    import pickle
    import torch
    from repro_torch.models import moe
    cfg = family_cfg(MESH_ARCH, compute_dtype="float32")
    t0 = time.perf_counter()
    p = ep_layer(cfg, dev, 0, cfg.num_experts)
    x, w = ep_inputs(cfg, dev)
    out, aux, gx, plain_ms = ep_run(moe.moe_apply, p, cfg, x, w)
    want = {"out": out, "aux": aux, "grad.x": gx}
    want.update({f"grad.{n}": t.grad for n, t in p.named_parameters()})
    expert_bytes = sum(p.get_parameter(f"{k}.w").numel() * 4
                       for k in ("wi", "wg", "wo"))
    say(f"[mesh] part 3: {cfg.name} moe layer, {cfg.num_experts} experts "
        f"({expert_bytes:,} B of f32 expert weights), (B, S) = "
        f"{MESH_EP_TOKENS}: moe_apply forward and backward here "
        f"{plain_ms:.3f} ms; drawn and run in {time.perf_counter() - t0:.2f}"
        f" s")
    del p, x, w, out, aux, gx
    errors = [None, None]

    def compare(procs, deadline):
        for r in range(2):
            path = os.path.join(MESH_DIR, f"ep_handles{r}.pkl")
            while not os.path.isfile(path):
                if any(q.poll() not in (None, 0) for q in procs) or \
                        time.perf_counter() > deadline:
                    raise AssertionError("[mesh] part 3: a worker ended "
                                         "before its results")
                time.sleep(0.2)
            with open(path, "rb") as f:
                got = {k: fn(*args) for k, (fn, args) in
                       pickle.load(f).items()}
            lo, hi = got.pop("experts").tolist()
            errors[r] = {}
            for k, t in got.items():
                ref = want[k]
                if k in ("grad.wi.w", "grad.wg.w", "grad.wo.w"):
                    ref = ref[lo:hi]
                errors[r][k] = float((t - ref).abs().max()
                                     / ref.abs().max())
            del got, t
            torch.cuda.synchronize()
        with open(os.path.join(MESH_DIR, "ep_release"), "w"):
            pass

    env = dict(os.environ)
    env["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:False"
    t0 = time.perf_counter()
    torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    try:
        reports = mesh_spawn("ep", {}, env=env, meanwhile=compare)
    finally:
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    for r, rep in enumerate(reports):
        say(f"[mesh] part 3 rank {r}: experts {rep['experts']}, forward and "
            f"backward {[round(t, 3) for t in rep['step_ms']]} ms by CUDA "
            f"events (first call, second), peak max_memory_allocated "
            f"{rep['peak']:,} B; largest relative difference from "
            f"moe_apply {errors[r]}")
        bad = {k: e for k, e in errors[r].items() if not e <= MESH_EP_TOL}
        if bad:
            raise AssertionError(f"[mesh] part 3 rank {r}: {bad}")
    del want
    say(f"[mesh] part 3: workers {time.perf_counter() - t0:.1f} s")


def mesh_launcher(proc, t0) -> None:
    """Part 5: ``python -m torch.distributed.run --nproc-per-node 8 -m
    repro_torch.launch.train ... --mesh test`` on the card (8 gloo ranks on
    cuda:0), started as ``proc`` at ``t0`` (``mesh_phase`` runs parts 1
    and 3 meanwhile): exit 0, finite losses, every rank's final state
    digest equal."""
    try:
        out, err = proc.communicate(timeout=MESH_WORKER_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    secs = time.perf_counter() - t0
    for line in out.splitlines():
        say(f"[mesh] launcher: {line}")
    if proc.returncode != 0:
        say(err[-4000:])
        raise AssertionError(f"[mesh] the launcher exited "
                             f"{proc.returncode}")
    digests = dict(re.findall(
        r"rank (\d+): final state sha256 ([0-9a-f]{64})", out))
    losses = [float(v) for v in re.findall(r" loss (\S+) ", out)]
    say(f"[mesh] part 5: torch.distributed.run {' '.join(MESH_LAUNCH)}: "
        f"exit 0 {secs:.1f} s after its start, losses {losses}, "
        f"{len(digests)} ranks' digests, {len(set(digests.values()))} "
        f"distinct")
    if sorted(digests) != [str(r) for r in range(8)] or \
            len(set(digests.values())) != 1:
        raise AssertionError(f"[mesh] part 5 digests {digests}")
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"[mesh] part 5 losses {losses}")


def mesh_worker(part: str, rank: int) -> int:
    """One gloo rank of part 2 (``zero``) or part 3 (``ep``) on the card;
    writes its report and returns 0 when every check held."""
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.dist import make_mesh, set_mesh
    from repro_torch.kernels import launch_counts
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with open(os.path.join(MESH_DIR, f"{part}.json")) as f:
        cfg_in = json.load(f)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(MESH_DIR, part + '_s')}",
        rank=rank, world_size=2)
    pre = f"[mesh] {part} rank {rank}:"
    report = {}
    try:
        mesh = make_mesh((2, 1) if part == "zero" else (1, 2))
        set_mesh(mesh)
        if part == "zero":
            report = zero_worker(cfg_in, mesh, dev, pre)
        else:
            report = ep_worker(cfg_in, mesh, dev, pre)
        set_mesh(None)
    finally:
        dist.destroy_process_group()
    report["launches"] = dict(launch_counts)
    report["peak"] = torch.cuda.max_memory_allocated()
    with open(os.path.join(MESH_DIR, f"{part}_report{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def zero_worker(cfg_in, mesh, dev, pre) -> dict:
    """Part 2's rank: a ``Trainer`` of one in-place sharded step, its state
    written by rank 0 as the final checkpoint; reports the step's loss,
    grad norm and ms and the state's fingerprints."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig
    cfg = family_cfg(MESH_ARCH, **cfg_in["changes"])
    opt_cfg = adamw.AdamWConfig(schedule=cfg.schedule, **MESH_ZERO_OPT)
    b, s = cfg_in["batch"]
    ms, metrics = [], []
    step = timed_step(steps.make_train_step(cfg, opt_cfg, donate=True,
                                            mesh=mesh), ms)

    def recorded(state, batch):
        state, met = step(state, batch)
        metrics.append({k: float(v) for k, v in met.items()})
        return state, met
    t0 = time.perf_counter()
    tr = Trainer(TrainerConfig(total_steps=1, donate=True, ckpt_async=False,
                               ckpt_dir=cfg_in["ckpt"]),
                 cfg, opt_cfg, recorded, SyntheticLM(DataConfig(
                     vocab_size=cfg.vocab_size, global_batch=b, seq_len=s)),
                 init_generator=torch.Generator(dev).manual_seed(SEED + 7),
                 device=dev, mesh=mesh)
    made = time.perf_counter() - t0
    held = sum(p.to_local().numel() * 4
               for p in tr.state["params"].parameters())
    t0 = time.perf_counter()
    tr.run()
    run_s = time.perf_counter() - t0
    prints = {k: fingerprint(t) for k, t in state_tensors(tr.state).items()}
    say(f"{pre} Trainer made (state drawn whole, then its blocks) in "
        f"{made:.2f} s, {held:,} B of parameter blocks; run (1 step and "
        f"the final checkpoint) {run_s:.2f} s, step {ms[0]:.3f} ms")
    return {**metrics[0], "step_ms": ms[0], "save_s": run_s - ms[0] / 1e3,
            "fingerprints": prints}


def ep_worker(cfg_in, mesh, dev, pre) -> dict:
    """Part 3's rank: its 80 experts drawn by ``ep_layer``, ``moe_layer``
    forward and backward twice (the first call includes the set-up); the
    second's results handed to the parent through CUDA IPC, kept until
    the parent has compared them."""
    import pickle
    import torch
    from torch.multiprocessing.reductions import reduce_tensor
    from repro_torch.models import moe
    cfg = family_cfg(MESH_ARCH, compute_dtype="float32")
    el = cfg.num_experts // mesh.size(1)
    lo = mesh.get_local_rank("model") * el
    p = ep_layer(cfg, dev, lo, lo + el)
    x, w = ep_inputs(cfg, dev)
    ms = []
    for _ in range(2):
        out, aux, gx, t = ep_run(moe.moe_layer, p, cfg, x, w)
        ms.append(t)
    got = {"experts": torch.tensor([lo, lo + el], device=dev), "out": out,
           "aux": aux, "grad.x": gx}
    got.update({f"grad.{n}": t.grad for n, t in p.named_parameters()})
    rank = mesh.get_local_rank("model")
    path = os.path.join(MESH_DIR, f"ep_handles{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump({k: reduce_tensor(v) for k, v in got.items()}, f)
    os.rename(path + ".tmp", path)
    release = os.path.join(MESH_DIR, "ep_release")
    deadline = time.perf_counter() + MESH_WORKER_TIMEOUT
    while not os.path.isfile(release):
        if time.perf_counter() > deadline:
            raise AssertionError(f"{pre} the parent never released")
        time.sleep(0.2)
    return {"experts": [lo, lo + el], "step_ms": ms}


def mesh_phase(dev) -> None:
    """The ``[mesh]`` phase: parts 1-5 (see the module's docstring); the
    launcher (part 5) runs beside parts 1 and 3, and part 2's workers
    start once it has ended (they need most of the card)."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import make_mesh, set_mesh
    t_phase = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    launcher = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "8", "-m", "repro_torch.launch.train",
         *MESH_LAUNCH, "--ckpt-dir", os.path.join(MESH_DIR, "launch")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(MESH_DIR, 'store1')}",
            rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1))
            set_mesh(mesh)
            for name, part in (("1", lambda: mesh_world1(mesh, dev)),
                               ("3", lambda: mesh_ep(dev)),
                               ("5", lambda: mesh_launcher(launcher,
                                                           t_phase)),
                               ("2 and 4", lambda: mesh_zero(mesh, dev))):
                t0 = time.perf_counter()
                part()
                torch.cuda.empty_cache()
                say(f"[mesh] part {name}: {time.perf_counter() - t0:.1f} s")
        finally:
            set_mesh(None)
            dist.destroy_process_group()
    finally:
        if launcher.poll() is None:
            launcher.kill()
            launcher.wait()
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    say(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s")


# -------------------------------------------------------------- [dryrun]
# the dry run (launch/dryrun.py): three cells of the matrix, each its own
# process (a fake process group of 256 or 512 ranks, fake tensors on the
# card), then the calibration: the steps [train] and [serve] ran, traced
# on fake tensors here against their real runs
DRYRUN_DIR = os.path.join(ROOT, "build", "dryrun")
DRYRUN_CELLS = (("minicpm-2b", "train_4k", "single", ()),
                ("deepseek-v2-236b", "decode_32k", "single", ()),
                ("mamba2-370m", "long_500k", "multi", ("--skip-cost-model",)))
DRYRUN_TIMEOUT = 600
# the traced peak against the real step's max_memory_allocated, relative
PEAK_TOL = 0.10
# what [train] and [serve] measured of one real step each, for [dryrun]
CALIBRATION: dict = {}


def measured_step(fn, args, dev) -> tuple[dict, object]:
    """One real step ``fn(*args)`` on the card under ``FlopCounterMode``:
    its flops, and its peak as the tracer counts it — the rise of
    ``max_memory_allocated`` over the step plus the bytes its arguments
    hold (each storage rounded up to the allocator's 512 B, as
    ``MemTracker`` rounds).  Returns (record, the step's output)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun
    held = sum(-(-b // 512) * 512 for _, b in
               dryrun._storages(dryrun._leaves(args)).values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    fc = FlopCounterMode(display=False)
    with fc:
        out = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    return {"flops": int(fc.get_total_flops()), "peak": peak - base + held,
            "held": held, "base": base}, out


def stop_all(procs) -> None:
    """Kill whichever of ``procs`` still runs, and reap it."""
    for *_, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def dryrun_cells() -> list:
    """Start the three cells as ``python -m repro_torch.launch.dryrun``
    processes at once; returns them with their outputs' paths.  They are
    host work (fake tensors) and run beside the phases that follow until
    ``[dryrun]`` reads them; whatever still runs when the smoke exits is
    killed."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    os.makedirs(DRYRUN_DIR)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    procs = []
    for arch, shape, mesh, extra in DRYRUN_CELLS:
        out = os.path.join(DRYRUN_DIR, f"{arch}.{shape}.{mesh}.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out", out, *extra]
        # stderr to a file: nobody reads a pipe until [dryrun]
        with open(out + ".err", "w") as err:
            procs.append(((arch, shape, mesh), out, time.time(),
                          subprocess.Popen(cmd, env=env,
                                           stdout=subprocess.DEVNULL,
                                           stderr=err)))
    atexit.register(stop_all, procs)
    return procs


def dryrun_results(procs, smi) -> None:
    """Wait for each cell; it must end ``ok``.  Prints its roofline terms,
    dominant term, peak per rank, useful flops ratio and seconds."""
    try:
        for cell, out, t0, proc in procs:
            try:
                proc.wait(timeout=DRYRUN_TIMEOUT)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"[dryrun] {cell} ran past "
                                     f"{DRYRUN_TIMEOUT} s")
            rec = json.load(open(out)) if os.path.isfile(out) else {}
            if proc.returncode != 0 or rec.get("status") != "ok":
                err = open(out + ".err").read()
                raise AssertionError(
                    f"[dryrun] {cell}: rc {proc.returncode}, status "
                    f"{rec.get('status')}: {rec.get('traceback', '')}"
                    f"{err[-3000:]}")
            rf = rec["roofline"]
            coll = rec["rolled_analysis"]["collectives"]["counts"]
            say(f"[dryrun] {' '.join(cell)} on {rec['chips']} fake ranks: "
                f"compute {rf['compute_s']:.6f} s, memory "
                f"{rf['memory_s']:.6f} s, collective {rf['collective_s']:.6f}"
                f" s per rank, dominant {rf['dominant']}, step lower bound "
                f"{rf['step_time_s']:.6f} s; {rf['flops_per_device']:,} "
                f"flops, {rf['hbm_bytes_per_device']:,} B, "
                f"{rf['wire_bytes_per_device']:,} wire B; collectives "
                f"{coll}; peak per rank {rec['hbm_per_device_bytes']:,} B; "
                f"useful flops ratio {rec['useful_flops_ratio']:.6f}; "
                f"{rec['rolled_analysis']['ops_traced']:,} ops traced in "
                f"{rec['trace_s']:.1f} s, the process "
                f"{os.path.getmtime(out) - t0:.1f} s to its record; "
                f"predicted from the "
                f"H100's data-sheet rates, {smi}")
    finally:
        stop_all(procs)


def calibrate(kind, trace_of, dev, smi) -> None:
    """The step ``[train]`` or ``[serve]`` ran, traced on fake tensors:
    its flops equal to the real step's, its peak within ``PEAK_TOL`` of
    the real one, the real step's time at least the roofline's bound."""
    from repro_torch.launch import roofline
    cal = CALIBRATION[kind]
    t0 = time.perf_counter()
    tr = trace_of(cal)
    trace_s = time.perf_counter() - t0
    roof = roofline.roofline_terms(tr["flops"], tr["bytes"], 0.0)
    rel = abs(tr["peak_bytes"] - cal["peak"]) / cal["peak"]
    say(f"[dryrun] calibration, {kind} ({cal['cfg'].name}): flops traced "
        f"{tr['flops']:,}, real {cal['flops']:,}; peak traced "
        f"{tr['peak_bytes']:,} B (arguments {tr['argument_bytes']:,}), "
        f"real {cal['peak']:,} B (arguments {cal['held']:,}), "
        f"{rel:.4f} apart; step real {cal['step_ms']:.3f} ms (CUDA events, "
        f"median), roofline bound {roof.step_time_s * 1e3:.3f} ms "
        f"({roof.dominant}: {tr['bytes']:,} B over the 3.35 TB/s data sheet "
        f"rate, {tr['ops']:,} ops); traced in {trace_s:.1f} s; {smi}")
    if tr["flops"] != cal["flops"]:
        raise AssertionError(f"[dryrun] {kind}: traced flops {tr['flops']} "
                             f"differ from the real step's {cal['flops']}")
    if rel > PEAK_TOL:
        raise AssertionError(f"[dryrun] {kind}: traced peak "
                             f"{tr['peak_bytes']} B is {rel:.4f} from the "
                             f"real step's {cal['peak']} B")
    if cal["step_ms"] < roof.step_time_s * 1e3:
        raise AssertionError(f"[dryrun] {kind}: the real step "
                             f"({cal['step_ms']:.3f} ms) beats the roofline's"
                             f" bound ({roof.step_time_s * 1e3:.3f} ms)")


def fake_train_trace(cal, dev) -> dict:
    """[train]'s in-place step on fake tensors of the same shapes."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun, steps
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    cfg, opt_cfg = cal["cfg"], cal["opt_cfg"]
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = init_params(cfg, device=dev)
        state = {"params": model, "opt": adamw.init_state(model, opt_cfg)}
        batch = {k: torch.empty(shape, dtype=dt, device=dev)
                 for k, (shape, dt) in cal["batch"].items()}
        return dryrun.trace_step(
            steps.make_train_step(cfg, opt_cfg, donate=True),
            (state, batch), device=dev)


def fake_decode_trace(cal, dev) -> dict:
    """[serve]'s decode step on fake tensors of the same shapes."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun
    from repro_torch.models.model import init_params
    cfg, pos = cal["cfg"], cal["pos"]
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = init_params(cfg, device=dev)
        cache = model.init_cache(*cal["cache"])
        shape, dt = cal["tok"]
        tok = torch.empty(shape, dtype=dt, device=dev)
        return dryrun.trace_step(
            lambda m, c, t: m.decode_step(c, t, pos), (model, cache, tok),
            device=dev)


def dryrun_phase(procs, dev, smi) -> None:
    """The ``[dryrun]`` phase: the calibration traces [train]'s and
    [serve]'s steps here, then the three cells that ``dryrun_cells``
    started before ``[baselines]`` are read."""
    t_phase = time.perf_counter()
    try:
        calibrate("train", lambda c: fake_train_trace(c, dev), dev, smi)
        calibrate("decode", lambda c: fake_decode_trace(c, dev), dev, smi)
    except BaseException:
        stop_all(procs)
        raise
    dryrun_results(procs, smi)
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    say(f"[dryrun] phase {time.perf_counter() - t_phase:.1f} s")


def overhead_phase(run) -> None:
    """The in-memory call (mode 0) with tracing and the ledger both on
    against both off, in turns (off, on, on, off): the mean of each
    state's two medians of 5 calls."""
    from repro_torch import obs
    plan, fs = run["plan"], run["factors"]
    times = {"off": [], "on": []}
    for state in ("off", "on", "on", "off"):
        if state == "on":
            obs.trace.enable()
            obs.ledger.enable()
        times[state].append(host_ms(lambda: plan.mttkrp(fs, 0)))
        obs.trace.disable()
        obs.ledger.disable()
    obs.trace.clear()
    obs.ledger.clear()
    off, on = (sum(times[s]) / 2 for s in ("off", "on"))
    say(f"[obs] {run['name']} in-memory mode-0 call: {off:.4f} ms with "
        f"tracing and the ledger off, {on:.4f} ms with both on "
        f"({(on / off - 1) * 100:+.2f}%; the reference's bar is +2%; not "
        f"gated)")


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
    if sys.argv[1:2] == ["--sharded-worker"]:
        return sharded_worker(int(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-worker"]:
        return mesh_worker(sys.argv[2], int(sys.argv[3]))
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
    # the uniform stream's host build runs beside the next phases
    uniform_pool = ThreadPoolExecutor(max_workers=1)
    uniform_built = uniform_pool.submit(timed, uniform_blco)
    uniform_pool.shutdown(wait=False)
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
    uniform_timing(uniform_built, dev)
    del uniform_built
    phases_timing(runs, rows)
    rates = h2d_rates(dev)
    stream_timing(runs, rates, dev)
    t_disk = time.perf_counter()
    disk_timing(runs, dev)
    say(f"[disk] timing {time.perf_counter() - t_disk:.1f} s")

    # the dry run's cells: host processes, read in [dryrun]
    dryrun_procs = dryrun_cells()
    t_phase = time.perf_counter()
    baselines_phase(runs, dev)
    say(f"[baselines] {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    reset_launch_counts()
    want = obs_phase(runs, rates, dev)
    obs_launches = dict(launch_counts)
    say(f"[obs] kernel launches of the sweeps: {obs_launches} (one per "
        f"mode in memory, chunks per mode streamed and from disk: {want}); "
        f"{time.perf_counter() - t_phase:.1f} s")
    if obs_launches != {k: want.get(k, 0) for k in KERNELS}:
        raise AssertionError(f"the [obs] sweeps launched {obs_launches}, "
                             f"expected {want}")
    for v in FUSED:
        launches[v] += obs_launches[v]
    overhead_phase(runs[0])
    reset_launch_counts()
    service_launches = service_phase(runs, dev)
    say(f"[service] kernel launches through the service: {service_launches}")
    if not all(service_launches.get(v, 0) > 0 for v in FUSED):
        raise AssertionError(f"a kernel of the service's path never ran: "
                             f"{service_launches}")
    for v in FUSED:
        launches[v] += service_launches[v]
    reset_launch_counts()
    sharded_launches = sharded_phase(runs, dev)
    say(f"[sharded] kernel launches of the sharded path: "
        f"{sharded_launches}")
    if not all(sharded_launches.get(v, 0) > 0 for v in FUSED):
        raise AssertionError(f"a kernel of the sharded path never ran: "
                             f"{sharded_launches}")
    for v in FUSED:
        launches[v] += sharded_launches[v]
    analysis_launches = analysis_phase(runs)
    if not all(analysis_launches.get(k, 0) > 0 for k in FUSED
               + ("segments",)):
        raise AssertionError(f"[analysis] a kernel of the phase never ran:"
                             f" {analysis_launches}")
    for k, n in analysis_launches.items():
        launches[k] += n
    reset_launch_counts()
    here, in_ranks = examples_phase()
    if dict(launch_counts) != here:
        raise AssertionError(f"[examples] launches {dict(launch_counts)}, "
                             f"the entry points' {here}")
    examples_launches = {k: here[k] + in_ranks[k] for k in KERNELS}
    say(f"[examples] kernel launches of the entry points: {here} in this "
        f"process, {in_ranks} in distributed_cpals' ranks")
    if not all(examples_launches[v] > 0 for v in FUSED):
        raise AssertionError(f"[examples] a kernel of the entry points never"
                             f" ran: {examples_launches}")
    for v in FUSED:
        launches[v] += examples_launches[v]
    reset_launch_counts()
    serve_phase(dev)
    if any(launch_counts.values()):
        raise AssertionError(f"[serve] launched {dict(launch_counts)}; the "
                             f"LM path runs no kernel of this port")
    reset_launch_counts()
    train_phase(dev)
    say(f"[train] kernel launches of the phase: {dict(launch_counts)}")
    if any(launch_counts.values()):
        raise AssertionError(f"[train] launched {dict(launch_counts)}; the "
                             f"training path runs no kernel of this port")
    reset_launch_counts()
    families_phase(dev)
    say(f"[families] kernel launches of the phase: {dict(launch_counts)}")
    if any(launch_counts.values()):
        raise AssertionError(f"[families] launched {dict(launch_counts)}; "
                             f"these families run no kernel of this port")
    reset_launch_counts()
    mesh_phase(dev)
    say(f"[mesh] kernel launches of the phase: {dict(launch_counts)}")
    if any(launch_counts.values()):
        raise AssertionError(f"[mesh] launched {dict(launch_counts)}; the "
                             f"mesh substrate runs no kernel of this port")
    reset_launch_counts()
    dryrun_phase(dryrun_procs, dev, smi)
    say(f"[dryrun] kernel launches of the phase: {dict(launch_counts)}")
    if any(launch_counts.values()):
        raise AssertionError(f"[dryrun] launched {dict(launch_counts)}; the "
                             f"dry run runs no kernel of this port")
    for run in runs:
        path = run["disk_plan"].stored.path
        run["disk_plan"].close()
        os.unlink(path)
        del run["tensor"]
    say("[disk] store files deleted")
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
