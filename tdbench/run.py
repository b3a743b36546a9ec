"""The benchmark of ``repro_torch``'s CP-ALS: one run of one cell.

    python3 tdbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

In order: the cell's COO tensor is generated on the card from the seed and
handed to the program as host numpy (``SparseTensor`` -> ``build_blco``);
``plan_for`` plans it under the card's free memory; ``cp_als_init`` starts
from initial factors made from the seed, with ``tol=0`` so that no sweep is
skipped as converged; the traffic's warm-up sweeps warm up every shape and
are checked; then ``cp_als_step`` runs back to back (a closed loop, one job) for
``--seconds``.  After the window one more sweep is checked, the program is
freed, and the reference judges the checked sweeps (``check.py``).

The last line of standard output is the result, with the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics (``--trace 1``,
where the window's sweeps and MTTKRP calls are timed as spans and a slice
of sweeps after it runs under ``torch.profiler``).  ``--control`` puts the
reference, computed in TF32, in the program's place: the control that has
to come out not correct; the benchmark's own runs never pass it.
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import torch  # noqa: E402

from repro_torch.core import (  # noqa: E402
    SparseTensor, build_blco, cp_als_init, cp_als_step)
from repro_torch.engine import plan_for  # noqa: E402
from tdbench import (  # noqa: E402
    check, gen, manifest, reference, tracing, work)

# modules that may not be loaded in a run, by their top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the program's kernel path on each kind of device
KERNEL = {"cuda": "cuda", "cpu": "torch"}
# sweeps under torch.profiler after the traced run's window
PROFILED_SWEEPS = 20


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def budget_bytes(device: torch.device) -> int:
    """The plan's memory budget: the card's free memory."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def device_info(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak,
            "power_limit": smi or "unknown"}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def p95(values) -> float:
    """Nearest-rank 95th percentile."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", control: bool = False, start: float | None = None,
             spec: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result line's object."""
    start = time.perf_counter() if start is None else start
    spec = spec if spec is not None else manifest.cell(name)
    cfg, traffic = spec["config"], spec["traffic"]
    dev = torch.device(device)
    dims, rank = [int(d) for d in cfg["dims"]], int(cfg["rank"])
    rtol = float(cfg["pinv_rtol"])
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- inputs: the tensor and the initial factors, from the seed
    idx_dev, vals_dev = gen.generate(cfg, seed, dev)
    norm_x = float(torch.linalg.vector_norm(vals_dev.double()))
    idx, vals = idx_dev.cpu().numpy(), vals_dev.cpu().numpy()
    del idx_dev, vals_dev
    factors = gen.initial_factors(cfg, seed, dev)
    start_factors = [check.host(f) for f in factors]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- the program (or the control in its place)
    build = None
    if control:
        plan = reference.Control(torch.from_numpy(idx).to(dev),
                                 torch.from_numpy(vals).to(dev))
        step = reference.Control.step
        state = reference.State(factors=factors, norm_x=norm_x, rtol=rtol,
                                lam=torch.ones(rank, device=dev))
    else:
        blco = build_blco(SparseTensor(tuple(dims), idx, vals))
        build = dict(blco.construction_stats)
        plan = plan_for(blco, budget_bytes(dev), rank=rank,
                        kernel=KERNEL[dev.type], device=dev, sanitize=False)
        del blco
        if plan.backend != traffic["regime"]:
            raise RuntimeError(f"plan_for chose {plan.backend}, the traffic "
                               f"asks for {traffic['regime']}")
        step = cp_als_step
        # tol 0: a converged state would return unchanged, as a free sweep
        state = cp_als_init(tuple(dims), rank, norm_x=norm_x, tol=0.0,
                            factors=factors)
    del factors

    # ---- set-up's sweeps: warm-up, every one checked
    checked, inputs = [], start_factors
    for _ in range(int(traffic["warmup_sweeps"])):
        checked.append(check.checked_sweep(step, plan, state, inputs))
        inputs = checked[-1].factors
    sync(dev)
    setup_s = time.perf_counter() - start

    # ---- the window: sweeps back to back for `seconds`
    stats = getattr(plan, "stats", None)
    dispatch0 = stats().dispatch_time_s if stats else None
    spans = tracing.Spans(plan) if trace else None
    target = spans if trace else plan
    iteration0, times, mttkrp_s = state.iteration, [], []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        before = spans.mttkrp_s if trace else 0.0
        step(target, state)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if trace:
            mttkrp_s.append(spans.mttkrp_s - before)
        if t1 - t_start >= seconds:
            break
    window_s = t1 - t_start
    counted = len(times)
    sweeps_gap = abs(state.iteration - iteration0 - counted)
    fits = state.fits[-counted:]
    failed = sum(1 for f in fits if not math.isfinite(f))
    dispatch_s = stats().dispatch_time_s - dispatch0 if stats else None

    profile = None
    if trace:
        profile = profiled_slice(step, plan, state,
                                 PROFILED_SWEEPS, dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0

    # ---- one more checked sweep, on the state the window left
    checked.append(check.checked_sweep(
        step, plan, state, [check.host(f) for f in state.factors],
        solve=False))
    sync(dev)
    if hasattr(plan, "close"):
        plan.close()
    del plan, state, target, spans, stats
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gaps, detail = check.judge(torch.from_numpy(idx), torch.from_numpy(vals),
                               norm_x, checked, rtol, dev)
    for k, d in enumerate(detail):
        print(f"checked sweep {k}: " + ", ".join(
            f"{n} {v!r}" for n, v in d.items()), file=sys.stderr)
    if profile:
        print("profile: " + ", ".join(
            f"{n} {v!r}" for n, v in profile.items()), file=sys.stderr)
    gaps["sweeps_gap"] = float(sweeps_gap)
    limits = {k: float(v) for k, v in cfg["limits"].items()}
    correct = failed == 0 and all(gaps[k] <= limits[k] for k in limits)

    result = {"correct": bool(correct), "attempted": counted,
              "failed": failed, "metrics": {},
              "device": device_info(dev, peak)}
    if trace:
        run = {"dims": dims, "nnz": int(cfg["nnz"]), "rank": rank,
               "build": build, "sweeps": counted, "sweep_s": times,
               "mttkrp_s": mttkrp_s, "dispatch_s": dispatch_s,
               "profile": profile, "work": work}
        for m in spec["per_layer"]:
            value = manifest.reader(m["name"])(run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        if profile:
            result["device"]["busy_s"] = profile["busy_s"]
            result["device"]["window_s"] = profile["window_s"]
            result["breakdown"] = {"device_ops": profile["device_ops"],
                                   "idle_gaps": profile["idle_gaps"]}
    else:
        e2e = {"setup_s": setup_s, "sweep_ms": window_s / counted * 1e3,
               "sweep_p95_ms": p95(times) * 1e3, "peak_device_gb": peak / 1e9}
        for m in spec["end_to_end"]:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
    result["checks"] = {k: {"value": gaps[k], "limit": limits[k]}
                        for k in limits}
    return result


def profiled_slice(step, plan, state, sweeps: int, dev) -> dict | None:
    """``sweeps`` sweeps under ``torch.profiler``, each in a ``sweep``
    annotation and each MTTKRP call in its own; the trace's summary."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile, record_function
    spans = tracing.Spans(plan, annotate=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(sweeps):
            with record_function(tracing.SWEEP):
                step(spans, state)
        torch.cuda.synchronize(dev)
    return tracing.summarize(prof.events())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="the reference in TF32 in the program's place")
    args = ap.parse_args(argv)
    spec = manifest.cell(args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), control=args.control, start=START,
                      spec=spec)
    found = forbidden_modules()
    if found:
        print(f"modules that may not be loaded were: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
