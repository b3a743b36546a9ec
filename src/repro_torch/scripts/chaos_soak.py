"""Env-driven chaos soak: the CI chaos lane's entry point.

The port's counterpart of ``scripts/chaos_soak.py``, with its workload.
Runs a fixed mixed-tenant workload through the async service runtime
with whatever ``REPRO_FAULTS`` plan is installed (``repro_torch.faults``
reads the variable when it is imported; a caller in the same process
installs a plan with ``inject.install`` or ``inject.reload_from_env``),
records a full span trace, and asserts the robustness invariants:

  * the worker thread survives (watchdog restarts are fine, death isn't),
  * every job ends DONE — matching a fault-free run of the same workload
    — or FAILED with an explanatory ``error_payload``,
  * the admission ledger drains to zero (audited continuously when
    ``REPRO_SANITIZE=1``, asserted at the end regardless), and the
    bandwidth ledger's edges equal the retired jobs' byte totals.

A done job must be bit-identical to the fault-free run on the CPU.  On
the card K1 adds across CTAs with atomics and K2 merges per-CTA stashes,
so two runs of one job may differ in the last bits: there a done job is
held within ``FIT_TOL`` of the fault-free fits, and the largest |Δfit|
and |Δfactor| are printed beside ``bit-identical`` or ``within
tolerance``.

Exit status is non-zero on any violation; the Chrome trace is written to
``--trace-out`` either way so CI can attach it to failures.

    REPRO_FAULTS="1234:store.read@n=2:transient;runtime.quantum@n=3:crash" \
        REPRO_SANITIZE=1 PYTHONPATH=src \
        python -m repro_torch.scripts.chaos_soak --trace-out chaos.json
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.core.tensor import SparseTensor
from repro_torch.examples import device_parser, kernel_for
from repro_torch.faults import inject
from repro_torch.obs import ledger as obs_ledger
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.slo import TelemetryExporter
from repro_torch.service import GetTrace, ServiceRuntime, SubmitDecomposition

WORKLOAD = ((0, 1, "acme", 1.0), (1, 2, "umbrella", 2.0),
            (0, 3, "umbrella", 1.0))
RANK, ITERS = 8, 6
# |Δfit| a done job may show against the fault-free run on the card
# (chip_smoke.py's FIT_TOL); on the CPU it must be 0
FIT_TOL = 1e-3


def _tensor(seed, nnz=500, dim=12):
    rng = np.random.default_rng(seed)
    return SparseTensor(
        indices=rng.integers(0, dim, size=(nnz, 3)).astype(np.int64),
        values=rng.standard_normal(nnz).astype(np.float32),
        dims=(dim, dim, dim))


def _run(store_dir, *, faults, device, export_jsonl=None, export_prom=None):
    """One workload pass; returns (outcome, metrics, trace, ok, exporter).

    ``outcome[n]`` is ``(state, fits, factors, error_payload)``."""
    ctx = inject.active(None) if not faults else contextlib.nullcontext()
    exp_counters = None
    with ctx:
        with ServiceRuntime(device_budget_bytes=256 << 20,
                            store_dir=store_dir, host_budget_bytes=1,
                            device=device,
                            kernel=kernel_for(device)) as rt:
            exporter = None
            if export_jsonl is not None:
                # runs in its own daemon thread: worker crashes and
                # watchdog restarts must not interrupt the export cadence
                exporter = TelemetryExporter(rt, interval_s=0.2,
                                             jsonl_path=export_jsonl,
                                             prom_path=export_prom)
                exporter.start()
            try:
                ids = [rt.submit(SubmitDecomposition(
                    tensor=_tensor(ts), rank=RANK, iters=ITERS, tol=0.0,
                    seed=ss, tenant=tenant, weight=weight))
                    for ts, ss, tenant, weight in WORKLOAD]
                ok = rt.drain(timeout=600)
                out = {}
                for n, jid in enumerate(ids):
                    st = rt.status(jid)
                    if st.state == "done":
                        res = rt.result(jid).result
                        out[n] = ("done", [float(f) for f in res.fits],
                                  [f.detach().cpu().numpy()
                                   for f in res.factors], None)
                    else:
                        out[n] = (st.state, None, None, st.error_payload)
                metrics = rt.service_metrics()
                trace = rt.trace(GetTrace(drain=True))
                dead = rt._error is not None
            finally:
                if exporter is not None:
                    alive_at_stop = exporter.running
                    exporter.stop()
                    exp_counters = dict(exporter.counters(),
                                        alive_at_stop=alive_at_stop)
    return out, metrics, trace, ok and not dead, exp_counters


def _largest_deltas(fits, factors, ref) -> tuple[float, float]:
    """max |Δfit| and max |Δfactor| of a done job against its fault-free
    run (inf where the sweep counts or shapes differ)."""
    _, ref_fits, ref_factors, _ = ref
    if len(fits) != len(ref_fits):
        return float("inf"), float("inf")
    dfit = max((abs(a - b) for a, b in zip(fits, ref_fits)), default=0.0)
    dfac = max(float(np.max(np.abs(a.astype(np.float64) - b)))
               for a, b in zip(factors, ref_factors))
    return dfit, dfac


def main(argv=None) -> int:
    ap = device_parser(__doc__)
    ap.add_argument("--trace-out", default="chaos_trace.json")
    ap.add_argument("--telemetry-out", default=None, metavar="JSONL",
                    help="run the TelemetryExporter against the faulted "
                         "runtime and write its JSONL feed here "
                         "(default: a temp file, kept only on request)")
    args = ap.parse_args(argv)
    # tracing is on for the soak only: a caller in the same process finds
    # it as it was
    with obs_trace.enabled():
        return _soak(args)


def _soak(args) -> int:
    on_cpu = torch.device(args.device).type == "cpu"
    tol = 0.0 if on_cpu else FIT_TOL
    plan = inject.FAULTS.plan
    print(f"chaos soak: fault plan = {plan!r} on {args.device}")

    with tempfile.TemporaryDirectory() as ref_dir:
        ref, ref_metrics, _, ref_ok, _ = _run(ref_dir, faults=False,
                                              device=args.device)
    if not ref_ok or any(v[0] != "done" for v in ref.values()):
        print("FATAL: fault-free reference run failed", file=sys.stderr)
        return 2

    jsonl_path = args.telemetry_out or os.path.join(
        tempfile.gettempdir(), f"chaos_telemetry_{os.getpid()}.jsonl")
    obs_ledger.clear()
    obs_ledger.enable()
    try:
        with tempfile.TemporaryDirectory() as store_dir:
            out, metrics, trace, alive, exp = _run(
                store_dir, faults=True, device=args.device,
                export_jsonl=jsonl_path, export_prom=jsonl_path + ".prom")
        ledger_snap = obs_ledger.snapshot()
    finally:
        obs_ledger.disable()

    with open(args.trace_out, "w") as f:
        json.dump(trace, f)
    print(f"trace: {len(trace.get('traceEvents', []))} events "
          f"-> {args.trace_out}")

    violations = []
    if not alive:
        violations.append("worker died (or drain timed out)")
    for n, (state, fits, factors, payload) in sorted(out.items()):
        if state == "done":
            dfit, dfac = _largest_deltas(fits, factors, ref[n])
            if fits == ref[n][1]:
                tag = "bit-identical"
            elif dfit <= tol:
                tag = "within tolerance"
            else:
                tag = "DIVERGED"
            print(f"  job {n}: done, {tag} (max |dfit| {dfit:.3e}, "
                  f"max |dfactor| {dfac:.3e})")
            if tag == "DIVERGED":
                violations.append(f"job {n} completed but diverged "
                                  f"from the fault-free reference")
        elif state == "failed" and payload:
            print(f"  job {n}: failed ({payload.get('type')}: "
                  f"{payload.get('message')})")
        else:
            violations.append(f"job {n} ended {state!r} without an "
                              f"explanatory payload")
    for key in ("retries_total", "giveups_total", "demotions_total",
                "watchdog_restarts", "store_rebuilds", "jobs_failed"):
        print(f"  {key} = {metrics[key]}")
    if metrics["admitted_reservation_bytes"] != 0:
        violations.append(
            f"ledger leak: admitted_reservation_bytes = "
            f"{metrics['admitted_reservation_bytes']}")

    # fault balance: under retries the transfer is re-attempted but both
    # the EngineStats counter and the bandwidth ledger record once, after
    # success; a giveup raises before either records.  Every job reaches a
    # terminal state here, so the retired-job byte totals must equal the
    # ledger's edge accounts exactly (integer byte counts — order-free).
    edges = ledger_snap.get("edges", {})
    for edge, stats_key in (("host_device", "h2d_bytes_total"),
                            ("disk_host", "disk_bytes_total")):
        lv = int(edges.get(edge, {}).get("bytes", 0))
        sv = int(metrics[stats_key])
        print(f"  ledger[{edge}].bytes = {lv}  ({stats_key} = {sv})")
        if lv != sv:
            violations.append(
                f"bandwidth ledger imbalance on {edge}: ledger {lv} B "
                f"!= {stats_key} {sv} B (double-count or drop under "
                f"faults)")

    # the exporter runs on its own thread: worker crashes + watchdog
    # restarts must not stop the telemetry cadence
    if exp is None:
        violations.append("telemetry exporter never ran")
    else:
        print(f"  telemetry: {exp['exports']} exports, "
              f"{exp['failures']} failures across "
              f"{metrics['watchdog_restarts']} worker restart(s) "
              f"-> {jsonl_path}")
        if exp["exports"] < 1:
            violations.append("telemetry exporter produced no exports")
        if exp["failures"]:
            violations.append(
                f"telemetry exporter recorded {exp['failures']} "
                f"failed export(s)")
        if not exp["alive_at_stop"]:
            violations.append("telemetry exporter thread died before "
                              "shutdown (did not survive the soak)")
    if not args.telemetry_out:
        for p in (jsonl_path, jsonl_path + ".prom"):
            try:
                os.unlink(p)
            except OSError:
                pass

    if violations:
        print("CHAOS SOAK FAILED:", file=sys.stderr)
        for v in violations:
            print(f"  - {v}", file=sys.stderr)
        return 1
    print("chaos soak clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
