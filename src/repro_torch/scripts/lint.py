"""repro-lint: run the port's static-analysis tiers (see repro_torch.analysis).

The port's counterpart of ``scripts/lint.py``, with its flags and exit
codes.

Usage:
    python -m repro_torch.scripts.lint [paths...] [--tier ast|trace|all]
        [--baseline src/repro_torch/analysis/lint_baseline.json]
        [--format text|json] [--write-baseline] [--prune-baseline]
        [--report-out PATH] [--list] [--device cpu]

Tiers:
    ast    (default) the AST lint passes over Python source;
    trace  the trace tier: the op audit of the registered hot paths (on
           the card under ``torch.cuda.set_sync_debug_mode("error")``,
           or on the CPU with ``--device cpu``), cache-key bounds,
           symbolic BLCO encoding proofs and the fused variants' write
           structure with the per-launch conflict report;
    all    both.

Default paths: ``src/repro_torch`` and ``chip_smoke.py`` (AST tier only —
the trace tier audits the registered hot paths, not a path list).  Exit
status 1 when any finding is not covered by the committed baseline (or an
inline ``# repro-lint: disable=<pass>`` comment), or when the baseline
carries STALE entries — suppressions whose finding no longer exists must
be removed, which ``--prune-baseline`` does in place.
``--write-baseline`` records the current findings as the new baseline —
entries are stamped with a placeholder reason that MUST be replaced with
a real justification before committing.  ``--report-out`` writes the
trace tier's artifact bundle (conflict report, encoding proofs, verifier
metrics, hot paths) as JSON.
"""
from __future__ import annotations

import json
import os
import sys

from repro_torch.analysis import (BASELINE_PATH, Baseline, all_passes,
                                  lint_paths, run_trace_tier)
from repro_torch.examples import device_parser

# the checkout that holds this package: src/repro_torch/scripts/lint.py
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
DEFAULT_PATHS = [os.path.join(REPO_ROOT, "src", "repro_torch"),
                 os.path.join(REPO_ROOT, "chip_smoke.py")]


def main(argv=None) -> int:
    ap = device_parser(__doc__)
    ap.add_argument("paths", nargs="*", default=DEFAULT_PATHS)
    ap.add_argument("--tier", choices=("ast", "trace", "all"),
                    default="ast",
                    help="which analysis tier(s) to run (default: ast)")
    ap.add_argument("--baseline", default=BASELINE_PATH)
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings as the suppression "
                         "baseline (justify every entry before committing)")
    ap.add_argument("--prune-baseline", action="store_true",
                    help="rewrite the baseline dropping stale entries "
                         "(suppressions whose finding no longer exists)")
    ap.add_argument("--report-out", default=None, metavar="PATH",
                    help="write the trace tier's artifact bundle (conflict "
                         "report + encoding proofs + metrics) as JSON")
    ap.add_argument("--list", action="store_true",
                    help="list the registered passes and exit")
    args = ap.parse_args(argv)

    if args.list:
        for p in all_passes():
            print(f"{p.pass_id:24s} {p.description}")
        if args.tier in ("trace", "all"):
            from repro_torch.analysis.trace import TRACE_PASS_IDS
            for pid in TRACE_PASS_IDS:
                print(f"{pid:24s} (trace tier)")
        return 0

    findings = []
    ran_pass_ids = set()
    if args.tier in ("ast", "all"):
        findings.extend(lint_paths(args.paths, root=REPO_ROOT))
        ran_pass_ids |= {p.pass_id for p in all_passes()}
    bundle = None
    if args.tier in ("trace", "all"):
        from repro_torch.analysis.trace import TRACE_PASS_IDS
        trace_findings, bundle, _metrics = run_trace_tier(device=args.device)
        findings.extend(trace_findings)
        ran_pass_ids |= set(TRACE_PASS_IDS)

    if args.report_out and bundle is not None:
        with open(args.report_out, "w", encoding="utf-8") as fh:
            json.dump(bundle, fh, indent=2, sort_keys=True)
            fh.write("\n")

    if args.write_baseline:
        Baseline.from_findings(
            findings,
            reason="TODO: justify or fix (recorded by --write-baseline)",
        ).save(args.baseline)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    baseline = Baseline([]) if args.no_baseline else Baseline.load(
        args.baseline)
    unsuppressed = [f for f in findings if not baseline.suppresses(f)]
    # only entries for the tier(s) that actually ran can be judged stale —
    # an AST-tier suppression is not stale just because only the trace
    # tier was invoked
    stale = [e for e in baseline.stale_entries(findings)
             if e["pass"] in ran_pass_ids]

    if args.prune_baseline:
        if stale:
            keep = [e for e in baseline.entries if e not in stale]
            Baseline(keep).save(args.baseline)
            print(f"pruned {len(stale)} stale entr"
                  f"{'y' if len(stale) == 1 else 'ies'} from "
                  f"{args.baseline}")
        else:
            print(f"no stale entries in {args.baseline}")
        stale = []

    if args.format == "json":
        print(json.dumps({
            "findings": [vars(f) for f in unsuppressed],
            "suppressed": len(findings) - len(unsuppressed),
            "stale_baseline_entries": stale,
        }, indent=2))
    else:
        for f in unsuppressed:
            print(f.render())
        for e in stale:
            print(f"error: stale baseline entry "
                  f"{e['pass']}:{e['path']}:{e['symbol']} — the finding it "
                  f"suppressed no longer exists; run --prune-baseline")
        n_sup = len(findings) - len(unsuppressed)
        print(f"repro-lint[{args.tier}]: {len(unsuppressed)} finding(s), "
              f"{n_sup} baseline-suppressed, {len(stale)} stale baseline "
              f"entr{'y' if len(stale) == 1 else 'ies'}")
    return 1 if (unsuppressed or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
