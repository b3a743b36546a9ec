"""Write-conflict prover for the plain fused variants + the conflict report.

The port's counterpart of the reference's ``conflicts.py``.  Two halves,
cross-checked against each other:

* **recorded facts** — the reference walks the fused kernel's jaxpr for
  its scatters and their ``unique_indices`` claims.  The port's CUDA
  kernels are opaque to the host (``op_audit``), so the facts come from
  the kernels' plain versions (``kernels/ref.py``, what a CPU tensor
  runs): every indexed write they make, recorded by ``op_audit``'s
  ``OpRecorder`` with whether it accumulates.  A non-accumulating write
  is the port's uniqueness claim (the last writer wins).  The write
  structure each variant has, and must keep:

  - *segment* (K1's plain version): per-slot writes only (the per-tile
    run sums, an ``index_add_`` into a ``(T, R)`` array, and the run
    targets, a ``scatter_reduce_`` into ``(T,)``), then exactly ONE
    accumulating ``index_add_`` of the runs into the ``(out_rows, R)``
    output, last — the same row can be targeted by several runs
    (non-adjacent repeats within a tile, repeats across tiles, and the
    padding runs that land on row 0);
  - *stash* (K2's plain version): exactly one indexed write, the stash
    update — an accumulating ``index_add_`` of every partial into the
    ``(out_rows, R)`` output.

* **conflict report** — the per-launch conflict *structure* of a real
  tensor, computed host-side from the BLCO encoding itself: segments per
  tile, writers per output row, and whether a uniqueness claim would be
  sound.  ``conflict_report`` is the reference's, statement for
  statement, over the port's ``decode_coords``, ``default_reservation``
  and ``choose_resolution``.  On the card K4 (``mttkrp_segments``) is
  held to it: the runs K4 writes in a launch (``seg_tgt >= 0``) are
  exactly the report's ``segments + padding_segments`` for that launch
  (``report_runs``), because a padding slot (value 0 at coordinate 0,
  base 0) targets row 0 and opens a run wherever the stream's target
  changes to 0 or a tile starts.
"""
from __future__ import annotations

import numpy as np

from repro_torch.analysis.linter import Finding

from .op_audit import PASS_CONFLICT, OpRecorder

_FUSED = "src/repro_torch/kernels/fused.py"

VARIANTS = ("segment", "stash")


def write_facts(variant: str) -> tuple[list[dict], list[Finding]]:
    """Every indexed write the plain version of one fused variant makes
    over the representative stream (``hotpaths.representative_stream``),
    in order, each marked ``into_output``; and the recorder's findings."""
    from repro_torch.kernels.fused import fused_mttkrp_flat

    from .hotpaths import representative_stream
    s = representative_stream("cpu")
    hi, lo, vals, bases = s.flat()
    mode = 0 if variant == "segment" else len(s.dims) - 1
    rec = OpRecorder(path=_FUSED, symbol=f"fused_mttkrp_flat[{variant}]")
    with rec:
        fused_mttkrp_flat(hi, lo, vals, bases, s.factors,
                          field_bits=s.fields, field_shifts=s.shifts,
                          mode=mode, out_rows=s.dims[mode],
                          resolution="register" if variant == "segment"
                          else "hierarchical")
    out_shape = (s.dims[mode], s.factors[0].shape[1])
    return [dict(f, into_output=f["out_shape"] == out_shape)
            for f in rec.writes], rec.findings


def prove_variant(variant: str, *, symbol: str | None = None):
    """Record one fused variant's plain version and prove its write-set
    structure.  Returns ``(facts, findings)``; empty findings = the proof
    holds."""
    symbol = symbol or f"fused_mttkrp_flat[{variant}]"
    facts, findings = write_facts(variant)
    return facts, findings + check_write_structure(facts, variant=variant,
                                                   symbol=symbol)


def check_write_structure(facts: list, *, variant: str,
                          symbol: str) -> list[Finding]:
    """The per-variant structure proof over recorded write facts."""
    findings = []

    def flag(msg):
        findings.append(Finding(pass_id=PASS_CONFLICT, path=_FUSED,
                                symbol=symbol, line=0, message=msg))

    outputs = [f for f in facts if f["into_output"]]
    if not outputs:
        flag("no indexed write into the (out_rows, R) output — the "
             "variant computes nothing")
    for f in outputs:
        if not f["accumulate"]:
            flag(f"'{f['op']}' writes the output without accumulating: it "
                 f"claims unique target rows, but several runs (or "
                 f"partials) can target one row — the last writer would "
                 f"win")
    if variant == "stash":
        if len(facts) != 1:
            flag(f"stash variant makes {len(facts)} indexed writes; its "
                 f"structure is ONE stash update of every partial")
    elif variant == "segment":
        if len(outputs) != 1:
            flag(f"segment variant makes {len(outputs)} updates of the "
                 f"output (expected exactly one per-run apply)")
        elif facts[-1] is not outputs[0]:
            flag("segment variant writes per-slot arrays after its "
                 "per-run apply")
    else:
        flag(f"unknown fused variant {variant!r}")
    return findings


def check_scatter_claims(facts: list, *, duplicates_possible: bool,
                         path: str, symbol: str) -> list[Finding]:
    """Generic check: no write may claim a uniqueness the write set
    violates — a non-accumulating indexed write (the port's claim) where
    duplicate targets are possible, or one that met duplicates."""
    findings = []
    for f in facts:
        if f["accumulate"]:
            continue
        if f["duplicates"] or (duplicates_possible
                               and f.get("into_output", True)):
            findings.append(Finding(
                pass_id=PASS_CONFLICT, path=path, symbol=symbol, line=0,
                message=f"'{f['op']}' into {f['out_shape']} writes without "
                        f"accumulating while the write set "
                        f"{'holds' if f['duplicates'] else 'can hold'} "
                        f"duplicate rows"))
    return findings


# ------------------------------------------------------------------ report
def conflict_report(blco, mode: int, *, tile: int = 256) -> dict:
    """Per-launch conflict structure of ``blco``'s fused-kernel write set.

    Pure host arithmetic over the encoding (no device, no tracing): the
    target coordinates come from ``decode_coords`` — i.e. from the very
    bit fields the kernel extracts — split into the reservation-padded
    flat stream exactly as ``LaunchCache.flat()`` lays it out, with
    segments discovered per tile the way the fused kernel discovers them.
    """
    from repro_torch.core.blco import decode_coords
    from repro_torch.core.launches import default_reservation
    from repro_torch.core.mttkrp import choose_resolution

    tgt_all = decode_coords(blco)[:, mode] if blco.nnz else \
        np.zeros(0, np.int64)
    max_launch = max((l.nnz for l in blco.launches), default=1)
    res = default_reservation(max_launch)
    tile = int(np.gcd(res, max(1, min(tile, res))))
    resolution = choose_resolution(blco.dims[mode])

    launches = []
    global_writers = np.zeros(blco.dims[mode], np.int64)
    for i, launch in enumerate(blco.launches):
        tgt = np.zeros(res, np.int64)
        valid = np.zeros(res, bool)
        n = launch.nnz
        tgt[:n] = tgt_all[launch.start:launch.end]
        valid[:n] = True

        # per-tile segment discovery: boundary at each tile start and
        # wherever the target changes (paper §5.1 step 3)
        pos = np.arange(res)
        prev = np.roll(tgt, 1)
        starts = (pos % tile == 0) | (tgt != prev)
        seg_starts = np.flatnonzero(starts)
        seg_valid = valid[seg_starts]           # segment has real data?
        seg_rows = tgt[seg_starts]

        writers = np.bincount(seg_rows[seg_valid],
                              minlength=blco.dims[mode])
        global_writers += writers
        conflict_rows = np.flatnonzero(writers > 1)
        padding_segments = int((~seg_valid).sum())
        launches.append({
            "launch": i,
            "nnz": int(n),
            "padded_nnz": int(res),
            "tiles": int(res // tile),
            "segments": int(seg_valid.sum()),
            "padding_segments": padding_segments,
            "distinct_rows": int((writers > 0).sum()),
            "max_writers_per_row": int(writers.max()) if n else 0,
            "conflict_rows": [int(r) for r in conflict_rows[:8]],
        })

    max_writers = int(global_writers.max()) if blco.nnz else 0
    return {
        "mode": int(mode),
        "dims": [int(d) for d in blco.dims],
        "tile": int(tile),
        "reservation": int(res),
        "resolution": resolution,
        "launches": launches,
        "total_segments": int(sum(l["segments"] for l in launches)),
        # writers per row across the ONE fused scatter (all launches'
        # segments merge in a single update step)
        "max_writers_per_row_per_step": max_writers,
        # padding segments always target row 0 with zero sums, so the
        # final scatter sees duplicate indices whenever any padding or
        # any repeated target exists:
        "unique_indices_sound": bool(
            max_writers <= 1
            and all(l["padding_segments"] == 0 for l in launches)),
    }


def report_runs(report: dict) -> list[int]:
    """Runs per launch that K4 writes for the report's stream and tile:
    the segments that start at a real slot plus those that start at a
    padding slot (which target row 0)."""
    return [l["segments"] + l["padding_segments"]
            for l in report["launches"]]


def k4_runs(cache, factors, mode: int, *, tile: int) -> list[int]:
    """Runs K4 (``mttkrp_segments``) writes (``seg_tgt >= 0``) in each
    launch of ``cache``'s flat stream at ``tile``: one launch of the
    kernel on the card, its plain version on the CPU.  The coordinates are
    extracted in plain PyTorch (``core.u64``), not by K3."""
    import torch

    from repro_torch.core import u64
    from repro_torch.kernels import mttkrp_segments
    hi, lo, vals, bases = cache.flat()
    words = u64.widen(hi, lo)

    def coord(m):
        return (u64.field(words, cache.re_shifts[m], cache.re_fields[m])
                + bases[:, m]).to(torch.int32)

    gathered = tuple(factors[m].index_select(0, coord(m))
                     for m in range(cache.order) if m != mode)
    tgt = coord(mode)
    del words
    seg_tgt, _ = mttkrp_segments(vals, tgt, gathered, tile=tile)
    del gathered
    runs = (seg_tgt.view(cache.num_launches, cache.reservation) >= 0).sum(1)
    return [int(n) for n in runs.cpu()]


def audit_conflicts(blco=None, *, mode: int = 0, tile: int = 256):
    """Tier entry: prove both variants + report a representative tensor.

    Returns ``(findings, report)``.  Cross-check: when the report shows
    conflicting writers, no recorded write of the segment variant may
    write the output without accumulating (the structural proof already
    enforces it; the report makes the *reason* machine-readable per
    launch).
    """
    findings = []
    facts = {}
    for variant in VARIANTS:
        facts[variant], fs = prove_variant(variant)
        findings.extend(fs)
    if blco is None:
        from repro_torch.core.blco import build_blco
        from repro_torch.core.tensor import random_tensor
        blco = build_blco(random_tensor((40, 25, 30), 2000, seed=1,
                                        dist="powerlaw"),
                          target_bits=12, max_nnz_per_block=256)
    report = conflict_report(blco, mode, tile=tile)
    if not report["unique_indices_sound"]:
        findings.extend(check_scatter_claims(
            facts["segment"], duplicates_possible=True, path=_FUSED,
            symbol="fused_mttkrp_flat[segment]"))
    return findings, report
