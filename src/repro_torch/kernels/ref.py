"""Plain PyTorch versions of the kernels, shape for shape: the fused K1
(segment) and K2 (stash), and the three-phase pipeline's K3 (delinearize),
K4 (segments) and K5 (stash).

The CPU path of every wrapper in ``repro_torch.kernels`` runs these, the
tests hold them against the JAX package's kernels, and ``chip_smoke.py``
holds the CUDA kernels against them on the card.  Nothing on a kernel path
calls them when the tensors lie on the card, except
``scatter_segments_ref``: the phases path's last step is plain PyTorch, as
the reference leaves it to XLA.  The decode, gather and multiply that K1
and K2 start with is ``core.mttkrp.partial_and_target``, which the plain
``kernel="torch"`` path shares.
"""
from __future__ import annotations

import torch

from repro_torch.core.mttkrp import delinearize, partial_and_target


def delinearize_ref(idx_hi, idx_lo, bases, *, field_bits, field_shifts):
    """K3: (T,) hi/lo uint32 + (T, N) int32 bases -> (T, N) int32
    coordinates."""
    fields = delinearize(field_bits, field_shifts, idx_hi, idx_lo)
    return torch.stack([f.to(torch.int32) + bases[:, n]
                        for n, f in enumerate(fields)], dim=1)


def _hadamard(vals, gathered):
    """value x the gathered rows, at ``promote_types(vals, rows)``."""
    partial = vals[:, None].to(torch.promote_types(vals.dtype,
                                                   gathered[0].dtype))
    for u in gathered:
        partial = partial * u
    return partial


def mttkrp_segments_ref(vals, tgt, gathered, *, tile: int):
    """K4: per-tile ``(seg_tgt (T,) int32 -1 padded, seg_sums (T, R))`` of
    value x hadamard(gathered rows); row k of tile j is the k-th run of
    equal target in that tile."""
    return segments_ref(tgt, _hadamard(vals, gathered), tile=tile)


def mttkrp_stash_ref(vals, tgt, gathered, *, out_rows: int):
    """K5: the whole (out_rows, R) output — a plain scatter-add of every
    partial."""
    return _scatter_add(tgt, _hadamard(vals, gathered), out_rows)


def _scatter_add(tgt, partial, out_rows: int):
    out = torch.zeros((out_rows, partial.shape[1]), dtype=partial.dtype,
                      device=partial.device)
    return out.index_add_(0, tgt, partial)


def segments_ref(tgt, partial, *, tile: int):
    """Per-tile on-the-fly segmented reduction (paper §5.1 steps 3-5).

    A segment starts at every tile boundary and wherever the target changes.
    Returns ``(seg_tgt (T,) int32 with -1 padding, seg_sums (T, R))``: row k
    of tile j holds the k-th segment of that tile.
    """
    t = tgt.shape[0]
    if t % tile:
        raise ValueError(f"stream of {t} slots is not a multiple of {tile}")
    pos = torch.arange(t, device=tgt.device)
    flags = (pos % tile == 0) | (tgt != torch.roll(tgt, 1))
    seg_global = torch.cumsum(flags.to(torch.int64), 0) - 1
    tile_id = pos // tile
    tile_first = seg_global.view(-1, tile)[:, 0]
    flat_seg = tile_id * tile + (seg_global - tile_first[tile_id])
    seg_sums = torch.zeros_like(partial).index_add_(0, flat_seg, partial)
    seg_tgt = torch.full((t,), -1, dtype=torch.int64, device=tgt.device)
    seg_tgt.scatter_reduce_(0, flat_seg, tgt.to(torch.int64), "amax")
    return seg_tgt.to(torch.int32), seg_sums


def scatter_segments_ref(seg_tgt, seg_sums, out_rows: int):
    """Final per-segment update (one update per segment, not per nnz);
    -1 rows are padding."""
    out = torch.zeros((out_rows, seg_sums.shape[1]), dtype=seg_sums.dtype,
                      device=seg_sums.device)
    keep = (seg_tgt >= 0)[:, None]
    return out.index_add_(0, seg_tgt.clamp(min=0).to(torch.int64),
                          torch.where(keep, seg_sums, 0))


def fused_segment_ref(idx_hi, idx_lo, vals, bases, factors, *, field_bits,
                      field_shifts, mode: int, tile: int):
    """K1's per-tile outputs ``(seg_tgt, seg_sums)``."""
    partial, tgt = partial_and_target(idx_hi, idx_lo, vals, bases, factors,
                                      re_fields=field_bits,
                                      re_shifts=field_shifts, mode=mode)
    return segments_ref(tgt, partial, tile=tile)


def fused_segment_mttkrp_ref(idx_hi, idx_lo, vals, bases, factors, *,
                             field_bits, field_shifts, mode: int,
                             out_rows: int, tile: int):
    """The plain version of K1 end to end: per-tile segments, then one
    scatter-add per segment -> (out_rows, R)."""
    seg_tgt, seg_sums = fused_segment_ref(
        idx_hi, idx_lo, vals, bases, factors, field_bits=field_bits,
        field_shifts=field_shifts, mode=mode, tile=tile)
    return scatter_segments_ref(seg_tgt, seg_sums, out_rows)


def fused_stash_ref(idx_hi, idx_lo, vals, bases, factors, *, field_bits,
                    field_shifts, mode: int, out_rows: int):
    """The plain version of K2: the whole (out_rows, R) output accumulated
    from every partial — a plain scatter-add."""
    partial, tgt = partial_and_target(idx_hi, idx_lo, vals, bases, factors,
                                      re_fields=field_bits,
                                      re_shifts=field_shifts, mode=mode)
    return _scatter_add(tgt, partial, out_rows)
