"""The computing phase of the three-phase pipeline (paper §5.1.2, §5.2), from
pre-gathered factor rows.

The port of ``repro.kernels.blco_mttkrp``.  Both kernels multiply each value
with its N-1 gathered non-target rows (at ``promote_types(vals, rows)``) and
resolve conflicts in one of the paper's two ways:

``mttkrp_segments`` (K4, register analogue, §5.2)
    Per tile of ``tile`` non-zeros, runs of equal target are found on the
    fly in stream order and summed: ``(seg_tgt, seg_sums)`` with row k of
    tile j the k-th run of that tile, -1 / zero rows after the last run.
    The caller makes one update per run (``ref.scatter_segments_ref``).
``mttkrp_stash`` (K5, hierarchical, §5.1 steps 5-7)
    For short target modes the whole (out_rows, R) output is accumulated in
    a per-CTA shared-memory stash and merged; it must fit
    ``STASH_MAX_BYTES``, and a larger one is refused on every device.

On the card each call is exactly one launch (``csrc/phases.cu``); given CPU
tensors the wrappers run the plain versions in ``ref.py``.  K4 launches one
wave of CTAs whose warps stream the tiles through rings of shared-memory
stages (``segments_layout``); what the card is asked for the launch (SM
count, occupancy, the raised shared-memory limit) is asked once per key
(``phases_occupancy``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import ref
from .common import (DTYPE_PAIRS, MAX_ORDER, STASH_MAX_BYTES,
                     check_contiguous, check_dtype_pair, device_index,
                     launch_counts, one_device, raise_on_error)

MAX_TILE = 256      # MAX_TILE in csrc/phases.cu
# K4's shape (K4_WARPS, K4_MAX_STAGES, K4_MAX_ROWS, K4_BAR_BYTES in
# csrc/phases.cu): warps per CTA, stages in each warp's ring at most, slots
# per stage at most, and the bytes of a ring's mbarriers
K4_WARPS = 4
K4_MAX_STAGES = 3
K4_MAX_ROWS = 32
K4_BAR_BYTES = 32
# the most dynamic shared memory a CTA may take for two to fit one SM:
# Hopper's 228 KB per SM, less 1 KB that the card keeps per CTA, halved.
# Two CTAs (8 warps) per SM hide the walk's latency; one does not
K4_PAIR_BYTES = (228 * 1024) // 2 - 1024
# phases_occupancy's kernel codes
QUERY = {"delinearize": 0, "segments": 1, "stash_phases": 2}
# K4's two ways of filling a stage, and its launches with each (on the card
# only, like launch_counts)
FILLS = ("bulk", "cp.async")
segments_fills = {f: 0 for f in FILLS}


def _r16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _stage_bytes(rows, rank, n_gathered, vals_itemsize, rows_itemsize):
    return (_r16(rows * vals_itemsize) + _r16(rows * 4)
            + n_gathered * _r16(rows * rank * rows_itemsize))


def _k4_smem(rows, stages, rank, n_gathered, vals_itemsize,
             rows_itemsize) -> int:
    """Dynamic shared memory of one K4 CTA (``seg_layout`` in
    ``csrc/phases.cu``): per warp its barriers, the carried sums of a run
    (R values at the output type) and ``stages`` stages."""
    out_itemsize = max(vals_itemsize, rows_itemsize)
    return K4_WARPS * (K4_BAR_BYTES + _r16(rank * out_itemsize) + stages
                       * _stage_bytes(rows, rank, n_gathered, vals_itemsize,
                                      rows_itemsize))


@dataclasses.dataclass(frozen=True)
class SegmentsLayout:
    """How one K4 call cuts a stream of ``t`` slots: ``tasks`` tasks of
    ``span`` slots (one tile, or ``rows`` slots of whole tiles), each in
    ``pieces_per_task`` pieces of at most ``rows`` slots, one per stage."""
    t: int
    tile: int
    rows: int
    stages: int             # stages in each warp's ring
    span: int
    pieces_per_task: int
    tasks: int
    stage_bytes: int
    smem: int               # dynamic shared memory per CTA
    bulk: bool              # bulk copies; else cp.async per element

    @property
    def fill(self) -> str:
        return FILLS[0] if self.bulk else FILLS[1]

    def blocks(self, sms: int, blocks_per_sm: int) -> int:
        """CTAs of one wave: no more than the card holds at once, nor than
        the tasks keep busy."""
        return max(1, min(sms * blocks_per_sm, -(-self.tasks // K4_WARPS)))


def segments_layout(t: int, tile: int, rank: int, n_gathered: int,
                    vals_itemsize: int, rows_itemsize: int, *,
                    aligned: bool) -> SegmentsLayout:
    """K4's layout for a stream of ``t`` slots.

    Each warp's ring holds 3, else 2, stages of up to ``K4_MAX_ROWS`` slots:
    the first such (more slots first, a multiple of 4 slots before 3, 2 or
    1) that lets two CTAs share an SM (``K4_PAIR_BYTES``), else that fits
    one CTA (``STASH_MAX_BYTES``).  A short tile's stages hold whole tiles.
    The fill is bulk copies exactly when every span they would copy is
    16-byte aligned: ``aligned`` (every tensor's first byte is), and every
    piece's first slot and length a multiple of 4.  Raises ``ValueError``
    for a shape whose two stages of one slot would not fit."""
    if t < 1 or not 1 <= tile <= MAX_TILE or t % tile or rank < 1 \
            or not 1 <= n_gathered <= MAX_ORDER - 1:
        raise ValueError(f"no K4 layout for t={t}, tile={tile}, "
                         f"rank={rank}, {n_gathered} gathered row sets")
    sizes = (rank, n_gathered, vals_itemsize, rows_itemsize)
    fit = next(((r, n) for rows in (range(K4_MAX_ROWS, 3, -4), (3, 2, 1))
                for budget in (K4_PAIR_BYTES, STASH_MAX_BYTES) for r in rows
                for n in range(K4_MAX_STAGES, 1, -1)
                if _k4_smem(r, n, *sizes) <= budget), None)
    if fit is None:
        raise ValueError(f"K4 refuses rank {rank} with {n_gathered} gathered "
                         f"row sets of {rows_itemsize} B: two stages of one "
                         f"slot take {_k4_smem(1, 2, *sizes)} B of shared "
                         f"memory, more than {STASH_MAX_BYTES}")
    cap, stages = fit
    if tile <= cap:         # whole tiles per stage, a multiple of 4 if can
        step = math.lcm(tile, 4)
        rows = cap // step * step or cap // tile * tile
        span = rows
    else:                   # a tile in pieces
        rows, span = cap, tile
    ppt = -(-span // rows)
    tasks = -(-t // span)
    bulk = (aligned and t % 4 == 0 and (tasks == 1 or span % 4 == 0)
            and (ppt == 1 or rows % 4 == 0))
    return SegmentsLayout(t, tile, rows, stages, span, ppt, tasks,
                          _stage_bytes(rows, *sizes),
                          _k4_smem(rows, stages, *sizes), bulk)


@functools.lru_cache(maxsize=None)
def phases_occupancy(kernel: str, dtype_pair: int, n_gathered: int,
                     rank: int, rows: int, stages: int,
                     device_index: int) -> tuple[int, int, int]:
    """(SMs, resident CTAs per SM, dynamic shared memory per CTA) for one of
    the phases kernels, asked of the card once per key; the query also
    raises the shared-memory limit of K4's and K5's kernel instance.  Only
    K4 fills the last two (K3 and K5 pass zeros for what they do not use)."""
    from .build import load_library
    lib = load_library("phases").lib
    sms, per_sm, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        err = lib.phases_occupancy(QUERY[kernel], dtype_pair, n_gathered,
                                   rank, rows, stages, ctypes.byref(sms),
                                   ctypes.byref(per_sm), ctypes.byref(smem))
    raise_on_error(err, lib.phases_error_string, f"{kernel} occupancy query")
    if kernel == "segments" and per_sm.value < 1:
        raise RuntimeError(f"K4: no CTA fits an SM ({smem.value} B of "
                           f"shared memory)")
    return sms.value, per_sm.value, smem.value


@dataclasses.dataclass(frozen=True)
class SegmentsGeometry:
    """How one launch of K4 lies on the card."""
    layout: SegmentsLayout
    blocks: int             # CTAs of K4_WARPS warps
    sms: int
    blocks_per_sm: int      # resident CTAs per SM, from the occupancy query

    @property
    def waves(self) -> int:
        return -(-self.blocks // (self.sms * self.blocks_per_sm))

    @property
    def bytes_in_flight_per_sm(self) -> int:
        """The stages a full SM's warps have filling while each sums one."""
        return (self.blocks_per_sm * K4_WARPS * (self.layout.stages - 1)
                * self.layout.stage_bytes)


def _check_rows(vals, tgt, gathered):
    """Shapes of (vals, tgt, gathered) on every device; returns (T, R)."""
    if not 1 <= len(gathered) <= MAX_ORDER - 1:
        raise ValueError(f"{len(gathered)} gathered row sets; the kernels "
                         f"take 1..{MAX_ORDER - 1}")
    t = vals.shape[0]
    rank = gathered[0].shape[1] if gathered[0].dim() == 2 else -1
    if vals.shape != (t,) or tgt.shape != (t,) or any(
            g.shape != (t, rank) for g in gathered):
        raise ValueError(f"shapes disagree: vals {tuple(vals.shape)}, tgt "
                         f"{tuple(tgt.shape)}, gathered "
                         f"{[tuple(g.shape) for g in gathered]}")
    return t, rank


def _check_kernel_inputs(vals, tgt, gathered):
    """What the card's kernels also need: types and contiguity."""
    if tgt.dtype != torch.int32:
        raise TypeError("tgt must be torch.int32")
    check_dtype_pair(vals, gathered[0])
    if any(g.dtype != gathered[0].dtype for g in gathered):
        raise TypeError("gathered rows must share one dtype")
    check_contiguous(vals, tgt, *gathered)


def _row_ptrs(gathered):
    return (ctypes.c_void_p * len(gathered))(*(g.data_ptr()
                                               for g in gathered))


def segments_query(t: int, tile: int, rank: int, n_gathered: int, vals_dtype,
                   rows_dtype, *, aligned: bool,
                   device: int) -> tuple[SegmentsLayout, tuple]:
    """K4's layout for a stream of ``t`` slots and the ``phases_occupancy``
    key its launch asks under: (kernel, dtype pair, gathered row sets,
    rank, stage rows, ring depth, device ordinal).  The stream's length
    shapes the layout, never the key (``analysis.trace.cachekeys`` holds
    it to that)."""
    layout = segments_layout(t, tile, rank, n_gathered, vals_dtype.itemsize,
                             rows_dtype.itemsize, aligned=aligned)
    return layout, ("segments", DTYPE_PAIRS[(vals_dtype, rows_dtype)],
                    n_gathered, rank, layout.rows, layout.stages, device)


def segments_geometry(vals, tgt, gathered, *, tile: int) -> SegmentsGeometry:
    """The one-wave geometry of a K4 launch on these CUDA tensors."""
    gathered = tuple(gathered)
    t, rank = _check_rows(vals, tgt, gathered)
    layout, key = segments_query(
        t, tile, rank, len(gathered), vals.dtype, gathered[0].dtype,
        aligned=all(x.data_ptr() % 16 == 0 for x in (vals, tgt, *gathered)),
        device=device_index(vals.device))
    sms, per_sm, smem = phases_occupancy(*key)
    if smem != layout.smem:
        raise RuntimeError(f"K4's shared memory: {smem} B on the card, "
                           f"{layout.smem} B in segments_layout")
    return SegmentsGeometry(layout, layout.blocks(sms, per_sm), sms, per_sm)


def mttkrp_segments(vals, tgt, gathered, *, tile: int):
    """Hadamard + per-tile on-the-fly segmented reduction (K4).

    vals: (T,); tgt: (T,) int32 target coordinates in ALTO order (not
    sorted); gathered: N-1 (T, R) rows.  ``tile`` divides T.  Returns
    ``(seg_tgt (T,) int32, seg_sums (T, R))``.
    """
    gathered = tuple(gathered)
    device = one_device(vals, tgt, *gathered)
    t, rank = _check_rows(vals, tgt, gathered)
    if not 1 <= tile <= MAX_TILE or t % tile:
        raise ValueError(f"tile {tile} must divide the stream of {t} slots "
                         f"and lie in 1..{MAX_TILE}")
    if device.type == "cpu":
        return ref.mttkrp_segments_ref(vals, tgt, gathered, tile=tile)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    _check_kernel_inputs(vals, tgt, gathered)
    return _launch_segments(vals, tgt, gathered, tile=tile)


def _launch_segments(vals, tgt, gathered, *, tile, blocks=None):
    """One launch of K4 on the tensors' card.  ``blocks`` replaces the
    one-wave grid; the tests pin a small one with it."""
    t, rank = _check_rows(vals, tgt, gathered)
    out_dtype = torch.promote_types(vals.dtype, gathered[0].dtype)
    seg_tgt = torch.empty((t,), dtype=torch.int32, device=vals.device)
    seg_sums = torch.empty((t, rank), dtype=out_dtype, device=vals.device)
    if t == 0:
        return seg_tgt, seg_sums
    geo = segments_geometry(vals, tgt, gathered, tile=tile)
    lay = geo.layout
    from .build import load_library
    lib = load_library("phases").lib
    with torch.cuda.device(vals.device):
        err = lib.phases_segments_launch(
            DTYPE_PAIRS[(vals.dtype, gathered[0].dtype)], vals.data_ptr(),
            tgt.data_ptr(), _row_ptrs(gathered), len(gathered), t, rank, tile,
            lay.rows, lay.stages, lay.span, int(lay.bulk),
            blocks or geo.blocks,
            seg_tgt.data_ptr(), seg_sums.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    raise_on_error(err, lib.phases_error_string, "MTTKRP segments")
    launch_counts["segments"] += 1
    segments_fills[lay.fill] += 1
    return seg_tgt, seg_sums


def mttkrp_stash(vals, tgt, gathered, *, out_rows: int):
    """Hadamard accumulated straight into an (out_rows, R) stash (K5).

    Same inputs as ``mttkrp_segments``; returns the (out_rows, R) output at
    ``promote_types(vals, rows)``.
    """
    gathered = tuple(gathered)
    device = one_device(vals, tgt, *gathered)
    t, rank = _check_rows(vals, tgt, gathered)
    out_dtype = torch.promote_types(vals.dtype, gathered[0].dtype)
    if out_rows * rank * out_dtype.itemsize > STASH_MAX_BYTES:
        raise ValueError(f"a ({out_rows}, {rank}) {out_dtype} stash exceeds "
                         f"{STASH_MAX_BYTES} B of shared memory; use "
                         f"mttkrp_segments")
    if device.type == "cpu":
        return ref.mttkrp_stash_ref(vals, tgt, gathered, out_rows=out_rows)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    _check_kernel_inputs(vals, tgt, gathered)
    out = torch.zeros((out_rows, rank), dtype=out_dtype, device=device)
    if t == 0:
        return out
    pair = DTYPE_PAIRS[(vals.dtype, gathered[0].dtype)]
    sms = phases_occupancy("stash_phases", pair, 0, 0, 0, 0,
                           device_index(device))[0]
    # about 4 CTAs per SM, each with at least 2048 slots
    blocks = max(1, min(sms * 4, -(-t // 2048)))
    from .build import load_library
    lib = load_library("phases").lib
    with torch.cuda.device(device):
        err = lib.phases_stash_launch(
            pair, vals.data_ptr(), tgt.data_ptr(), _row_ptrs(gathered),
            len(gathered), t, rank, out_rows, blocks, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    raise_on_error(err, lib.phases_error_string, "MTTKRP stash")
    launch_counts["stash_phases"] += 1
    return out
