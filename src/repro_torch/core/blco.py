"""BLCO format construction: adaptive blocking + batching (paper §4.2).

The port's own copy of ``repro.core.blco``; it builds the same arrays,
blocks and launches byte for byte.  Pipeline (host, vectorized numpy — the
paper also constructs on the CPU, §6.5):

  COO -> ALTO-encode -> sort by ALTO index -> strip top bits to block keys ->
  re-encode survivors into contiguous fields -> split oversized blocks ->
  batch small blocks into launches.

The device-facing arrays are two uint32 index words + one value array per
tensor, with blocks/launches as (start, end) views — a *single* tensor copy,
mode-agnostic, exactly the property the paper is built around.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import linearize as lin
from .tensor import SparseTensor
from .u64 import split64


@dataclasses.dataclass(frozen=True)
class Block:
    """One BLCO block: a contiguous run of the sorted nnz arrays."""
    key: int                 # stripped upper ALTO bits (the paper's `b`)
    start: int
    end: int
    upper: tuple[int, ...]   # per-mode upper coordinate bits recovered from key

    @property
    def nnz(self) -> int:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class Launch:
    """A batch of blocks issued as one device launch (paper's block batching).

    block_ids index into BLCOTensor.blocks; their nnz ranges are contiguous
    in the global arrays by construction, so a launch is a (start, end)
    range plus a per-element block-id array used to apply per-block offsets.
    """
    block_ids: tuple[int, ...]
    start: int
    end: int

    @property
    def nnz(self) -> int:
        return self.end - self.start


@dataclasses.dataclass
class BLCOTensor:
    dims: tuple[int, ...]
    spec: lin.LinearSpec
    re: lin.ReencodeSpec
    idx_hi: np.ndarray          # (nnz,) uint32 — stored index, high word
    idx_lo: np.ndarray          # (nnz,) uint32 — stored index, low word
    values: np.ndarray          # (nnz,)
    blocks: list[Block]
    launches: list[Launch]
    construction_stats: dict    # timing breakdown (paper Fig. 12)

    @property
    def order(self) -> int:
        return len(self.dims)

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    def block_upper_bases(self) -> np.ndarray:
        """(num_blocks, N) int64: per-block coordinate base = upper << field_bits."""
        out = np.zeros((len(self.blocks), self.order), dtype=np.int64)
        for i, b in enumerate(self.blocks):
            for n in range(self.order):
                out[i, n] = b.upper[n] << self.re.field_bits[n]
        return out

    def element_block_ids(self) -> np.ndarray:
        """(nnz,) int32 block id per element (for batched launches)."""
        out = np.empty(self.nnz, dtype=np.int32)
        for i, b in enumerate(self.blocks):
            out[b.start:b.end] = i
        return out


def build_blco(t: SparseTensor, *, target_bits: int = 64,
               max_nnz_per_block: int = 1 << 27,
               launch_nnz_budget: int | None = None) -> BLCOTensor:
    """Construct the BLCO representation of a COO tensor.

    target_bits: native integer width of the device (64 in the paper; smaller
        values exercise the blocking machinery on small test tensors).
    max_nnz_per_block: device memory constraint (2^27 in the paper).
    launch_nnz_budget: batch blocks into launches of at most this many nnz
        (defaults to max_nnz_per_block) — the paper's work-group batching for
        hypersparse tensors.
    """
    stats: dict[str, float] = {}
    t0 = time.perf_counter()
    spec = lin.LinearSpec.make(t.dims)
    hi, lo = lin.alto_encode(spec, t.indices)
    stats["linearize"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    perm = lin.sort_by_alto(hi, lo)
    hi, lo = hi[perm], lo[perm]
    indices = t.indices[perm]
    values = t.values[perm]
    stats["sort"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    re = lin.reencode_spec(spec, target_bits)
    keys = lin.block_key(spec, re, hi, lo)
    stats["block_keys"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    stored = lin.reencode(spec, re, indices)
    idx_hi, idx_lo = split64(stored)
    stats["reencode"] = time.perf_counter() - t0

    # --- initial blocks: runs of equal key in sorted order -------------------
    t0 = time.perf_counter()
    nnz = values.shape[0]
    blocks: list[Block] = []
    if nnz:
        boundaries = np.flatnonzero(np.concatenate(([True], keys[1:] != keys[:-1])))
        boundaries = np.append(boundaries, nnz)
        for s, e in zip(boundaries[:-1], boundaries[1:]):
            key = int(keys[s])
            upper = tuple(int(u) for u in lin.key_to_upper_coords(spec, re, key))
            # split oversized blocks to the device budget (paper: 2^27 nnz)
            for cs in range(int(s), int(e), max_nnz_per_block):
                ce = min(cs + max_nnz_per_block, int(e))
                blocks.append(Block(key=key, start=cs, end=ce, upper=upper))
    stats["blocking"] = time.perf_counter() - t0

    # --- batch small blocks into launches ------------------------------------
    t0 = time.perf_counter()
    budget = launch_nnz_budget or max_nnz_per_block
    launches: list[Launch] = []
    cur: list[int] = []
    cur_nnz = 0
    for i, b in enumerate(blocks):
        if cur and cur_nnz + b.nnz > budget:
            launches.append(Launch(tuple(cur), blocks[cur[0]].start, blocks[cur[-1]].end))
            cur, cur_nnz = [], 0
        cur.append(i)
        cur_nnz += b.nnz
    if cur:
        launches.append(Launch(tuple(cur), blocks[cur[0]].start, blocks[cur[-1]].end))
    stats["batching"] = time.perf_counter() - t0

    return BLCOTensor(dims=t.dims, spec=spec, re=re, idx_hi=idx_hi, idx_lo=idx_lo,
                      values=values, blocks=blocks, launches=launches,
                      construction_stats=stats)


def format_bytes(b: BLCOTensor) -> int:
    """True device-resident bytes of the format (Table-3-style analysis).

    Counts everything an in-memory MTTKRP keeps on the device per element:
    the two uint32 index words, the value, AND the per-element int32 block
    coordinate bases (order words wide).  This matches
    ``ReservationSpec.bytes_per_launch`` per nnz slot.
    """
    bases_bytes = 4 * b.order * b.nnz
    return int(b.idx_hi.nbytes + b.idx_lo.nbytes + b.values.nbytes
               + bases_bytes)


def decode_coords(b: BLCOTensor) -> np.ndarray:
    """Recover the (nnz, N) original coordinates from the stored encoding.

    Host-side inverse of the ALTO re-encode: extract each mode's field from
    the 64-bit stored index and add the per-block upper-bit base.  Rows are
    in BLCO (ALTO-sorted) order, matching ``b.values``.
    """
    stored = (b.idx_hi.astype(np.uint64) << np.uint64(32)) \
        | b.idx_lo.astype(np.uint64)
    bases = b.block_upper_bases()[b.element_block_ids()] if b.nnz else \
        np.zeros((0, b.order), np.int64)
    coords = np.empty((b.nnz, b.order), np.int64)
    for n, (shift, width) in enumerate(zip(b.re.field_shift, b.re.field_bits)):
        mask = (1 << width) - 1
        field = (stored >> np.uint64(shift)).astype(np.int64) & mask
        coords[:, n] = field + bases[:, n]
    return coords
