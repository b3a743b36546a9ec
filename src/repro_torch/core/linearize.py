"""ALTO-ordered linearization and BLCO re-encoding (paper §4.1).

The port's own copy of ``repro.core.linearize``; it produces the same arrays
byte for byte.  Two index encodings are in play:

* **ALTO index** — bits of the per-mode coordinates interleaved round-robin
  (LSB-first over modes that still have bits left).  Used only on the host,
  for sorting and for deriving block keys.  Up to 128 bits, held as (hi, lo)
  uint64 word pairs.
* **BLCO re-encoded index** — the *stored* per-nnz index: each mode's
  surviving (in-block) bits packed into a contiguous field, so that
  de-linearization on the device is one shift and mask per mode (paper
  Fig. 6b).  At most 64 bits, stored on the device as (hi, lo) uint32 pairs.

Construction is vectorized numpy on the host, as in the paper (§6.5).
``alto_encode`` scatters a coordinate's bits a byte at a time through
256-entry tables, and ``sort_by_alto`` sorts one word when the index fits
64 bits: both give the reference's result, in a fraction of its time at
FROSTT scale.
"""
from __future__ import annotations

import dataclasses

import numpy as np

U64_1 = np.uint64(1)


def mode_bits(dims) -> list[int]:
    """Bits needed per mode: ceil(log2(I_n)), min 1."""
    out = []
    for d in dims:
        d = int(d)
        assert d >= 1
        out.append(max(1, int(np.ceil(np.log2(d))) if d > 1 else 1))
    return out


def alto_bit_positions(dims) -> list[list[int]]:
    """ALTO bit layout: positions[n] = global bit positions (LSB→MSB) receiving
    successive bits (LSB→MSB) of mode n's coordinate.

    Round-robin from bit 0 over modes with bits remaining; modes with fewer
    bits drop out early, so the uppermost positions belong to the longest
    modes.
    """
    bits = mode_bits(dims)
    positions: list[list[int]] = [[] for _ in dims]
    taken = [0] * len(dims)
    p = 0
    while any(t < b for t, b in zip(taken, bits)):
        for n in range(len(dims)):
            if taken[n] < bits[n]:
                positions[n].append(p)
                taken[n] += 1
                p += 1
    return positions


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    """Static description of one tensor's linearization."""
    dims: tuple[int, ...]
    bits: tuple[int, ...]            # bits per mode
    positions: tuple[tuple[int, ...], ...]  # ALTO positions per mode
    total_bits: int

    @staticmethod
    def make(dims) -> "LinearSpec":
        # coordinates, block bases and gather indices are int32 on the
        # device; reject a mode longer than 2^31 here rather than wrap
        for d in dims:
            if int(d) > 1 << 31:
                raise ValueError(
                    f"mode length {int(d)} exceeds 2^31; coordinates are "
                    f"int32 throughout the device pipeline")
        bits = mode_bits(dims)
        pos = alto_bit_positions(dims)
        total = sum(bits)
        if total > 128:
            raise ValueError(f"tensor needs {total} index bits; >128 unsupported")
        return LinearSpec(tuple(int(d) for d in dims), tuple(bits),
                          tuple(tuple(p) for p in pos), total)


def _byte_tables(positions) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) uint64 tables: entry v places the bits of byte value v at
    ``positions`` (one position per bit of the byte, LSB first)."""
    v = np.arange(256, dtype=np.uint64)
    lo = np.zeros(256, np.uint64)
    hi = np.zeros(256, np.uint64)
    for b, p in enumerate(positions):
        bit = (v >> np.uint64(b)) & U64_1
        if p < 64:
            lo |= bit << np.uint64(p)
        else:
            hi |= bit << np.uint64(p - 64)
    return lo, hi


def alto_encode(spec: LinearSpec, indices: np.ndarray):
    """(nnz, N) int64 coords -> ALTO index as (hi, lo) uint64 arrays."""
    nnz = indices.shape[0]
    hi = np.zeros(nnz, dtype=np.uint64)
    lo = np.zeros(nnz, dtype=np.uint64)
    for n, positions in enumerate(spec.positions):
        coord = indices[:, n].astype(np.uint64)
        for k in range(0, len(positions), 8):
            tbl_lo, tbl_hi = _byte_tables(positions[k:k + 8])
            byte = ((coord >> np.uint64(k)) & np.uint64(0xFF)).astype(np.intp)
            if tbl_lo.any():
                lo |= tbl_lo[byte]
            if tbl_hi.any():
                hi |= tbl_hi[byte]
    return hi, lo


def alto_decode(spec: LinearSpec, hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Inverse of alto_encode (host-side; used in tests and format checks)."""
    nnz = hi.shape[0]
    out = np.zeros((nnz, len(spec.dims)), dtype=np.int64)
    for n, positions in enumerate(spec.positions):
        coord = np.zeros(nnz, dtype=np.uint64)
        for b, p in enumerate(positions):
            bit = ((lo >> np.uint64(p)) if p < 64 else (hi >> np.uint64(p - 64))) & U64_1
            coord |= bit << np.uint64(b)
        out[:, n] = coord.astype(np.int64)
    return out


def sort_by_alto(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Permutation sorting nnz by 128-bit ALTO index (hi major).

    Stable, as ``np.lexsort((lo, hi))``; when every hi word is 0 that is a
    stable sort of ``lo`` alone.
    """
    if not hi.any():
        return np.argsort(lo, kind="stable")
    return np.lexsort((lo, hi))


# ---------------------------------------------------------------- re-encoding
@dataclasses.dataclass(frozen=True)
class ReencodeSpec:
    """Contiguous-field layout for in-block (BLCO) indices.

    field_bits[n]  : surviving bits of mode n inside a block
    field_shift[n] : LSB position of mode n's field in the 64-bit stored index
    block_bits[n]  : bits of mode n stripped into the block key
    """
    field_bits: tuple[int, ...]
    field_shift: tuple[int, ...]
    block_bits: tuple[int, ...]

    @property
    def inblock_bits(self) -> int:
        return sum(self.field_bits)


def reencode_spec(spec: LinearSpec, target_bits: int = 64) -> ReencodeSpec:
    """Decide which bits are stripped to the block key (paper §4.2).

    The uppermost ``total_bits - target_bits`` bits *of the ALTO layout* are
    stripped; because ALTO interleaves, they come "from every mode" exactly as
    the paper prescribes. The survivors are packed contiguously, mode 0 lowest.
    """
    strip_from = max(0, spec.total_bits - target_bits)  # number of top bits stripped
    cutoff = spec.total_bits - strip_from               # ALTO positions >= cutoff go to key
    field_bits = []
    block_bits = []
    for n, positions in enumerate(spec.positions):
        inblock = sum(1 for p in positions if p < cutoff)
        field_bits.append(inblock)
        block_bits.append(spec.bits[n] - inblock)
    shifts = []
    acc = 0
    for fb in field_bits:
        shifts.append(acc)
        acc += fb
    assert acc <= target_bits
    return ReencodeSpec(tuple(field_bits), tuple(shifts), tuple(block_bits))


def block_key(spec: LinearSpec, re: ReencodeSpec, hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Top ALTO bits as the block key (uint64; stripped bits always <= 64)."""
    cutoff = spec.total_bits - sum(re.block_bits)
    if sum(re.block_bits) > 64:
        raise ValueError("block key wider than 64 bits unsupported")
    if cutoff >= 64:
        return hi >> np.uint64(cutoff - 64)
    # key straddles: low part from lo, high part from hi
    key = lo >> np.uint64(cutoff)
    if spec.total_bits > 64:
        key |= hi << np.uint64(64 - cutoff)
    mask_bits = sum(re.block_bits)
    if mask_bits < 64:
        key &= (U64_1 << np.uint64(mask_bits)) - U64_1
    return key


def key_to_upper_coords(spec: LinearSpec, re: ReencodeSpec, key: int) -> np.ndarray:
    """Recover each mode's stripped upper coordinate bits from a block key.

    Returns (N,) int64 b where mode-n original coord = (b[n] << field_bits[n]) | field.
    """
    cutoff = spec.total_bits - sum(re.block_bits)
    out = np.zeros(len(spec.dims), dtype=np.int64)
    for n, positions in enumerate(spec.positions):
        v = 0
        for b, p in enumerate(positions):
            if p >= cutoff:
                bit = (int(key) >> (p - cutoff)) & 1
                v |= bit << (b - re.field_bits[n])
        out[n] = v
    return out


def reencode(spec: LinearSpec, re: ReencodeSpec, indices: np.ndarray) -> np.ndarray:
    """(nnz, N) coords -> 64-bit BLCO stored index (contiguous fields)."""
    out = np.zeros(indices.shape[0], dtype=np.uint64)
    for n in range(len(spec.dims)):
        fb = re.field_bits[n]
        if fb == 0:
            continue
        field = indices[:, n].astype(np.uint64) & ((U64_1 << np.uint64(fb)) - U64_1)
        out |= field << np.uint64(re.field_shift[n])
    return out

