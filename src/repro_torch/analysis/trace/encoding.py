"""Symbolic BLCO encoding verifier: bit-width/interval proofs, no arrays.

The reference's verifier, copied, over the port's ``core/linearize.py``.
Its proofs are what make the port's index arithmetic safe: the plain
path widens each (hi, lo) word pair to int64 and extracts a field by an
arithmetic shift and a mask (``core.u64.field``), which is exact because
every field is at most 32 bits wide and ends at or below bit 64.

Given a tensor's dims and build parameters (or an arbitrary — possibly
hand-broken — ``LinearSpec``/``ReencodeSpec`` pair), prove with pure
integer arithmetic every invariant the device pipeline assumes:

1. the ALTO bit layout is a bijection onto ``[0, total_bits)`` and every
   mode's bit count covers its extent (losslessness of the linearization);
2. the re-encoding partitions each mode's bits exactly
   (``field + block == bits`` — no bit lost to the split, so
   re-encode∘delinearize is the identity on every in-range coordinate);
3. the packed fields are disjoint, in-range and fit the stored-word width
   (``shift + width <= 64`` — no mask overflow at the u64 boundary), and
   the block key fits 64 bits (``block_key``'s own guard, proven here
   before any data exists);
4. every field is <= 32 bits wide and every decoded coordinate fits int32
   (the 2x-uint32 word pair: ``u64.field`` refuses width > 32, and the
   kernels' coordinates, bases and gather indices are int32);
5. every delinearized coordinate is in-bounds for its factor gather:
   ``max decoded = ((dim-1) >> field) << field | (field mask over the
   residue) = dim - 1``, by the exact-partition property;
6. padded lanes are provably no-ops: all-zero index words decode to
   coordinate 0 of every mode (fields of 0 are 0, padding bases are 0),
   row 0 always exists (dims >= 1), and the padded value 0 annihilates
   the hadamard product — the update contributes +0.0 to row 0.

``prove_encoding`` returns an :class:`EncodingProof` (the machine-
readable certificate) plus findings; an empty finding list IS the proof.
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.linter import Finding

PASS_ENCODING = "trace-encoding"

_LINEARIZE = "src/repro_torch/core/linearize.py"


@dataclasses.dataclass(frozen=True)
class EncodingProof:
    """Certificate of one verified (dims, spec, re) encoding."""
    dims: tuple
    bits: tuple
    total_bits: int
    field_bits: tuple
    field_shift: tuple
    block_bits: tuple
    stored_bits: int            # sum(field_bits) — width of the packed index
    key_bits: int               # sum(block_bits) — width of the block key
    max_coord: tuple            # per-mode maximum decodable coordinate
    padded_lane_noop: bool

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


def verify_layout(dims, spec, re, *, target_bits: int = 64,
                  symbol: str = "encoding") -> list[Finding]:
    """All invariant checks over an explicit (possibly broken) layout."""
    findings: list[Finding] = []

    def flag(msg):
        findings.append(Finding(pass_id=PASS_ENCODING, path=_LINEARIZE,
                                symbol=symbol, line=0, message=msg))

    n_modes = len(dims)
    if not (len(spec.bits) == len(spec.positions) == len(re.field_bits)
            == len(re.field_shift) == len(re.block_bits) == n_modes):
        flag("spec/reencode arity mismatch with dims")
        return findings

    # (1) ALTO layout: bijection onto [0, total_bits), extents covered
    flat = [p for pos in spec.positions for p in pos]
    if sorted(flat) != list(range(spec.total_bits)):
        flag(f"ALTO positions are not a bijection onto "
             f"[0, {spec.total_bits}): the linearization is lossy or "
             f"double-books a bit")
    if spec.total_bits > 128:
        flag(f"total index width {spec.total_bits} exceeds the 128-bit "
             f"(hi, lo) u64 pair")
    for n, (d, b, pos) in enumerate(zip(dims, spec.bits, spec.positions)):
        if len(pos) != b:
            flag(f"mode {n}: {len(pos)} ALTO positions for {b} bits")
        if d > (1 << b):
            flag(f"mode {n}: extent {d} does not fit {b} bits — "
                 f"coordinates >= {1 << b} alias under encode")

    # (2) exact per-mode bit partition (losslessness of the re-encode)
    for n in range(n_modes):
        if re.field_bits[n] + re.block_bits[n] != spec.bits[n]:
            flag(f"mode {n}: field({re.field_bits[n]}) + "
                 f"block({re.block_bits[n]}) != bits({spec.bits[n]}) — "
                 f"the re-encode drops or invents coordinate bits")
        if re.field_bits[n] < 0 or re.block_bits[n] < 0:
            flag(f"mode {n}: negative bit width in the re-encode")

    # (3) packed fields: disjoint, in-range, no u64 mask overflow
    covered: set[int] = set()
    for n in range(n_modes):
        fb, sh = re.field_bits[n], re.field_shift[n]
        if fb == 0:
            continue
        if sh < 0 or sh + fb > 64:
            flag(f"mode {n}: field [{sh}, {sh + fb}) overflows the 64-bit "
                 f"stored word — the shifted mask wraps")
            continue
        span = set(range(sh, sh + fb))
        if covered & span:
            flag(f"mode {n}: field [{sh}, {sh + fb}) overlaps another "
                 f"mode's field — decode reads foreign bits")
        covered |= span
    stored_bits = sum(re.field_bits)
    if stored_bits > target_bits:
        flag(f"packed index needs {stored_bits} bits but target_bits is "
             f"{target_bits}")
    key_bits = sum(re.block_bits)
    if key_bits > 64:
        flag(f"block key needs {key_bits} bits; >64 unsupported "
             f"(block_key would raise at build time)")

    # (4) 32-bit device constraints
    for n in range(n_modes):
        if re.field_bits[n] > 32:
            flag(f"mode {n}: field width {re.field_bits[n]} > 32 — "
                 f"u64.extract_field asserts at trace time on device")
        if dims[n] > 1 << 31:
            flag(f"mode {n}: extent {dims[n]} > 2^31 — coordinates are "
                 f"int32 throughout the device pipeline")
        if dims[n] < 1:
            flag(f"mode {n}: empty extent {dims[n]}")

    # (5) gather in-bounds: decode(encode(c)) = (c >> fb << fb) | (c & mask)
    # = c for every c in [0, dim) — the identity holds exactly when the
    # per-mode partition is exact and fields are disjoint (checks 2-3), so
    # the decoded set IS the encoded set and max decoded = dim-1 < dim.
    # Verify the algebra at the extent's edge rather than assuming it:
    if not findings:
        for n, d in enumerate(dims):
            fb = re.field_bits[n]
            mask = (1 << fb) - 1
            edge = ((d - 1) >> fb << fb) | ((d - 1) & mask)
            if edge != d - 1:
                flag(f"mode {n}: round-trip of extent edge {d - 1} gives "
                     f"{edge} — factor gather would read the wrong row")
    return findings


def max_coords(dims, re) -> tuple:
    """Per-mode maximum decodable coordinate: ``dim-1`` exactly, because
    the verified partition makes decode∘encode the identity on [0, dim)."""
    return tuple(int(d) - 1 for d in dims)


def prove_encoding(dims, *, target_bits: int = 64,
                   symbol: str = "encoding"):
    """Build the shipped layout for ``dims`` and verify it.

    Returns ``(proof_or_None, findings)`` — ``proof`` only when the
    layout verifies clean.  A construction-time rejection (``LinearSpec
    .make``/``reencode_spec`` raising) is itself a finding: the verifier
    must witness the guard, not crash on it.
    """
    from repro_torch.core import linearize as lin
    try:
        spec = lin.LinearSpec.make(dims)
        re = lin.reencode_spec(spec, target_bits)
    except (ValueError, AssertionError) as exc:
        return None, [Finding(
            pass_id=PASS_ENCODING, path=_LINEARIZE, symbol=symbol, line=0,
            message=f"construction rejected dims={tuple(dims)} "
                    f"target_bits={target_bits}: {exc}")]
    findings = verify_layout(dims, spec, re, target_bits=target_bits,
                             symbol=symbol)
    if findings:
        return None, findings
    proof = EncodingProof(
        dims=tuple(int(d) for d in dims), bits=spec.bits,
        total_bits=spec.total_bits, field_bits=re.field_bits,
        field_shift=re.field_shift, block_bits=re.block_bits,
        stored_bits=sum(re.field_bits), key_bits=sum(re.block_bits),
        max_coord=max_coords(dims, re),
        padded_lane_noop=all(d >= 1 for d in dims))
    return proof, findings


#: the configurations the tier sweeps by default: small tensors, mixed
#: extents, the 128-bit total ceiling, and adversarial near-2^31 modes
DEFAULT_CONFIGS = (
    ((8, 6, 4), 64),
    ((40, 25, 30), 12),                     # forces blocking (tests' shape)
    ((1, 1, 1), 64),
    ((2**31, 4), 64),                       # int32 boundary, exactly legal
    ((2**31 - 1, 2**31 - 1, 4, 4), 64),     # 66 encoded bits -> split
    ((2**20, 2**20, 2**20, 2**20, 2**20, 2**20), 64),  # 120/128 bits
    ((2**31, 2**31, 2**31, 2**31), 64),     # the full 124-bit ALTO index
)


def audit_encodings(configs=DEFAULT_CONFIGS):
    """Verify the default configuration sweep; returns (proofs, findings)."""
    proofs, findings = [], []
    for dims, target in configs:
        proof, fs = prove_encoding(
            dims, target_bits=target,
            symbol=f"encoding[{'x'.join(str(d) for d in dims)}@{target}]")
        if proof is not None:
            proofs.append(proof)
        findings.extend(fs)
    return proofs, findings
