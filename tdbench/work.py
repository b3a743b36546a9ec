"""The work a CP-ALS sweep needs, counted from the tensor's shape alone,
and the card's data-sheet peaks.

The counts depend on dims, nnz, order and rank only, never on how the
program lays the tensor out or which kernel runs, so they stay the same
yardstick whatever implements the MTTKRP:

* each non-zero costs its value (4 B in float32) and its linearized index,
  ``ceil(sum_m ceil(log2 I_m) / 8)`` bytes, once per mode;
* each mode's MTTKRP reads every other mode's factor once and writes its
  own (I_n, R) output once;
* an MTTKRP does N x R multiply-adds' worth of flops per non-zero
  (N - 1 products and one accumulation per rank column);
* the sweep's solve reads each mode's (I_n, R) MTTKRP result and writes its
  (I_n, R) factor once, with two (I_n, R) x (R, R) products (the update and
  the Gram matrix).
"""
from __future__ import annotations

import math

# NVIDIA's H100 SXM data sheet: HBM3 bandwidth and float32 outside the
# tensor cores (TF32 is off on the timed path), both at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def index_bytes(dims) -> int:
    """Bytes of one linearized index: the modes' bits, rounded up to bytes."""
    return math.ceil(sum(max(1, (int(d) - 1).bit_length()) for d in dims) / 8)


def mttkrp_work(dims, nnz: int, rank: int, itemsize: int = 4) -> dict:
    """Bytes and flops of the sweep's N MTTKRPs (one per mode)."""
    order = len(dims)
    per_nnz = itemsize + index_bytes(dims)
    nbytes = order * (nnz * per_nnz + sum(dims) * rank * itemsize)
    return {"bytes": nbytes, "flops": order * order * rank * nnz}


def solve_work(dims, rank: int, itemsize: int = 4) -> dict:
    """Bytes and flops of the sweep's dense updates outside the MTTKRPs."""
    rows = sum(dims)
    return {"bytes": 2 * rows * rank * itemsize,
            "flops": 4 * rows * rank * rank}


def least_s(work: dict) -> float:
    """The least time the card could take: the larger of bytes over the
    bandwidth and flops over the float32 rate."""
    return max(work["bytes"] / PEAK_BYTES_PER_S,
               work["flops"] / PEAK_F32_FLOPS)


def sweep_work(dims, nnz: int, rank: int, itemsize: int = 4) -> dict:
    """The whole sweep: its MTTKRPs and its solve."""
    m, s = mttkrp_work(dims, nnz, rank, itemsize), solve_work(dims, rank,
                                                               itemsize)
    return {"bytes": m["bytes"] + s["bytes"], "flops": m["flops"] + s["flops"]}
