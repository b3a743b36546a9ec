"""Launch-padding arithmetic (the port's copy of ``repro.core.padding``).

Every execution path pads launches to a fixed *reservation*, the analogue of
the paper's fixed per-queue memory reservations (§4.2).  Three roundings:

* ``next_pow2`` / ``pad_pow2`` — power-of-two buckets;
* ``pad_multiple`` — round up to a ``LANE`` multiple only, for callers that
  pinned an explicit reservation;
* ``pad_bucket`` — geometric size classes (8 per power-of-two octave, at
  most 25% padding waste), the in-memory regime's default reservation.

``LANE`` stays 256: the byte layout of a padded launch is the JAX package's,
so the two packages build identical launch caches.
"""
from __future__ import annotations

import math

LANE = 256


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    return 1 << max(0, math.ceil(math.log2(max(1, n))))


def pad_pow2(n: int, floor: int = LANE) -> int:
    """Power-of-two bucket for ``n``, never below ``floor``."""
    return max(floor, next_pow2(n))


def pad_multiple(n: int, multiple: int = LANE) -> int:
    """Round ``n`` up to a multiple (minimum one multiple)."""
    return max(multiple, -(-n // multiple) * multiple)


def pad_bucket(n: int, multiple: int = LANE) -> int:
    """Size-class rounding: round ``n`` up to the next of 8 geometrically
    spaced classes per power-of-two octave (classes are LANE multiples).

    With ``n`` in (2^(k-1), 2^k] the class step is ``max(multiple,
    2^(k-3))``, so the overshoot is < 2^(k-3) < n/4.
    """
    n = max(int(n), multiple)
    step = max(multiple, (1 << (n - 1).bit_length()) >> 3)
    return -(-n // step) * step
