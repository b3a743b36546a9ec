"""64-bit BLCO index words as pairs of uint32 words.

The stored BLCO index keeps the JAX package's layout on the device: two
``uint32`` words per non-zero, ``hi`` and ``lo``.  The CUDA kernels read the
words as they are.  The plain PyTorch path cannot: PyTorch has no ``>>`` for
``torch.uint32`` on the CPU (``"rshift_cpu" not implemented for 'UInt32'``),
so it widens each (hi, lo) pair once to ``int64`` and extracts every field as
``(x >> shift) & mask``.  The arithmetic shift is safe because a BLCO field
is at most 32 bits wide and ``shift + width <= 64``: the sign bits that the
shift drags in from a set top bit are masked off.

Host-side construction uses numpy ``uint64`` with ``split64``/``join64``.
"""
from __future__ import annotations

import numpy as np
import torch

U32_MASK = np.uint64(0xFFFFFFFF)


# ---------------------------------------------------------------- host helpers
def split64(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 array -> (hi, lo) uint32 arrays."""
    x = np.asarray(x, dtype=np.uint64)
    lo = (x & U32_MASK).astype(np.uint32)
    hi = (x >> np.uint64(32)).astype(np.uint32)
    return hi, lo


def join64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) uint32 arrays -> uint64 array (host side only)."""
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)


# ------------------------------------------------------------- tensor helpers
def widen(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) uint32 tensors -> one int64 tensor holding ``(hi << 32) | lo``
    (two's complement: a set top bit of ``hi`` makes the value negative)."""
    return (hi.to(torch.int64) << 32) | lo.to(torch.int64)


def field(x: torch.Tensor, shift: int, width: int) -> torch.Tensor:
    """Bits ``[shift, shift + width)`` of a widened index, as int64."""
    if not 0 <= width <= 32:
        raise ValueError("mode field wider than 32 bits is unsupported")
    if shift + width > 64:
        raise ValueError(f"field [{shift}, {shift + width}) exceeds 64 bits")
    if width == 0:
        return torch.zeros_like(x)
    return (x >> shift) & ((1 << width) - 1)


def extract_field(hi: torch.Tensor, lo: torch.Tensor, shift: int,
                  width: int) -> torch.Tensor:
    """Bits ``[shift, shift + width)`` of ``(hi << 32) | lo`` as int64.

    One field; callers that extract every mode widen once with ``widen``
    and call ``field`` per mode.
    """
    return field(widen(hi, lo), shift, width)
