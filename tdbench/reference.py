"""Plain PyTorch CP-ALS on the benchmark's own COO tensor: the reference
that decides ``correct``, and the control computed in TF32.

Written from the algorithm (Kolda and Bader's CP-ALS, the BLCO paper's
Algorithm 1), not from the program: it imports nothing of ``repro_torch``
and reads only the coordinates and values the benchmark generated.  The
MTTKRP gathers each non-zero's factor rows, multiplies them with its value
and adds the product into the target row, in blocks of non-zeros so that
it fits beside nothing else on the card.

``tf=True`` computes every product from operands rounded to TF32 (10
mantissa bits, round to nearest even) and accumulates in float32, as the
card's TF32 units do: the nearest precision below the float32 the
configurations state, and the control that ``correct`` has to refuse.
"""
from __future__ import annotations

import dataclasses

import torch

# non-zeros per block: (block, R) float64 products of 1 GiB at R = 32
BLOCK = 1 << 22


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def _mul(a, b, tf: bool):
    return tf32(a) * tf32(b) if tf else a * b


def _matmul(a, b, tf: bool):
    return tf32(a) @ tf32(b) if tf else a @ b


def mttkrp(idx: torch.Tensor, vals: torch.Tensor, factors, mode: int, *,
           tf: bool = False, block: int = BLOCK) -> torch.Tensor:
    """M[i, r] = sum over non-zeros x at (..., i, ...) of
    x * prod_{m != mode} factors[m][i_m, r], in the factors' dtype."""
    dtype = factors[0].dtype
    out = torch.zeros(factors[mode].shape, dtype=dtype,
                      device=factors[0].device)
    for s in range(0, idx.shape[0], block):
        rows = idx[s:s + block]
        p = vals[s:s + block].to(dtype)[:, None]
        for m, f in enumerate(factors):
            if m != mode:
                p = _mul(p, f[rows[:, m]], tf)
        out.index_add_(0, rows[:, mode], p)
    return out


def gram(f, tf: bool = False):
    return _matmul(f.T, f, tf)


def update(m_mat, factors, mode: int, rtol: float, tf: bool = False):
    """One mode's least-squares update: A = M pinv(V), V the Hadamard
    product of the other modes' Gram matrices, split into unit columns
    and their norms (a zero column keeps norm 1)."""
    rank = m_mat.shape[1]
    v = torch.ones((rank, rank), dtype=m_mat.dtype, device=m_mat.device)
    for m, f in enumerate(factors):
        if m != mode:
            v = _mul(v, gram(f, tf), tf)
    a = _matmul(m_mat, torch.linalg.pinv(v, rtol=rtol), tf)
    lam = torch.linalg.vector_norm(a, dim=0)
    lam = torch.where(lam > 0, lam, torch.ones_like(lam))
    return a / lam, lam


def fit(norm_x: float, m_last, factors, lam, tf: bool = False) -> float:
    """1 - ||X - X_hat|| / ||X||, with <X, X_hat> from the last mode's
    MTTKRP and ||X_hat||^2 from the Gram matrices."""
    rank = lam.shape[0]
    v = torch.ones((rank, rank), dtype=lam.dtype, device=lam.device)
    for f in factors:
        v = v * gram(f, tf)
    est_sq = lam @ (v @ lam)
    inner = torch.sum(lam * torch.sum(m_last * factors[-1], dim=0))
    resid_sq = torch.clamp(norm_x ** 2 + est_sq - 2.0 * inner, min=0.0)
    return float(1.0 - torch.sqrt(resid_sq) / norm_x)


@dataclasses.dataclass
class State:
    """What a sweep reads and writes (the fields the harness looks at)."""
    factors: list
    lam: torch.Tensor
    norm_x: float
    rtol: float
    fits: list = dataclasses.field(default_factory=list)
    iteration: int = 0


def sweep(mttkrp_fn, state: State, *, tf: bool = False) -> State:
    """One ALS sweep over every mode, in place, then its fit."""
    factors = state.factors
    for n in range(len(factors)):
        m_mat = mttkrp_fn(factors, n)
        factors[n], state.lam = update(m_mat, factors, n, state.rtol, tf)
    state.fits.append(fit(state.norm_x, m_mat, factors, state.lam, tf))
    state.iteration += 1
    return state


class Control:
    """The reference in TF32 put in the program's place: an object with
    ``.mttkrp(factors, mode)`` like a plan, and its sweep."""

    def __init__(self, idx, vals):
        self.idx, self.vals = idx, vals

    def mttkrp(self, factors, mode):
        return mttkrp(self.idx, self.vals, factors, mode, tf=True)

    @staticmethod
    def step(plan, state):
        return sweep(plan.mttkrp, state, tf=True)
