"""CP-ALS (paper Algorithm 1) on top of any MTTKRP backend.

The port of ``repro.core.cp_als``.  The MTTKRP backend is either a bare
callable ``(factors, mode) -> M`` or any object exposing
``.mttkrp(factors, mode)`` — in particular an ``ExecutionPlan``.
``as_mttkrp_fn`` is the adapter.

The algorithm is exposed at two granularities: ``cp_als`` (the one-shot
loop) and ``cp_als_init`` + ``cp_als_step`` (a resumable stepper over an
explicit ``CPState``, one full ALS sweep per call); ``cp_als`` is a loop
over the stepper, so both are numerically identical.

The Gram products and the pseudo-inverse are small dense (R, R) work and
stay ``torch.matmul``/``torch.linalg``.  ``pinv`` is called with the JAX
package's cut-off (``10 * max(R, R) * eps``), not PyTorch's default.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass
class CPResult:
    factors: list        # N tensors (I_n, R), unit-norm columns
    lam: np.ndarray      # (R,) column weights
    fits: list           # per-iteration fit
    converged: bool
    iterations: int


@dataclasses.dataclass
class CPState:
    """Resumable CP-ALS state: everything one ALS sweep reads and writes."""
    dims: tuple
    rank: int
    norm_x: float
    tol: float
    factors: list        # N tensors (I_n, R), unit-norm columns
    lam: torch.Tensor    # (R,) column weights
    grams: list          # N tensors (R, R) = factors[n].T @ factors[n]
    fits: list           # per-iteration fit, appended by each step
    prev_fit: float
    iteration: int       # completed ALS sweeps
    converged: bool

    def as_result(self) -> CPResult:
        return CPResult(factors=self.factors,
                        lam=self.lam.detach().cpu().numpy(),
                        fits=self.fits, converged=self.converged,
                        iterations=self.iteration)


def as_mttkrp_fn(backend):
    """Adapt an engine/plan-or-callable MTTKRP backend to ``(factors, mode)``."""
    method = getattr(backend, "mttkrp", None)
    if method is not None and callable(method):
        return method
    if callable(backend):
        return backend
    raise TypeError(
        f"MTTKRP backend must be a callable (factors, mode) -> M or expose "
        f".mttkrp(factors, mode); got {type(backend).__name__}")


def init_factors(dims, rank, *, seed=0, dtype=torch.float32,
                 device=DEFAULT_DEVICE):
    """Standard-normal factors from a numpy seed (the JAX package's draws,
    cast to ``dtype``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal((d, rank))).to(
        device=dev, dtype=dtype) for d in dims]


def _grams(factors):
    return [f.T @ f for f in factors]


def cp_als_init(dims, rank, *, norm_x: float, tol: float = 1e-5,
                seed: int = 0, dtype=torch.float32, factors=None,
                device=DEFAULT_DEVICE) -> CPState:
    """Fresh CP-ALS state (factors drawn from ``seed`` unless given; given
    factors keep their own device and dtype)."""
    if factors is not None:
        factors = list(factors)
        dtype, dev = factors[0].dtype, factors[0].device
    else:
        factors = init_factors(dims, rank, seed=seed, dtype=dtype,
                               device=device)
        dev = factors[0].device
    return CPState(dims=tuple(dims), rank=rank, norm_x=norm_x, tol=tol,
                   factors=factors,
                   lam=torch.ones(rank, dtype=dtype, device=dev),
                   grams=_grams(factors), fits=[], prev_fit=-np.inf,
                   iteration=0, converged=False)


def _pinv(v):
    rtol = 10 * max(v.shape) * torch.finfo(v.dtype).eps
    try:
        return torch.linalg.pinv(v, rtol=rtol)
    except torch.linalg.LinAlgError:
        # the SVD of a matrix with NaN/Inf entries does not converge: give
        # NaN, as the JAX package's pinv does, so poisoned factors end in
        # a non-finite fit (the service's guard) instead of an exception
        if bool(torch.isfinite(v).all()):
            raise
        return torch.full_like(v, float("nan"))


def sweep_mode_update(m_mat, grams, mode: int):
    """Dense math of one ALS mode update (Alg. 1 lines 3 + 5).

    ``m_mat`` is the mode's MTTKRP result (line 4), ``grams`` the current
    Gram matrices.  Returns ``(factor, lam, gram)``: the column-normalized
    new factor, its column norms, and its refreshed Gram matrix.
    """
    rank = m_mat.shape[1]
    g = grams[mode]
    # V = hadamard of Gram matrices of all other modes (Alg. 1 line 3)
    v = torch.ones((rank, rank), dtype=g.dtype, device=g.device)
    for m, gm in enumerate(grams):
        if m != mode:
            v = v * gm
    a_new = m_mat @ _pinv(v)                             # line 5
    lam = torch.linalg.vector_norm(a_new, dim=0)
    lam = torch.where(lam > 0, lam, torch.ones_like(lam))
    factor = a_new / lam
    return factor, lam, factor.T @ factor


def cp_als_step(mttkrp_fn, state: CPState) -> CPState:
    """One full ALS sweep (all modes, Alg. 1 lines 2-6) + fit update, in place.

    Returns ``state`` for chaining; a converged state is returned unchanged.
    """
    if state.converged:
        return state
    mttkrp_fn = as_mttkrp_fn(mttkrp_fn)
    n_modes = len(state.dims)
    rank = state.rank
    factors, grams = state.factors, state.grams
    m_mat = None
    for n in range(n_modes):
        m_mat = mttkrp_fn(factors, n)                    # line 4
        factors[n], lam, grams[n] = sweep_mode_update(m_mat, grams, n)
        state.lam = lam

    # fit = 1 - ||X - X_hat||_F / ||X||_F, computed without materializing
    # X_hat (standard CP-ALS identity; m_mat is the last mode's MTTKRP).
    last = n_modes - 1
    g = grams[0]
    v_all = torch.ones((rank, rank), dtype=g.dtype, device=g.device)
    for m in range(n_modes):
        v_all = v_all * grams[m]
    norm_est_sq = state.lam @ (v_all @ state.lam)
    inner = torch.sum(state.lam * torch.sum(m_mat * factors[last], dim=0))
    resid_sq = torch.clamp(state.norm_x ** 2 + norm_est_sq - 2.0 * inner,
                           min=0.0)
    fit = float(1.0 - torch.sqrt(resid_sq) / state.norm_x)
    state.fits.append(fit)
    state.iteration += 1
    if abs(fit - state.prev_fit) < state.tol:
        state.converged = True
    state.prev_fit = fit
    return state


def cp_als(mttkrp_fn, dims, rank, *, norm_x: float, iters: int = 25,
           tol: float = 1e-5, seed: int = 0, dtype=torch.float32,
           factors=None, device=DEFAULT_DEVICE) -> CPResult:
    """Alternating least squares for rank-R CPD (one-shot loop).

    norm_x: Frobenius norm of the sparse tensor (sum of squared values)**0.5.
    """
    mttkrp_fn = as_mttkrp_fn(mttkrp_fn)
    state = cp_als_init(dims, rank, norm_x=norm_x, tol=tol, seed=seed,
                        dtype=dtype, factors=factors, device=device)
    for _ in range(iters):
        cp_als_step(mttkrp_fn, state)
        if state.converged:
            break
    return state.as_result()


def reconstruct_dense(result: CPResult) -> np.ndarray:
    """Dense reconstruction from factors (test oracle; small tensors only)."""
    factors = [f.detach().cpu().numpy().astype(np.float64)
               if isinstance(f, torch.Tensor) else np.asarray(f, np.float64)
               for f in result.factors]
    lam = np.asarray(result.lam, np.float64)
    rank = lam.shape[0]
    dims = [f.shape[0] for f in factors]
    out = np.zeros(dims)
    for r in range(rank):
        term = lam[r]
        vecs = [f[:, r] for f in factors]
        acc = vecs[0]
        for v in vecs[1:]:
            acc = np.multiply.outer(acc, v)
        out += term * acc
    return out
