"""What decides ``correct``: the checked sweeps of the timed path, each
followed step by step by the reference.

A checked sweep is one ``step(plan, state)`` call, the same call and plan
the window drives, whose MTTKRP outputs, updated factors and weights are
copied to the host as they are made (``Recorder``).  Every sweep of
set-up is checked whole, and one sweep after the window, on the state the
window left: after hundreds of sweeps the Gram matrices' Hadamard products
are ill-conditioned (condition numbers of 1e4 and more), which magnifies
float32's rounding in the solve's forward error as much as TF32's, while
neither an MTTKRP's rounding nor the solve's backward error depends on
them.

``judge`` runs once the program is freed.  For each checked sweep and
mode it takes the factors the program held at that call (the benchmark's
own initial factors at the first sweep), computes the MTTKRP and the
mode's update in float64, and compares:

* ``mttkrp_gap``: each row of the program's MTTKRP output against the
  reference's, the norm of the difference over the larger of the
  reference row's norm and the median row norm, worst row of any mode;
* ``solve_residual``: the normwise backward error of the mode's normal
  equations, ||(X V - M) P|| / (||X|| ||V|| + ||M||) at X = A diag(lam), in
  float64 from the program's own M, updated factor A and weights lam, V the
  Hadamard product of the Gram matrices of the other factors it held, and
  P the projector onto V's eigenvectors whose eigenvalues reach
  ``KEEP_ABOVE`` times the pseudo-inverse's cut-off (rtol times the
  largest); worst mode of any sweep.  A pseudo-inverse that drops a
  direction under its cut-off leaves M's component there as residual; P
  leaves out what it may drop, with room for float32's V to decide a
  direction near the cut-off otherwise than float64's;
* ``unmoved_factors``: the modes whose updated factor is bit for bit the
  factor they started from (exact: a sweep that counts itself but skips
  its update);
* ``factor_gap``: the same as ``mttkrp_gap`` for each updated factor
  (set-up's sweeps);
* ``lam_gap``: the sweep's column weights, worst gap over the largest
  (set-up's sweeps);
* ``fit_gap``: the sweep's fit, absolute (set-up's sweeps).

The reference then goes on from the program's own updated factor, so one
mode's rounding is not carried into the next; the start, the benchmark's
initial factors, is the reference's own.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from tdbench import reference

GAPS = ("mttkrp_gap", "solve_residual", "unmoved_factors", "factor_gap",
        "lam_gap", "fit_gap")
# solve_residual leaves out V's directions under this many times the
# pseudo-inverse's cut-off
KEEP_ABOVE = 10.0
# the numbers of the sweep after the window: those the Gram matrices'
# conditioning does not inflate
AFTER_WINDOW = ("mttkrp_gap", "solve_residual", "unmoved_factors")


def host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


@dataclasses.dataclass
class Sweep:
    """One checked sweep: the factors it started from, and per mode the
    MTTKRP output, the updated factor and its weights; then the sweep's
    weights and fit."""
    inputs: list
    outputs: list = dataclasses.field(default_factory=list)
    factors: list = dataclasses.field(default_factory=list)
    lams: list = dataclasses.field(default_factory=list)
    lam: torch.Tensor | None = None
    fit: float = math.nan
    solve: bool = True      # the solve's forward gaps count too


class Recorder:
    """Hands ``plan.mttkrp`` through and copies what it sees to the host:
    at mode n's call, mode n - 1's updated factor and the state's weights;
    then mode n's output."""

    def __init__(self, plan, state, sweep: Sweep):
        self.plan, self.state, self.sweep = plan, state, sweep

    def mttkrp(self, factors, mode):
        if mode > 0:
            self.sweep.factors.append(host(factors[mode - 1]))
            self.sweep.lams.append(host(self.state.lam))
        out = self.plan.mttkrp(factors, mode)
        self.sweep.outputs.append(host(out))
        return out


def checked_sweep(step, plan, state, inputs, solve: bool = True) -> Sweep:
    """Run one sweep through ``step(plan, state)`` with its outputs
    recorded; ``inputs`` are the host copies of the factors it starts from,
    ``solve`` whether its solve's forward gaps count."""
    rec = Sweep(inputs=list(inputs), solve=solve)
    before = state.iteration
    step(Recorder(plan, state, rec), state)
    if state.iteration == before + 1:
        rec.factors.append(host(state.factors[-1]))
        rec.lam = host(state.lam)
        rec.lams.append(rec.lam)
        rec.fit = float(state.fits[-1])
    return rec


def _finite(x: float) -> float:
    """NaN, which fails no comparison, as inf, which fails every one."""
    return x if x == x else math.inf


def row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst row's ||got - want|| over max(||want row||, median row norm)."""
    norms = torch.linalg.vector_norm(want, dim=1)
    floor = torch.clamp(norms.median(), min=torch.finfo(want.dtype).tiny)
    diff = torch.linalg.vector_norm(got - want, dim=1)
    return _finite(float((diff / torch.maximum(norms, floor)).max()))


def hadamard_gram(factors, mode) -> torch.Tensor:
    """V: the Hadamard product of the other modes' Gram matrices."""
    rank = factors[0].shape[1]
    v = torch.ones((rank, rank), dtype=factors[0].dtype,
                   device=factors[0].device)
    for m, f in enumerate(factors):
        if m != mode:
            v = v * reference.gram(f)
    return v


def kept(v, cut: float) -> tuple[torch.Tensor, int]:
    """The projector onto symmetric ``v``'s eigenvectors whose eigenvalues
    reach ``cut`` times the largest, and how many fall below."""
    w, u = torch.linalg.eigh(v)
    keep = w >= cut * w.max()
    return u[:, keep] @ u[:, keep].T, int((~keep).sum())


def residual(a, lam, v, m_mat, proj=None,
             block: int = reference.BLOCK) -> float:
    """Normwise backward error of the normal equations X V = M at
    X = A diag(lam): ||(X V - M) P|| / (||X|| ||V|| + ||M||), Frobenius
    norms, in blocks of rows, P the projector ``proj`` (the identity where
    it is None).  A backward-stable solve reads a few float32 epsilons at
    any condition number of V, since V and M may both take the rounding."""
    resid_sq = x_sq = 0.0
    for s in range(0, a.shape[0], block):
        x = a[s:s + block] * lam
        r = x @ v - m_mat[s:s + block]
        if proj is not None:
            r = r @ proj
        resid_sq += float(torch.sum(r ** 2))
        x_sq += float(torch.sum(x ** 2))
    return _finite(math.sqrt(resid_sq) / (
        math.sqrt(x_sq) * float(torch.linalg.matrix_norm(v))
        + float(torch.linalg.matrix_norm(m_mat))))


def judge(idx, vals, norm_x: float, sweeps, rtol: float, device):
    """The numbers over the checked sweeps (inf where a sweep left out a
    mode, a weight or a fit, or where one is not a number), and per sweep
    its own numbers, the largest condition number of its modes' V, the
    reference's own backward error (its pseudo-inverse's cut-off), the
    program's backward error over all of V's directions, and the most
    directions any mode's V has under the cut-off, in float64 and in
    float32."""
    gaps, detail = dict.fromkeys(GAPS, 0.0), []
    f64 = torch.float64
    idx, vals = idx.to(device), vals.to(device)

    def dev(t):
        return t.to(device=device, dtype=f64)

    for rec in sweeps:
        order = len(rec.inputs)
        if len(rec.outputs) != order or len(rec.factors) != order \
                or len(rec.lams) != order:
            return dict.fromkeys(GAPS, math.inf), detail
        cur = [dev(f) for f in rec.inputs]
        own = dict.fromkeys(GAPS, 0.0)
        cond = ref_residual = full_residual = 0.0
        dropped = dropped32 = 0
        for n in range(order):
            m_ref = reference.mttkrp(idx, vals, cur, n)
            m_got = dev(rec.outputs[n])
            own["mttkrp_gap"] = max(own["mttkrp_gap"], row_gap(m_got, m_ref))
            f_ref, lam_ref = reference.update(m_ref, cur, n, rtol)
            got = dev(rec.factors[n])
            own["factor_gap"] = max(own["factor_gap"], row_gap(got, f_ref))
            v = hadamard_gram(cur, n)
            proj, _ = kept(v, KEEP_ABOVE * rtol)
            own["solve_residual"] = max(own["solve_residual"], residual(
                got, dev(rec.lams[n]), v, m_got, proj))
            full_residual = max(full_residual, residual(
                got, dev(rec.lams[n]), v, m_got))
            dropped = max(dropped, kept(v, rtol)[1])
            dropped32 = max(dropped32, kept(hadamard_gram(
                [t.to(torch.float32) for t in cur], n), rtol)[1])
            own["unmoved_factors"] += float(
                torch.equal(rec.factors[n], rec.inputs[n]))
            f_own, lam_own = reference.update(m_got, cur, n, rtol)
            ref_residual = max(ref_residual,
                               residual(f_own, lam_own, v, m_got))
            cond = max(cond, float(torch.linalg.cond(v)))
            del m_got, f_own, v
            if n < order - 1:
                cur[n] = got
                del m_ref, f_ref
        own["lam_gap"] = _finite(float(
            torch.max(torch.abs(dev(rec.lam) - lam_ref))
            / torch.max(torch.abs(lam_ref))))
        own["fit_gap"] = _finite(abs(rec.fit - reference.fit(
            norm_x, m_ref, cur[:-1] + [f_ref], lam_ref)))
        for k in GAPS if rec.solve else AFTER_WINDOW:
            gaps[k] = max(gaps[k], own[k])
        detail.append(dict(own, cond=cond, ref_residual=ref_residual,
                           full_residual=full_residual, dropped=dropped,
                           dropped32=dropped32))
        del cur, m_ref, f_ref
    return gaps, detail
