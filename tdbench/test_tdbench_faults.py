"""A whole run on the CPU at a small size, past the harness's look for a
card: sound, it is correct; with the timed path broken underneath, or
with the TF32 control in the program's place, ``correct`` comes out false.
The faults that start after warm-up (a sweep that counts itself but leaves
the factors as they were; a pseudo-inverse reused from the sweep before)
are seen only by the sweep checked after the window.

The control at the cells' own sizes is read on a card
(``run.py --control``); ``test_control_fails_on_the_card`` repeats it at a
small size there.
"""
import importlib

import pytest
import torch

from repro_torch.core import SparseTensor, build_blco, cp_als_step
from repro_torch.engine import plan_for
from tdbench import manifest, run

CELL = "nell2-cpals-r32"
CP_ALS = importlib.import_module("repro_torch.core.cp_als")
WARMUP = manifest.cell(CELL)["traffic"]["warmup_sweeps"]


def _spec(dims=(30, 24, 36), nnz=3000):
    spec = manifest.cell(CELL)
    spec["config"] = dict(spec["config"], dims=list(dims), nnz=nnz)
    return spec


def _run(spec, device="cpu", **kw):
    return run.run_cell(CELL, 2**31 + 17, 0.2, False, device=device,
                        spec=spec, **kw)


class _Altered:
    """The plan with one answer altered where it is produced: row 0 of
    every MTTKRP output off by a thousandth."""

    def __init__(self, plan):
        self.plan = plan

    def __getattr__(self, name):
        return getattr(self.plan, name)

    def mttkrp(self, factors, mode):
        out = self.plan.mttkrp(factors, mode).clone()
        out[0] *= 1.001
        return out


def _half_blco(tensor, **kw):
    """Half the non-zeros left out, the rest doubled: the mean over the
    rest in place of the sum."""
    keep = slice(0, None, 2)
    return build_blco(SparseTensor(tensor.dims, tensor.indices[keep],
                                   2 * tensor.values[keep]), **kw)


def _counts_itself(warmup):
    """After ``warmup`` sound sweeps, a sweep that computes each mode's
    MTTKRP but skips the update: the factors stay as they were, the
    iteration goes up and the last fit is appended again."""
    calls = []

    def step(plan, state):
        calls.append(1)
        if len(calls) <= warmup:
            return cp_als_step(plan, state)
        for mode in range(len(state.factors)):
            plan.mttkrp(state.factors, mode)
        state.iteration += 1
        state.fits.append(state.fits[-1])
        return state
    return step


def _stale_pinv(warmup, order):
    """After ``warmup`` sound sweeps, each mode's pseudo-inverse is the one
    its mode had in the last sweep of warm-up."""
    real, done = CP_ALS._pinv, []

    def pinv(v):
        k = len(done)
        done.append(real(v) if k < warmup * order else done[k - order])
        return done[-1]
    return pinv


def test_sound_run_is_correct():
    result = _run(_spec())
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result["checks"]) == list(
        manifest.cell(CELL)["config"]["limits"])
    assert set(result["metrics"]) == {"setup_s", "sweep_ms", "sweep_p95_ms",
                                      "peak_device_gb"}
    assert result["checks"]["unmoved_factors"]["value"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "control"])
def test_fault_is_not_correct(monkeypatch, fault):
    kw = {}
    if fault == "unchanged":
        monkeypatch.setattr(run, "cp_als_step", lambda plan, state: state)
    elif fault == "half":
        monkeypatch.setattr(run, "build_blco", _half_blco)
    elif fault == "altered":
        monkeypatch.setattr(run, "plan_for",
                            lambda *a, **k: _Altered(plan_for(*a, **k)))
    else:
        kw["control"] = True
    result = _run(_spec(), **kw)
    assert not result["correct"], result["checks"]


def test_unchanged_state_reads_in_the_sweep_count(monkeypatch):
    monkeypatch.setattr(run, "cp_als_step", lambda plan, state: state)
    checks = _run(_spec())["checks"]
    assert checks["sweeps_gap"]["value"] > 0
    assert checks["mttkrp_gap"]["value"] == float("inf")


def test_unchanged_state_that_counts_itself_reads_in_the_solve(
        monkeypatch):
    monkeypatch.setattr(run, "cp_als_step", _counts_itself(WARMUP))
    result = _run(_spec())
    checks = result["checks"]
    assert not result["correct"]
    assert checks["sweeps_gap"]["value"] == 0
    assert checks["unmoved_factors"]["value"] == 3
    assert checks["solve_residual"]["value"] > 100 * checks[
        "solve_residual"]["limit"]


def test_stale_pseudo_inverse_reads_in_the_solve(monkeypatch):
    monkeypatch.setattr(CP_ALS, "_pinv", _stale_pinv(WARMUP, 3))
    result = _run(_spec())
    checks = result["checks"]
    assert not result["correct"]
    assert checks["sweeps_gap"]["value"] == 0
    assert checks["mttkrp_gap"]["value"] <= checks["mttkrp_gap"]["limit"]
    assert checks["solve_residual"]["value"] > checks[
        "solve_residual"]["limit"]


def test_window_drives_the_real_step():
    assert run.cp_als_step is cp_als_step


@pytest.mark.gpu
def test_control_fails_on_the_card(cuda):
    spec = _spec((600, 500, 700), 200_000)
    sound = _run(spec, device=cuda)
    control = _run(spec, device=cuda, control=True)
    assert sound["correct"], sound["checks"]
    assert not control["correct"], control["checks"]
    assert sound["device"]["kind"] == torch.cuda.get_device_name(cuda)
