"""The CP-ALS sweep's spans (``cp_als.sweep``, ``cp_als.update``,
``cp_als.pinv``, ``cp_als.fit`` beside the plan's ``plan.mttkrp``), their
mirror in a ``torch.profiler`` trace and the host-sync counter, on the CPU
with the plain kernel path.  The card's side (kernels matched to their
span, the counter against the runtime's synchronising calls, the call's
device time) is ``tests/test_torch_cp_als_spans_gpu.py``."""
import collections

import pytest
import torch
from torch.profiler import profile

from repro_torch import core, obs
from repro_torch.core.counters import host_sync_counts
from repro_torch.engine import plan_for
from repro_torch.obs import trace

RANK = 4
PROGRAM = ("cp_als.sweep", "cp_als.update", "cp_als.pinv", "cp_als.fit",
           "plan.mttkrp")
CASES = [((20, 16, 24), 800), ((9, 7, 11, 5), 600)]


@pytest.fixture(autouse=True)
def _clean_trace():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _setup(dims, nnz, seed=3):
    t = core.random_tensor(dims, nnz, seed=seed, dist="powerlaw")
    plan = plan_for(core.build_blco(t), 1 << 30, rank=RANK, kernel="torch",
                    device="cpu")
    state = core.cp_als_init(t.dims, RANK, norm_x=1.0, seed=5, tol=0.0,
                             device="cpu")
    return plan, state


def _traced_sweep(dims, nnz):
    plan, state = _setup(dims, nnz)
    with trace.enabled():
        core.cp_als_step(plan, state)
    return [s for s in trace.spans() if s.name in PROGRAM], state


@pytest.mark.parametrize("dims,nnz", CASES)
def test_one_sweep_records_each_span_once_per_mode(dims, nnz):
    got, _ = _traced_sweep(dims, nnz)
    n = len(dims)
    assert collections.Counter(s.name for s in got) == {
        "cp_als.sweep": 1, "cp_als.update": n, "cp_als.pinv": n,
        "plan.mttkrp": n, "cp_als.fit": 1}
    assert {s.track for s in got if s.name.startswith("cp_als")} == \
        {"cp_als"}


@pytest.mark.parametrize("dims,nnz", CASES)
def test_spans_nest_under_the_sweep(dims, nnz):
    got, _ = _traced_sweep(dims, nnz)
    parent = {"cp_als.sweep": None, "cp_als.update": "cp_als.sweep",
              "cp_als.pinv": "cp_als.update", "cp_als.fit": "cp_als.sweep",
              "plan.mttkrp": "cp_als.sweep"}
    for s in got:
        assert s.parent == parent[s.name], s
    sweep = [s for s in got if s.name == "cp_als.sweep"][0]
    for s in got:
        assert sweep.start_s <= s.start_s <= s.end_s <= sweep.end_s, s


@pytest.mark.parametrize("dims,nnz", CASES)
def test_update_and_mttkrp_carry_their_mode(dims, nnz):
    got, _ = _traced_sweep(dims, nnz)
    modes = list(range(len(dims)))
    for name in ("cp_als.update", "plan.mttkrp"):
        assert [s.attrs["mode"] for s in got if s.name == name] == modes
    # per mode the MTTKRP comes first, then the update that reads it
    order = [(s.name, s.attrs.get("mode")) for s in
             sorted(got, key=lambda s: s.start_s)
             if s.name in ("cp_als.update", "plan.mttkrp")]
    assert order == [(name, m) for m in modes
                     for name in ("plan.mttkrp", "cp_als.update")]


def test_sweep_carries_its_iteration():
    plan, state = _setup(*CASES[0])
    with trace.enabled():
        for _ in range(3):
            core.cp_als_step(plan, state)
    assert [s.attrs["iteration"] for s in trace.spans()
            if s.name == "cp_als.sweep"] == [0, 1, 2]


def test_a_converged_state_records_no_sweep():
    plan, state = _setup(*CASES[0])
    state.converged = True
    with trace.enabled():
        core.cp_als_step(plan, state)
    assert trace.spans() == []


@pytest.mark.parametrize("dims,nnz", CASES)
def test_tracing_off_records_nothing_and_changes_no_bit(dims, nnz):
    plan, off = _setup(dims, nnz)
    _, on = _setup(dims, nnz)
    for _ in range(2):
        core.cp_als_step(plan, off)
    assert trace.spans() == []
    with trace.enabled():
        for _ in range(2):
            core.cp_als_step(plan, on)
    assert trace.spans()
    assert off.fits == on.fits
    assert torch.equal(off.lam, on.lam)
    for a, b in zip(off.factors, on.factors):
        assert torch.equal(a, b)


def test_host_sync_counts_do_not_grow_on_the_cpu():
    plan, state = _setup(*CASES[0])
    before = host_sync_counts()
    core.cp_als_step(plan, state)
    with trace.enabled():
        core.cp_als_step(plan, state)
    assert host_sync_counts() == before


def test_host_sync_counts_are_a_copy():
    counts = host_sync_counts()
    counts["plan.fence"] = counts.get("plan.fence", 0) + 99
    assert host_sync_counts() != counts


def _profiled_names(traced: bool):
    plan, state = _setup(*CASES[0])
    core.cp_als_step(plan, state)
    if traced:
        trace.enable()
    with profile() as prof:
        core.cp_als_step(plan, state)
    trace.disable()
    return collections.Counter(e.name for e in prof.events()
                               if e.name in PROGRAM)


def test_profiler_holds_the_program_spans_while_tracing():
    assert _profiled_names(traced=True) == {
        "cp_als.sweep": 1, "cp_als.update": 3, "cp_als.pinv": 3,
        "plan.mttkrp": 3, "cp_als.fit": 1}
    assert [s.name for s in trace.spans()].count("cp_als.sweep") == 1


def test_tracing_off_mirrors_nothing_into_the_profiler():
    assert _profiled_names(traced=False) == {}
    with profile():
        assert trace.span("cp_als.sweep", "cp_als") is trace._NULL


def test_mirrored_span_yields_the_span_and_records_it():
    with trace.enabled(), profile():
        with trace.span("cp_als.fit", "cp_als") as sp:
            sp.set(x=1)
    assert isinstance(sp, obs.trace.Span)
    assert [(s.name, s.attrs) for s in trace.spans()] == [
        ("cp_als.fit", {"x": 1})]
