"""The port's fault layer (``repro_torch.faults``, ``repro_torch.obs.trace``)
and the degradation ladder of ``plan_for``, against the JAX package's, on
the CPU: the spec grammar, the retry taxonomy, the fault sites
(``store.read``, ``plan.alloc``, ``stream.h2d``) and the ladder
in_memory -> streamed -> disk_streamed."""
import ast
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro.faults import FaultPlan as RFaultPlan  # noqa: E402
from repro.faults import FaultRule as RFaultRule  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import launches  # noqa: E402
from repro_torch.engine import (DefaultEngine, DiskStreamedPlan,  # noqa: E402
                                InMemoryPlan, MTTKRPEngine, StreamedPlan,
                                plan_for)
from repro_torch.faults import (FaultPlan, FaultRule,  # noqa: E402
                                FaultSpecError, Permanent, RetryPolicy,
                                Transient, inject, is_transient, retry_call)
from repro_torch.obs import trace  # noqa: E402
from repro_torch.store import StoreCorruptionError  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANK = 4
BUDGET = 64 << 20
DIMS = (8, 8, 8)


def _tensor(seed=0, nnz=200, dim=8):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(nnz, 3)).astype(np.int64)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return idx, vals


def _blcos():
    """The reference's tensor and the port's BLCO of the same COO entries,
    in several launches."""
    idx, vals = _tensor()
    t = rcore.from_coo(idx, vals, DIMS)
    return t, core.build_blco(core.from_coo(idx, vals, DIMS),
                              max_nnz_per_block=32)


def _factors(rank=RANK):
    rng = np.random.default_rng(1)
    return [rng.standard_normal((d, rank)).astype(np.float32) for d in DIMS]


def _torch(fs):
    return [torch.from_numpy(x) for x in fs]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    yield
    inject.uninstall()


# ------------------------------------------------------------- the copies
def _code(path: Path, pkg: str, drop=()) -> str:
    """The module's AST without docstrings and without the top-level
    functions and classes named in ``drop``, with absolute imports of
    ``pkg`` renamed to one placeholder package."""
    tree = ast.parse(path.read_text())
    tree.body = [n for n in tree.body
                 if not (isinstance(n, (ast.FunctionDef, ast.ClassDef))
                         and n.name in drop)]
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[0] == pkg:
            node.module = "PKG" + node.module[len(pkg):]
    return ast.dump(tree)


def _top_level(path: Path, name: str):
    tree = ast.parse(path.read_text())
    found = [ast.dump(n) for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))
             and n.name == name]
    return found[0] if found else None


# each copy's deliberate differences from the reference, by top-level name:
# the port's ``span`` also enters a ``torch.profiler.record_function`` of
# its name while a profiler records (``_ProfiledSpan``)
DIFFERENCES = {
    "faults/inject.py": (),
    "faults/retry.py": (),
    "obs/trace.py": ("span", "_ProfiledSpan"),
}


@pytest.mark.parametrize("module", DIFFERENCES)
def test_copies_identical_to_reference_but_imports(module):
    """The port's ``faults`` and ``obs/trace.py`` are the reference's code:
    the same statements, only the package of their imports (and the
    docstrings, which speak of the port) differ, and the top-level
    definitions named in ``DIFFERENCES``, each of which does differ."""
    port = ROOT / "src" / "repro_torch" / module
    ref = ROOT / "src" / "repro" / module
    drop = DIFFERENCES[module]
    assert _code(port, "repro_torch", drop) == _code(ref, "repro", drop)
    assert "repro_torch" in port.read_text() or module == "obs/trace.py"
    for name in drop:
        assert _top_level(port, name) is not None, name
        assert _top_level(port, name) != _top_level(ref, name), name


def test_copy_check_sees_a_changed_statement(tmp_path):
    ref = ROOT / "src" / "repro" / "faults" / "retry.py"
    bad = tmp_path / "retry.py"
    bad.write_text(ref.read_text().replace("attempt += 1", "attempt += 2"))
    assert _code(bad, "repro") != _code(ref, "repro")


# ------------------------------------------------------------ spec parsing
def test_spec_round_trip():
    plan = FaultPlan.from_spec(
        "7:store.read@p=0.3:transient;plan.alloc@n=1;stream.h2d@n=2,times=1")
    assert plan.seed == 7
    assert [r.site for r in plan.rules] == \
        ["store.read", "plan.alloc", "stream.h2d"]
    assert plan.rules[0].p == pytest.approx(0.3)
    assert plan.rules[1].kind == "alloc"          # site default kind
    assert plan.rules[2].nth == 2 and plan.rules[2].times == 1
    assert inject.SITES == __import__("repro.faults.inject",
                                      fromlist=["SITES"]).SITES


@pytest.mark.parametrize("spec,match", [
    ("no-seed-prefix", "seed"),
    ("x:store.read@n=1", "not an int"),
    ("1:", "no rules"),
    ("1:not.a.site@n=1", "unknown fault site"),
    ("1:store.read@n=1:explode", "no fault kind"),
    ("1:store.read@n=1,p=0.5", "exactly one"),
    ("1:store.read", "exactly one"),
    ("1:store.read@p=2.0", "p must be"),
    ("1:store.read@n=0", "n must be"),
    ("1:store.read@bogus=3", "unknown qualifier"),
    ("1:store.read@n", "malformed qualifier"),
    ("1:store.read@n=x", "bad value"),
])
def test_spec_errors(spec, match):
    with pytest.raises(FaultSpecError, match=match):
        FaultPlan.from_spec(spec)


def test_env_reload(monkeypatch):
    monkeypatch.setenv(inject.ENV_VAR, "3:plan.alloc@n=1")
    plan = inject.reload_from_env()
    assert plan is not None and inject.FAULTS.enabled
    monkeypatch.setenv(inject.ENV_VAR, "")
    assert inject.reload_from_env() is None
    assert not inject.FAULTS.enabled


def test_nth_rule_fires_exactly_once():
    plan = FaultPlan(seed=0, rules=(FaultRule("stream.h2d", nth=2),))
    with inject.active(plan):
        assert inject.fire("stream.h2d") is None
        assert inject.fire("stream.h2d") == "transient"
        assert inject.fire("stream.h2d") is None
    assert plan.fired_log == [("stream.h2d", "transient", 2)]
    assert plan.calls("stream.h2d") == 3


def test_probabilistic_rule_is_seed_deterministic_as_the_reference():
    """A seed gives the same firings in both packages (the same draws of
    the same generator)."""
    def run(plan_cls, rule_cls, seed):
        plan = plan_cls(seed=seed, rules=(
            rule_cls("store.read", p=0.5, kind="transient"),))
        return [plan.fire("store.read") for _ in range(32)]
    assert run(FaultPlan, FaultRule, 11) == run(FaultPlan, FaultRule, 11)
    assert run(FaultPlan, FaultRule, 11) != run(FaultPlan, FaultRule, 12)
    for seed in (11, 12):
        assert run(FaultPlan, FaultRule, seed) == \
            run(RFaultPlan, RFaultRule, seed)


def test_undeclared_site_raises_when_enabled():
    with inject.active(FaultPlan(seed=0, rules=(
            FaultRule("store.read", nth=1),))):
        with pytest.raises(FaultSpecError, match="undeclared"):
            inject.fire("store.raed")


def test_disabled_probe_is_cheap_and_inert():
    assert not inject.FAULTS.enabled
    assert inject.fire("store.read") is None
    inject.maybe_fail("plan.alloc")            # no-op, no raise
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        inject.fire("store.read")
    assert (time.perf_counter() - t0) / n < 5e-6


def test_exception_types_per_site():
    assert type(inject.exception_for("store.read", "transient")) is OSError
    assert isinstance(inject.exception_for("store.read", "corrupt"),
                      StoreCorruptionError)
    assert isinstance(inject.exception_for("plan.alloc", "alloc"),
                      inject.AllocationError)
    assert isinstance(inject.exception_for("plan.alloc", "kernel"),
                      inject.KernelFailure)
    assert type(inject.exception_for("stream.h2d", "transient")) is OSError


def test_is_alloc_failure_matches_a_card_oom():
    """The ladder's predicate: injected AllocationError, and the message
    of a genuine ``torch.cuda.OutOfMemoryError``; nothing else."""
    assert inject.is_alloc_failure(inject.AllocationError("x"))
    assert inject.is_alloc_failure(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.19 GiB "
        "total capacity)"))
    assert inject.is_alloc_failure(RuntimeError("RESOURCE_EXHAUSTED: x"))
    assert not inject.is_alloc_failure(inject.KernelFailure("x"))
    assert not inject.is_alloc_failure(ValueError("no regime fits"))


# -------------------------------------------------------------- retry layer
class _Stats:
    retries = 0
    giveups = 0


def test_retry_absorbs_transients_and_counts():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("flaky")
        return "ok"

    stats = _Stats()
    policy = RetryPolicy(attempts=4, base_delay_s=0.0, max_delay_s=0.0)
    with trace.enabled():
        trace.clear()
        assert retry_call(flaky, site="t", policy=policy, stats=stats,
                          sleep=lambda s: None) == "ok"
        spans = [s for s in trace.drain() if s.name == "retry.attempt"]
    assert stats.retries == 2 and stats.giveups == 0
    assert [s.attrs["attempt"] for s in spans] == [2, 3]


def test_retry_gives_up_and_reraises():
    stats = _Stats()
    policy = RetryPolicy(attempts=3, base_delay_s=0.0, max_delay_s=0.0)

    def always():
        raise TimeoutError("down")

    with pytest.raises(TimeoutError):
        retry_call(always, site="t", policy=policy, stats=stats,
                   sleep=lambda s: None)
    assert stats.retries == 2 and stats.giveups == 1


def test_retry_permanent_fails_fast():
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise Permanent("no point")

    with pytest.raises(Permanent):
        retry_call(broken, site="t", sleep=lambda s: None)
    assert calls["n"] == 1


def test_retry_backoff_is_capped_and_jittered():
    policy = RetryPolicy(attempts=8, base_delay_s=0.002, max_delay_s=0.05,
                         jitter=0.5)
    for attempt in range(1, 9):
        base = min(0.05, 0.002 * 2 ** (attempt - 1))
        assert base <= policy.delay_s(attempt) <= 1.5 * base


def test_transient_taxonomy():
    assert is_transient(OSError("x"))
    assert is_transient(TimeoutError("x"))
    assert is_transient(Transient("x"))
    assert not is_transient(ValueError("x"))
    assert not is_transient(StoreCorruptionError("x"))
    assert not is_transient(Permanent("x"))


# ------------------------------------------------------- per-site taxonomy
@pytest.mark.parametrize("nth", [1, 3])
def test_store_read_transient_is_retried(tmp_path, nth):
    t, blco = _blcos()
    f = _factors()
    ref = DiskStreamedPlan.spill(blco, str(tmp_path / "r.blco"),
                                 device="cpu")
    want = ref.mttkrp(_torch(f), 0)
    ref.close()
    with inject.active(FaultPlan(seed=3, rules=(
            FaultRule("store.read", kind="transient", nth=nth),))):
        p = DiskStreamedPlan.spill(blco, str(tmp_path / "t.blco"),
                                   device="cpu")
        got = p.mttkrp(_torch(f), 0)
        st = p.stats()
        p.close()
    assert st.retries == 1 and st.giveups == 0
    assert st.disk_bytes == len(blco.launches) * p.spec.bytes_per_launch
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert _rel(got, rcore.mttkrp_dense_oracle(t, f, 0)) < 5e-4


@pytest.mark.parametrize("kind", ["corrupt", "truncate"])
def test_store_read_corruption_is_permanent(tmp_path, kind):
    _, blco = _blcos()
    with inject.active(FaultPlan(seed=3, rules=(
            FaultRule("store.read", kind=kind, nth=1),))):
        p = DiskStreamedPlan.spill(blco, str(tmp_path / "t.blco"),
                                   device="cpu")
        with pytest.raises(StoreCorruptionError):
            p.mttkrp(_torch(_factors()), 0)
        st = p.stats()
        p.close()
    assert st.retries == 0        # permanent faults are not retried


def test_store_read_gives_up_after_the_policy(tmp_path):
    _, blco = _blcos()
    with inject.active("5:store.read@p=1.0"):
        p = DiskStreamedPlan.spill(blco, str(tmp_path / "t.blco"),
                                   device="cpu")
        with pytest.raises(OSError, match="fault-injection"):
            p.mttkrp(_torch(_factors()), 0)
        st = p.stats()
        p.close()
    assert st.retries == 3 and st.giveups == 1


@pytest.mark.parametrize("backend", ["streamed", "disk_streamed"])
def test_h2d_transient_is_retried_bit_identical(backend, tmp_path):
    _, blco = _blcos()
    kw = dict(rank=RANK, backend=backend, device="cpu",
              store_path=str(tmp_path / "t.blco"))
    ref = plan_for(blco, BUDGET, **kw)
    want = ref.mttkrp(_torch(_factors()), 0)
    ref.close()
    with inject.active(FaultPlan(seed=4, rules=(
            FaultRule("stream.h2d", nth=1), FaultRule("stream.h2d", nth=4)))):
        p = plan_for(blco, BUDGET, **kw)
        got = p.mttkrp(_torch(_factors()), 0)
        st = p.stats()
        p.close()
    assert st.retries == 2 and st.giveups == 0
    assert st.h2d_bytes == len(blco.launches) * p.spec.bytes_per_launch
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------- ladder
@pytest.mark.parametrize("kernel", ["cuda", "torch"])
def test_alloc_failure_walks_the_ladder(kernel, tmp_path, monkeypatch):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    t, blco = _blcos()
    f = _factors()
    oracle = rcore.mttkrp_dense_oracle(t, f, 0)
    with trace.enabled():
        trace.clear()
        with inject.active(FaultPlan(seed=0, rules=(
                FaultRule("plan.alloc", nth=1),))):
            p = plan_for(blco, BUDGET, rank=RANK, kernel=kernel,
                         device="cpu")
        spans = trace.drain()
    assert isinstance(p, StreamedPlan) and p.stats().demotions == 1
    assert [s.attrs["demote"] for s in spans if s.name == "engine.demote"] \
        == ["in_memory->streamed"]
    top = [s for s in spans if s.name == "engine.plan_for"]
    assert len(top) == 1 and top[0].attrs["backend"] == "streamed"
    assert _rel(p.mttkrp(_torch(f), 0), oracle) < 5e-4
    p.close()
    with inject.active(FaultPlan(seed=0, rules=(
            FaultRule("plan.alloc", nth=1), FaultRule("plan.alloc", nth=2)))):
        p = plan_for(blco, BUDGET, rank=RANK, kernel=kernel, device="cpu")
    assert isinstance(p, DiskStreamedPlan) and p.stats().demotions == 2
    out = p.mttkrp(_torch(f), 0)        # the demoted plan still computes
    assert out.shape == (DIMS[0], RANK) and _rel(out, oracle) < 5e-4
    p.close()
    assert list(tmp_path.iterdir()) == []     # the anonymous spill is gone


def test_a_card_oom_at_the_upload_demotes(monkeypatch):
    """A genuine out-of-memory error from the in-memory upload (here raised
    by the upload itself, as the card's allocator raises it) takes the same
    door as the injected fault."""
    _, blco = _blcos()

    def oom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 20.00 MiB")

    monkeypatch.setattr(launches.LaunchCache, "from_chunks", oom)
    p = plan_for(blco, BUDGET, rank=RANK, device="cpu")
    assert p.backend == "streamed" and p.stats().demotions == 1
    p.close()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        plan_for(blco, BUDGET, rank=RANK, backend="in_memory", device="cpu")


@pytest.mark.parametrize("backend", ["in_memory", "streamed"])
def test_explicit_backend_never_demotes(backend):
    _, blco = _blcos()
    with inject.active(FaultPlan(seed=0, rules=(
            FaultRule("plan.alloc", nth=1),))):
        with pytest.raises(inject.AllocationError):
            plan_for(blco, BUDGET, rank=RANK, backend=backend, device="cpu")


def test_other_failures_never_demote():
    """Only an allocation failure falls a tier: the budget's ValueError
    propagates from the streamed rung."""
    _, blco = _blcos()
    with pytest.raises(ValueError, match="no regime fits"):
        plan_for(blco, 1000, rank=RANK, device="cpu")


@pytest.mark.parametrize("backend", ["auto", "in_memory", "streamed"])
@pytest.mark.parametrize("kernel", ["cuda", "torch"])
def test_kernel_failure_propagates(kernel, backend):
    """No kernel rung: a KernelFailure leaves plan_for, whatever the
    kernel and the backend, and nothing demotes in its place."""
    _, blco = _blcos()
    with inject.active(FaultPlan(seed=0, rules=(
            FaultRule("plan.alloc", kind="kernel", nth=1),))):
        with pytest.raises(inject.KernelFailure):
            plan_for(blco, BUDGET, rank=RANK, kernel=kernel,
                     backend=backend, device="cpu")


# ----------------------------------------------------- engine and tracing
def test_default_engine_is_an_mttkrp_engine(tmp_path, monkeypatch):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    t, blco = _blcos()
    f = _factors()
    engine = DefaultEngine(queues=2, device="cpu")
    assert isinstance(engine, MTTKRPEngine)
    p = engine.plan(blco, device_budget_bytes=BUDGET, rank=RANK)
    assert isinstance(p, InMemoryPlan)
    p.close()
    disk = DefaultEngine(queues=2, device="cpu", host_budget_bytes=1)
    p = disk.plan(blco, device_budget_bytes=BUDGET, rank=RANK)
    assert isinstance(p, DiskStreamedPlan) and p.queues == 2
    assert _rel(p.mttkrp(_torch(f), 1),
                rcore.mttkrp_dense_oracle(t, f, 1)) < 5e-4
    p.close()


def test_spans_of_a_disk_streamed_call(tmp_path):
    _, blco = _blcos()
    with trace.enabled():
        trace.clear()
        p = plan_for(blco, BUDGET, rank=RANK, backend="disk_streamed",
                     store_path=str(tmp_path / "t.blco"), device="cpu")
        p.mttkrp(_torch(_factors()), 2)
        spans = trace.drain()
    p.close()
    names = [s.name for s in spans]
    assert names.count("store.read") == len(blco.launches)
    assert names.count("plan.mttkrp") == names.count("engine.plan_for") == 1
    reads = [s for s in spans if s.name == "store.read"]
    assert [s.attrs["launch"] for s in reads] == list(range(len(reads)))
    assert all(s.parent == "plan.mttkrp" for s in reads)
    assert not trace.is_enabled()
    trace.add_event("store.read", "store", 0.0, 1.0)   # disabled: dropped
    assert trace.spans() == []
