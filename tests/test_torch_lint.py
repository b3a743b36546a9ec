"""The port's AST lint tier (``repro_torch.analysis.linter`` and
``passes``) against the JAX package's, on the CPU.

* the copied modules are the reference's code: the same statements but
  for the package of their imports, the docstrings and the definitions
  named in ``DIFFERENCES`` (each with its reason);
* the reference's own fixture snippets (``tests/test_analysis.py``) give
  the same findings from both packages' copied passes;
* each torch twin (``dtype-promotion``, ``host-sync-in-hot-path``,
  ``unfenced-timing``) flags a torch-spelled fixture of its bug class and
  stays silent on the fixed form;
* ``src/repro_torch/`` and ``chip_smoke.py`` lint clean against the port's
  baseline, which carries no stale or unjustified entry.
"""
import ast
from pathlib import Path

import pytest

pytest.importorskip("jax")

from repro.analysis import lint_sources as ref_lint_sources  # noqa: E402
from repro.analysis.passes import REGISTRY as REF_REGISTRY  # noqa: E402
from repro_torch.analysis import (BASELINE_PATH, Baseline,  # noqa: E402
                                  Finding, lint_paths, lint_sources)
from repro_torch.analysis.passes import REGISTRY  # noqa: E402
from repro_torch.faults import inject  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _only(findings, pass_id):
    return [f for f in findings if f.pass_id == pass_id]


# ------------------------------------------------------------ the copies
def _code(path: Path, pkg: str, drop=()) -> str:
    """The module's AST without docstrings and without the top-level
    definitions (functions, classes, ``Class.method``s, assignments) named
    in ``drop``; absolute imports of ``pkg`` renamed to one placeholder
    package."""
    tree = ast.parse(path.read_text())

    def keep(node, prefix):
        names = [getattr(node, "name", None)]
        if isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        return not any(n is not None and f"{prefix}{n}" in drop
                       for n in names)

    def walk(node, prefix=""):
        body = getattr(node, "body", None)
        if not isinstance(body, list):
            return
        if body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            body = body[1:]
        body = [n for n in body if keep(n, prefix)]
        node.body = body or [ast.Pass()]
        for child in body:
            inner = f"{child.name}." if isinstance(child, ast.ClassDef) \
                else ""
            walk(child, prefix + inner)

    walk(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[0] == pkg:
            node.module = "PKG" + node.module[len(pkg):]
    return ast.dump(tree)


def _defs(path: Path, pkg: str) -> dict:
    """``name`` / ``Class.method`` / assigned name -> its code, docstrings
    dropped and imports of ``pkg`` renamed as ``_code`` does."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = _render(node, pkg)
        if isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, ast.FunctionDef):
                    out[f"{node.name}.{m.name}"] = _render(m, pkg)
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ast.dump(node.value)
    return out


def _render(node, pkg) -> str:
    for sub in ast.walk(node):
        body = getattr(sub, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            sub.body = body[1:] or [ast.Pass()]
        if isinstance(sub, ast.ImportFrom) and sub.module \
                and sub.module.split(".")[0] == pkg:
            sub.module = "PKG" + sub.module[len(pkg):]
    return ast.dump(node)


# analysis module -> {definition: why the port's differs}; everything else
# is the reference's code statement for statement
DIFFERENCES = {
    "linter.py": {},
    "passes/__init__.py": {},
    "passes/common.py": {},
    "passes/span_hygiene.py": {},
    "passes/lock_discipline.py": {},
    "passes/fault_site_hygiene.py": {
        "FaultSiteHygienePass.run": "the message names the port's SITES",
    },
    "trace/metrics.py": {},
    "trace/encoding.py": {
        "_LINEARIZE": "findings point at the port's linearize.py",
    },
    "trace/cachekeys.py": {
        "_PADDING": "findings point at the port's padding.py (port only)",
        "_KERNELS": "the occupancy findings' path (port only)",
        "audit_rounding": "default path is the port's padding.py",
        "audit_tenant_invariance": "path is the port's padding.py",
        "_PROBE_NNZ": "the occupancy-key audit (port only)",
        "_PAIRS": "the occupancy-key audit (port only)",
        "launch_keys": "the occupancy-key audit (port only)",
        "_tenant": "the occupancy-key audit (port only)",
        "occupancy_bound": "the occupancy-key audit (port only)",
        "audit_occupancy_keys": "the occupancy-key audit (port only)",
    },
}


@pytest.mark.parametrize("module", DIFFERENCES)
def test_copies_identical_to_reference_but_named_differences(module):
    """Each copied analysis module is the reference's code: the same
    statements but for imports, docstrings and the named definitions,
    each of which does differ (or exists in one package only)."""
    port = ROOT / "src" / "repro_torch" / "analysis" / module
    ref = ROOT / "src" / "repro" / "analysis" / module
    drop = DIFFERENCES[module]
    assert _code(port, "repro_torch", drop) == _code(ref, "repro", drop)
    pdefs, rdefs = _defs(port, "repro_torch"), _defs(ref, "repro")
    for name in drop:
        assert name in pdefs or name in rdefs, name
        assert pdefs.get(name) != rdefs.get(name), name


def test_conflict_report_is_the_reference_function():
    """``trace/conflicts.py`` is a twin but for ``conflict_report``, which
    is the reference's statement for statement."""
    port = ROOT / "src/repro_torch/analysis/trace/conflicts.py"
    ref = ROOT / "src/repro/analysis/trace/conflicts.py"
    pdefs, rdefs = _defs(port, "repro_torch"), _defs(ref, "repro")
    assert pdefs["conflict_report"] == rdefs["conflict_report"]


def test_copy_check_sees_a_changed_statement(tmp_path):
    ref = ROOT / "src/repro/analysis/passes/lock_discipline.py"
    bad = tmp_path / "lock_discipline.py"
    text = ref.read_text()
    assert 'if meth.name == "__init__":' in text
    bad.write_text(text.replace('if meth.name == "__init__":',
                                'if meth.name == "__init__x":'))
    assert _code(bad, "repro") != _code(ref, "repro")


def test_registry_spells_the_reference_pass_ids():
    assert [p.pass_id for p in REGISTRY] == \
        [p.pass_id for p in REF_REGISTRY]
    assert [p.__name__ for p in REGISTRY] == \
        [p.__name__ for p in REF_REGISTRY]


# ------------------------------------ the reference's fixtures, both sides
def _reference_snippets() -> dict:
    """The module-level fixture strings of ``tests/test_analysis.py``
    (``BAD_*`` / ``GOOD_*``), evaluated without importing it."""
    tree = ast.parse((ROOT / "tests" / "test_analysis.py").read_text())
    ns = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id.startswith(("BAD_", "GOOD_")):
            ns[node.targets[0].id] = eval(compile(
                ast.Expression(node.value), "test_analysis.py", "eval"),
                {"__builtins__": {}}, dict(ns))
    return ns


SNIPPETS = _reference_snippets()
COPIED_PASSES = ("span-hygiene", "lock-discipline", "fault-site-hygiene")
# where the reference's tests lint each snippet
SNIPPET_PATHS = ("src/repro/core/x.py", "src/repro/engine/plans.py",
                 "src/repro/service/x.py", "src/repro/obs/x.py")


def _key(findings, passes):
    return sorted((f.pass_id, f.path, f.symbol, f.line, f.message)
                  for f in findings if f.pass_id in passes)


def test_reference_snippets_found():
    assert {"BAD_DTYPE", "GOOD_DTYPE", "BAD_HOST_SYNC", "BAD_TIMING",
            "GOOD_TIMING", "BAD_LOCK", "GOOD_LOCK", "BAD_LOCK_MUTATOR",
            "BAD_SINGLETON", "BAD_SPAN", "GOOD_SPAN"} <= set(SNIPPETS)


@pytest.mark.parametrize("path", SNIPPET_PATHS)
@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_copied_passes_agree_with_reference_on_its_fixtures(name, path):
    src = {path: SNIPPETS[name]}
    assert _key(lint_sources(src), COPIED_PASSES) == \
        _key(ref_lint_sources(src), COPIED_PASSES)


def test_reference_fixtures_fire_the_copied_passes():
    def n(name, pass_id, path="src/repro/service/x.py"):
        return len(_only(lint_sources({path: SNIPPETS[name]}), pass_id))
    assert n("BAD_LOCK", "lock-discipline") == 1
    assert n("GOOD_LOCK", "lock-discipline") == 0
    assert n("BAD_LOCK_MUTATOR", "lock-discipline") == 1
    assert n("BAD_SINGLETON", "lock-discipline", "src/repro/obs/x.py") == 1
    assert n("BAD_SPAN", "span-hygiene") == 1
    assert n("GOOD_SPAN", "span-hygiene") == 0


BAD_FAULT_SITE = '''
from repro_torch.faults import inject as faults

def read_chunk(i):
    faults.maybe_fail("store.raed")       # typo: the probe never fires
    faults.fire("store.read")
'''


def test_fault_site_hygiene_checks_the_port_sites():
    assert "store.read" in inject.SITES and "store.raed" not in inject.SITES
    found = _only(lint_sources({"src/repro_torch/store/x.py":
                                BAD_FAULT_SITE}), "fault-site-hygiene")
    assert len(found) == 1 and "repro_torch.faults.inject.SITES" in \
        found[0].message
    ref = _only(ref_lint_sources({"src/repro_torch/store/x.py":
                                  BAD_FAULT_SITE}), "fault-site-hygiene")
    assert [(f.symbol, f.line) for f in found] == \
        [(f.symbol, f.line) for f in ref]
    # the declaring module itself is exempt
    assert not _only(lint_sources({"src/repro_torch/faults/inject.py":
                                   BAD_FAULT_SITE}), "fault-site-hygiene")


# -------------------------------------------------- the twins, torch-spelled
BAD_TO = '''
import torch

def coo_mttkrp(vals, cols, factors, mode):
    partial = vals[:, None].to(factors[0].dtype)   # f64 values downcast
    return partial
'''

GOOD_TO = '''
import torch

def coo_mttkrp(vals, cols, factors, mode):
    partial = vals[:, None].to(torch.promote_types(vals.dtype,
                                                   factors[0].dtype))
    return partial
'''

BAD_ZEROS = '''
import torch

def stream_mttkrp(b, factors, mode, rank):
    out = torch.zeros((b.dims[mode], rank), dtype=factors[0].dtype)
    acc = out.new_zeros((4, rank), dtype=gathered[0].dtype)
    return out, acc
'''

BAD_TYPE = '''
def hadamard(vals, gathered):
    return vals.type(gathered[0].dtype)
'''


@pytest.mark.parametrize("src,want", [(BAD_TO, 1), (BAD_ZEROS, 2),
                                      (BAD_TYPE, 1), (GOOD_TO, 0)],
                         ids=["to", "zeros+new_zeros", "type", "fixed"])
def test_dtype_promotion_twin(src, want):
    found = _only(lint_sources({"src/repro_torch/core/x.py": src}),
                  "dtype-promotion")
    assert len(found) == want
    assert all("promote_types" in f.message for f in found)


def test_dtype_promotion_twin_scoped_to_mttkrp_names():
    src = BAD_TO.replace("coo_mttkrp", "coo_gather")
    assert not _only(lint_sources({"src/repro_torch/core/x.py": src}),
                     "dtype-promotion")


BAD_ITEM = '''
import torch

def stacked_mttkrp(hi, lo, vals, bases, factors, *, mode, out_rows):
    out = torch.zeros((out_rows, factors[0].shape[1]))
    for i in range(hi.shape[0]):
        if vals[i].abs().sum().item() == 0:     # a host read per launch
            continue
        out += launch(hi[i], lo[i], vals[i], bases[i], factors)
    return out
'''

GOOD_ITEM = '''
import torch

def stacked_mttkrp(hi, lo, vals, bases, factors, *, mode, out_rows):
    out = torch.zeros((out_rows, factors[0].shape[1]))
    for i in range(hi.shape[0]):
        out += launch(hi[i], lo[i], vals[i], bases[i], factors)
    return out
'''

BAD_SYNCS = '''
import numpy as np
import torch

def fused_mttkrp_flat(hi, lo, vals, bases, factors):
    out = torch.zeros(4)
    rows = out.tolist()
    host = out.cpu()
    arr = out.numpy()
    if bool(vals.any()):
        pass
    total = np.sum(out)
    limits = np.cumsum(vals)
    fine = np.dtype("float32")
    return out
'''

BAD_WAIT = '''
class StreamBuffers:
    def host_set(self, k):
        self._copied[k].synchronize()
        return self._host_views[k]
'''


def test_host_sync_twin_flags_item_in_a_per_launch_body():
    found = _only(lint_sources({"src/repro_torch/core/launches.py":
                                BAD_ITEM}), "host-sync-in-hot-path")
    assert len(found) == 1 and found[0].symbol == "stacked_mttkrp"
    assert ".item()" in found[0].message
    assert not _only(lint_sources({"src/repro_torch/core/launches.py":
                                   GOOD_ITEM}), "host-sync-in-hot-path")


def test_host_sync_twin_flags_each_host_read():
    found = _only(lint_sources({"src/repro_torch/kernels/x.py": BAD_SYNCS}),
                  "host-sync-in-hot-path")
    msgs = " | ".join(f.message for f in found)
    assert len(found) == 6, msgs
    for what in (".tolist()", ".cpu()", ".numpy()", "bool(",
                 "np.sum", "np.cumsum"):
        assert what in msgs, what


def test_host_sync_twin_event_wait_needs_an_inline_reason():
    path = "src/repro_torch/core/streaming.py"
    found = _only(lint_sources({path: BAD_WAIT}), "host-sync-in-hot-path")
    assert len(found) == 1 and found[0].symbol == "StreamBuffers.host_set"
    disabled = BAD_WAIT.replace(
        "self._copied[k].synchronize()",
        "self._copied[k].synchronize()  "
        "# repro-lint: disable=host-sync-in-hot-path")
    assert not _only(lint_sources({path: disabled}),
                     "host-sync-in-hot-path")


def test_host_sync_twin_scope_and_fence():
    # outside the hot files, and a cold function in a hot file: not flagged
    assert not _only(lint_sources({"src/repro_torch/obs/export.py":
                                   BAD_ITEM}), "host-sync-in-hot-path")
    assert not _only(lint_sources({"src/repro_torch/kernels/build.py":
                                   BAD_SYNCS}), "host-sync-in-hot-path")
    cold = BAD_ITEM.replace("def stacked_mttkrp", "def launch_cache_bytes")
    assert not _only(lint_sources({"src/repro_torch/core/launches.py":
                                   cold}), "host-sync-in-hot-path")
    fenced = GOOD_ITEM.replace("    return out",
                               "    torch.cuda.synchronize()\n    return out")
    assert not _only(lint_sources({"src/repro_torch/core/launches.py":
                                   fenced}), "host-sync-in-hot-path")


BAD_DECODE = {
    "src/repro_torch/models/transformer.py": '''
def decode_step(params, cfg, cache, tokens, pos):
    if bool(tokens.max() >= cfg.padded_vocab):
        raise ValueError("token out of range")
    return tokens, cache


def forward(params, cfg, batch):
    return batch["tokens"].tolist()
''',
    "src/repro_torch/models/attention.py": '''
def gqa_decode(p, cfg, x, cache_k, cache_v, pos):
    return x.cpu(), cache_k, cache_v


def _full_attn(q, k, v, mask):
    return q[mask.nonzero().numpy()]
''',
}


def test_host_sync_twin_covers_the_decode_bodies():
    """The LM's decode step, ``gqa_decode`` and ``_full_attn`` are hot;
    the prefill ``forward`` is not."""
    found = _only(lint_sources(BAD_DECODE), "host-sync-in-hot-path")
    assert sorted((f.path.rsplit("/", 1)[-1], f.symbol) for f in found) == [
        ("attention.py", "_full_attn"), ("attention.py", "gqa_decode"),
        ("transformer.py", "decode_step")]


BAD_TRAIN = {
    "src/repro_torch/optim/adamw.py": '''
def apply_updates(params, grads, state, cfg):
    return float(state["step"].item())


def _global_norm(grads):
    return sum(g.square().sum().tolist() for g in grads.values())


def init_state(params, cfg):
    return {"step": params["w"].cpu()}
''',
    "src/repro_torch/optim/schedules.py": '''
def wsd(step, *, peak_lr, warmup, total):
    return peak_lr if bool(step < warmup) else 0.0
''',
    "src/repro_torch/launch/steps.py": '''
def make_train_step(cfg, opt_cfg):
    def train_step(state, batch):
        return state, {"loss": batch["labels"].numpy()}
    return train_step
''',
    "src/repro_torch/models/transformer.py": '''
def parallel_cross_entropy(logits, labels):
    return logits[labels.cpu()]


def forward(params, cfg, batch):
    return batch["tokens"].tolist()
''',
}


def test_host_sync_twin_covers_the_train_step_bodies():
    """The train step, AdamW's step and norm, the schedules and the loss
    are hot; ``init_state`` and the prefill ``forward`` are not."""
    found = _only(lint_sources(BAD_TRAIN), "host-sync-in-hot-path")
    assert sorted((f.path.rsplit("/", 1)[-1], f.symbol) for f in found) == [
        ("adamw.py", "_global_norm"), ("adamw.py", "apply_updates"),
        ("schedules.py", "wsd"), ("steps.py", "make_train_step.train_step"),
        ("transformer.py", "parallel_cross_entropy")]


# the streamed put time as it once was: the clock ran around the wait for
# the host set, its fill and the asynchronous copy, with no fence
BAD_PUT_TIME = '''
import time

def _issue(buffers, k, item, fill, stats):
    t0 = time.perf_counter()
    bufs = buffers.host_set(k)
    n = fill(item, bufs)
    buffers.upload(k)
    stats.put_time_s += time.perf_counter() - t0
    return n
'''

GOOD_PUT_TIME = '''
import time
import torch

def _issue(buffers, k, item, fill, stats):
    bufs = buffers.host_set(k)
    n = fill(item, bufs)
    t0 = time.perf_counter()
    start, stop = buffers.upload(k)
    torch.cuda.synchronize()
    stats.put_time_s += start.elapsed_time(stop) / 1e3
    stats.issue_s += time.perf_counter() - t0
    return n
'''

BAD_TO_DEVICE = '''
import time

def upload(arrays, dev):
    t0 = time.perf_counter()
    out = [a.to(dev, non_blocking=True) for a in arrays]
    return out, time.perf_counter() - t0
'''

BAD_KERNEL_TIMING = '''
import time
from repro_torch.kernels import fused_mttkrp_flat

def bench(hi, lo, vals, bases, fs):
    t0 = time.perf_counter()
    fused_mttkrp_flat(hi, lo, vals, bases, fs)
    return time.perf_counter() - t0
'''

NOT_A_DISPATCH = '''
import time

def report(run):
    t0 = time.perf_counter()
    n = fused_launches(run, 3)
    return n, time.perf_counter() - t0
'''


@pytest.mark.parametrize("src,want", [
    (BAD_PUT_TIME, 1), (GOOD_PUT_TIME, 0), (BAD_TO_DEVICE, 1),
    (BAD_KERNEL_TIMING, 1), (NOT_A_DISPATCH, 0),
    (BAD_KERNEL_TIMING.replace("    return time",
                               "    torch.cuda.synchronize()\n    return time"),
     0)],
    ids=["put-time-fault", "put-time-fixed", "to-device", "kernel",
         "helper", "kernel-fenced"])
def test_unfenced_timing_twin(src, want):
    found = _only(lint_sources({"src/repro_torch/core/x.py": src}),
                  "unfenced-timing")
    assert len(found) == want
    assert all("synchronize" in f.message for f in found)


def test_unfenced_timing_twin_names_the_put_time_fault():
    found = _only(lint_sources({"src/repro_torch/core/streaming.py":
                                BAD_PUT_TIME}), "unfenced-timing")
    assert found[0].symbol == "_issue" and "put-time" in found[0].message


# ---------------------------------------------------------- the meta-test
def test_baseline_entries_are_justified():
    data = Baseline.load(BASELINE_PATH)
    for e in data.entries:
        assert len(e["reason"].split()) >= 5, e
    with pytest.raises(ValueError, match="reason"):
        Baseline([{"pass": "unfenced-timing", "path": "x.py",
                   "symbol": "f", "reason": ""}])


def test_port_tree_lints_clean_against_its_baseline():
    """The port's invariants hold: zero findings outside its committed
    baseline, and no stale baseline entry."""
    findings = lint_paths([str(ROOT / "src" / "repro_torch"),
                           str(ROOT / "chip_smoke.py")], root=str(ROOT))
    baseline = Baseline.load(BASELINE_PATH)
    assert [f.render() for f in findings
            if not baseline.suppresses(f)] == []
    assert baseline.stale_entries(findings) == []


def test_baseline_reports_stale_entries():
    f = Finding(pass_id="unfenced-timing", path="chip_smoke.py",
                symbol="bench", line=5, message="m")
    base = Baseline([
        {"pass": "unfenced-timing", "path": "chip_smoke.py",
         "symbol": "bench", "reason": "a printed set-up time only"},
        {"pass": "dtype-promotion", "path": "gone.py", "symbol": "f",
         "reason": "file was deleted"},
    ])
    assert base.suppresses(f)
    assert [e["path"] for e in base.stale_entries([f])] == ["gone.py"]
