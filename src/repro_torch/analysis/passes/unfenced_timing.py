"""unfenced-timing pass: dispatch timing must fence the device.

The torch twin of the reference's pass.  Bug class: CUDA work is issued
asynchronously, so bracketing a kernel launch or a host-to-device copy
with ``time.perf_counter()`` measures the host's issue, not the device's
work.  The streamed put time once did exactly that: its clock ran around
the fill and the asynchronous copy of a chunk (``StreamBuffers.upload``)
with no fence, and counted host work as the copy.  Every timed dispatch
path therefore fences — ``torch.cuda.synchronize()``, or an event's or a
stream's ``.synchronize()`` (CUDA events' ``elapsed_time`` is read only
after such a fence, since an unfinished event has no time) — before it
reads the second timestamp.

The rule is holistic per outermost function (nested helpers fold into
their enclosing function, because a fence at the end of the outer loop
legitimately covers per-chunk timestamps taken inside closures — see
``core.streaming.stream_mttkrp``): a function that

* reads ``time.perf_counter()`` at least twice, and
* issues at least one device dispatch: an ``mttkrp``-family call (which
  takes in every ``fused_*`` and ``cuda_*`` kernel wrapper, and K4/K5's
  ``mttkrp_segments``/``mttkrp_stash``), K3's ``delinearize``, or a
  host-to-device copy (``.to(<device>)``, ``.cuda()``, a
  ``copy_(..., non_blocking=...)`` out of pinned memory, ``upload``), and
* never calls ``synchronize``

is reporting async dispatch time as device time.
"""
from __future__ import annotations

import ast

from ..linter import Finding, LintPass, ParsedModule
from .common import call_name, dotted

PASS_ID = "unfenced-timing"

FENCES = frozenset({"synchronize"})
COPIES = frozenset({"cuda", "upload"})
KERNELS = frozenset({"delinearize"})


def _names_a_device(node: ast.AST) -> bool:
    """``dev``, ``self.device``, ``"cuda"``, ``torch.device(...)``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("cuda")
    if isinstance(node, ast.Call):
        return call_name(node) == "device"
    return "dev" in dotted(node).lower()


def _is_dispatch(call: ast.Call) -> bool:
    name = call_name(call)
    if "mttkrp" in name.lower() or name in KERNELS:
        return True
    if not isinstance(call.func, ast.Attribute):
        return False
    if name in COPIES:
        return True
    if name == "to":
        return any(kw.arg == "device" for kw in call.keywords) or any(
            _names_a_device(a) for a in call.args[:1])
    if name == "copy_":
        return any(kw.arg == "non_blocking" for kw in call.keywords)
    return False


class UnfencedTimingPass(LintPass):
    pass_id = PASS_ID
    description = ("perf_counter pair around a device dispatch with no "
                   "synchronize fence")
    scope = ()

    def run(self, module: ParsedModule) -> list[Finding]:
        findings: list[Finding] = []
        for qualname, fn in module.outer_functions():
            timers = 0
            dispatches = []
            fenced = False
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node)
                if name == "perf_counter":
                    timers += 1
                elif name in FENCES:
                    fenced = True
                elif _is_dispatch(node):
                    dispatches.append(node)
            if timers >= 2 and dispatches and not fenced:
                node = dispatches[0]
                if module.is_disabled(self.pass_id, node, fn):
                    continue
                findings.append(module.finding(
                    self.pass_id, node,
                    f"{qualname} times a device dispatch with "
                    f"perf_counter but never fences with synchronize() — "
                    f"the asynchronous issue would be reported as device "
                    f"time (the streamed put-time bug class)",
                    scope=fn))
        return findings
