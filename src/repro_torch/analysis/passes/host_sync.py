"""host-sync pass: no host round-trips inside per-launch device bodies.

The torch twin of the reference's pass.  Bug class: a per-launch or
per-chunk body that reads a device value on the host (``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()``, ``bool(tensor)``, host numpy on
a tensor) or waits on an event stalls the stream of launches the launch
cache and the ring exist to keep asynchronous: the host stops issuing
until the card has drained.  The reference finds its hot functions
structurally (``jit``, ``lax.scan``, ``pallas_call``); the port issues
its launches from plain Python loops (``stacked_mttkrp`` over launches,
``stream_mttkrp`` over chunks, the LM's ``decode_step`` over layers),
each launch asynchronous, so its hot functions are named: the bodies in
``HOT`` below, and every function in ``kernels/`` but the build.  A
Python loop over launches is the port's design, not a finding.

Flagged inside a hot function (nested defs folded in):

* ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``;
* ``bool(x)`` of anything but a constant (a tensor's truth value is a
  device read);
* a host numpy call (``np.*``) on a parameter or on a name bound to a
  ``torch`` call — numpy on a device tensor copies it to the host;
* ``<event or stream>.synchronize()``: a host wait.  A body that must
  wait (the ring's host set may be refilled only after its copy) says so
  with ``# repro-lint: disable=host-sync-in-hot-path`` and a reason.

``torch.cuda.synchronize()`` is not flagged: it is the plan's fence
around a whole call, which ``unfenced-timing`` demands.
"""
from __future__ import annotations

import ast
import fnmatch

from ..linter import Finding, LintPass, ParsedModule
from .common import call_name, dotted, root_name

PASS_ID = "host-sync-in-hot-path"

HOST_MODULES = frozenset({"np", "numpy"})
SYNC_METHODS = frozenset({"tolist", "item", "cpu", "numpy"})

#: path fragment -> qualname patterns of the per-launch / per-chunk bodies
HOT = {
    "core/launches.py": ("stacked_mttkrp", "LaunchCache.mttkrp"),
    "core/mttkrp.py": ("launch_mttkrp_impl", "partial_and_target",
                       "_segment_compress", "delinearize"),
    "core/streaming.py": ("stream_mttkrp", "StreamBuffers.host_set",
                          "StreamBuffers.upload", "StreamBuffers.device_set",
                          "StreamBuffers.release"),
    "engine/plans.py": ("*.mttkrp",),
    "kernels/": ("*",),
    "models/transformer.py": ("*decode_step",),
    "models/attention.py": ("gqa_decode", "_full_attn"),
}
#: files under a hot fragment that run no launch
COLD = ("kernels/build.py",)


def _hot_patterns(path: str) -> tuple:
    if any(path.endswith(c) for c in COLD):
        return ()
    return tuple(p for frag, pats in HOT.items() if frag in path
                 for p in pats)


def _tensor_names(fn) -> set[str]:
    """Parameters, and names bound to the result of a ``torch.*`` call."""
    names = {a.arg for a in fn.args.args + fn.args.kwonlyargs
             + fn.args.posonlyargs}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and root_name(node.value.func) == "torch":
            for tgt in node.targets:
                for leaf in ast.walk(tgt):
                    if isinstance(leaf, ast.Name):
                        names.add(leaf.id)
    return names


class HostSyncPass(LintPass):
    pass_id = PASS_ID
    description = ("host read of a device value or host wait inside a "
                   "per-launch / per-chunk body")
    scope = tuple(HOT)

    def run(self, module: ParsedModule) -> list[Finding]:
        findings: list[Finding] = []
        seen: set[tuple] = set()    # a nested def is walked by its outer
        patterns = _hot_patterns(module.path)
        for qualname, fn in module.functions():
            if not any(fnmatch.fnmatchcase(qualname, p) for p in patterns):
                continue
            tensors = _tensor_names(fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node)
                msg = None
                if isinstance(node.func, ast.Attribute) and \
                        root_name(node.func) in HOST_MODULES:
                    if any(root_name(a) in tensors for a in node.args):
                        msg = (f"host numpy call {dotted(node.func)}() on a "
                               f"tensor in a per-launch body")
                elif isinstance(node.func, ast.Attribute) and \
                        name in SYNC_METHODS:
                    msg = (f".{name}() reads a device value on the host in a "
                           f"per-launch body")
                elif isinstance(node.func, ast.Name) and name == "bool" \
                        and node.args \
                        and not isinstance(node.args[0], ast.Constant):
                    msg = "bool(...) of a tensor reads it on the host"
                elif isinstance(node.func, ast.Attribute) and \
                        name == "synchronize" and \
                        dotted(node.func.value) != "torch.cuda":
                    msg = (f"{dotted(node.func)}() waits on the host in a "
                           f"per-launch body")
                if msg is None:
                    continue
                loc = (node.lineno, node.col_offset)
                if loc in seen:
                    continue
                seen.add(loc)
                if module.is_disabled(self.pass_id, node, fn):
                    continue
                findings.append(module.finding(self.pass_id, node, msg,
                                               scope=fn))
        return findings
