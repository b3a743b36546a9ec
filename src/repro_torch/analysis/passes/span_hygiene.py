"""span-hygiene pass: tracer spans are context managers, not values.

The reference's pass, copied.  Bug class (the observability tier): ``obs.trace.span(...)`` returns a context
manager; a span held as a bare value is never entered, never records, and
silently drops its interval (worse: with tracing disabled it is the
shared no-op singleton, so code that "works" in tests records nothing in
production).  Every ``span(...)`` call must be the context expression of
a ``with`` statement::

    with obs_trace.span("plan.mttkrp", "plan", mode=mode) as sp:
        ...

The tracer module itself is exempt (it constructs spans by definition),
as is ``add_event`` (the already-measured-interval API).
"""
from __future__ import annotations

import ast

from ..linter import Finding, LintPass, ParsedModule
from .common import call_name, root_name

PASS_ID = "span-hygiene"


class SpanHygienePass(LintPass):
    pass_id = PASS_ID
    description = "tracer span opened outside a 'with' block"
    scope = ()

    def applies(self, module: ParsedModule) -> bool:
        return not module.path.endswith("obs/trace.py")

    def run(self, module: ParsedModule) -> list[Finding]:
        with_exprs: set[ast.AST] = set()
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    with_exprs.add(item.context_expr)
        findings: list[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call) or node in with_exprs:
                continue
            if call_name(node) != "span":
                continue
            # only the tracer's span factory: bare span(...) or a call on
            # a module spelled like the tracer (trace / obs_trace / obs)
            if isinstance(node.func, ast.Attribute):
                root = (root_name(node.func) or "").lower()
                if not ("trace" in root or root == "obs"):
                    continue
            if module.is_disabled(self.pass_id, node):
                continue
            findings.append(module.finding(
                self.pass_id, node,
                "span(...) must be entered via 'with' — an unentered span "
                "never records its interval"))
        return findings
