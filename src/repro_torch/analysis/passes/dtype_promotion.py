"""dtype-promotion pass: no factor-dtype casts/allocations on mttkrp paths.

The torch twin of the reference's pass.  Bug class: MTTKRP paths that
cast the tensor values — or allocate the accumulator — with
``factors[0].dtype`` silently downcast float64 tensor values against
float32 factors.  The port's idiom is

    out_dtype = torch.promote_types(vals.dtype, factors[0].dtype)

so the accumulation runs at the promoted precision.  This pass flags, in
any function whose qualname mentions ``mttkrp`` or ``hadamard``:

* ``x.to(<factor>.dtype)`` and ``x.type(<factor>.dtype)`` (positional or
  ``dtype=``);
* tensor creation (``zeros``/``ones``/``empty``/``full``, their
  ``new_*`` and ``*_like`` forms) whose dtype argument is
  ``<factor>.dtype``;

where ``<factor>`` is a factor-matrix spelling (``factors``, ``gathered``,
...).  Expressions routed through ``torch.promote_types`` never match —
the dtype argument is then a Call, not a bare ``.dtype`` attribute.
"""
from __future__ import annotations

import ast

from ..linter import Finding, LintPass, ParsedModule
from .common import call_name, root_name

FACTOR_NAMES = frozenset({
    "factors", "factor", "f_refs", "fs", "gathered", "others", "mats",
})

CREATION_FUNCS = frozenset({
    "zeros", "ones", "empty", "full", "new_zeros", "new_ones", "new_empty",
    "new_full", "zeros_like", "ones_like", "empty_like", "full_like",
})

CASTS = frozenset({"to", "type"})

PASS_ID = "dtype-promotion"


def _factor_dtype_expr(node: ast.AST) -> str | None:
    """``factors[0].dtype``-shaped expression -> its factor root name."""
    if isinstance(node, ast.Attribute) and node.attr == "dtype":
        root = root_name(node.value)
        if root in FACTOR_NAMES:
            return root
    return None


def _call_args(call: ast.Call):
    yield from call.args
    for kw in call.keywords:
        if kw.arg is not None:      # skip **kwargs
            yield kw.value


class DtypePromotionPass(LintPass):
    pass_id = PASS_ID
    description = ("factor-dtype cast/allocation on an mttkrp path; "
                   "promote with torch.promote_types(vals.dtype, ...)")
    scope = ()                      # dtype discipline applies everywhere

    def run(self, module: ParsedModule) -> list[Finding]:
        findings: list[Finding] = []
        seen: set[tuple] = set()    # a nested def is walked by its outer
        for qualname, fn in module.functions():
            low = qualname.lower()
            if "mttkrp" not in low and "hadamard" not in low:
                continue
            for call in ast.walk(fn):
                if not isinstance(call, ast.Call):
                    continue
                name = call_name(call)
                hit = None
                if name in CASTS and isinstance(call.func, ast.Attribute):
                    for arg in _call_args(call):
                        root = _factor_dtype_expr(arg)
                        if root is not None:
                            hit = (f".{name}({root}[...].dtype) downcasts "
                                   f"the values operand")
                            break
                elif name in CREATION_FUNCS:
                    for arg in _call_args(call):
                        root = _factor_dtype_expr(arg)
                        if root is not None:
                            hit = (f"{name}(..., {root}[...].dtype) pins the "
                                   f"output to the factor dtype")
                            break
                if hit is None:
                    continue
                loc = (call.lineno, call.col_offset)
                if loc in seen:
                    continue        # already reported from the enclosing def
                seen.add(loc)
                if module.is_disabled(self.pass_id, call, fn):
                    continue
                findings.append(module.finding(
                    self.pass_id, call,
                    f"{hit}; use torch.promote_types(vals.dtype, "
                    f"factors[...].dtype) so f64 values are not silently "
                    f"downcast",
                    scope=fn))
        return findings
