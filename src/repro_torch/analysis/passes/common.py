"""Small AST helpers shared by the lint passes (the reference's copy)."""
from __future__ import annotations

import ast


def root_name(node: ast.AST) -> str | None:
    """The base ``Name`` id of an attribute/subscript chain.

    ``factors[0].dtype`` -> ``factors``; ``self._lock`` -> ``self``.
    """
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def call_name(call: ast.Call) -> str:
    """The trailing name of the called expression (``a.b.c()`` -> ``c``)."""
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def dotted(node: ast.AST) -> str:
    """Dotted rendering of a Name/Attribute chain (best-effort)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def self_attr(node: ast.AST) -> str | None:
    """``self.X`` -> ``"X"`` (one level only), else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def walk_calls(node: ast.AST):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            yield sub
