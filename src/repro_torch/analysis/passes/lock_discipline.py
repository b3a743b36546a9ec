"""lock-discipline pass: state guarded somewhere must be guarded everywhere.

The reference's pass, copied; it guards the port's threaded service as
it guards the reference's.  Bug class: the threaded service
(``ServiceRuntime`` worker + caller threads) synchronizes on ``self._lock``; an attribute written under
the lock in one method but read or written without it elsewhere is a data
race waiting for a scheduler interleaving.  Two structural rules:

* **classes** — for every class that creates a ``threading.Lock``/
  ``RLock`` on ``self`` (conditions built over it count as aliases), any
  attribute *written* inside a ``with self._lock:`` block anywhere becomes
  lock-guarded state; accesses to it outside a guarded block (in any
  method except ``__init__``, which runs before the object is shared) are
  flagged;
* **module singletons** — for a module-level ``STATE = SomeClass()``
  whose class carries a ``.lock``, *writes* to ``STATE.attr`` outside
  ``with STATE.lock:`` are flagged.  Reads stay free: the tracer's hot
  path reads ``TRACING.enabled`` lock-free by design, and a stale read
  of a monotonic flag is benign where a torn write sequence is not.

Known limitation (documented, deliberate): an attribute *never* written
under the lock is invisible to rule one — the pass learns what is shared
state from the code's own locking, it does not infer sharing.
"""
from __future__ import annotations

import ast

from ..linter import Finding, LintPass, ParsedModule
from .common import dotted, self_attr

PASS_ID = "lock-discipline"

_LOCK_CTORS = frozenset({"Lock", "RLock"})
_ALIAS_CTORS = frozenset({"Condition"})


def _ctor_name(node: ast.AST) -> str | None:
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute):
            return f.attr
        if isinstance(f, ast.Name):
            return f.id
    return None


def _methods(cls: ast.ClassDef):
    for child in cls.body:
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield child


def _guarded_nodes(scope: ast.AST, is_lock_expr) -> set[ast.AST]:
    """All AST nodes lexically inside a ``with <lock>:`` block."""
    guarded: set[ast.AST] = set()
    for node in ast.walk(scope):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        if not any(is_lock_expr(item.context_expr) for item in node.items):
            continue
        for sub in ast.walk(node):
            guarded.add(sub)
    return guarded


#: method calls that mutate their receiver in place (container mutation is
#: a write for locking purposes: ``self._feeds.append(...)``)
_MUTATORS = frozenset({"append", "remove", "clear", "pop", "extend", "add",
                       "update", "discard", "insert", "popleft",
                       "appendleft"})


def _attr_writes(scope: ast.AST):
    """Yield (attr-name-node, node) for attribute writes: assignment
    targets plus in-place container mutations."""
    for node in ast.walk(scope):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATORS and \
                isinstance(node.func.value, ast.Attribute):
            targets = [node.func.value]
        for tgt in targets:
            for leaf in ast.walk(tgt):
                if isinstance(leaf, ast.Attribute):
                    yield leaf, node


class LockDisciplinePass(LintPass):
    pass_id = PASS_ID
    description = ("attribute guarded by self._lock in one method but "
                   "accessed without it elsewhere")
    scope = ()

    # ----------------------------------------------------------- rule one
    def _check_class(self, module: ParsedModule,
                     cls: ast.ClassDef) -> list[Finding]:
        locks: set[str] = set()
        for meth in _methods(cls):
            for leaf, node in _attr_writes(meth):
                name = self_attr(leaf)
                if name is None or not isinstance(node, ast.Assign):
                    continue
                ctor = _ctor_name(node.value)
                if ctor in _LOCK_CTORS:
                    locks.add(name)
        if not locks:
            return []
        # conditions constructed over a lock acquire it on entry: aliases
        for meth in _methods(cls):
            for leaf, node in _attr_writes(meth):
                name = self_attr(leaf)
                if name is None or not isinstance(node, ast.Assign):
                    continue
                if _ctor_name(node.value) in _ALIAS_CTORS and any(
                        self_attr(a) in locks
                        for a in ast.walk(node.value)
                        if isinstance(a, ast.Attribute)):
                    locks.add(name)

        def is_lock_expr(expr):
            return self_attr(expr) in locks

        # pass 1: which attributes does the class itself guard?
        guarded_attrs: set[str] = set()
        for meth in _methods(cls):
            guarded = _guarded_nodes(meth, is_lock_expr)
            for leaf, node in _attr_writes(meth):
                name = self_attr(leaf)
                if name in locks or name is None:
                    continue
                if leaf in guarded:
                    guarded_attrs.add(name)
        if not guarded_attrs:
            return []

        # pass 2: flag unguarded accesses to those attributes
        findings: list[Finding] = []
        for meth in _methods(cls):
            if meth.name == "__init__":
                continue            # runs before the object is shared
            guarded = _guarded_nodes(meth, is_lock_expr)
            for node in ast.walk(meth):
                if not isinstance(node, ast.Attribute):
                    continue
                name = self_attr(node)
                if name not in guarded_attrs or node in guarded:
                    continue
                if module.is_disabled(self.pass_id, node, meth):
                    continue
                findings.append(module.finding(
                    self.pass_id, node,
                    f"self.{name} is written under self lock(s) "
                    f"{sorted(locks)} elsewhere in {cls.name} but accessed "
                    f"here without holding one",
                    scope=meth))
                break               # one finding per method is plenty
        return findings

    # ----------------------------------------------------------- rule two
    def _check_singletons(self, module: ParsedModule) -> list[Finding]:
        # classes whose __init__ hangs a ".lock"/"._lock" off self
        lock_classes: set[str] = set()
        for node in module.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            for meth in _methods(node):
                for leaf, stmt in _attr_writes(meth):
                    if self_attr(leaf) in ("lock", "_lock") and \
                            isinstance(stmt, ast.Assign) and \
                            _ctor_name(stmt.value) in _LOCK_CTORS:
                        lock_classes.add(node.name)
        if not lock_classes:
            return []
        singletons: dict[str, str] = {}
        for node in module.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    _ctor_name(node.value) in lock_classes:
                singletons[node.targets[0].id] = _ctor_name(node.value)
        if not singletons:
            return []

        def is_lock_expr(expr):
            return (isinstance(expr, ast.Attribute)
                    and expr.attr in ("lock", "_lock")
                    and isinstance(expr.value, ast.Name)
                    and expr.value.id in singletons)

        guarded = _guarded_nodes(module.tree, is_lock_expr)
        findings: list[Finding] = []
        for leaf, node in _attr_writes(module.tree):
            if not (isinstance(leaf.value, ast.Name)
                    and leaf.value.id in singletons):
                continue
            if leaf in guarded or node in guarded:
                continue
            if module.is_disabled(self.pass_id, node):
                continue
            findings.append(module.finding(
                self.pass_id, node,
                f"write to {dotted(leaf)} outside 'with "
                f"{leaf.value.id}.lock:' — singleton state must only be "
                f"mutated under its lock (reads may stay lock-free)"))
        return findings

    def run(self, module: ParsedModule) -> list[Finding]:
        findings: list[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(module, node))
        findings.extend(self._check_singletons(module))
        return findings
