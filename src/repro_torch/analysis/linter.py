"""AST lint framework: repo-specific passes over parsed source modules.

The port's copy of ``repro.analysis.linter``, statement for statement.
Each :class:`LintPass` encodes ONE invariant a shipped change fixed by
hand (see ``repro_torch.analysis.passes``) and reports
:class:`Finding`\\ s.  Findings
are keyed by ``(pass_id, path, enclosing-symbol)`` — not line numbers — so
a committed suppression baseline survives unrelated edits that shift
lines.  Two suppression mechanisms:

* a **baseline** file (JSON): reviewed, justified findings that predate
  the pass or are intentional; every entry must carry a ``reason``;
* an **inline comment** ``# repro-lint: disable=<pass-id>`` on the
  offending line or on the enclosing ``def``/``class`` line.

``lint_paths`` lints files and directories (``tests/test_torch_lint.py``
and ``chip_smoke.py`` run it over ``src/repro_torch/`` and the smoke
against ``analysis/lint_baseline.json``); ``lint_sources`` takes
in-memory sources for fixture tests.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re

_DISABLE_RE = re.compile(r"#\s*repro-lint:\s*disable=([\w,\-]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint violation, stable-keyed for baseline suppression."""
    pass_id: str
    path: str            # repo-relative, forward slashes
    symbol: str          # enclosing qualname ("<module>" at top level)
    line: int
    message: str

    @property
    def key(self) -> str:
        return f"{self.pass_id}:{self.path}:{self.symbol}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.pass_id}] {self.symbol}: "
                f"{self.message}")


class ParsedModule:
    """A parsed source file plus the symbol/suppression maps passes need."""

    def __init__(self, path: str, source: str):
        self.path = path.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # enclosing qualname per AST node, computed once for every pass
        self._qualname: dict[ast.AST, str] = {}
        self._assign_qualnames(self.tree, [])
        # lines carrying "# repro-lint: disable=<pass>" -> set of pass ids
        self.disabled: dict[int, set[str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _DISABLE_RE.search(text)
            if m:
                self.disabled[i] = set(m.group(1).split(","))

    def _assign_qualnames(self, node: ast.AST, stack: list[str]) -> None:
        name = ".".join(stack) if stack else "<module>"
        self._qualname[node] = name
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                self._assign_qualnames(child, stack + [child.name])
            else:
                self._assign_qualnames(child, stack)

    def qualname(self, node: ast.AST) -> str:
        """Qualname of the scope ``node`` belongs to; def/class nodes map
        to their OWN qualified name, so a finding on a ``def`` line blames
        that function."""
        return self._qualname.get(node, "<module>")

    def functions(self):
        """Every (qualname, def-node) pair, outermost first."""
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield self.qualname(node), node

    def outer_functions(self):
        """Top-level functions and methods, with nested defs folded in.

        Yields only defs whose enclosing scopes are modules or classes —
        a closure nested inside a function is analysed as part of its
        outermost enclosing function (timing/fencing invariants hold for
        the outer call, not each helper in isolation).
        """
        def _walk(node, in_function):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if not in_function:
                        yield self.qualname(child), child
                    yield from _walk(child, True)
                elif isinstance(child, ast.ClassDef):
                    yield from _walk(child, in_function)
                else:
                    yield from _walk(child, in_function)
        yield from _walk(self.tree, False)

    def is_disabled(self, pass_id: str, node: ast.AST,
                    scope: ast.AST | None = None) -> bool:
        """True when the finding line (or its enclosing def line) carries
        an inline ``# repro-lint: disable=`` comment for ``pass_id``."""
        for n in (node, scope):
            if n is None or not hasattr(n, "lineno"):
                continue
            ids = self.disabled.get(n.lineno)
            if ids and (pass_id in ids or "all" in ids):
                return True
        return False

    def finding(self, pass_id: str, node: ast.AST, message: str,
                scope: ast.AST | None = None) -> Finding:
        symbol = self.qualname(scope if scope is not None else node)
        return Finding(pass_id=pass_id, path=self.path, symbol=symbol,
                       line=getattr(node, "lineno", 0), message=message)


class LintPass:
    """Base class: one invariant, one ``run`` over a parsed module."""

    pass_id = "base"
    description = ""
    #: path fragments the pass is scoped to; empty = every file
    scope: tuple = ()

    def applies(self, module: ParsedModule) -> bool:
        if not self.scope:
            return True
        return any(frag in module.path for frag in self.scope)

    def run(self, module: ParsedModule) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError

    def check(self, module: ParsedModule) -> list[Finding]:
        if not self.applies(module):
            return []
        return self.run(module)


class Baseline:
    """Committed suppression list: reviewed findings with justifications.

    Entries match findings by stable key (pass + path + symbol), so line
    drift never invalidates them.  ``reason`` is mandatory — an entry
    without one fails loading, which is what keeps the baseline honest
    ("only justified entries" is enforced, not hoped for).
    """

    def __init__(self, entries: list[dict] | None = None):
        self.entries = list(entries or [])
        for e in self.entries:
            for field in ("pass", "path", "symbol", "reason"):
                if not e.get(field):
                    raise ValueError(
                        f"baseline entry {e!r} is missing {field!r}; every "
                        f"suppression must name its finding and justify it")
        self._keys = {f"{e['pass']}:{e['path']}:{e['symbol']}"
                      for e in self.entries}

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls([])
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        return cls(data.get("suppressions", []))

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({"suppressions": self.entries}, fh, indent=2,
                      sort_keys=True)
            fh.write("\n")

    def suppresses(self, finding: Finding) -> bool:
        return finding.key in self._keys

    def stale_entries(self, findings: list[Finding]) -> list[dict]:
        """Entries matching nothing any more — fixed code should shed its
        suppressions rather than accumulate dead ones."""
        live = {f.key for f in findings}
        return [e for e in self.entries
                if f"{e['pass']}:{e['path']}:{e['symbol']}" not in live]

    @classmethod
    def from_findings(cls, findings: list[Finding],
                      reason: str = "baselined pre-existing finding"
                      ) -> "Baseline":
        seen, entries = set(), []
        for f in sorted(findings, key=lambda f: f.key):
            if f.key in seen:
                continue
            seen.add(f.key)
            entries.append({"pass": f.pass_id, "path": f.path,
                            "symbol": f.symbol, "reason": reason})
        return cls(entries)


def all_passes() -> list[LintPass]:
    """The registered repo passes (import deferred to avoid cycles)."""
    from .passes import REGISTRY
    return [cls() for cls in REGISTRY]


def _iter_py_files(paths):
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)


def lint_sources(sources: dict[str, str],
                 passes: list[LintPass] | None = None) -> list[Finding]:
    """Lint in-memory ``{path: source}`` pairs (the fixture-test path)."""
    passes = passes if passes is not None else all_passes()
    findings: list[Finding] = []
    for path, source in sources.items():
        module = ParsedModule(path, source)
        for p in passes:
            findings.extend(p.check(module))
    findings.sort(key=lambda f: (f.path, f.line, f.pass_id))
    return findings


def lint_paths(paths, *, root: str | None = None,
               passes: list[LintPass] | None = None) -> list[Finding]:
    """Lint files/directories; paths in findings are relative to ``root``."""
    sources = {}
    for fpath in _iter_py_files(paths):
        rel = os.path.relpath(fpath, root) if root else fpath
        with open(fpath, encoding="utf-8") as fh:
            sources[rel] = fh.read()
    return lint_sources(sources, passes=passes)
