"""fault-site-hygiene pass: fault probes must name declared sites.

The reference's pass, pointed at the port's sites.  Bug class (fault
injection): ``faults.fire("...")`` / ``faults.maybe_fail("...")`` look up
the site string in ``repro_torch.faults.inject.SITES`` at *fire* time — but only when a plan is
installed.  A typo'd site at a probe point is therefore invisible in
normal operation (the disabled fast path never validates) and turns a
chaos-test scenario into a silent no-op: the fault "injected" at
``store.raed`` never fires and the test vacuously passes.  This pass
checks every string-literal site argument against the declared ``SITES``
table statically, so a misspelled probe fails CI instead of weakening
the chaos suite.

Non-literal site arguments (a variable, an f-string) are skipped — they
are the injection framework's own plumbing, which validates at runtime.
"""
from __future__ import annotations

import ast

from ..linter import Finding, LintPass, ParsedModule
from .common import call_name, root_name

PASS_ID = "fault-site-hygiene"

_PROBES = ("fire", "maybe_fail", "exception_for")


def _declared_sites() -> frozenset:
    from repro_torch.faults.inject import SITES
    return frozenset(SITES)


class FaultSiteHygienePass(LintPass):
    pass_id = PASS_ID
    description = "fault probe names an undeclared injection site"
    scope = ()

    def applies(self, module: ParsedModule) -> bool:
        return not module.path.endswith("faults/inject.py")

    def run(self, module: ParsedModule) -> list[Finding]:
        sites = _declared_sites()
        findings: list[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            if call_name(node) not in _PROBES:
                continue
            # only the injection module's probes: faults.fire(...),
            # inject.maybe_fail(...), or a bare import of those names
            if isinstance(node.func, ast.Attribute):
                root = (root_name(node.func) or "").lower()
                if not ("fault" in root or "inject" in root):
                    continue
            if not node.args:
                continue
            site = node.args[0]
            if not (isinstance(site, ast.Constant)
                    and isinstance(site.value, str)):
                continue            # runtime-validated plumbing
            if site.value in sites:
                continue
            if module.is_disabled(self.pass_id, node):
                continue
            findings.append(module.finding(
                self.pass_id, node,
                f"fault site {site.value!r} is not declared in "
                f"repro_torch.faults.inject.SITES — the probe can never "
                f"fire"))
        return findings
