"""solve_ms: the sweep's time outside its MTTKRP calls (the Gram
matrices, the pseudo-inverses, the updates and the fit of
``core/cp_als.py``), per sweep: each window sweep's host time minus the
host time of its ``plan.mttkrp`` calls, averaged; moves ``sweep_ms``."""


def read(run):
    if not run["mttkrp_s"]:
        return None
    rest = [s - m for s, m in zip(run["sweep_s"], run["mttkrp_s"])]
    return sum(rest) / len(rest) * 1e3
