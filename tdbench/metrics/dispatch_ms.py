"""dispatch_ms: the plan's host issue time per sweep, the growth of
``EngineStats.dispatch_time_s`` over the window's sweeps (``engine/plans.py``
times each MTTKRP call's asynchronous issue, before its fence); moves
``sweep_ms``."""


def read(run):
    if run["dispatch_s"] is None or not run["sweeps"]:
        return None
    return run["dispatch_s"] / run["sweeps"] * 1e3
