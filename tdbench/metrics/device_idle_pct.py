"""device_idle_pct: the share of the profiled slice (from the first
sweep's start to the last one's end) in which no kernel, copy or set ran
on the card; moves ``sweep_ms``."""


def read(run):
    prof = run["profile"]
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
