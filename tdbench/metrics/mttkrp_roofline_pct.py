"""mttkrp_roofline_pct: the least time of a sweep's MTTKRPs (``work.py``,
from dims, nnz, order and rank) over the device time of every kernel and
copy launched inside the benchmark's ``mttkrp`` spans, per sweep of the
profiled slice; moves ``sweep_ms``."""


def read(run):
    prof = run["profile"]
    if not prof or prof["mttkrp_device_s"] <= 0:
        return None
    work = run["work"]
    least = work.least_s(work.mttkrp_work(run["dims"], run["nnz"],
                                          run["rank"]))
    return 100.0 * least / (prof["mttkrp_device_s"] / prof["sweeps"])
