"""sweep_roofline_pct: the least time of a sweep's whole work (its
MTTKRPs, and each mode's (I_n, R) matrices read and written once in the
solve, ``work.py``) over the window's mean sweep time by the host clock:
the system's share of the card's peak, a bound on every kernel's gain;
moves ``sweep_ms``."""


def read(run):
    if not run["sweep_s"]:
        return None
    work = run["work"]
    least = work.least_s(work.sweep_work(run["dims"], run["nnz"], run["rank"]))
    return 100.0 * least / (sum(run["sweep_s"]) / len(run["sweep_s"]))
