"""Cache-key audit: the keys the port's launches ask under must be bounded.

The reference's audit, copied, plus the port's own check.  In the JAX
package every distinct reservation is a distinct traced shape, i.e. a
distinct compiled executable; the port compiles no executable per shape,
but its reservations still decide how many distinct buffer shapes a
regime allocates (the in-memory launch cache, the streamed ring), so the
roundings are held to the same bound: the image of each regime's shipped
rounding over the launch-size range grows logarithmically, never
linearly, and the roundings are sound (cover the launch, stay
LANE-divisible, monotone so a bigger tensor never maps below a smaller
one).  Tenant count can never enter a reservation:
``audit_tenant_invariance`` checks an N-tenant workload's reservation
count stays within the same envelope regardless of N.

The port's counterpart of a compiled executable's cache key is the
per-process occupancy cache its kernels ask the card through:
``kernels/fused.py::_occupancy`` (K1/K2, keyed by
``fused.occupancy_key``: kernel, dtype pair, order, shared memory,
device) and ``kernels/blco_mttkrp.py::phases_occupancy`` (K4 keyed by
``blco_mttkrp.segments_query``: kernel, dtype pair, gathered row sets,
rank, stage rows, ring depth, device; K3 and K5 by a constant key per
device).  ``audit_occupancy_keys`` holds those keys independent of the
launch's nnz and of the tenant count.

The audits run against the functions the port ships
(``core.launches.default_reservation``, ``core.padding.next_pow2`` via
``reservation_for``, the kernels' key functions) — pass a different
table or key function to audit a candidate, e.g. the known-bad raw-LANE
rounding in the fixture tests.
"""
from __future__ import annotations

from repro_torch.analysis.linter import Finding

PASS_CHURN = "trace-cache-churn"

_PADDING = "src/repro_torch/core/padding.py"
_KERNELS = "src/repro_torch/kernels"

#: keys enumerated densely over [1, MAX_NNZ]; the churn bound below is
#: expressed in octaves of this range, so the verdict is range-independent
MAX_NNZ = 1 << 18

#: admissible distinct-reservation count: ``CLASSES_PER_OCTAVE`` per
#: power-of-two octave (size classes), plus slack for the floor bucket
CLASSES_PER_OCTAVE = 16


def shipped_roundings() -> dict:
    """regime name -> the reservation rounding that regime really uses."""
    from repro_torch.core.launches import default_reservation
    from repro_torch.core.padding import next_pow2

    return {
        # LaunchCache.from_blco default (in-memory regime)
        "in_memory": default_reservation,
        # reservation_for (streamed + disk_streamed regimes)
        "streamed": next_pow2,
        "disk_streamed": next_pow2,
    }


def enumerate_reservations(rounding, max_nnz: int = MAX_NNZ) -> set:
    """The reachable reservation set over launch sizes [1, max_nnz]."""
    return {rounding(n) for n in range(1, max_nnz + 1)}


def churn_bound(max_nnz: int = MAX_NNZ) -> int:
    """Admissible distinct-executable count for the launch-size range."""
    octaves = max(1, max_nnz.bit_length())
    return CLASSES_PER_OCTAVE * octaves


def audit_rounding(regime: str, rounding, *, max_nnz: int = MAX_NNZ,
                   path: str = _PADDING) -> list[Finding]:
    """Soundness + boundedness of one regime's reservation rounding."""
    findings = []

    def flag(msg):
        findings.append(Finding(pass_id=PASS_CHURN, path=path,
                                symbol=regime, line=0, message=msg))

    prev = 0
    image = set()
    for n in range(1, max_nnz + 1):
        r = rounding(n)
        image.add(r)
        if r < n:
            flag(f"reservation {r} smaller than launch nnz {n}: padded "
                 f"launches would overflow the buffer")
            return findings
        if r < prev:
            flag(f"rounding not monotone at nnz {n}: {r} < {prev} — a "
                 f"bigger launch must never get a smaller reservation")
            return findings
        prev = r
    bound = churn_bound(max_nnz)
    if len(image) > bound:
        flag(f"{len(image)} distinct reservations over launch sizes "
             f"[1, {max_nnz}] (bound: {bound}) — jit cache keys grow "
             f"linearly with launch shape; use size-class or pow2 "
             f"rounding so executable count is O(log max_launch)")
    return findings


def audit_reservation_churn(roundings: dict | None = None, *,
                            max_nnz: int = MAX_NNZ) -> list[Finding]:
    """Audit every regime's shipped rounding (or a candidate table)."""
    findings = []
    for regime, fn in (roundings or shipped_roundings()).items():
        findings.extend(audit_rounding(regime, fn, max_nnz=max_nnz))
    return findings


def audit_tenant_invariance(n_tenants: int = 1000, *,
                            roundings: dict | None = None) -> list[Finding]:
    """Executable count over an N-tenant workload stays O(log), not O(N).

    A deterministic spread of per-tenant max-launch sizes (every tenant a
    different tensor) must collapse onto the bounded reservation classes —
    the property that lets the pooled service executor reuse one compiled
    executable per shape across tenants.
    """
    findings = []
    sizes = [1 + (i * 2654435761) % MAX_NNZ for i in range(n_tenants)]
    for regime, fn in (roundings or shipped_roundings()).items():
        keys = {fn(s) for s in sizes}
        bound = churn_bound(MAX_NNZ)
        if len(keys) > bound:
            findings.append(Finding(
                pass_id=PASS_CHURN, path=_PADDING,
                symbol=regime, line=0,
                message=f"{len(keys)} distinct reservations across "
                        f"{n_tenants} tenants (bound: {bound}) — the jit "
                        f"cache grows with tenant count"))
    return findings


# ------------------------------------------------------- occupancy keys
#: launch sizes every tenant's keys are recomputed at: one slot, a LANE
#: less one, the tenants' own spread and the card's largest streams
_PROBE_NNZ = (1, 255, 4096, 1 << 20, 83_886_080, 1 << 27)

#: (values, factor) dtypes the kernels take, by name (numpy spelling)
_PAIRS = (("float32", "float32"), ("float64", "float64"),
          ("float64", "float32"))


def launch_keys(dims, nnz: int, rank: int, pair, device: int = 0) -> set:
    """Every occupancy key a tensor of ``dims`` with ``nnz`` non-zeros asks
    under at ``rank`` and ``pair``: per mode its K1/K2 variant's
    (``fused.occupancy_key``) and K4's over the in-memory stream
    (``blco_mttkrp.segments_query`` at ``ops.TILE``'s divisor)."""
    import math

    import torch

    from repro_torch.core.launches import default_reservation
    from repro_torch.core.mttkrp import choose_resolution
    from repro_torch.kernels import blco_mttkrp, fused
    vdt, fdt = (getattr(torch, d) for d in pair)
    out_itemsize = torch.promote_types(vdt, fdt).itemsize
    t = default_reservation(nnz)
    keys = set()
    for mode, d in enumerate(dims):
        variant = fused._variant_for(choose_resolution(d), d, rank=rank,
                                     itemsize=out_itemsize)
        keys.add(fused.occupancy_key(variant, vdt, fdt, len(dims), d, rank,
                                     device))
        try:
            keys.add(blco_mttkrp.segments_query(
                t, math.gcd(t, 256), rank, len(dims) - 1, vdt, fdt,
                aligned=True, device=device)[1])
        except ValueError:
            pass                    # K4 refuses the rank: no launch, no key
    return keys


def _tenant(i: int):
    """Tenant ``i``'s (class, dims, nnz, rank, pair): a deterministic
    spread of orders 3-5, ranks 8-64, the three dtype pairs, extents up to
    2^20 with one mode short enough for a stash, nnz up to 2^27.  The class
    is what a key may depend on: order, pair, rank and the extents of the
    modes short enough for K2's stash."""
    from repro_torch.kernels.fused import STASH_MAX_ROWS
    order = 3 + i % 3
    pair = _PAIRS[(i // 3) % 3]
    rank = (8, 16, 32, 64)[(i // 9) % 4]
    dims = [1 + (i * 2654435761 + m * 40503) % (1 << 20)
            for m in range(order)]
    dims[1] = 1 + (i * 7919) % (2 * STASH_MAX_ROWS)
    nnz = 1 + (i * 2654435761) % (1 << 27)
    short = tuple(d if d <= STASH_MAX_ROWS else None for d in dims)
    return (order, pair, rank, short), tuple(dims), nnz, rank, pair


def occupancy_bound(classes) -> int:
    """Admissible key count for a set of tenant classes: per class one key
    per mode for K1/K2 and one for K4 (the same for every mode)."""
    return sum(cls[0] + 1 for cls in classes)


def audit_occupancy_keys(n_tenants: int = 1000, *,
                         key_fn=launch_keys) -> list[Finding]:
    """The occupancy keys of an N-tenant workload do not depend on launch
    nnz, nor on the extent of a mode too long for a stash, nor on N.

    Each tenant's keys are recomputed at every ``_PROBE_NNZ`` launch size
    and must not change; tenants of one class (``_tenant``) must ask
    under the same keys; the workload's key count must stay within
    ``occupancy_bound`` of its classes, however many tenants share them.
    """
    findings = []

    def flag(symbol, msg):
        findings.append(Finding(pass_id=PASS_CHURN, path=_KERNELS,
                                symbol=symbol, line=0, message=msg))

    by_class: dict = {}
    every = set()
    for i in range(n_tenants):
        cls, dims, nnz, rank, pair = _tenant(i)
        keys = key_fn(dims, nnz, rank, pair)
        for probe in _PROBE_NNZ:
            if key_fn(dims, probe, rank, pair) != keys:
                flag("occupancy[nnz]",
                     f"tenant {i} (dims {dims}, R {rank}, {pair}) asks "
                     f"under other occupancy keys at {probe} nnz than at "
                     f"{nnz}: the launch size enters the key, so the "
                     f"per-process cache grows with launch shape")
                return findings
        seen = by_class.setdefault(cls, keys)
        if seen != keys:
            flag("occupancy[class]",
                 f"tenant {i} (dims {dims}) asks under other keys than "
                 f"tenants of its class {cls}: a long mode's extent enters "
                 f"the key")
            return findings
        every |= keys
    bound = occupancy_bound(by_class)
    if len(every) > bound:
        flag("occupancy[tenants]",
             f"{len(every)} distinct occupancy keys across {n_tenants} "
             f"tenants of {len(by_class)} classes (bound: {bound})")
    return findings
