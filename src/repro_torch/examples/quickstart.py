"""Quickstart: decompose a sparse tensor with BLCO-based CP-ALS.

The port's counterpart of ``examples/quickstart.py``, at its sizes and
seeds.  ``plan_for`` picks the execution regime (device-resident vs
streamed) for the device budget, and the plan goes straight into
``cp_als``; on the card every MTTKRP is one fused kernel launch (K1 on
the long mode, K2 on the short ones).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch import core
from repro_torch.engine import plan_for
from repro_torch.examples import device_parser, kernel_for


def main(argv=None) -> int:
    args = device_parser(__doc__).parse_args(argv)
    device, kernel = args.device, kernel_for(args.device)

    # a 4-order sparse tensor with skewed fiber density (paper's hard regime)
    t = core.random_tensor((500, 120, 80, 40), 200_000, seed=0,
                           dist="powerlaw")
    print(f"tensor dims={t.dims} nnz={t.nnz:,} density={t.density:.2e}")

    # build the BLCO format: one copy, mode-agnostic
    b = core.build_blco(t)
    print(f"BLCO: {len(b.blocks)} block(s), {len(b.launches)} launch(es), "
          f"{b.spec.total_bits} index bits, "
          f"{core.format_bytes(b)/1e6:.1f} MB device-resident")
    print(f"construction: "
          f"{ {k: f'{v*1e3:.1f}ms' for k, v in b.construction_stats.items()} }")

    # plan execution under a 1 GiB device budget -> in-memory regime here;
    # kernel="cuda" runs the fused kernel, one launch per call
    plan = plan_for(b, 1 << 30, rank=16, kernel=kernel, device=device)
    print(f"engine chose backend={plan.backend!r} kernel={plan.kernel!r} "
          f"({plan.device_bytes()/1e6:.1f} MB resident)")
    c0 = core.dispatch_count()
    plan.mttkrp(core.init_factors(t.dims, 16, seed=1, device=device), 0)
    print(f"one MTTKRP call = {core.dispatch_count() - c0} device dispatch "
          f"across {len(b.launches)} launch(es)")

    # rank-16 CP decomposition via CP-ALS (Algorithm 1 of the paper)
    res = core.cp_als(plan, t.dims, rank=16,
                      norm_x=float(np.linalg.norm(t.values)), iters=15,
                      seed=1, device=device)
    for i, fit in enumerate(res.fits, 1):
        print(f"iter {i:2d}  fit {fit:.4f}")
    print(f"converged={res.converged} after {res.iterations} iterations")
    print("lambda:", np.round(res.lam[:8], 3), "...")
    print(f"engine stats: {plan.stats().snapshot()}")
    plan.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
