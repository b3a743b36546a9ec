"""Out-of-memory decomposition: the paper's headline capability.

The port's counterpart of ``examples/oom_decomposition.py``, at its sizes
and seeds.  The tensor lives in HOST memory; only fixed-size launch
reservations ever occupy the device.  Under a budget smaller than the
tensor's device footprint ``plan_for`` returns a ``StreamedPlan``: a ring
of pinned host buffers and device reservations whose copies run on a copy
stream while K1/K2 run one launch per chunk (paper §4.2 / §6.4.2), and
CP-ALS runs unmodified on top of the plan.

    PYTHONPATH=src python -m repro_torch.examples.oom_decomposition \
        [--device cpu]
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch import core
from repro_torch.engine import factor_bytes, in_memory_bytes, plan_for
from repro_torch.examples import device_parser, kernel_for, require


def main(argv=None) -> int:
    args = device_parser(__doc__).parse_args(argv)
    device, kernel = args.device, kernel_for(args.device)

    # "amazon-like" scale-down: 3 long modes (paper Table 2 analogue)
    t = core.paper_like("amazon-like", seed=0)
    print(f"tensor dims={t.dims} nnz={t.nnz:,}")

    # deliberately tiny per-launch reservation -> many streamed launches,
    # emulating a tensor far larger than device memory
    b = core.build_blco(t, max_nnz_per_block=1 << 13)
    # budget covers the factor working set but only HALF the tensor -> stream
    budget = factor_bytes(b.dims, 16, np.float32) + in_memory_bytes(b) // 2
    plan = plan_for(b, budget, rank=16, queues=4, kernel=kernel,
                    device=device)
    require(plan.backend == "streamed", plan.backend)
    print(f"budget {budget/1e6:.1f} MB cannot hold the "
          f"{in_memory_bytes(b)/1e6:.1f} MB tensor + factors "
          f"-> backend={plan.backend!r}: {len(b.launches)} launches of "
          f"<= {plan.spec.nnz:,} nnz, {plan.device_bytes()/1e6:.1f} MB in "
          f"flight")

    res = core.cp_als(plan, t.dims, rank=16,
                      norm_x=float(np.linalg.norm(t.values)), iters=8,
                      seed=1, device=device)
    print("fits:", [f"{f:.4f}" for f in res.fits])

    # put: the copies alone (CUDA events on the copy stream on the card);
    # device: every call fenced by the plan
    s = plan.stats()
    print(f"engine stats: {s.launches} launches, "
          f"{s.h2d_bytes/1e6:.1f} MB H2D, "
          f"put {s.put_time_s:.2f}s / dispatch {s.dispatch_time_s:.2f}s / "
          f"device {s.device_time_s:.2f}s / total {s.total_time_s:.2f}s")
    print("in-memory-throughput vs overall-throughput gap = host-device "
          "interconnect cost (paper Fig. 10)")
    plan.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
