"""Batched serving example: prefill + streaming greedy decode.

The port's counterpart of ``examples/serve_lm.py``, at its sizes: the
``reduced()`` config of ``--arch`` (any of the ten configs), batch 4, a
12-token prompt and 24 new tokens, weights drawn from a generator seeded
0 on the device.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch minicpm-2b] [--device cpu]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.examples import device_parser
from repro_torch.models import build_model, param_count
from repro_torch.serving import ServeConfig, Server


def main(argv=None) -> int:
    ap = device_parser(__doc__)
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=24)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    print(f"{cfg.name} ({cfg.family}) reduced: "
          f"{param_count(model)/1e6:.1f}M params")

    srv = Server(cfg, ServeConfig(max_len=args.prompt_len + args.new_tokens),
                 model, device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)

    t0 = time.perf_counter()
    out = srv.generate(prompts, args.new_tokens)
    dt = time.perf_counter() - t0
    total_steps = args.prompt_len + args.new_tokens
    print(f"generated {args.batch}x{args.new_tokens} tokens "
          f"in {dt:.2f}s ({args.batch * total_steps / dt:.0f} steps/s batched)")
    for i, row in enumerate(out):
        print(f"  request {i}: {row.tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
