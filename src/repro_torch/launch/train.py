"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port's counterpart of ``repro.launch.train``, with its flags: wires
config -> model -> train step -> fault-tolerant Trainer, on the card
unless ``--device cpu``.  ``--mesh none`` runs on one device; the meshes
``test``, ``single`` and ``multi`` wait for the mesh substrate (ROADMAP
queue 1, 13.5) and raise ``NotImplementedError``.  SIGTERM and SIGINT ask
the trainer to stop after the current step, save and exit.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import sys
import tempfile

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.examples import device_parser
from repro_torch.launch import steps as steps_mod
from repro_torch.optim import adamw
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = device_parser(__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", choices=("none", "test", "single", "multi"),
                    default="none")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--embed-grad", choices=("segment", "scatter"),
                    default="segment")
    args = ap.parse_args(argv)

    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port's mesh substrate (sharded train "
            f"state, production meshes) is ROADMAP queue 1, item 13.5; "
            f"--mesh none runs on one device")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, embed_grad=args.embed_grad)

    opt_cfg = adamw.AdamWConfig(peak_lr=args.peak_lr, total_steps=args.steps,
                                schedule=cfg.schedule)
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=args.global_batch,
        seq_len=args.seq_len, input_mode=cfg.input_mode,
        frontend_dim=cfg.frontend_dim or cfg.d_model,
        encdec=cfg.is_encdec))

    trainer = Trainer(
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every),
        cfg, opt_cfg, steps_mod.make_train_step(cfg, opt_cfg), data,
        device=args.device)
    handlers = {sig: signal.signal(sig, trainer.request_stop)
                for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        out = trainer.run()
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    for h in out["history"]:
        print(f"step {h['step']:>6}  loss {h['loss']:.4f}  "
              f"lr {h['lr']:.2e}  {h['step_time_s']*1e3:.0f} ms")
    print(f"final step {out['final_step']}  "
          f"stragglers {len(out['stragglers'])}  "
          f"nan-skipped {len(out['nan_skipped'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
