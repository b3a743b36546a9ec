"""End-to-end LM training driver with the paper's technique in the
embedding-gradient path (segment conflict resolution vs naive scatter).

The port's counterpart of ``examples/train_lm.py``, at its sizes: the
``reduced()`` config of ``--arch`` (any of the ten configs), batch 8,
sequence 128, 300 steps of the fault-tolerant trainer (checkpoint +
resume) over the deterministic synthetic data, the config's WSD/cosine
schedule; on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--arch minicpm-2b] [--steps 300] [--device cpu]
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import sys
import tempfile

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.examples import device_parser
from repro_torch.launch import steps as steps_mod
from repro_torch.models import param_count
from repro_torch.optim import adamw
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = device_parser(__doc__)
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--embed-grad", choices=("segment", "scatter"),
                    default="segment")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_train_lm"))
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config(args.arch).reduced(),
                              embed_grad=args.embed_grad)
    opt_cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup=20,
                                total_steps=args.steps, schedule=cfg.schedule)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, global_batch=8,
                                  seq_len=128, input_mode=cfg.input_mode,
                                  frontend_dim=cfg.frontend_dim or cfg.d_model,
                                  encdec=cfg.is_encdec))
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    trainer = Trainer(
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=100, log_every=20),
        cfg, opt_cfg, steps_mod.make_train_step(cfg, opt_cfg), data,
        device=args.device)

    params_m = param_count(trainer.state["params"]) / 1e6
    print(f"{cfg.name} ({cfg.family}): {params_m:.1f}M params, "
          f"embed_grad={cfg.embed_grad}, schedule={cfg.schedule}")
    out = trainer.run()
    for h in out["history"]:
        print(f"step {h['step']:>5}  loss {h['loss']:.4f}  lr {h['lr']:.2e}  "
              f"{h['step_time_s']*1e3:.0f} ms")
    print(f"done at step {out['final_step']}; "
          f"checkpoints in {args.ckpt_dir}; "
          f"stragglers flagged: {len(out['stragglers'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
