"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port's counterpart of ``repro.launch.train``, with its flags: wires
config -> model -> sharded train step -> fault-tolerant Trainer, on the
card unless ``--device cpu``.  ``--mesh none`` runs on one device.  The
meshes run under a process group of as many ranks as they hold, which
the caller starts, e.g. eight ranks for ``test``'s (4, 2):

    python -m torch.distributed.run --nproc-per-node 8 \
        -m repro_torch.launch.train --arch dbrx-132b --reduced --mesh test

``single`` (16 x 16) and ``multi`` (2 x 16 x 16) need 256 and 512 ranks,
and any mesh raises a ``ValueError`` naming the count it needs when the
world differs.  The backend is gloo on the host, and on the card when
ranks share a card; NCCL where each rank has a card of its own.  Every
rank draws the same state from one seeded generator, takes its ZeRO
block (``launch.steps.train_state_shardings``) and steps on its rows of
the batch; rank 0 prints and writes the checkpoints.  SIGTERM and SIGINT
ask the trainer to stop after the current step, save and exit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import signal
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.dist import context as dist_context
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.dist import make_mesh
from repro_torch.examples import device_parser
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import PRODUCTION
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

    if args.mesh == "none":
        return _run(args, cfg, opt_cfg, data, resolve_device(args.device))
    shape, axes = MESHES[args.mesh]
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != math.prod(shape):
        raise ValueError(f"--mesh {args.mesh} {shape} needs a world of "
                         f"{math.prod(shape)} ranks; this run has {world} "
                         f"(start it with python -m torch.distributed.run "
                         f"--nproc-per-node {math.prod(shape)})")
    device, backend = _rank_device(args.device)
    dist.init_process_group(backend, init_method="env://")
    try:
        mesh = make_mesh(shape, axes, device=device)
        dist_context.set_mesh(mesh)
        try:
            return _run(args, cfg, opt_cfg, data, device, mesh)
        finally:
            dist_context.set_mesh(None)
    finally:
        dist.destroy_process_group()


#: --mesh -> (shape, axis names): the reference's make_test_mesh() and
#: production meshes
MESHES = {"test": ((4, 2), ("data", "model")),
          "single": PRODUCTION[False], "multi": PRODUCTION[True]}


def _rank_device(device) -> tuple:
    """(this rank's device, the backend): on the card, rank ``LOCAL_RANK``
    takes card ``LOCAL_RANK`` when every local rank has one of its own
    (NCCL), else all share card 0 (gloo: NCCL refuses two ranks on one
    card); gloo on the host."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev, "gloo"
    local, n_local = (int(os.environ.get(k, d)) for k, d in
                      (("LOCAL_RANK", "0"), ("LOCAL_WORLD_SIZE", "1")))
    own = n_local <= torch.cuda.device_count()
    dev = torch.device("cuda", local if own else 0)
    torch.cuda.set_device(dev)
    return dev, "nccl" if own else "gloo"


def _run(args, cfg, opt_cfg, data, device, mesh=None) -> int:
    state_sh = None
    if mesh is not None:
        state_sh = steps_mod.train_state_shardings(
            mesh, steps_mod.abstract_train_state(cfg, opt_cfg))
    trainer = Trainer(
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every),
        cfg, opt_cfg, steps_mod.make_train_step(cfg, opt_cfg, mesh=mesh),
        data, device=device, mesh=mesh, state_shardings=state_sh)
    handlers = {sig: signal.signal(sig, trainer.request_stop)
                for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        out = trainer.run()
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    if mesh is not None:
        # every rank gathers the whole state: its digest must agree (one
        # write, so the ranks' lines do not interleave)
        sys.stdout.write(f"rank {dist.get_rank()}: final state sha256 "
                         f"{_digest(trainer.state_to_host())}\n")
        sys.stdout.flush()
        if dist.get_rank() != 0:
            return 0
        print(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
              f"{dist.get_backend()} on {device}, world "
              f"{dist.get_world_size()}")
    for h in out["history"]:
        print(f"step {h['step']:>6}  loss {h['loss']:.4f}  "
              f"lr {h['lr']:.2e}  {h['step_time_s']*1e3:.0f} ms")
    print(f"final step {out['final_step']}  "
          f"stragglers {len(out['stragglers'])}  "
          f"nan-skipped {len(out['nan_skipped'])}")
    return 0


def _digest(tree) -> str:
    """sha256 over a host tree's arrays in the reference's leaf order."""
    from repro_torch.train.checkpoint import _flatten
    h = hashlib.sha256()
    for _, leaf in _flatten(tree):
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()


if __name__ == "__main__":
    sys.exit(main())
