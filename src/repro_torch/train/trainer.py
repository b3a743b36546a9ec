"""Fault-tolerant training loop: the port's counterpart of
``repro.train.trainer``, with its behaviours.

* **checkpoint/restart** — atomic step-tagged snapshots (train/checkpoint.py,
  the reference's layout, through ``convert.train_state_to_jax``); on start
  the trainer restores the latest complete step and the data pipeline
  replays deterministically from there (data/pipeline.py), so a preempted
  job resumes where it stopped: bit for bit on the CPU, within the
  reordered float additions of the card's ``index_add_`` atomics there.
* **async checkpointing** — copy to host memory, write on a background
  thread, one save in flight at a time.
* **preemption hooks** — ``request_stop()`` (wired to SIGTERM and SIGINT in
  launch/train.py) finishes the current step, saves, and exits cleanly.
* **elastic scaling** — ``state_to_host``/``state_from_host`` move the
  state through host memory, onto one device or onto a *different* mesh
  (``state_from_host(host_state, mesh, state_shardings)``): restart a
  smaller fleet from the same checkpoint.
* **sharded state** — with a ``mesh`` and ``state_shardings``
  (``launch.steps.train_state_shardings``), the state lives as ``DTensor``
  blocks, ZeRO over the data axes; a fresh state is drawn the same on
  every rank (one seeded generator) and then distributed, and a
  checkpoint is written by rank 0 while every rank waits for it.
* **NaN/overflow guard** — skip-and-log on non-finite loss.
* **step-time watchdog** — flags steps slower than ``straggler_factor`` x
  the trailing median.

Where the reference takes a ``Model`` and a JAX key, the port takes the
model's config and an explicit ``torch.Generator`` (``init_generator``),
and draws a fresh state on its device (the card unless the caller asks
for the CPU).
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.models.model import init_params
from repro_torch.optim import adamw
from . import checkpoint as ckpt


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    ckpt_every: int = 50
    ckpt_async: bool = True
    log_every: int = 10
    straggler_factor: float = 2.0
    keep_ckpts: int = 3
    # set it when the step updates the state in place
    # (make_train_step(donate=True)): the old state is gone then, so the
    # NaN guard cannot roll back a poisoned step and raises instead
    donate: bool = False


def put_batch(batch: dict, device) -> dict:
    """A host batch's arrays as tensors on ``device`` (``None`` entries
    kept); a ``put_fn`` for ``data.prefetch``."""
    return {k: None if v is None else torch.as_tensor(v).to(device)
            for k, v in batch.items()}


class Trainer:
    def __init__(self, cfg: TrainerConfig, model_cfg,
                 opt_cfg: adamw.AdamWConfig, train_step: Callable,
                 data_source, *, init_generator=None,
                 device=DEFAULT_DEVICE, mesh=None, state_shardings=None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.data = data_source
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None and state_shardings is None:
            state_shardings = steps.train_state_shardings(
                mesh, steps.abstract_train_state(model_cfg, opt_cfg))
        self.state_shardings = state_shardings
        self.train_step = train_step
        self._stop = False
        self._ckpt_thread = None
        self.step_times: list[float] = []
        self.straggler_steps: list[int] = []
        self.skipped_nan_steps: list[int] = []

        # ---- init or restore -------------------------------------------------
        like = convert.train_state_to_jax(self._state_of(
            init_params(model_cfg, device="meta")))
        step, restored = ckpt.restore_latest(cfg.ckpt_dir, like)
        if restored is not None:
            self.start_step = step
            self.state = self.state_from_host(restored, self.mesh,
                                              self.state_shardings)
        else:
            self.start_step = 0
            model = build_model(model_cfg, device=self.device,
                                generator=init_generator)
            self.state = self._state_of(model) if self.mesh is None else \
                steps.init_sharded_state(model, opt_cfg, self.mesh,
                                         self.state_shardings)

    def _state_of(self, params):
        return {"params": params,
                "opt": adamw.init_state(params, self.opt_cfg)}

    def request_stop(self, *_):
        self._stop = True

    # ---- host snapshots and elastic rescale ---------------------------------
    def state_to_host(self, *, rank0_only: bool = False):
        """The state as the reference's tree of numpy arrays.  On a mesh the
        blocks are gathered first (a collective: every rank calls it), each
        tensor copied to the host as soon as it is whole; with
        ``rank0_only`` only rank 0 keeps the copies (the others return
        ``None``): a checkpoint's writer."""
        if self.mesh is None:
            return convert.train_state_to_jax(self.state)
        mine = not rank0_only or dist.get_rank() == 0
        state = steps.gather_state(self.state, "cpu" if mine else "meta")
        return convert.train_state_to_jax(state) if mine else None

    def state_from_host(self, host_state, mesh=None, state_shardings=None):
        """A host snapshot (the reference's tree of arrays) as a train
        state on the trainer's device, and with a mesh and its shardings,
        resharded onto that mesh — which may differ from the one the
        snapshot came from (elastic restart)."""
        state = convert.train_state_from_jax(self.model_cfg, host_state,
                                             device=self.device)
        if mesh is None:
            return state
        return steps.shard_state(state, mesh, state_shardings)

    # ---- the loop --------------------------------------------------------------
    def run(self) -> dict:
        cfg = self.cfg
        history: list[dict[str, Any]] = []
        t_median = None
        for step in range(self.start_step, cfg.total_steps):
            if self._stop:
                break
            batch = put_batch(self.data.batch_at(step), self.device)
            t0 = time.perf_counter()
            new_state, metrics = self.train_step(self.state, batch)
            # the step's one host read, which also fences its timer
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.step_times.append(dt)

            if not np.isfinite(loss):
                if cfg.donate:
                    raise FloatingPointError(
                        f"non-finite loss {loss} at step {step}: the step "
                        f"updated the state in place (donate), so it cannot "
                        f"be rolled back; restore the latest checkpoint")
                # NaN guard: drop the update, keep the old state
                self.skipped_nan_steps.append(step)
                del new_state
                continue
            self.state = new_state

            if len(self.step_times) >= 5:
                t_median = statistics.median(self.step_times[-20:])
                if dt > cfg.straggler_factor * t_median:
                    self.straggler_steps.append(step)

            if (step + 1) % cfg.log_every == 0 or step == self.start_step:
                history.append({"step": step + 1, "loss": loss,
                                "lr": float(metrics["lr"]),
                                "grad_norm": float(metrics["grad_norm"]),
                                "step_time_s": dt})
            if (step + 1) % cfg.ckpt_every == 0:
                self._save(step + 1)

        final_step = step + 1 if not self._stop else step
        self._save(final_step, blocking=True)
        return {"history": history, "final_step": final_step,
                "stragglers": self.straggler_steps,
                "nan_skipped": self.skipped_nan_steps}

    def _save(self, step: int, blocking: bool | None = None):
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()        # one async save in flight max
        blocking = (not self.cfg.ckpt_async) if blocking is None else blocking
        self._ckpt_thread = ckpt.save(
            self.cfg.ckpt_dir, step, self.state_to_host(rank0_only=True),
            blocking=blocking, keep=self.cfg.keep_ckpts, mesh=self.mesh,
            copy=self.mesh is None)
