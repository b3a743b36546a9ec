"""Deterministic, shardable synthetic data pipeline: the port's own copy
of ``repro.data.pipeline``, numpy only and statement for statement the
reference's (``tests/test_torch_trainer.py`` holds the two equal), so both
packages train on the same batches.  ``prefetch``'s ``put_fn`` is how
batches reach the card (``repro_torch.train.trainer.put_batch``).

Real deployments swap ``SyntheticLM`` for a file-backed source; everything
downstream (host sharding, resume-from-step, prefetch) is source-agnostic.

Properties needed at scale and provided here:
  * per-host sharding: host h of H draws only its 1/H slice of the global
    batch (``host_slice``) — no cross-host data traffic;
  * exact resume: batch at step s is a pure function of (seed, s), so a
    restarted trainer replays the stream from the checkpointed step with no
    state file;
  * prefetch: a depth-k iterator that keeps device_put ahead of compute
    (same discipline as core/streaming.py).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    input_mode: str = "tokens"     # tokens | embeddings
    frontend_dim: int = 0
    encdec: bool = False


class SyntheticLM:
    """Zipf-distributed token stream (hot tokens stress the embedding-grad
    MTTKRP exactly like dense fibers stress the paper's kernels)."""

    def __init__(self, cfg: DataConfig, *, host_id: int = 0,
                 num_hosts: int = 1):
        assert cfg.global_batch % num_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, self.host_id))          # pure function of step
        b, s = self.local_batch, cfg.seq_len
        out = {}
        toks = rng.zipf(1.2, size=(b, s + 1)) % cfg.vocab_size
        toks = toks.astype(np.int32)
        if cfg.input_mode == "embeddings":
            fd = cfg.frontend_dim
            out["embeds"] = rng.standard_normal((b, s, fd)).astype(np.float32)
            out["labels"] = toks[:, 1:]
            if cfg.encdec:
                out["tokens"] = toks[:, :-1]
        else:
            out["tokens"] = toks[:, :-1]
            out["labels"] = toks[:, 1:]
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def prefetch(it, depth: int, put_fn=None):
    """Keep up to ``depth`` batches in flight (device_put'ed if put_fn)."""
    import collections
    q: collections.deque = collections.deque()
    it = iter(it)
    try:
        for _ in range(depth):
            b = next(it)
            q.append(put_fn(b) if put_fn else b)
        while True:
            out = q.popleft()
            b = next(it)
            q.append(put_fn(b) if put_fn else b)
            yield out
    except StopIteration:
        while q:
            yield q.popleft()
