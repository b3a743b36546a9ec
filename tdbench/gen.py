"""The benchmark's tensors, made on the device from a seed.

The key distributions are those of the port's host generator
(``random_tensor(dist="powerlaw" | "uniform")`` followed by
``top_up_uniform``), drawn with a ``torch.Generator`` on the device instead
of numpy on the host:

* ``powerlaw``: each mode's coordinate is a Zipf(a) draw minus one, with the
  tail clipped onto the mode's last index (a dense-fiber head);
* ``uniform``: each coordinate uniform over its mode.

``nnz`` draws are made, duplicates are summed (standard COO semantics), and
the result is topped up with distinct uniform coordinates, not yet present,
to exactly ``nnz`` non-zeros, as the real data sets have.  Deduplication
sorts on coordinates packed into several int64 words, so it is exact for
any dims, ``prod(dims) >= 2**63`` included.  Every step is deterministic:
the same seed on the same device gives the same tensor.

Only the dims and nnz are the real tensors'; the sparsity pattern is this
generator's.  The Zipf head puts about 1/zeta(a) of each mode's draws on
index 0 (25% at a = 1.3) and the clipped tail a few per cent on the last
index, fibers that NELL-2 and Delicious do not have.  So a kernel's run
lengths, conflicts and cache behaviour measured on these tensors describe
the generator, not the data sets.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# a draw a little over what is missing: collisions are rare when sparse
_MARGIN = 64


def field_bits(dims) -> list[int]:
    """Bits of each mode's coordinate (at least one)."""
    return [max(1, (int(d) - 1).bit_length()) for d in dims]


def pack_words(idx: torch.Tensor, dims) -> list[torch.Tensor]:
    """(n, N) coordinates -> int64 words, most significant first, whose
    lexicographic order is the coordinates' (mode 0 most significant).
    Each word holds whole modes, at most 63 bits of them."""
    words, cur, used = [], None, 0
    for m, bits in enumerate(field_bits(dims)):
        if cur is not None and used + bits > 63:
            words.append(cur)
            cur, used = None, 0
        col = idx[:, m]
        cur = col.clone() if cur is None else (cur << bits) | col
        used += bits
    words.append(cur)
    return words


def lex_order(words: list[torch.Tensor]) -> torch.Tensor:
    """Stable permutation sorting rows by their words (first most
    significant): stable sorts from the least significant word up."""
    n = words[0].shape[0]
    perm = torch.arange(n, device=words[0].device)
    for w in reversed(words):
        perm = perm[torch.sort(w[perm], stable=True).indices]
    return perm


def _first_of_runs(words: list[torch.Tensor]) -> torch.Tensor:
    """Mask of rows that differ from the row before (rows already sorted)."""
    n = words[0].shape[0]
    first = torch.ones(n, dtype=torch.bool, device=words[0].device)
    if n > 1:
        same = torch.ones(n - 1, dtype=torch.bool, device=words[0].device)
        for w in words:
            same &= w[1:] == w[:-1]
        first[1:] = ~same
    return first


def dedupe_sum(idx: torch.Tensor, vals: torch.Tensor, dims):
    """Distinct coordinates in lexicographic order, duplicates' values
    summed in float64 (a scan, so the sum is the same on every run)."""
    words = pack_words(idx, dims)
    perm = lex_order(words)
    idx, vals = idx[perm], vals[perm]
    first = _first_of_runs([w[perm] for w in words])
    starts = torch.nonzero(first).flatten()
    csum = torch.cat([torch.zeros(1, dtype=torch.float64, device=vals.device),
                      torch.cumsum(vals.double(), 0)])
    ends = torch.cat([starts[1:], torch.tensor([idx.shape[0]],
                                               device=idx.device)])
    return idx[starts], (csum[ends] - csum[starts]).to(vals.dtype)


def _normal(n, gen, device, dtype):
    v = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    return torch.where(v == 0, torch.ones_like(v), v).to(dtype)


def _uniform_coords(dims, n, gen, device) -> torch.Tensor:
    return torch.stack([torch.randint(0, int(d), (n,), generator=gen,
                                      device=device) for d in dims], dim=1)


def zipf_cdf(a: float, d: int) -> np.ndarray:
    """CDF over ``0..d-1`` of ``min(Z - 1, d - 1)`` for Z ~ Zipf(a), a > 1:
    P(j) = (j + 1)^-a / zeta(a) below the last index, the tail on it."""
    k = np.arange(1, d, dtype=np.float64)
    return np.append(np.cumsum(k ** -a) / zeta(a), 1.0)


def zeta(a: float, terms: int = 1 << 16) -> float:
    """Riemann zeta(a), a > 1: a partial sum and its Euler-Maclaurin tail."""
    n = float(terms)
    head = float(np.sum(np.arange(1, terms, dtype=np.float64) ** -a))
    return (head + n ** (1 - a) / (a - 1) + 0.5 * n ** -a
            + a * n ** (-a - 1) / 12 - a * (a + 1) * (a + 2) * n ** (-a - 3)
            / 720)


def _zipf_coords(dims, n, a, gen, device) -> torch.Tensor:
    cols = []
    for d in dims:
        cdf = torch.as_tensor(zipf_cdf(a, int(d)), device=device)
        u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
        col = torch.searchsorted(cdf, u, right=True)
        cols.append(col.clamp_(max=int(d) - 1))
    return torch.stack(cols, dim=1)


def top_up(idx: torch.Tensor, vals: torch.Tensor, dims, nnz: int, gen):
    """``idx``/``vals`` (distinct) followed by distinct uniform coordinates
    not among them, to exactly ``nnz`` rows."""
    device, need = idx.device, nnz - idx.shape[0]
    if need < 0 or nnz > math.prod(int(d) for d in dims):
        raise ValueError(f"cannot top {idx.shape[0]} non-zeros up to {nnz}")
    extra = idx.new_empty((0, len(dims)))
    while extra.shape[0] < need:
        more = need - extra.shape[0] + need // 64 + _MARGIN
        drawn = _uniform_coords(dims, more, gen, device)
        cand = torch.cat([idx, extra, drawn])
        # rows of the head come first: a stable sort keeps them ahead of
        # an equal draw, which is then dropped
        tag = torch.arange(cand.shape[0], device=device) >= idx.shape[0]
        words = pack_words(cand, dims)
        perm = lex_order(words)
        cand, tag = cand[perm], tag[perm]
        keep = _first_of_runs([w[perm] for w in words]) & tag
        extra = cand[keep]
    # drop a uniform choice of the surplus: the rest is a uniform subset
    pick = torch.randperm(extra.shape[0], generator=gen, device=device)[:need]
    extra = extra[torch.sort(pick).values]
    return (torch.cat([idx, extra]),
            torch.cat([vals, _normal(need, gen, device, vals.dtype)]))


def generate(cfg: dict, seed: int, device):
    """The configuration's COO tensor from ``seed``: (nnz, N) int64 indices
    and (nnz,) values of the configuration's dtype, on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    dims, nnz = [int(d) for d in cfg["dims"]], int(cfg["nnz"])
    dtype = getattr(torch, cfg["dtype"])
    if cfg["dist"] == "powerlaw":
        idx = _zipf_coords(dims, nnz, float(cfg["zipf_a"]), gen, device)
    elif cfg["dist"] == "uniform":
        idx = _uniform_coords(dims, nnz, gen, device)
    else:
        raise ValueError(f"unknown key distribution {cfg['dist']!r}")
    idx, vals = dedupe_sum(idx, _normal(nnz, gen, device, dtype), dims)
    return top_up(idx, vals, dims, nnz, gen)


def initial_factors(cfg: dict, seed: int, device) -> list[torch.Tensor]:
    """Standard-normal (I_n, R) factors from ``seed``, in one draw."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + 1) % (1 << 64))
    dims, rank = [int(d) for d in cfg["dims"]], int(cfg["rank"])
    flat = torch.randn(sum(dims) * rank, generator=gen, device=device,
                       dtype=getattr(torch, cfg["dtype"]))
    return [f.view(d, rank) for f, d in
            zip(torch.split(flat, [d * rank for d in dims]), dims)]
