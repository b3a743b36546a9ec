"""The benchmark's generator against the port's host generator, and its
exactness where the dims' product passes 2**63."""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import random_tensor, top_up_uniform
from tdbench import gen

DELICIOUS = (532924, 17262471, 2480308, 1443)


def _hist(col, d):
    h = np.bincount(np.asarray(col), minlength=d).astype(np.float64)
    return h / h.sum()


@pytest.mark.parametrize("dist,dims,nnz", [
    ("powerlaw", (64, 48, 80), 30_000),
    ("uniform", (50, 60, 70), 20_000),
])
def test_mode_histograms_match_host_generator(dist, dims, nnz):
    cfg = {"dims": dims, "nnz": nnz, "dist": dist, "zipf_a": 1.3,
           "dtype": "float32"}
    idx, vals = gen.generate(cfg, 11, "cpu")
    want = top_up_uniform(random_tensor(dims, nnz, seed=11, dist=dist), nnz,
                          seed=11)
    assert idx.shape == (nnz, len(dims)) and vals.shape == (nnz,)
    for m, d in enumerate(dims):
        tv = 0.5 * np.abs(_hist(idx[:, m].numpy(), d)
                          - _hist(want.indices[:, m], d)).sum()
        assert tv < 0.05, (m, tv)
    assert abs(float(vals.std()) - float(want.values.std())) < 0.5


def test_exact_and_distinct_past_2_63():
    assert math.prod(DELICIOUS) >= 1 << 63
    cfg = {"dims": DELICIOUS, "nnz": 50_000, "dist": "uniform",
           "dtype": "float32"}
    idx, vals = gen.generate(cfg, 2**31 + 5, "cpu")
    assert idx.shape == (50_000, 4) and bool(torch.all(vals != 0))
    assert bool(torch.all(idx >= 0)) and bool(
        torch.all(idx < torch.tensor(DELICIOUS)))
    assert len({tuple(r) for r in idx.tolist()}) == 50_000
    again, _ = gen.generate(cfg, 2**31 + 5, "cpu")
    assert torch.equal(idx, again)


def test_dedupe_sums_duplicates_past_2_63():
    rows = torch.tensor([[532923, 17262470, 2480307, 1442],
                         [0, 0, 0, 0],
                         [532923, 17262470, 2480307, 1442],
                         [532923, 17262470, 2480307, 1441],
                         [0, 0, 0, 0],
                         [532923, 17262470, 2480307, 1442]])
    vals = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    idx, summed = gen.dedupe_sum(rows, vals, DELICIOUS)
    assert idx.tolist() == [[0, 0, 0, 0], [532923, 17262470, 2480307, 1441],
                            [532923, 17262470, 2480307, 1442]]
    assert summed.tolist() == [7.0, 4.0, 10.0]
    full, _ = gen.top_up(idx, summed, DELICIOUS, 1000,
                         torch.Generator().manual_seed(3))
    assert full.shape == (1000, 4)
    assert torch.equal(full[:3], idx)
    assert len({tuple(r) for r in full.tolist()}) == 1000


def test_zipf_cdf_matches_numpy_draws():
    cdf = gen.zipf_cdf(1.3, 40)
    rng = np.random.default_rng(0)
    draws = np.minimum(rng.zipf(1.3, 400_000) - 1, 39)
    emp = np.cumsum(np.bincount(draws, minlength=40)) / draws.size
    assert np.max(np.abs(emp - cdf)) < 5e-3
    assert cdf[-1] == 1.0
