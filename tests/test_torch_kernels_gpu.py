"""The CUDA kernels K1 (segment) and K2 (stash) against their plain
PyTorch versions, on the card.

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips where no card is present; whether one is present is decided inside
the fixture, never at import time.  This file imports only the port, so it
also runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.core.launches import LaunchCache
from repro_torch.engine import plan_for
from repro_torch.kernels import fused, ref

pytestmark = pytest.mark.gpu

# (dims, nnz, target_bits, max_nnz_per_block, rank): orders 3-5 with ragged
# nnz, forced blocking, a field straddling the two index words with R > 32
CASES = [
    ((70, 40, 30), 1777, 12, 512, 8),
    ((13, 7, 29, 5), 499, 8, 64, 32),
    ((128, 4, 256, 8, 3), 801, 16, 128, 16),
    ((2048, 2048, 2048), 6007, 64, 1 << 27, 40),
]
PAIRS = [(torch.float32, torch.float32), (torch.float64, torch.float64),
         (torch.float64, torch.float32)]
# max |kernel - plain| / max |plain|: 5e-4 in f32 (the JAX package's kernel
# tests); in f64 only the order of the atomic additions differs
REL_TOL = {torch.float32: 5e-4, torch.float64: 1e-10}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("pair", PAIRS, ids=["f32", "f64", "f64xf32"])
@pytest.mark.parametrize("dims,nnz,tb,mx,rank", CASES)
def test_kernels_match_plain_versions(cuda, dims, nnz, tb, mx, rank, pair):
    vdt, fdt = pair
    t = core.random_tensor(dims, nnz, seed=7, dist="powerlaw")
    b = core.build_blco(t, target_bits=tb, max_nnz_per_block=mx)
    hi, lo, vals, bases = LaunchCache.from_blco(b, device=cuda).flat()
    vals = vals.to(vdt)
    rng = np.random.default_rng(0)
    fs = [torch.as_tensor(rng.standard_normal((d, rank))).to(cuda, fdt)
          for d in dims]
    for mode, d in enumerate(dims):
        kw = dict(field_bits=b.re.field_bits, field_shifts=b.re.field_shift,
                  mode=mode, out_rows=d)
        for res in ("register", "hierarchical"):
            before = dict(fused.launch_counts)
            out = fused.fused_mttkrp_flat(hi, lo, vals, bases, fs,
                                          resolution=res, **kw)
            variant = fused._variant_for(res, d, rank=rank,
                                         itemsize=out.element_size())
            assert fused.launch_counts[variant] == before[variant] + 1
            if variant == "stash":
                want = ref.fused_stash_ref(hi, lo, vals, bases, fs, **kw)
            else:
                want = ref.fused_segment_mttkrp_ref(
                    hi, lo, vals, bases, fs, tile=math.gcd(hi.shape[0], 256),
                    **kw)
            torch.cuda.synchronize()
            assert out.dtype == torch.promote_types(vdt, fdt)
            assert out.shape == (d, rank)
            assert _rel(out, want) < REL_TOL[out.dtype], (mode, res, variant)


def test_plan_is_one_launch_per_call(cuda):
    t = core.random_tensor((13, 7, 29, 5), 499, seed=3, dist="powerlaw")
    b = core.build_blco(t, target_bits=8, max_nnz_per_block=64)
    plan = plan_for(b, 1 << 30, rank=8)
    assert plan.resident.device.type == "cuda"
    fs = core.init_factors(b.dims, 8, seed=1)
    before = sum(fused.launch_counts.values())
    for mode in range(b.order):
        plan.mttkrp(fs, mode)
    assert sum(fused.launch_counts.values()) - before == b.order
    assert plan.stats().launches == plan.stats().mttkrp_calls == b.order


def test_unsupported_dtypes_raise(cuda):
    t = core.random_tensor((30, 20, 10), 300, seed=1)
    b = core.build_blco(t)
    hi, lo, vals, bases = LaunchCache.from_blco(b, device=cuda).flat()
    fs = [torch.ones(d, 4, device=cuda, dtype=torch.float64) for d in b.dims]
    with pytest.raises(TypeError):          # f32 values x f64 factors
        fused.fused_mttkrp_flat(hi, lo, vals, bases, fs,
                                field_bits=b.re.field_bits,
                                field_shifts=b.re.field_shift, mode=0,
                                out_rows=30)


def test_build_reports_registers(cuda):
    from repro_torch.kernels.build import load_library
    kl = load_library()
    assert kl.path.is_file()
    assert "registers" in kl.log
    # the limits the wrapper checks are the ones the C side enforces
    assert kl.lib.fused_mttkrp_max_order() == fused._MAX_ORDER
    assert kl.lib.fused_mttkrp_stash_max_bytes() == fused.STASH_MAX_BYTES
