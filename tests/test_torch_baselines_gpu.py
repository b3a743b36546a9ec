"""The baselines (COO, F-COO, CSF) on the card against their CPU run.

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips where no card is present.  This file imports only the port:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_baselines_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.core import baselines
from repro_torch.engine import BASELINE_KINDS, BaselinePlan, plan_for

pytestmark = pytest.mark.gpu

# max |card - cpu| / max |cpu| in f32: index_add_ on the card adds in
# another order; f64 differs only in the order of additions
TOL = {torch.float32: 5e-4, torch.float64: 1e-10}
RANK = 32
# order 4 with a 24-row mode (long segments) at 60,000 nnz
DIMS, NNZ = (183, 24, 1140, 1717), 60_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _tensor(dtype=np.float32):
    return core.random_tensor(DIMS, NNZ, seed=2, dist="powerlaw", dtype=dtype)


def _factors(dev, dtype=torch.float32):
    rng = np.random.default_rng(1)
    return [torch.as_tensor(rng.standard_normal((d, RANK)), dtype=dtype,
                            device=dev) for d in DIMS]


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kind", BASELINE_KINDS)
def test_formats_on_the_card_match_their_cpu_run(cuda, kind, dtype):
    t = _tensor(dtype)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    card = BaselinePlan.from_tensor(t, kind, device=cuda)
    host = BaselinePlan.from_tensor(t, kind, device="cpu")
    fc, fh = _factors(cuda, tdt), _factors("cpu", tdt)
    assert card.device_bytes() == host.device_bytes()
    for mode in range(len(DIMS)):
        a = card.mttkrp(fc, mode)
        b = host.mttkrp(fh, mode)
        assert a.is_cuda and a.dtype == b.dtype == tdt
        assert torch.isfinite(a).all()
        assert _rel(a, b) < TOL[tdt], mode


def test_csf_from_other_roots_on_the_card(cuda):
    t = _tensor()
    fmt = baselines.CSFFormat.build(t)
    fc, fh = _factors(cuda), _factors("cpu")
    for mode in range(len(DIMS)):
        for root in range(len(DIMS)):
            a = core.csf_mttkrp(fmt, fc, mode, root=root, device=cuda)
            b = core.csf_mttkrp(fmt, fh, mode, root=root, device="cpu")
            assert _rel(a, b) < TOL[torch.float32], (mode, root)


def test_plan_for_baselines_on_the_card(cuda):
    """``plan_for(backend=kind, kernel="torch")`` puts the format on the
    card, matches the in-memory fused output, and refuses ``"cuda"``."""
    t = _tensor()
    b = core.build_blco(t)
    fs = _factors(cuda)
    fused = plan_for(b, 1 << 34, rank=RANK, kernel="cuda", device=cuda)
    for kind in BASELINE_KINDS:
        with pytest.raises(ValueError, match="kernel='torch'"):
            plan_for(b, 1 << 34, rank=RANK, backend=kind, kernel="cuda",
                     device=cuda, tensor=t)
        plan = plan_for(b, 1 << 34, rank=RANK, backend=kind, kernel="torch",
                        device=cuda)
        for mode in range(len(DIMS)):
            assert _rel(plan.mttkrp(fs, mode), fused.mttkrp(fs, mode)) \
                < TOL[torch.float32], (kind, mode)
        before = torch.cuda.memory_allocated(cuda)
        freed = plan.close()
        del plan
        assert freed > 0
        assert torch.cuda.memory_allocated(cuda) <= before
    fused.close()
