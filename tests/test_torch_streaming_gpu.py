"""The streamed regime on the card: the ring of pinned host buffers, the
copy stream and the events around K1/K2.

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips where no card is present.  This file imports only the port:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_streaming_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.engine import InMemoryPlan, StreamedPlan
from repro_torch.kernels import launch_counts, reset_launch_counts

pytestmark = pytest.mark.gpu

# max |a - b| / max |b| in f32: K1's atomics reorder additions, so two
# streamed runs, or streamed and in-memory, agree only to tolerance
F32_TOL = 5e-4
RANK = 32
# order 4 with a stash mode (24 rows, K2) and K1 on the others; a
# reservation of 4096 slots over launches of at most 3,000 non-zeros, many
# launches and a ragged last one
DIMS, NNZ, MAX_BLOCK = (183, 24, 1140, 1717), 60_000, 3_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _blco():
    t = core.random_tensor(DIMS, NNZ, seed=2, dist="powerlaw")
    return core.build_blco(t, max_nnz_per_block=MAX_BLOCK)


def _factors(dev):
    return core.init_factors(DIMS, RANK, seed=1, device=dev)


def test_queues_one_and_four_agree(cuda):
    """queues=1 reuses every buffer at once; its output equals queues=4's
    and the in-memory fused output at f32 tolerance."""
    b = _blco()
    assert len(b.launches) > 8
    fs = _factors(cuda)
    one = StreamedPlan(b, queues=1, device=cuda)
    four = StreamedPlan(b, queues=4, device=cuda)
    in_mem = InMemoryPlan(b, device=cuda)
    for mode in range(len(DIMS)):
        a = one.mttkrp(fs, mode)
        c = four.mttkrp(fs, mode)
        want = in_mem.mttkrp(fs, mode)
        assert torch.isfinite(a).all()
        assert _rel(a, c) < F32_TOL and _rel(c, want) < F32_TOL, mode


def test_host_buffers_are_pinned(cuda):
    plan = StreamedPlan(_blco(), queues=3, device=cuda)
    ring = plan.buffers
    assert ring.copy_stream is not None
    for k in range(3):
        assert ring._host[k].is_pinned()
        assert all(x.is_cuda for x in ring.device_set(k))
    plan.close()


def test_device_bytes_allocated_once_at_creation(cuda):
    """Plan creation allocates exactly the reservations in flight; a call
    allocates nothing that outlives it; close frees them."""
    b = _blco()
    fs = _factors(cuda)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    plan = StreamedPlan(b, queues=4, device=cuda)
    created = torch.cuda.memory_allocated(cuda)
    assert created - base == plan.spec.bytes_in_flight(4) == \
        plan.device_bytes()
    for mode in range(len(DIMS)):
        out = plan.mttkrp(fs, mode)
        del out
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(cuda) == created
    assert plan.close() == plan.spec.bytes_in_flight(4)
    assert torch.cuda.memory_allocated(cuda) == base


def test_kernel_launches_are_chunks_per_call(cuda):
    b = _blco()
    fs = _factors(cuda)
    plan = StreamedPlan(b, queues=4, device=cuda)
    chunks = len(b.launches)
    for mode, variant in ((0, "segment"), (1, "stash"), (2, "segment")):
        reset_launch_counts()
        plan.mttkrp(fs, mode)
        plan.mttkrp(fs, mode)
        want = {k: 0 for k in launch_counts}
        want[variant] = 2 * chunks
        assert launch_counts == want, mode
    s = plan.stats()
    assert s.launches == 6 * chunks and s.mttkrp_calls == 6
    assert s.h2d_bytes == 6 * chunks * plan.spec.bytes_per_launch


def test_streamed_input_arrays_match_a_fresh_chunk(cuda):
    """After a call, each device set holds exactly the padded chunk the
    reference ``chunk`` gives for the last launch it carried."""
    b = _blco()
    plan = StreamedPlan(b, queues=3, device=cuda)
    plan.mttkrp(_factors(cuda), 0)
    torch.cuda.synchronize()
    chunks = len(b.launches)
    for k in range(3):
        last = max(i for i in range(chunks) if i % 3 == k)
        want = plan.chunks.chunk(last)
        for got, w in zip(plan.buffers.device_set(k), want[:4]):
            assert np.array_equal(got.cpu().numpy(), w)
