"""The disk tier and the ladder on the card: a ``.blco`` store streamed
through the ring of pinned buffers, K1/K2 once per chunk, and a genuine
``torch.cuda.OutOfMemoryError`` walking ``plan_for``'s ladder.

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips where no card is present.  This file imports only the port:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_store_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.engine import (DiskStreamedPlan, InMemoryPlan, StreamedPlan,
                                plan_for)
from repro_torch.faults import is_alloc_failure
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.store import open_blco, save_blco

pytestmark = pytest.mark.gpu

# max |a - b| / max |b| in f32: K1's atomics reorder additions, so a
# disk-streamed and a host-streamed run agree only to tolerance
F32_TOL = 5e-4
RANK = 32
# order 4 with a stash mode (24 rows, K2) and K1 on the others; a
# reservation of 4096 slots over launches of at most 3,000 non-zeros, many
# launches and a ragged last one
DIMS, NNZ, MAX_BLOCK = (183, 24, 1140, 1717), 60_000, 3_000
# the ladder test: launches of up to 2^17 non-zeros, so every device buffer
# is megabytes and the allocator's rounding is small beside the two needs
BIG_NNZ, BIG_BLOCK = 1_500_000, 1 << 17


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _blco(nnz=NNZ, block=MAX_BLOCK, dist="powerlaw"):
    t = core.random_tensor(DIMS, nnz, seed=2, dist=dist)
    return core.build_blco(t, max_nnz_per_block=block)


def _store(b, tmp_path):
    path = str(tmp_path / "t.blco")
    save_blco(b, path)
    return path


def test_disk_streamed_matches_host_streamed_with_a_pinned_ring(cuda,
                                                                tmp_path):
    b = _blco()
    assert len(b.launches) > 8
    fs = core.init_factors(DIMS, RANK, seed=1, device=cuda)
    disk = DiskStreamedPlan(_store(b, tmp_path), queues=3, device=cuda)
    host = StreamedPlan(b, queues=3, device=cuda)
    ring = disk.buffers
    assert ring.copy_stream is not None
    assert all(ring._host[k].is_pinned() for k in range(3))
    for mode in range(len(DIMS)):
        got = disk.mttkrp(fs, mode)
        assert got.is_cuda and bool(torch.isfinite(got).all())
        assert _rel(got, host.mttkrp(fs, mode)) < F32_TOL, mode
    s = disk.stats()
    assert s.disk_bytes == s.h2d_bytes == \
        len(DIMS) * len(b.launches) * disk.spec.bytes_per_launch


def test_device_bytes_are_queues_times_bytes_per_launch(cuda, tmp_path):
    """Plan creation allocates exactly the reservations in flight; a call
    allocates nothing that outlives it; close frees them."""
    path = _store(_blco(), tmp_path)
    fs = core.init_factors(DIMS, RANK, seed=1, device=cuda)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    plan = DiskStreamedPlan(path, queues=4, device=cuda)
    created = torch.cuda.memory_allocated(cuda)
    assert created - base == plan.device_bytes() == \
        4 * plan.spec.bytes_per_launch
    for mode in range(len(DIMS)):
        out = plan.mttkrp(fs, mode)
        del out
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(cuda) == created
    assert plan.close() == 4 * plan.spec.bytes_per_launch
    assert torch.cuda.memory_allocated(cuda) == base


def test_kernel_launches_are_chunks_per_call(cuda, tmp_path):
    b = _blco()
    fs = core.init_factors(DIMS, RANK, seed=1, device=cuda)
    plan = DiskStreamedPlan(_store(b, tmp_path), queues=4, device=cuda)
    chunks = len(b.launches)
    for mode, variant in ((0, "segment"), (1, "stash"), (3, "segment")):
        reset_launch_counts()
        plan.mttkrp(fs, mode)
        plan.mttkrp(fs, mode)
        want = {k: 0 for k in launch_counts}
        want[variant] = 2 * chunks
        assert launch_counts == want, mode
    s = plan.stats()
    assert s.launches == 6 * chunks and s.mttkrp_calls == 6


def test_chunk_into_fills_the_pinned_views_with_the_memmap_bytes(cuda,
                                                                 tmp_path):
    """The read into the ring: each pinned host set holds, byte for byte,
    the memmap slices of the launch, the ragged last one included; after a
    call each device set holds the last chunk it carried."""
    b = _blco()
    stored = open_blco(_store(b, tmp_path))
    plan = DiskStreamedPlan(stored, queues=3, device=cuda)
    bufs = plan.buffers.host_set(0)
    for i in (0, stored.num_launches - 1, 1):
        assert stored.chunk_into(i, bufs) == b.launches[i].nnz
        for got, want in zip(bufs, stored.chunk(i)[:4]):
            assert got.tobytes() == np.asarray(want).tobytes()
    plan.mttkrp(core.init_factors(DIMS, RANK, seed=1, device=cuda), 0)
    torch.cuda.synchronize()
    for k in range(3):
        last = max(i for i in range(stored.num_launches) if i % 3 == k)
        for got, want in zip(plan.buffers.device_set(k),
                             stored.chunk(last)[:4]):
            assert np.array_equal(got.cpu().numpy(), np.asarray(want))


def test_a_real_oom_is_an_alloc_failure(cuda):
    with pytest.raises(torch.cuda.OutOfMemoryError) as info:
        torch.empty(1 << 50, dtype=torch.uint8, device=cuda)
    assert is_alloc_failure(info.value)


def _reserved_need(make, fs, cuda) -> int:
    """Bytes the caching allocator reserves to build ``make()`` and run one
    mode-0 call on it, from an emptied cache."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(cuda)
    plan = make()
    plan.mttkrp(fs, 0)
    torch.cuda.synchronize()
    need = torch.cuda.memory_reserved(cuda) - base
    plan.close()
    del plan
    torch.cuda.empty_cache()
    return need


def test_capped_allocator_walks_in_memory_to_streamed(cuda):
    """A genuine ``torch.cuda.OutOfMemoryError``: with the caching
    allocator capped between what the streamed plan and what the in-memory
    plan reserve, ``plan_for(auto)`` — whose device budget says the tensor
    fits in memory — demotes to the streamed regime and computes; the
    allocator is restored afterwards."""
    b = _blco(BIG_NNZ, BIG_BLOCK, "uniform")
    fs = core.init_factors(DIMS, RANK, seed=1, device=cuda)
    want = InMemoryPlan(b, device=cuda)
    ref = want.mttkrp(fs, 0)
    want.close()
    del want
    in_mem = _reserved_need(lambda: InMemoryPlan(b, device=cuda), fs, cuda)
    streamed = _reserved_need(lambda: StreamedPlan(b, queues=2, device=cuda),
                              fs, cuda)
    assert streamed + (8 << 20) < in_mem, (streamed, in_mem)
    total = torch.cuda.get_device_properties(cuda).total_memory
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cap = torch.cuda.memory_reserved(cuda) + (in_mem + streamed) // 2
    torch.cuda.set_per_process_memory_fraction(cap / total, cuda)
    try:
        plan = plan_for(b, 1 << 40, rank=RANK, queues=2, device=cuda)
        assert plan.backend == "streamed" and plan.stats().demotions == 1
        got = plan.mttkrp(fs, 0)
        assert _rel(got, ref) < F32_TOL
        plan.close()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, cuda)
        torch.cuda.empty_cache()
    big = torch.empty(in_mem * 4, dtype=torch.uint8, device=cuda)
    del big
    plan = plan_for(b, 1 << 40, rank=RANK, device=cuda)
    assert plan.backend == "in_memory" and plan.stats().demotions == 0
    plan.close()
