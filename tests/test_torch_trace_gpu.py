"""The trace tier on the card: K4 held to the conflict report, and the
registered hot paths under the op recorder and
``torch.cuda.set_sync_debug_mode("error")``.

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips where no card is present.  This file imports only the port:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_trace_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.analysis import trace
from repro_torch.analysis.trace import op_audit
from repro_torch.core.launches import LaunchCache
from repro_torch.kernels import launch_counts, reset_launch_counts

pytestmark = pytest.mark.gpu

RANK = 32
# (dims, nnz, build kwargs): many launches with forced blocking, and an
# order-4 tensor with a 24-row mode (K2's stash) in a few launches
TENSORS = {
    "demo": ((40, 25, 30), 2000, dict(target_bits=12,
                                      max_nnz_per_block=256)),
    "order4": ((183, 24, 1140, 1717), 60_011, dict(max_nnz_per_block=9000)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _blco(name):
    dims, nnz, kw = TENSORS[name]
    return core.build_blco(core.random_tensor(dims, nnz, seed=1,
                                              dist="powerlaw"), **kw)


def _factors(dims, dev):
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.standard_normal((d, RANK)).astype(
        np.float32)).to(dev) for d in dims]


@pytest.mark.parametrize("name", TENSORS)
def test_k4_runs_equal_the_report(cuda, name):
    """One K4 launch per (tensor, mode) on the launch cache's flat stream at
    the report's tile; its runs per launch equal the report's segments +
    padding segments exactly, as its plain version's do on the CPU."""
    b = _blco(name)
    cache = LaunchCache.from_blco(b, device=cuda)
    cpu_cache = LaunchCache.from_blco(b, device="cpu")
    fs = _factors(b.dims, cuda)
    for mode in range(b.order):
        report = trace.conflict_report(b, mode)
        reset_launch_counts()
        runs = trace.k4_runs(cache, fs, mode, tile=report["tile"])
        assert launch_counts["segments"] == 1
        assert runs == trace.report_runs(report)
        assert runs == trace.k4_runs(cpu_cache, [f.cpu() for f in fs], mode,
                                     tile=report["tile"])


@pytest.mark.parametrize("source", ["representative", "demo", "order4"])
def test_hot_paths_clean_under_sync_debug_error(cuda, source):
    """No host transfer, narrowing or duplicate write, and no implicit
    synchronisation the card refuses outside an inline disable — the one
    disabled site is ``torch.linalg.pinv``'s status check in CP-ALS."""
    if source == "representative":
        paths = trace.registered_hot_paths(device=cuda)
    else:
        b = _blco(source)
        paths = trace.registered_hot_paths(
            cache=LaunchCache.from_blco(b, device=cuda),
            factors=_factors(b.dims, cuda))
    assert all(hp.device.type == "cuda" for hp in paths)
    for hp in paths:
        rec = op_audit.OpRecorder(path=hp.path, symbol=hp.name)
        assert trace.audit_hot_path(hp, recorder=rec) == [], hp.name
        if hp.name == "sweep_mode_update":
            assert rec.suppressed and all(
                "src/repro_torch/core/cp_als.py" in s for s in rec.suppressed)
        else:
            assert rec.suppressed == [], hp.name
    assert torch.cuda.get_sync_debug_mode() == 0


def test_refused_synchronisation_is_a_finding_at_its_call_site(cuda):
    """A call the card refuses under the sync debug mode is a
    host-callback finding at the line that made it, and the path runs on
    to its end (the call is completed with the check off)."""
    x = torch.arange(64, device=cuda)
    done = []

    def path():
        nz = torch.nonzero(x > 10)          # data-dependent size: a sync
        done.append(nz.shape[0])

    hp = trace.HotPath("fixture", "tests/test_torch_trace_gpu.py", cuda,
                       (64,), path)
    found = trace.audit_hot_path(hp)
    assert [f.pass_id for f in found] == [trace.PASS_CALLBACK]
    assert found[0].path == "tests/test_torch_trace_gpu.py"
    assert "nonzero" in found[0].message and found[0].line > 0
    assert done == [53]


def test_recorder_flags_item_on_the_card_once(cuda):
    x = torch.arange(8.0, device=cuda)
    hp = trace.HotPath("fixture", "tests/fixture.py", cuda, (8,),
                       lambda: x.sum().item())
    found = trace.audit_hot_path(hp)
    assert len(found) == 1 and "host transfer" in found[0].message


def test_explicit_fences_pass_the_sync_debug_mode(cuda):
    """The plan's own fences stay legal under the audit: an explicit
    ``torch.cuda.synchronize()`` and an event's ``synchronize()`` pass the
    debug mode, a stream's ``synchronize()`` does not."""
    event = torch.cuda.Event()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.cuda.synchronize()
        event.record()
        event.synchronize()
        with pytest.raises(RuntimeError, match="synchronizing"):
            torch.cuda.current_stream().synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
