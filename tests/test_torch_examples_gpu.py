"""The port's entry points on the card: each ``main`` at the reference
script's sizes with the default ``--device`` (the card), exit 0, and the
fused kernels it must launch (K1 ``segment`` on modes of 128 rows or
more, K2 ``stash`` on shorter ones) counted by the wrappers.  The service
demo and the soak each run two runtimes in one process: the pinned ring
and the device memory return to where they were.

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips where no card is present.  This file imports only the port:

    PYTHONPATH=src python -m pytest -m gpu -s tests/test_torch_examples_gpu.py
"""
import contextlib
import gc
import io
import json
import re

import pytest
import torch

from repro_torch.core.streaming import StreamBuffers
from repro_torch.examples import (distributed_cpals, oom_decomposition,
                                  quickstart, serve_td)
from repro_torch.faults import inject
from repro_torch.kernels import launch_counts
from repro_torch.scripts import chaos_soak, lint

pytestmark = pytest.mark.gpu

SOAK_PLAN = "1234:store.read@n=2:transient;runtime.quantum@n=3:crash"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _held():
    """Pinned ring bytes and allocated device bytes, less the cuBLAS
    workspace that each new sweeping thread's handle takes (the
    library's, not the port's)."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return StreamBuffers.pinned_bytes(), torch.cuda.memory_allocated()


def _run(main, argv):
    """``main(argv)``: its exit code, its output and the K1/K2 launches
    this process made in it."""
    before = dict(launch_counts)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    print(out.getvalue())
    return rc, out.getvalue(), {k: launch_counts[k] - before[k]
                                for k in ("segment", "stash")}


@pytest.mark.parametrize("module, want", [
    (quickstart, {"segment", "stash"}),
    (oom_decomposition, {"segment"}),
    (serve_td, {"segment", "stash"}),
], ids=["quickstart", "oom_decomposition", "serve_td"])
def test_example_on_the_card(module, want, cuda):
    held = _held()
    rc, out, took = _run(module.main, [])
    assert rc == 0
    assert {k for k, n in took.items() if n} == want, took
    assert _held() == held


def test_oom_decomposition_streams_on_the_card(cuda):
    rc, out, took = _run(oom_decomposition.main, [])
    assert rc == 0 and "backend='streamed'" in out
    # one K1 launch per chunk: 12 chunks x 3 modes x (8 sweeps + 0)
    assert re.search(r"engine stats: (\d+) launches", out).group(1) == \
        str(took["segment"]) == "288"


def test_chaos_soak_on_the_card(cuda, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    held = _held()
    inject.install(SOAK_PLAN)
    try:
        rc, out, took = _run(chaos_soak.main,
                             ["--trace-out", str(tmp_path / "t.json")])
    finally:
        inject.uninstall()
    assert rc == 0 and "chaos soak clean" in out
    assert took["stash"] > 0                   # every mode is 12 rows
    assert re.findall(r"job \d: done, (bit-identical|within tolerance)",
                      out) and "DIVERGED" not in out
    assert _held() == held


def test_lint_all_tiers_on_the_card(cuda):
    rc, out, took = _run(lint.main, ["--tier", "all"])
    assert rc == 0
    assert "repro-lint[all]: 0 finding(s)" in out
    assert took["segment"] + took["stash"] > 0


def test_distributed_cpals_on_the_card(cuda):
    rc, out, _ = _run(distributed_cpals.main, [])
    assert rc == 0
    assert "factors bitwise equal across the 8 ranks" in out
    reports = [json.loads(line.split("] ", 1)[1])
               for line in out.splitlines()
               if re.match(r"^\[rank \d\] \{", line)]
    assert len(reports) == 8
    for r in reports:
        assert r["device"].startswith("cuda")
        assert r["launches"]["segment"] == r["dispatches"] == 30
