"""``plan_for``: the paper's regime decision, as far as the port reaches.

    in_memory      the tensor's device footprint (hi + lo + vals + bases,
                   padded) plus the rank-R factor working set fits the
                   budget — the paper's in-memory regime;
    streamed       otherwise — fixed reservations stream the host-resident
                   tensor (the paper's out-of-memory regime), provided the
                   reservations in flight plus the factor working set fit.

When neither fits, ``plan_for`` raises ``ValueError``.  Every other regime
of ``repro.engine.select`` is a later slice of the port: asking for one by
name raises ``NotImplementedError``.  Nothing is picked silently in their
place, and no allocation failure demotes a plan yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.blco import BLCOTensor
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.mttkrp import DEFAULT_COPIES, validate_kernel
from repro_torch.core.streaming import reservation_for

from .api import factor_bytes, in_memory_bytes
from .plans import InMemoryPlan, StreamedPlan

# backends of the JAX package that the port has not reached yet, with the
# ROADMAP.md queue-1 item that ports each
UNPORTED_BACKENDS = {
    "disk_streamed": "queue 1 item 5 (disk tier)",
    "sharded": "queue 1 item 10 (sharded MTTKRP)",
    "coo": "queue 1 item 7 (baselines)",
    "fcoo": "queue 1 item 7 (baselines)",
    "csf": "queue 1 item 7 (baselines)",
}
AUTO_BACKENDS = ("auto", "in_memory", "streamed") + tuple(UNPORTED_BACKENDS)


def plan_for(blco: BLCOTensor, device_budget_bytes: int, *, rank: int,
             dtype=torch.float32, backend: str = "auto", queues: int = 4,
             reservation_nnz: int | None = None, resolution: str = "auto",
             copies: int = DEFAULT_COPIES, kernel: str = "cuda",
             device=DEFAULT_DEVICE) -> InMemoryPlan | StreamedPlan:
    """Build the ExecutionPlan for ``blco`` under ``device_budget_bytes``.

    ``kernel`` selects the compute path: ``"cuda"`` (the fused kernel: one
    launch per call in memory, one per chunk streamed) or ``"torch"`` (the
    plain reference dataflow).  ``queues`` and ``reservation_nnz`` shape
    the streamed regime's ring.  ``device`` defaults to the card;
    ``device="cpu"`` runs the plain versions on the host.
    """
    if backend not in AUTO_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"expected one of {AUTO_BACKENDS}")
    validate_kernel(kernel)
    device = resolve_device(device)
    if backend in UNPORTED_BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r} is not ported to PyTorch yet; "
            f"ROADMAP.md {UNPORTED_BACKENDS[backend]}")
    working = factor_bytes(blco.dims, rank, dtype)
    need = in_memory_bytes(blco) + working
    if backend == "in_memory" or (backend == "auto"
                                  and need <= device_budget_bytes):
        if need > device_budget_bytes:
            raise ValueError(
                f"in-memory plan needs {need} B resident (tensor + "
                f"factors) but the device budget is {device_budget_bytes} B")
        return InMemoryPlan(blco, resolution=resolution, copies=copies,
                            kernel=kernel, device=device)
    spec = reservation_for(blco, reservation_nnz)
    need = spec.bytes_in_flight(queues) + working
    if need > device_budget_bytes:
        raise ValueError(
            f"no regime fits the budget: streaming needs {need} B in flight "
            f"(reservation {spec.nnz} nnz x {queues} queues + factors) but "
            f"the device budget is {device_budget_bytes} B")
    return StreamedPlan(blco, queues=queues, spec=spec, resolution=resolution,
                        copies=copies, kernel=kernel, device=device)
