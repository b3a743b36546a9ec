"""``plan_for``: the paper's regime decision, as far as the port reaches.

    in_memory      the tensor's device footprint (hi + lo + vals + bases,
                   padded) plus the rank-R factor working set fits the
                   budget — the paper's in-memory regime.

Every other regime of ``repro.engine.select`` is a later slice of the port.
Asking for one by name raises ``NotImplementedError``; a tensor too large
for the in-memory regime raises ``ValueError`` naming the regime that would
take it.  Nothing is picked silently in their place.
"""
from __future__ import annotations

import torch

from repro_torch.core.blco import BLCOTensor
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.mttkrp import DEFAULT_COPIES, validate_kernel

from .api import factor_bytes, in_memory_bytes
from .plans import InMemoryPlan

# backends of the JAX package that the port has not reached yet, with the
# ROADMAP.md queue-1 item that ports each
UNPORTED_BACKENDS = {
    "streamed": "queue 1 item 4 (out-of-memory streaming)",
    "disk_streamed": "queue 1 item 5 (disk tier)",
    "sharded": "queue 1 item 10 (sharded MTTKRP)",
    "coo": "queue 1 item 7 (baselines)",
    "fcoo": "queue 1 item 7 (baselines)",
    "csf": "queue 1 item 7 (baselines)",
}
AUTO_BACKENDS = ("auto", "in_memory") + tuple(UNPORTED_BACKENDS)


def plan_for(blco: BLCOTensor, device_budget_bytes: int, *, rank: int,
             dtype=torch.float32, backend: str = "auto",
             resolution: str = "auto", copies: int = DEFAULT_COPIES,
             kernel: str = "cuda", device=DEFAULT_DEVICE) -> InMemoryPlan:
    """Build the ExecutionPlan for ``blco`` under ``device_budget_bytes``.

    ``kernel`` selects the compute path: ``"cuda"`` (the fused kernel, one
    launch per call) or ``"torch"`` (the plain reference dataflow).
    ``device`` defaults to the card; ``device="cpu"`` runs the plain
    versions on the host.
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
    need = in_memory_bytes(blco) + factor_bytes(blco.dims, rank, dtype)
    if need > device_budget_bytes:
        raise ValueError(
            f"in-memory plan needs {need} B resident (tensor + factors) but "
            f"the device budget is {device_budget_bytes} B; the streamed "
            f"regime that would take it is not ported yet (ROADMAP.md "
            f"{UNPORTED_BACKENDS['streamed']})")
    return InMemoryPlan(blco, resolution=resolution, copies=copies,
                        kernel=kernel, device=device)
