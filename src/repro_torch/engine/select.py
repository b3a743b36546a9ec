"""``plan_for``: the paper's regime decision as a one-call auto-selector.

The port of ``repro.engine.select``:

    sharded        a mesh is passed in or set (``repro_torch.dist.set_mesh``)
                   — a mesh of ``torch.distributed`` ranks: the nnz stream
                   range-partitioned over its data axis, the rank split
                   over its model axis (``core.distributed``);
    in_memory      the tensor's device footprint (hi + lo + vals + bases,
                   padded) plus the rank-R factor working set fits the
                   budget — the paper's in-memory regime;
    disk_streamed  the tensor exceeds the HOST budget
                   (``host_budget_bytes``) — spill it to a ``.blco`` store
                   and stream its reservation chunks from the file through
                   the ring (one tier below the paper's OOM regime);
    streamed       otherwise — fixed reservations stream the host-resident
                   tensor (the paper's out-of-memory regime), provided the
                   reservations in flight plus the factor working set fit;
    baselines      never auto-selected; request ``backend="coo"|"fcoo"|
                   "csf"`` explicitly (with ``kernel="torch"``: they are
                   plain PyTorch) for parity with the paper's comparisons.

In auto mode an allocation failure — an injected ``plan.alloc`` fault or a
genuine ``torch.cuda.OutOfMemoryError`` — falls one memory tier: in_memory
-> streamed -> disk_streamed; each fall adds one to the plan's
``stats().demotions`` and records an ``engine.demote`` span.  A backend
named explicitly never changes regime.  There is no kernel rung: where the
JAX package retries a ``KernelFailure`` with its reference dataflow, the
port lets it propagate, for ``kernel="cuda"`` and ``"torch"`` alike — no
fallback hides a kernel that did not build or launch.

The sharded backend checks its mesh-wide need (the shards times their
replicas over the model axis, plus the factors) against the budget before
any upload.  Where the reference refuses every kernel but its reference
dataflow (``"xla"``) on this backend, the port takes both of its kernels:
``"torch"``, the counterpart of ``"xla"``, and ``"cuda"``, which runs K1/K2
on each rank's shard.  Both compute the function of the reference's
per-shard dataflow; the port never runs its plain version on the card's
main path.

``DefaultEngine`` wraps the same decision behind the ``MTTKRPEngine``
protocol for callers that hold an engine rather than call ``plan_for``.
"""
from __future__ import annotations

import os
import tempfile

import torch

from repro_torch.analysis.sanitize import wrap_plan
from repro_torch.core.blco import BLCOTensor, format_bytes
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.mttkrp import DEFAULT_COPIES, validate_kernel
from repro_torch.core.streaming import reservation_for
from repro_torch.dist.context import get_mesh
from repro_torch.faults import inject as faults
from repro_torch.obs import trace as obs_trace
from repro_torch.store import DiskStreamedPlan

from .api import factor_bytes, in_memory_bytes
from .plans import (BASELINE_KINDS, BaselinePlan, InMemoryPlan, ShardedPlan,
                    StreamedPlan, sharded_bytes)

AUTO_BACKENDS = ("auto", "in_memory", "streamed", "disk_streamed",
                 "sharded") + BASELINE_KINDS


def plan_for(blco: BLCOTensor, device_budget_bytes: int, *, rank: int,
             dtype=torch.float32, backend: str = "auto", mesh=None,
             queues: int = 4,
             reservation_nnz: int | None = None, resolution: str = "auto",
             copies: int = DEFAULT_COPIES, kernel: str = "cuda",
             device=DEFAULT_DEVICE, host_budget_bytes: int | None = None,
             store_path: str | None = None, sanitize: bool | None = None,
             tensor=None):
    """Build the ExecutionPlan for ``blco`` under ``device_budget_bytes``.

    ``tensor`` (the original SparseTensor) is only consulted for baseline
    backends; without it the coordinates are decoded from the BLCO copy.

    ``mesh`` (a ``DeviceMesh`` from ``repro_torch.dist.make_mesh``; the
    process-wide one of ``repro_torch.dist.get_mesh()`` when None) routes
    ``backend="auto"`` to the sharded backend, which ``backend="sharded"``
    names and which needs a mesh.

    ``kernel`` selects the compute path: ``"cuda"`` (the fused kernel: one
    launch per call in memory and per rank sharded, one per chunk
    streamed) or ``"torch"`` (the plain reference dataflow, and the only
    kernel of the baseline backends, which raise ``ValueError`` for any
    other).  ``queues`` and
    ``reservation_nnz`` shape the streamed regimes' ring.  ``device``
    defaults to the card; ``device="cpu"`` runs the plain versions on the
    host.

    ``host_budget_bytes`` extends the regime decision one memory tier
    down: when the tensor's host footprint (``format_bytes``) exceeds it,
    the tensor is spilled to the store at ``store_path`` (an anonymous
    temp file, deleted on ``plan.close()``, when not given; a named file
    is kept) and a ``DiskStreamedPlan`` feeds the device from it with an
    O(queues x reservation) host window.  Raises ValueError when no
    regime fits the budget.

    ``sanitize`` wraps the plan in the runtime sanitizer's contract
    checker (:mod:`repro_torch.analysis.sanitize`): ``True``/``False``
    force it on/off, ``None`` (default) follows ``REPRO_SANITIZE``.
    Sanitized plans are bit-identical to plain ones.
    """
    with obs_trace.span("engine.plan_for", "plan", nnz=blco.nnz,
                        requested=backend) as sp:
        plan = _plan_for_impl(
            blco, device_budget_bytes, rank=rank, dtype=dtype,
            backend=backend, mesh=mesh, queues=queues,
            reservation_nnz=reservation_nnz,
            resolution=resolution, copies=copies, kernel=kernel,
            device=device, host_budget_bytes=host_budget_bytes,
            store_path=store_path, tensor=tensor)
        sp.set(backend=plan.backend)
        return wrap_plan(plan, enable=sanitize)


def _plan_for_impl(blco: BLCOTensor, device_budget_bytes: int, *, rank: int,
                   dtype, backend: str, mesh, queues: int,
                   reservation_nnz: int | None, resolution: str, copies: int,
                   kernel: str, device, host_budget_bytes: int | None,
                   store_path: str | None, tensor):
    if backend not in AUTO_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"expected one of {AUTO_BACKENDS}")
    validate_kernel(kernel)
    device = resolve_device(device)
    if backend in BASELINE_KINDS:
        if kernel != "torch":
            raise ValueError(f"kernel={kernel!r} is not supported on "
                             f"baseline backends; use kernel='torch'")
        return BaselinePlan.from_tensor(tensor, backend, device=device) \
            if tensor is not None \
            else BaselinePlan.from_blco(blco, backend, device=device)
    working = factor_bytes(blco.dims, rank, dtype)
    mesh = mesh if mesh is not None else get_mesh()
    if backend == "sharded" or (backend == "auto" and mesh is not None):
        if mesh is None:
            raise ValueError("backend='sharded' requires an active mesh "
                             "(repro_torch.dist.set_mesh) or mesh=...")
        need = sharded_bytes(blco, mesh) + working
        if need > device_budget_bytes:
            raise ValueError(
                f"sharded plan needs {need} B across the mesh "
                f"(tensor shards x replicas + factors) but the device "
                f"budget is {device_budget_bytes} B")
        return ShardedPlan(blco, mesh, kernel=kernel, device=device)
    demotions: list[str] = []

    def _done(plan):
        plan.stats().demotions += len(demotions)
        return plan

    def _build_in_memory():
        # (the plan.alloc fault probe fires inside LaunchCache.from_blco —
        # the regime's actual device-allocation moment)
        return InMemoryPlan(blco, resolution=resolution, copies=copies,
                            kernel=kernel, device=device)

    def _build_streamed():
        faults.maybe_fail("plan.alloc")
        spec = reservation_for(blco, reservation_nnz)
        if spec.bytes_in_flight(queues) + working > device_budget_bytes:
            raise ValueError(
                f"no regime fits the budget: streaming needs "
                f"{spec.bytes_in_flight(queues) + working} B in flight "
                f"(reservation {spec.nnz} nnz x {queues} queues + factors) "
                f"but the device budget is {device_budget_bytes} B")
        return StreamedPlan(blco, queues=queues, spec=spec,
                            resolution=resolution, copies=copies,
                            kernel=kernel, device=device)

    def _build_disk():
        spec = reservation_for(blco, reservation_nnz)
        if spec.bytes_in_flight(queues) + working > device_budget_bytes:
            raise ValueError(
                f"disk-streamed plan needs "
                f"{spec.bytes_in_flight(queues) + working} B in flight "
                f"(reservation {spec.nnz} nnz x {queues} queues + factors) "
                f"but the device budget is {device_budget_bytes} B")
        if store_path is None:
            fd, path = tempfile.mkstemp(suffix=".blco")
            os.close(fd)
            delete = True
        else:
            path, delete = store_path, False
        try:
            return DiskStreamedPlan.spill(
                blco, path, reservation_nnz=spec.nnz, delete_on_close=delete,
                queues=queues, resolution=resolution, copies=copies,
                kernel=kernel, device=device)
        except BaseException:
            if delete:              # don't orphan the anonymous spill file
                try:
                    os.unlink(path)
                except OSError:
                    pass
            raise

    auto = backend == "auto"
    if backend == "disk_streamed" or (
            auto and host_budget_bytes is not None
            and format_bytes(blco) > host_budget_bytes):
        return _done(_build_disk())

    # ---------------------------------------------------- degradation ladder
    # auto mode falls one memory tier per allocation failure:
    # in_memory -> streamed -> disk_streamed.  Explicit backends never
    # change regime — the caller asked for that tier by name.
    need = in_memory_bytes(blco) + working
    if backend == "in_memory" or (auto and need <= device_budget_bytes):
        if need > device_budget_bytes:
            raise ValueError(
                f"in-memory plan needs {need} B resident (tensor + "
                f"factors) but the device budget is {device_budget_bytes} B")
        try:
            return _done(_build_in_memory())
        except Exception as exc:    # noqa: BLE001 — classified right below
            if not (auto and faults.is_alloc_failure(exc)):
                raise
            _note_demotion(demotions, "in_memory->streamed", exc)

    try:
        return _done(_build_streamed())
    except Exception as exc:        # noqa: BLE001 — classified right below
        if not (auto and faults.is_alloc_failure(exc)):
            raise
        _note_demotion(demotions, "streamed->disk_streamed", exc)
    return _done(_build_disk())


def _note_demotion(demotions: list, what: str, exc: BaseException) -> None:
    demotions.append(what)
    with obs_trace.span("engine.demote", "plan", demote=what,
                        error=repr(exc)):
        pass


class DefaultEngine:
    """MTTKRPEngine over ``plan_for`` with fixed streaming configuration."""

    def __init__(self, *, queues: int = 4, mesh=None, backend: str = "auto",
                 reservation_nnz: int | None = None, kernel: str = "cuda",
                 device=DEFAULT_DEVICE,
                 host_budget_bytes: int | None = None):
        self.queues = queues
        self.mesh = mesh
        self.backend = backend
        self.reservation_nnz = reservation_nnz
        self.kernel = kernel
        self.device = device
        self.host_budget_bytes = host_budget_bytes

    def plan(self, blco: BLCOTensor, *, device_budget_bytes: int, rank: int,
             dtype=torch.float32):
        return plan_for(blco, device_budget_bytes, rank=rank, dtype=dtype,
                        backend=self.backend, mesh=self.mesh,
                        queues=self.queues,
                        reservation_nnz=self.reservation_nnz,
                        kernel=self.kernel, device=self.device,
                        host_budget_bytes=self.host_budget_bytes)
