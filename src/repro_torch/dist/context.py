"""Process-wide mesh context.

The port of the mesh half of ``repro.dist.context``: with a mesh set,
``repro_torch.engine.plan_for(backend="auto")`` routes to the sharded
backend.  The logical-axis activation constraints of the reference belong
to its language-model half, which the port has not reached.
"""
from __future__ import annotations

_MESH = None


def set_mesh(mesh) -> None:
    """Install (or clear, with ``None``) the process-wide mesh.  The mesh
    it replaces loses the flattened-axis groups made for it
    (``core.distributed.release_axis_groups``)."""
    global _MESH
    if _MESH is not None and _MESH is not mesh:
        from repro_torch.core.distributed import release_axis_groups
        release_axis_groups(_MESH)
    _MESH = mesh


def get_mesh():
    return _MESH
