"""Process-wide mesh context.

The port of the mesh half of ``repro.dist.context``: with a mesh set,
``repro_torch.engine.plan_for(backend="auto")`` routes to the sharded
backend.  The logical-axis activation constraints of the reference belong
to its language-model half, which the port has not reached.
"""
from __future__ import annotations

_MESH = None


def set_mesh(mesh) -> None:
    """Install (or clear, with ``None``) the process-wide mesh."""
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH
