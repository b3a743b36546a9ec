"""Process-wide mesh context + logical-axis activation anchors: the port
of ``repro.dist.context``.

With a mesh set, ``repro_torch.engine.plan_for(backend="auto")`` routes
to the sharded backend, ``models.moe.moe_layer`` splits its experts over
the ``model`` axis, and the model's anchors (``constrain``) name each
activation's layout by logical axes — ``"dp"`` (all data-parallel/ZeRO
axes: ``data``, or ``(pod, data)`` on multi-pod meshes) and ``"tp"`` (the
``model`` axis).  The reference hands each anchor to GSPMD as a sharding
hint; the port runs per-rank code, in which every rank already holds its
own block, so ``constrain`` returns its input: an exact no-op without a
mesh, and with one it checks the anchor names one axis per dim, as the
reference asserts.
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


def _resolve(mesh, logical):
    """Map a logical axis name to concrete mesh axes (or None to drop it):
    ``"dp"`` to the data axes (one name, or a tuple in mesh order),
    ``"tp"`` to ``"model"``."""
    if logical is None:
        return None
    names = tuple(mesh.mesh_dim_names)
    if logical == "dp":
        from .sharding import fsdp_axes
        axes = tuple(a for a in fsdp_axes(mesh) if a in names)
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]
    if logical == "tp":
        return "model" if "model" in names else None
    # already a concrete mesh axis name
    return logical if logical in names else None


def constrain(x, *axes):
    """The reference's ``with_sharding_constraint`` by logical per-dim axis
    names: ``axes`` has one entry per dim of ``x`` ("dp", "tp", a concrete
    mesh axis name, or None).  Returns ``x`` itself (see the module's
    docstring)."""
    if _MESH is not None:
        assert len(axes) == x.ndim, (axes, x.shape)
    return x
