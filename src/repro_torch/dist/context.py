"""Process-wide mesh context + logical-axis activation anchors: the port
of ``repro.dist.context``.

With a mesh set, ``repro_torch.engine.plan_for(backend="auto")`` routes
to the sharded backend, ``models.moe.moe_layer`` splits its experts over
the ``model`` axis, and the model's anchors (``constrain``) name each
activation's layout by logical axes — ``"dp"`` (all data-parallel/ZeRO
axes: ``data``, or ``(pod, data)`` on multi-pod meshes) and ``"tp"`` (the
``model`` axis).  The reference hands each anchor to GSPMD as a sharding
hint; the port runs per-rank code, so ``constrain`` returns its input:
an exact no-op without a mesh, and with one it checks the anchor names
one axis per dim, as the reference asserts.  The split happens in the
module code instead: each rank computes with its blocks and calls the
collectives of ``dist.tensor_parallel``, in the layout that ``tp_layout``
(train and prefill attention) and ``tp_cache_layout`` (the decode cache)
choose as the reference's anchors and ``cache_specs`` choose it.
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


def tp_layout(cfg, mesh, seq: int) -> str:
    """The attention's layout over ``model`` for ``seq`` query rows, the
    reference's ``_attn_constrain`` decision: ``"heads"`` where the KV
    heads divide the axis (``tensor_parallel.Plan.heads``), else
    ``"rows"`` (each rank its block of query rows against the whole K
    and V) where the rows do, else ``"whole"``.  ``"whole"`` too where
    ``tensor_parallel.plan`` splits nothing or ``cfg`` has no
    attention."""
    from .tensor_parallel import plan
    tp = plan(cfg, mesh)
    if tp is None or cfg.attention == "none":
        return "whole"
    if tp.heads:
        return "heads"
    return "rows" if seq % tp.size == 0 else "whole"


def tp_cache_layout(cfg, mesh) -> str:
    """The attention cache's block over ``model``, as the reference's
    ``cache_specs`` splits it: ``tensor_parallel.Plan``'s ``cache`` (the
    KV heads, ``head_dim``, the KV length, or MLA's latent and rope
    dims), ``"whole"`` where ``plan`` splits nothing.  The KV-length
    block is always this rank's: ``ceil(S / m)`` positions from ``rank *
    ceil(S / m)``, also where the reference leaves ``model`` off the
    cache (a length the axis does not divide, or the data axes taking
    the length of a batch they do not divide: the port keeps no
    sequence-parallel cache over the data axes), so a decode step reads
    its block's first position from its length alone."""
    from .tensor_parallel import plan
    tp = plan(cfg, mesh)
    return "whole" if tp is None else tp.cache
