"""The port's process mesh: ``make_mesh`` over an initialised
``torch.distributed`` process group, the process-wide mesh (``set_mesh``
/ ``get_mesh``) that ``plan_for`` routes to the sharded backend and the
MoE splits its experts over, the model's anchors (``constrain``), and the
sharding rules (``sharding``: specs from shapes, ``DTensor`` placements).

The counterpart of ``repro.dist``; ``repro.dist.compat`` (``shard_map``
and ``make_mesh`` across jax releases) has no torch counterpart.
"""
from .context import constrain, get_mesh, set_mesh
from .mesh import make_mesh

__all__ = ["constrain", "get_mesh", "make_mesh", "set_mesh"]
