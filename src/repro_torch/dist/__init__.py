"""The port's process mesh: ``make_mesh`` over an initialised
``torch.distributed`` process group, and the process-wide mesh that
``plan_for`` routes to the sharded backend (``set_mesh`` / ``get_mesh``).

The counterpart of ``repro.dist.context`` (its mesh half) and
``repro.launch.mesh.make_test_mesh``.
"""
from .context import get_mesh, set_mesh
from .mesh import make_mesh

__all__ = ["get_mesh", "make_mesh", "set_mesh"]
