"""Meshes of ``torch.distributed`` ranks.

The counterpart of ``repro.launch.mesh.make_test_mesh``: a
``torch.distributed.device_mesh.DeviceMesh`` with named axes over the
ranks of the default process group, which the caller initialises
(``torch.distributed.init_process_group`` with its backend, rendezvous,
world size and rank).  Each named axis has its own process group
(``mesh.get_group(axis)``) and each rank its coordinate on it
(``mesh.get_local_rank(axis)``).
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device


def make_mesh(shape, axes=("data", "model"), *,
              device=DEFAULT_DEVICE):
    """A ``DeviceMesh`` of ``shape`` named by ``axes`` over every rank of
    the default process group; ``device`` gives its device type (the
    card by default, ``"cpu"`` for a gloo group on the host)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(axes) != len(shape) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} needs as many distinct axis "
                         f"names, got {axes}")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} holds {math.prod(shape)} ranks but "
                         f"the process group has {world}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)

