"""Production meshes: the port's counterpart of ``repro.launch.mesh``.

Single pod: 16 x 16 = 256 ranks, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 ranks, axes (pod, data, model) — the `pod`
axis carries only data parallelism + ZeRO sharding (cross-pod traffic is
gradient reduction and parameter gathers only).

Both are ``repro_torch.dist.make_mesh`` over the default process group,
which the caller initialises with as many ranks as the mesh holds
(``make_mesh`` raises a ``ValueError`` naming both counts otherwise).
"""
from __future__ import annotations

from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.dist import make_mesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device=DEFAULT_DEVICE):
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes, device=device)


def make_test_mesh(shape=(4, 2), axes=("data", "model"), *,
                   device=DEFAULT_DEVICE):
    """Small mesh for tests (gloo ranks on the host, or on one card)."""
    return make_mesh(shape, axes, device=device)
