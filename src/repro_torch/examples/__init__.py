"""The port's counterparts of the JAX package's TD examples, one module
each, run as ``python -m repro_torch.examples.<name>``:

    quickstart          BLCO build, ``plan_for``, one MTTKRP, 15 CP-ALS sweeps
    oom_decomposition   the streamed regime under a budget below the tensor
    serve_td            the multi-tenant service, the async runtime and a
                        kill -> snapshot -> restore -> resume
    distributed_cpals   CP-ALS over a (4, 2) ``("data", "model")`` mesh of
                        eight ``torch.distributed`` ranks

Each has ``main(argv=None) -> int`` and the reference script's sizes and
seeds.  Each takes ``--device`` (the card by default; ``cpu`` runs the
plain ``kernel="torch"`` path), the port's spelling of ``device=``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.device import DEFAULT_DEVICE


def device_parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser described by ``doc``'s first line, with the
    entry points' one flag, ``--device``."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where the tensors live: 'cuda' (default; K1/K2 "
                         "on the card) or 'cpu' (the plain PyTorch path)")
    return ap


def require(cond, what) -> None:
    """The examples' checks: raise ``AssertionError(what)`` unless ``cond``
    (kept under ``python -O``, which strips ``assert``)."""
    if not cond:
        raise AssertionError(what)


def kernel_for(device) -> str:
    """The compute path for ``device``: the fused kernels on the card, the
    plain PyTorch versions on the CPU."""
    return "torch" if torch.device(device).type == "cpu" else "cuda"
