"""Where the port's entry points put their tensors.

Every entry point takes ``device=`` and defaults to ``"cuda"``: the port
runs on the card unless the caller asks for the CPU, as the tests do.  A
request for the card on a machine without one raises here, before any
work; nothing falls back to the CPU.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names an absent card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            f"pass device='cpu' to run the plain PyTorch path")
    return dev
