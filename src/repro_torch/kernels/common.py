"""What every kernel wrapper shares: the launch counters, the limits and
dtype pairs of the C interfaces, and the checks made before a pointer is
handed to a kernel."""
from __future__ import annotations

import torch

# one counter per kernel: K1, K2 (fused.py), K3 (delinearize.py), K4, K5
# (blco_mttkrp.py).  A wrapper adds one where it launches its kernel, on the
# card only; the plain versions that CPU tensors take count nothing.
KERNEL_NAMES = ("segment", "stash", "delinearize", "segments", "stash_phases")
launch_counts = {k: 0 for k in KERNEL_NAMES}

# (values dtype, factor or gathered-row dtype) -> the C interfaces'
# dtype_pair code; sums are at promote_types of the two
DTYPE_PAIRS = {
    (torch.float32, torch.float32): 0,
    (torch.float64, torch.float64): 1,
    (torch.float64, torch.float32): 2,
}
MAX_ORDER = 8                   # MAX_ORDER in csrc/fields.cuh
STASH_MAX_BYTES = 227 * 1024    # one CTA's shared memory on Hopper


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNEL_NAMES:
        launch_counts[k] = 0


def one_device(*tensors) -> torch.device:
    """The device all ``tensors`` lie on; raises if they lie on several."""
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    return devices.pop()


def check_dtype_pair(vals, rows) -> None:
    if (vals.dtype, rows.dtype) not in DTYPE_PAIRS:
        raise TypeError(f"unsupported (vals, factors) dtypes "
                        f"({vals.dtype}, {rows.dtype}); the kernel "
                        f"takes {sorted(map(str, DTYPE_PAIRS))}")


def check_contiguous(*tensors) -> None:
    for x in tensors:
        if not x.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def device_index(device: torch.device) -> int:
    """The CUDA ordinal of ``device``; the current one where it names none."""
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def raise_on_error(err: int, error_string, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{error_string(err).decode()} (cudaError {err})")
