"""Hand-written CUDA kernels of the port (Hopper, ``sm_90a``) and their
plain PyTorch versions.

``fused_cache_mttkrp`` / ``fused_mttkrp_flat`` run the whole BLCO MTTKRP
pipeline as one kernel launch per call (K1 ``segment`` or K2 ``stash``);
the kernels are built with ``nvcc`` at first use (``build.py``)."""
from .fused import (STASH_MAX_BYTES, STASH_MAX_ROWS, VARIANTS,
                    fused_cache_mttkrp, fused_mttkrp_flat, launch_counts,
                    reset_launch_counts)

__all__ = ["STASH_MAX_BYTES", "STASH_MAX_ROWS", "VARIANTS",
           "fused_cache_mttkrp", "fused_mttkrp_flat", "launch_counts",
           "reset_launch_counts"]
