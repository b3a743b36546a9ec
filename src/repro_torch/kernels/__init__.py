"""Hand-written CUDA kernels of the port (Hopper, ``sm_90a``) and their
plain PyTorch versions.

``fused_cache_mttkrp`` / ``fused_mttkrp_flat`` run the whole BLCO MTTKRP
pipeline as one kernel launch per call (K1 ``segment`` or K2 ``stash``).
``delinearize`` (K3), ``mttkrp_segments`` (K4) and ``mttkrp_stash`` (K5)
are the kernels of the three-phase pipeline, ``cuda_mttkrp_phases``;
``cuda_mttkrp`` is the fused path over a BLCO tensor.  The kernels are built
with ``nvcc`` at first use (``build.py``); ``launch_counts`` counts each
kernel's launches on the card.
"""
from .blco_mttkrp import mttkrp_segments, mttkrp_stash
from .common import STASH_MAX_BYTES, launch_counts, reset_launch_counts
from .delinearize import delinearize
from .fused import (STASH_MAX_ROWS, VARIANTS, fused_cache_mttkrp,
                    fused_mttkrp_flat)
from .ops import cuda_mttkrp, cuda_mttkrp_phases

__all__ = ["STASH_MAX_BYTES", "STASH_MAX_ROWS", "VARIANTS",
           "cuda_mttkrp", "cuda_mttkrp_phases", "delinearize",
           "fused_cache_mttkrp", "fused_mttkrp_flat", "launch_counts",
           "mttkrp_segments", "mttkrp_stash", "reset_launch_counts"]
