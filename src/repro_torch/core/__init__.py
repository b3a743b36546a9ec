"""Core library of the PyTorch port: BLCO format, mode-agnostic MTTKRP,
launch cache, CP-ALS and out-of-memory streaming (the paper's in-memory
and out-of-memory regimes), the MTTKRP sharded over a mesh of
``torch.distributed`` ranks, the baselines it is compared against, and
the embedding-gradient accumulation (sort + segment) of the LM path."""
from .tensor import (SparseTensor, from_coo, load_tns, paper_like,
                     random_tensor, top_up_uniform)
from .blco import BLCOTensor, build_blco, decode_coords, format_bytes
from .mttkrp import (DEFAULT_COPIES, KERNELS, DeviceBLCO, choose_resolution,
                     clear_launch_cache, khatri_rao, launch_cache_for,
                     launch_mttkrp_impl, mttkrp, mttkrp_dense_oracle,
                     mttkrp_per_launch, validate_kernel)
from .launches import LaunchCache, launch_cache_bytes, stacked_mttkrp
from .counters import dispatch_count
from .baselines import (COOFormat, CSFFormat, FCOOFormat, coo_mttkrp,
                        csf_mttkrp, fcoo_mttkrp)
from .cp_als import (CPResult, CPState, as_mttkrp_fn, cp_als, cp_als_init,
                     cp_als_step, init_factors, reconstruct_dense)
from .streaming import (EngineStats, LaunchChunks, OOMExecutor,
                        ReservationSpec, StreamBuffers, StreamStats,
                        reservation_for, stream_mttkrp)
from .distributed import make_distributed_mttkrp, shard_launch_arrays
from .embed_grad import embedding_lookup

__all__ = [
    "SparseTensor", "random_tensor", "top_up_uniform", "from_coo",
    "load_tns", "paper_like",
    "BLCOTensor", "build_blco", "decode_coords", "format_bytes",
    "DEFAULT_COPIES", "KERNELS", "DeviceBLCO", "choose_resolution",
    "khatri_rao", "launch_mttkrp_impl", "mttkrp_dense_oracle",
    "validate_kernel", "launch_cache_for", "clear_launch_cache", "mttkrp",
    "mttkrp_per_launch",
    "LaunchCache", "launch_cache_bytes", "stacked_mttkrp", "dispatch_count",
    "COOFormat", "coo_mttkrp", "FCOOFormat", "fcoo_mttkrp",
    "CSFFormat", "csf_mttkrp",
    "CPResult", "CPState", "as_mttkrp_fn", "cp_als", "cp_als_init",
    "cp_als_step", "init_factors", "reconstruct_dense",
    "EngineStats", "LaunchChunks", "OOMExecutor", "ReservationSpec",
    "StreamBuffers", "StreamStats", "reservation_for", "stream_mttkrp",
    "make_distributed_mttkrp", "shard_launch_arrays", "embedding_lookup",
]
