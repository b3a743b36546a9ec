"""Mode-agnostic BLCO MTTKRP with opportunistic conflict resolution (paper §5).

The port of ``repro.core.mttkrp``.  One implementation serves every mode.
Per launch the dataflow is the paper's two phases:

  processing phase: (hi, lo) stored indices -> shift+mask de-linearization of
      every mode (§5.1.1);
  computing phase:  gather non-target factor rows -> hadamard x value ->
      on-the-fly segment discovery on the target-index stream -> segmented
      reduction -> one update per *segment* (not per nnz) into the output
      (§5.1.2), either directly ("register" resolution, §5.2) or via C partial
      copies merged at the end ("hierarchical" resolution, §5.1 steps 5-7).

``launch_mttkrp_impl`` is the plain PyTorch reference dataflow
(``kernel="torch"``, the counterpart of the JAX package's ``"xla"``);
``repro_torch.kernels.fused`` holds the fused CUDA kernel (``kernel="cuda"``,
the counterpart of ``"pallas"``).  Both are held against the dense
matricization oracle in the tests.

The free-function API: ``mttkrp`` pads the launches ONCE into a
device-resident ``LaunchCache`` attached to the tensor
(``launch_cache_for``; ``clear_launch_cache`` drops it) and runs the plain
dataflow over it; ``mttkrp_per_launch`` keeps the per-launch loop — one host
padding pass and one dispatch per launch per call — as the exact-shape
``pad=False`` oracle and the baseline the single-dispatch paths are
measured against.
"""
from __future__ import annotations

import numpy as np
import torch

from . import u64
from .blco import BLCOTensor
from .counters import record_dispatch
from .device import DEFAULT_DEVICE, resolve_device
from .padding import pad_pow2

# The paper's "#SMs" constant in the §5.3 heuristic: below this target-mode
# length, update contention dominates and the hierarchical (multi-copy)
# mechanism wins; above it, direct per-segment updates win.
CONTENTION_THRESHOLD = 128
DEFAULT_COPIES = 8

KERNELS = ("torch", "cuda")


def validate_kernel(kernel: str) -> str:
    """Reject unknown compute-kernel names (one validator for every layer)."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of "
                         f"{KERNELS}")
    return kernel


def choose_resolution(mode_len: int, threshold: int = CONTENTION_THRESHOLD) -> str:
    """Paper §5.3 adaptation heuristic."""
    return "hierarchical" if mode_len < threshold else "register"


def delinearize(re_fields, re_shifts, idx_hi, idx_lo):
    """All mode coordinates (int64, no block base) from (hi, lo) uint32 words;
    the words are widened to int64 once."""
    x = u64.widen(idx_hi, idx_lo)
    return [u64.field(x, shift, width)
            for shift, width in zip(re_shifts, re_fields)]


def partial_and_target(idx_hi, idx_lo, vals, bases, factors, *,
                       re_fields: tuple, re_shifts: tuple, mode: int):
    """The per-non-zero work every plain path shares: decode each mode's
    coordinate (field + block base), gather the N-1 non-target factor rows
    and multiply them with the value at ``promote_types(vals, factors)``.
    Returns ``(partial (T, R), tgt (T,) int64)``."""
    coords = delinearize(re_fields, re_shifts, idx_hi, idx_lo)
    coords = [c + bases[:, n] for n, c in enumerate(coords)]

    # promote, never downcast: float64 values against float32 factors
    # accumulate in float64, on every kernel path
    dtype = torch.promote_types(vals.dtype, factors[0].dtype)
    partial = vals[:, None].to(dtype)
    for m, f in enumerate(factors):
        if m == mode:
            continue
        partial = partial * f.index_select(0, coords[m]).to(dtype)
    return partial, coords[mode]


def _segment_compress(tgt, partial):
    """On-the-fly segment discovery + segmented reduction (paper §5.1 steps 3-5).

    tgt: (T,) target-mode indices in ALTO order (runs of equal target, NOT
    sorted by target).  Returns (seg_tgt, seg_sums) of length T where only
    the first #segments rows are meaningful; the rest are (0, 0-rows).
    """
    n = tgt.shape[0]
    flags = torch.ones(n, dtype=torch.int64, device=tgt.device)
    flags[1:] = (tgt[1:] != tgt[:-1]).to(torch.int64)
    seg_id = torch.cumsum(flags, 0) - 1
    seg_sums = torch.zeros_like(partial).index_add_(0, seg_id, partial)
    seg_tgt = torch.zeros(n, dtype=tgt.dtype, device=tgt.device)
    seg_tgt.scatter_reduce_(0, seg_id, tgt, "amax")
    return seg_tgt, seg_sums


def launch_mttkrp_impl(idx_hi, idx_lo, vals, bases, factors, *,
                       re_fields: tuple, re_shifts: tuple, mode: int,
                       out_rows: int, resolution: str, copies: int):
    """One launch's MTTKRP dataflow in plain PyTorch.

    idx_hi/idx_lo: (T,) uint32 stored indices. vals: (T,). bases: (T, N) int32
    per-element block coordinate bases. factors: sequence of N (I_n, R)
    tensors. Returns the (out_rows, R) partial output at
    ``torch.promote_types(vals, factors)``.
    """
    partial, tgt = partial_and_target(idx_hi, idx_lo, vals, bases, factors,
                                      re_fields=re_fields,
                                      re_shifts=re_shifts, mode=mode)
    dtype = partial.dtype
    rank = partial.shape[1]

    if resolution == "direct":
        # per-nnz scatter (no conflict resolution) — the COO dataflow
        out = torch.zeros((out_rows, rank), dtype=dtype, device=partial.device)
        return out.index_add_(0, tgt, partial)

    seg_tgt, seg_sums = _segment_compress(tgt, partial)

    if resolution == "register":
        out = torch.zeros((out_rows, rank), dtype=dtype, device=partial.device)
        return out.index_add_(0, seg_tgt, seg_sums)
    if resolution == "hierarchical":
        # spread segments over C partial copies (paper's factor-matrix
        # copies, step 6) and merge (step 7)
        n = seg_tgt.shape[0]
        copy_id = torch.arange(n, device=partial.device) % copies
        out = torch.zeros((copies, out_rows, rank), dtype=dtype,
                          device=partial.device)
        # index_add_ over the flattened copies: on the CPU it adds in a
        # fixed order, where index_put_(accumulate=True) splits the
        # indices over threads and reorders the float additions run to run
        out.view(copies * out_rows, rank).index_add_(
            0, copy_id * out_rows + seg_tgt, seg_sums)
        return out.sum(dim=0)
    raise ValueError(f"unknown resolution {resolution!r}")


def _on_device(x: torch.device, want: torch.device) -> bool:
    return x.type == want.type and (want.index is None
                                    or x.index == want.index)


def launch_cache_for(blco: BLCOTensor, *, device=DEFAULT_DEVICE):
    """The tensor's attached device-resident launch cache, built once (and
    built again if it was closed or lies on another device).

    It backs the free-function ``mttkrp`` and the ``repro_torch.kernels.ops``
    wrappers only; engine plans build and own their own cache.  Call
    :func:`clear_launch_cache` to release it.
    """
    from .launches import LaunchCache
    dev = resolve_device(device)
    cache = getattr(blco, "_launch_cache", None)
    if cache is None or cache.closed or not _on_device(cache.device, dev):
        cache = LaunchCache.from_blco(blco, device=dev)
        blco._launch_cache = cache
    return cache


def clear_launch_cache(blco: BLCOTensor) -> int:
    """Release the launch cache attached by ``launch_cache_for``; returns
    the device bytes freed (0 when none was attached)."""
    cache = getattr(blco, "_launch_cache", None)
    if cache is None:
        return 0
    freed = cache.device_bytes()
    cache.delete()
    blco._launch_cache = None
    return freed


def mttkrp(blco: BLCOTensor, factors, mode: int, *, resolution: str = "auto",
           copies: int = DEFAULT_COPIES, pad: bool = True, cache=None,
           device=DEFAULT_DEVICE):
    """Full mode-n MTTKRP over all launches of a BLCO tensor, plain PyTorch.

    factors: N (I_n, R) tensors on ``device``.  Returns (I_mode, R).  With
    ``pad=True`` the call runs over the attached launch cache (or
    ``cache=``), built once; ``pad=False`` is the exact-shape per-launch
    path (no padding slots).
    """
    if not 0 <= mode < blco.order:
        raise ValueError(f"mode {mode} out of range for order {blco.order}")
    if not pad:
        return mttkrp_per_launch(blco, factors, mode, resolution=resolution,
                                 copies=copies, pad=False, device=device)
    cache = cache if cache is not None else launch_cache_for(blco,
                                                             device=device)
    return cache.mttkrp(factors, mode, resolution=resolution, copies=copies)


def mttkrp_per_launch(blco: BLCOTensor, factors, mode: int, *,
                      resolution: str = "auto", copies: int = DEFAULT_COPIES,
                      pad: bool = True, device=DEFAULT_DEVICE):
    """One host padding pass (to a power of two, or none with ``pad=False``)
    + one upload + one plain dispatch PER LAUNCH per call; one dispatch is
    recorded per launch."""
    if not 0 <= mode < blco.order:
        raise ValueError(f"mode {mode} out of range for order {blco.order}")
    dev = resolve_device(device)
    if resolution == "auto":
        resolution = choose_resolution(blco.dims[mode])
    factors = tuple(torch.as_tensor(f, device=dev) for f in factors)
    rank = factors[0].shape[1]
    dtype = torch.promote_types(torch.from_numpy(blco.values[:0]).dtype,
                                factors[0].dtype)
    out = torch.zeros((blco.dims[mode], rank), dtype=dtype, device=dev)
    bases_all = blco.block_upper_bases()           # (num_blocks, N)
    block_ids = blco.element_block_ids()           # (nnz,)
    for launch in blco.launches:
        s, e = launch.start, launch.end
        n = e - s
        padded = pad_pow2(n) if pad else n
        hi = np.zeros(padded, np.uint32)
        lo = np.zeros(padded, np.uint32)
        vals = np.zeros(padded, blco.values.dtype)
        bases = np.zeros((padded, blco.order), np.int32)
        hi[:n] = blco.idx_hi[s:e]
        lo[:n] = blco.idx_lo[s:e]
        vals[:n] = blco.values[s:e]
        bases[:n] = bases_all[block_ids[s:e]]
        record_dispatch()
        out = out + launch_mttkrp_impl(
            *(torch.from_numpy(a).to(dev) for a in (hi, lo, vals, bases)),
            factors, re_fields=blco.re.field_bits,
            re_shifts=blco.re.field_shift, mode=mode,
            out_rows=blco.dims[mode], resolution=resolution, copies=copies)
    return out


class DeviceBLCO:
    """Device-resident BLCO tensor (the paper's in-memory regime).

    The padded launches are uploaded once into a stacked
    :class:`~repro_torch.core.launches.LaunchCache`; every ``mttkrp`` call is
    then either one fused CUDA kernel launch (``kernel="cuda"``) or the
    plain PyTorch dataflow looped over the launches (``kernel="torch"``).
    """

    def __init__(self, blco: BLCOTensor, *, kernel: str = "cuda",
                 device=DEFAULT_DEVICE):
        from .launches import LaunchCache
        validate_kernel(kernel)
        self.cache = LaunchCache.from_blco(blco, device=device)
        self.dims = blco.dims
        self.order = blco.order
        self.kernel = kernel

    @property
    def device(self) -> torch.device:
        return self.cache.device

    def device_bytes(self) -> int:
        """Exact device footprint: hi + lo + vals + bases (stacked, padded)."""
        return self.cache.device_bytes()

    def mttkrp(self, factors, mode: int, *, resolution: str = "auto",
               copies: int = DEFAULT_COPIES, kernel: str | None = None):
        kernel = validate_kernel(kernel if kernel is not None else self.kernel)
        if kernel == "cuda":
            from repro_torch.kernels.fused import fused_cache_mttkrp
            return fused_cache_mttkrp(self.cache, factors, mode,
                                      resolution=resolution)
        return self.cache.mttkrp(factors, mode, resolution=resolution,
                                 copies=copies)

    def delete(self) -> None:
        """Release the device buffers (the cache must not be used after)."""
        self.cache.delete()


# --------------------------------------------------------------------- oracle
def khatri_rao(mats) -> np.ndarray:
    """Column-wise Kronecker product of a list of (I_n, R) matrices."""
    out = mats[0]
    for m in mats[1:]:
        r = out.shape[1]
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, r)
    return out


def mttkrp_dense_oracle(t, factors, mode: int) -> np.ndarray:
    """Dense-matricization oracle: X_(n) @ KR(...) over the non-target modes.

    ``SparseTensor.matricize`` uses a C-order reshape (highest remaining
    mode varies fastest), so the KR list is ascending (lowest mode listed
    first = slowest-varying).  ``factors`` are numpy arrays or tensors.
    """
    xs = t.matricize(mode).astype(np.float64)
    others = [_as_numpy(factors[m]).astype(np.float64)
              for m in range(len(factors)) if m != mode]
    kr = khatri_rao(others)
    return xs @ kr


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
