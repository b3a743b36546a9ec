"""Distributed sparse MTTKRP / CP-ALS over a mesh of ``torch.distributed``
ranks.

The port of ``repro.core.distributed``.  BLCO is list-based and
mode-agnostic, so its format scales out over a 2-D mesh
(``repro_torch.dist.make_mesh``):

* **nnz parallelism (data axis)** — the sorted nnz stream is
  range-partitioned into equal, zero-padded shards
  (``shard_launch_arrays``); each rank holds the shard of its data
  coordinate, runs the mode-agnostic MTTKRP on it, and the per-mode
  outputs are merged with one ``all_reduce`` over the data axis.  Partials
  are segment-compressed before the collective, so its payload is
  O(I_mode x R / M), independent of nnz.
* **rank parallelism (model axis)** — MTTKRP columns are independent: each
  rank computes the column block of its model coordinate, and one
  ``all_gather`` over the model axis reassembles the full (I_mode, R)
  output on every rank.

Every rank returns the same output, so CP-ALS (``core.cp_als``) runs
unchanged and identically on every rank.  ``kernel="cuda"`` runs the fused
K1/K2 kernel on each shard (``kernels.fused.fused_mttkrp_flat``: one
launch per rank per call); ``kernel="torch"`` is the reference's per-shard
dataflow in plain PyTorch.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .blco import BLCOTensor
from .device import DEFAULT_DEVICE, resolve_device
from .mttkrp import _segment_compress, partial_and_target, validate_kernel


def _axis_names(axis) -> tuple:
    """``axis`` as a tuple of mesh axis names (one name, or a tuple)."""
    return tuple(axis) if isinstance(axis, tuple) else (axis,)


def axis_size(mesh, axis) -> int:
    """Ranks along ``axis`` of ``mesh`` (a ``DeviceMesh``, or anything with
    its ``shape`` and ``mesh_dim_names``): one name, or a tuple of names
    whose sizes multiply, as the reference's ``data_axis`` may be."""
    names = tuple(mesh.mesh_dim_names or ())
    axes = _axis_names(axis)
    if len(set(axes)) != len(axes):
        raise ValueError(f"axis {axis!r} names an axis twice")
    size = 1
    for a in axes:
        if a not in names:
            raise ValueError(f"mesh has no axis {a!r}; its axes are "
                             f"{names}")
        size *= int(mesh.shape[names.index(a)])
    return size


#: where ``axis_group`` keeps a mesh's flattened groups: on the mesh
_FLAT_GROUPS = "_repro_flat_groups"


def axis_group(mesh, axis):
    """``(process group, this rank's coordinate)`` along ``axis``.

    One name is the mesh's own group and coordinate.  A tuple of names is
    flattened row-major in the order listed (the first name varies
    slowest), as the reference's ``P(data_axis)`` splits the leading dim:
    ``("pod", "data")`` puts pod first.  Its groups are made with
    ``dist.new_group`` once per mesh and tuple, every group by every rank
    in the same order (a rank outside a group still takes part in making
    it), and kept on the mesh until ``release_axis_groups`` destroys them
    (``repro_torch.dist.set_mesh`` does so when it replaces the mesh).
    """
    axes = _axis_names(axis)
    if len(axes) == 1:
        return mesh.get_group(axes[0]), mesh.get_local_rank(axes[0])
    size = axis_size(mesh, axes)                    # checks the names
    made = mesh.__dict__.setdefault(_FLAT_GROUPS, {})
    if axes not in made:
        names = tuple(mesh.mesh_dim_names)
        flat = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in flat]
        rows = mesh.mesh.permute(rest + flat).reshape(-1, size).tolist()
        made[axes] = [(row, dist.new_group(row)) for row in rows]
    me = dist.get_rank()
    for row, group in made[axes]:
        if me in row:
            return group, row.index(me)
    raise ValueError(f"rank {me} is not in the mesh")


def release_axis_groups(mesh) -> int:
    """Destroy the flattened groups ``axis_group`` made for ``mesh``;
    returns how many this rank destroyed.  Every rank releases in the
    same order.  After the default group is destroyed they are gone
    already, and are only forgotten."""
    made = mesh.__dict__.pop(_FLAT_GROUPS, {})
    destroyed = 0
    if dist.is_initialized():
        for pairs in made.values():
            for _, group in pairs:
                if group != dist.GroupMember.NON_GROUP_MEMBER:
                    dist.destroy_process_group(group)
                    destroyed += 1
    return destroyed


def slot_bytes(blco: BLCOTensor) -> int:
    """Device bytes of one shard slot: hi + lo + value + N int32 bases."""
    return 4 + 4 + blco.values.dtype.itemsize + 4 * blco.order


def shard_slots(nnz: int, num_shards: int) -> int:
    """Slots per shard: ``ceil(nnz / num_shards)``."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be at least 1, got {num_shards}")
    return -(-nnz // num_shards)


def _fill(blco: BLCOTensor, start: int, end: int, slots: int) -> dict:
    """Elements ``[start, end)`` of the nnz stream in ``slots`` zeroed slots
    (hi, lo, value, per-element block base)."""
    n = end - start
    hi = np.zeros(slots, np.uint32)
    lo = np.zeros(slots, np.uint32)
    vals = np.zeros(slots, blco.values.dtype)
    bases = np.zeros((slots, blco.order), np.int32)
    hi[:n] = blco.idx_hi[start:end]
    lo[:n] = blco.idx_lo[start:end]
    vals[:n] = blco.values[start:end]
    upper = blco.block_upper_bases()
    for i, b in enumerate(blco.blocks):
        s, e = max(b.start, start), min(b.end, end)
        if s < e:
            bases[s - start:e - start] = upper[i]
    return {"idx_hi": hi, "idx_lo": lo, "vals": vals, "bases": bases}


def shard_launch_arrays(blco: BLCOTensor, num_shards: int, *,
                        shard: int | None = None) -> dict:
    """Range-partition the nnz stream into equal padded shards (host side).

    Returns the dict of ``(num_shards, per)`` arrays (``bases``
    ``(num_shards, per, N)``) of the reference, array for array: shard
    ``d`` holds elements ``[d * per, (d + 1) * per)``, ``per = ceil(nnz /
    num_shards)``, and the tail is zero padding (value 0 at coordinate 0
    with base 0, a +0.0 update to row 0).  With ``shard=d`` only row ``d``
    is built, as ``(per,)`` and ``(per, N)`` arrays, so a rank never holds
    the other shards on the host.  A shard boundary may split a run of
    equal target: that only makes one more update.
    """
    n = blco.nnz
    per = shard_slots(n, num_shards)
    if shard is None:
        full = _fill(blco, 0, n, per * num_shards)
        return {k: v.reshape((num_shards, per) + v.shape[1:])
                for k, v in full.items()}
    if not 0 <= shard < num_shards:
        raise ValueError(f"shard {shard} outside 0..{num_shards - 1}")
    return _fill(blco, min(shard * per, n), min((shard + 1) * per, n), per)


def make_distributed_mttkrp(blco: BLCOTensor, mesh, *, data_axis="data",
                            model_axis="model", kernel: str = "cuda",
                            device=DEFAULT_DEVICE):
    """Build ``run(factors, mode)``, the mode-n MTTKRP sharded over ``mesh``
    (a ``DeviceMesh`` from ``repro_torch.dist.make_mesh``).

    The nnz stream is range-partitioned over ``data_axis`` (one name, or a
    tuple of names flattened row-major as ``axis_group`` says) and
    replicated over ``model_axis``: this rank uploads the shard of its data coordinate
    once, to ``device``.  ``run`` takes the full (I_n, R) factors, which
    every rank holds, computes the column block of its model coordinate on
    its shard, sums the shards with one ``all_reduce`` over the data axis
    and gathers the column blocks with one ``all_gather`` over the model
    axis; every rank returns the same (I_mode, R) tensor at
    ``promote_types(values, factors)``.  R must be a multiple of the model
    axis' size.
    """
    validate_kernel(kernel)
    dev = resolve_device(device)
    data_size = axis_size(mesh, data_axis)
    model_size = axis_size(mesh, model_axis)
    data_group, shard = axis_group(mesh, data_axis)
    model_group, col = axis_group(mesh, model_axis)
    row = shard_launch_arrays(blco, data_size, shard=shard)
    hi, lo, vals, bases = (torch.from_numpy(row[k]).to(dev)
                           for k in ("idx_hi", "idx_lo", "vals", "bases"))
    del row
    dims, order = blco.dims, blco.order
    fields, shifts = blco.re.field_bits, blco.re.field_shift

    def run(factors, mode: int):
        factors = tuple(factors)
        if not 0 <= mode < order or len(factors) != order:
            raise ValueError(f"mode {mode} and {len(factors)} factors for "
                             f"an order-{order} tensor")
        rank = factors[0].shape[1]
        if rank % model_size:
            raise ValueError(f"rank {rank} is not a multiple of the "
                             f"{model_axis!r} axis' {model_size} ranks")
        out_dtype = torch.promote_types(vals.dtype, factors[0].dtype)
        if hi.shape[0] == 0:        # an empty tensor: no work on any rank
            return torch.zeros((dims[mode], rank), dtype=out_dtype,
                               device=factors[0].device)
        width = rank // model_size
        # K1 takes contiguous factors: the column block is copied (a no-op
        # where the model axis has one rank)
        block = [f[:, col * width:(col + 1) * width].contiguous()
                 for f in factors]
        if kernel == "cuda":
            from repro_torch.kernels.fused import fused_mttkrp_flat
            out = fused_mttkrp_flat(hi, lo, vals, bases, block,
                                    field_bits=fields, field_shifts=shifts,
                                    mode=mode, out_rows=dims[mode])
        else:
            partial, tgt = partial_and_target(hi, lo, vals, bases, block,
                                              re_fields=fields,
                                              re_shifts=shifts, mode=mode)
            seg_tgt, seg_sums = _segment_compress(tgt, partial)
            out = torch.zeros((dims[mode], width), dtype=out_dtype,
                              device=partial.device)
            out.index_add_(0, seg_tgt, seg_sums)
        # one collective per axis, payload O(I_mode x R / M)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=data_group)
        parts = [torch.empty_like(out) for _ in range(model_size)]
        dist.all_gather(parts, out, group=model_group)
        return torch.cat(parts, dim=1)

    return run
