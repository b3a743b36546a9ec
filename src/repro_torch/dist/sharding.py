"""Parameter sharding rules: shape-only ZeRO/TP partition-spec planning,
the port's counterpart of ``repro.dist.sharding``.

Every rule keys on the parameter's *path* and *shape* alone, so a layout
for a 256- or 512-rank mesh is planned from ``meta`` tensors, with no
process group and no allocation.

Rules, as in the reference:

* layer-stacked parameters (top-level groups named ``*_layers``, plus the
  per-site LoRA stack) are never sharded on their leading stack dims —
  those dims are looped over, not matmul dims;
* one dim per parameter is sharded over the data/ZeRO axes (``data``, or
  ``(pod, data)``): the largest dim the axis-size product divides;
* tiny parameters stay replicated.

The reference stacks a layer group's tensors on leading axes as one leaf
(``dense_layers/attn/wq/w`` of shape ``(L, d, h)``); the port keeps one
tensor per layer (``dense_layers.<i>.attn.wq.w``), and the hybrid's
``group_layers.<g>.<i>`` stands for two stack dims.  So the rules run on
the reference's leaf, its stacked shape rebuilt from the port's names
(``reference_leaves``): ``MIN_SHARD_ELEMS`` is a bound on the whole
stack, and a per-layer tensor below it whose stack is above it is sharded
as the reference shards it.  Each layer's tensor then takes the leaf
spec's dims after the stack dims.

A spec is a tuple with one entry per dim: ``None``, a mesh axis name, or
a tuple of names (``("pod", "data")``), as a ``PartitionSpec`` reads.
``placements`` turns it into ``torch.distributed.tensor`` placements on a
``DeviceMesh``.
"""
from __future__ import annotations

import math
import re

# Production axis extents (launch/mesh.py: 16x16 single pod, 2x16x16
# multi-pod) — used for shape-only planning when no live mesh is given.
PLAN_AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}

# Parameters smaller than this many elements stay replicated.
MIN_SHARD_ELEMS = 1 << 14


def axis_sizes(mesh) -> dict:
    """``{axis name: extent}`` of a ``DeviceMesh`` (or anything with its
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def fsdp_axes(mesh) -> tuple[str, ...]:
    """All data-parallel/ZeRO axes of a mesh: every axis except ``model``."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def _n_stack_dims(path: str) -> int:
    """Leading dims that index stacked layers, never sharded."""
    top = path.split("/", 1)[0]
    if top == "group_layers":
        return 2                      # (group, layer-in-group, ...)
    if top.endswith("_layers") or top == "site_lora":
        return 1
    return 0


def reference_leaves(named: dict) -> dict:
    """The reference's leaves, the counterpart of its ``tree_paths``:
    ``{"a/b/c": (stacked shape, [state-dict names in stack order])}`` from
    tensors (or anything with a ``shape``) by state-dict name.  A name's
    digit parts index the stack: ``dense_layers.3.attn.wq.w`` is layer 3
    of ``dense_layers/attn/wq/w``, ``group_layers.1.2.mamba.A_log`` is
    (group 1, layer 2) of ``group_layers/mamba/A_log``."""
    groups: dict[str, list] = {}
    for name, t in named.items():
        parts = name.split(".")
        path = "/".join(p for p in parts if not p.isdigit())
        index = tuple(int(p) for p in parts if p.isdigit())
        groups.setdefault(path, []).append((index, name, tuple(t.shape)))
    out = {}
    for path, members in groups.items():
        members.sort()
        index, _, shape = members[0]
        stack = tuple(max(m[0][i] for m in members) + 1
                      for i in range(len(index)))
        if math.prod(stack) != len(members):
            raise ValueError(f"{path}: the layers {[m[1] for m in members]} "
                             f"do not fill a {stack} stack")
        out[path] = (stack + shape, [m[1] for m in members])
    return out


def param_spec(path: str, shape, fsdp, *, axis_sizes=None) -> tuple:
    """The spec of one reference leaf: shard one dim over the given axes.

    ``fsdp``: a mesh axis name or tuple of names (the ZeRO axes; also used
    with ``("model",)`` for TP-style serving layouts). ``axis_sizes`` maps
    axis name -> extent; defaults to the production mesh extents so the
    spec is computable from shapes alone.
    """
    axes = (fsdp,) if isinstance(fsdp, str) else tuple(fsdp)
    sizes = axis_sizes or PLAN_AXIS_SIZES
    size = math.prod(sizes[a] for a in axes) if axes else 0
    spec = [None] * len(shape)
    if size <= 1 or math.prod(shape) < MIN_SHARD_ELEMS:
        return tuple(spec)
    best = None
    for d in range(_n_stack_dims(path), len(shape)):
        if shape[d] % size == 0 and (best is None or shape[d] > shape[best]):
            best = d
    if best is not None:
        spec[best] = axes if len(axes) > 1 else axes[0]
    return tuple(spec)


def leaf_specs(mesh, named: dict, *, mode: str = "train") -> dict:
    """``{reference leaf path: spec of its stacked shape}``.

    mode="train": ZeRO — shard over the data axes (gradients/optimizer
    states follow the same layout). mode="serve": prefer TP — weights stay
    sharded over ``model`` where divisible, falling back to the data axes
    otherwise.
    """
    sizes = axis_sizes(mesh)
    f = fsdp_axes(mesh)
    preference = [("model",), f] if mode == "serve" else [f]

    def one(path, shape):
        for axes in preference:
            spec = param_spec(path, shape, axes, axis_sizes=sizes)
            if any(ax is not None for ax in spec):
                return spec
        return ()

    return {path: one(path, shape)
            for path, (shape, _) in reference_leaves(named).items()}


def param_shardings(mesh, named: dict, *, mode: str = "train") -> dict:
    """``{state-dict name: spec}`` for a model's parameters (or an
    optimizer moment by the same names): each tensor takes its reference
    leaf's spec without the leaf's stack dims (``()``: replicated)."""
    specs = leaf_specs(mesh, named, mode=mode)
    out = {}
    for path, (_, names) in reference_leaves(named).items():
        spec = specs[path][_n_stack_dims(path):]
        for name in names:
            out[name] = spec
    return out


def placements(mesh, spec) -> list:
    """``spec`` as ``torch.distributed.tensor`` placements on ``mesh``:
    for each mesh dim, ``Shard(d)`` if the spec names its axis on tensor
    dim ``d``, else ``Replicate()``.  A tuple ``("pod", "data")`` on one
    dim shards it on both mesh dims, pod-major, as a ``PartitionSpec``
    splits it: ``DTensor`` splits a dim over its mesh dims in mesh order,
    and ``fsdp_axes`` lists them in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {}
    for d, ax in enumerate(spec):
        for a in (() if ax is None else (ax,) if isinstance(ax, str)
                  else ax):
            owner[a] = d
    return [Shard(owner[a]) if a in owner else Replicate()
            for a in mesh.mesh_dim_names]


def block(full, mesh, place):
    """This rank's block of ``full`` under the placements ``place`` (a
    view: the chunk of its coordinate along each mesh dim that shards a
    tensor dim, in mesh order)."""
    from torch.distributed.tensor import Shard
    local = full
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(i), dim=p.dim)[
                mesh.get_local_rank(mesh.mesh_dim_names[i])]
    return local


def distribute(full, mesh, spec):
    """This rank's block of ``full`` (every rank holds the same values) as
    a ``DTensor`` with ``spec``'s placements, with no collective: a copy
    where the spec shards a dim (so ``full`` can go), ``full`` itself
    where it shards none."""
    import torch
    from torch.distributed.tensor import DTensor, Shard
    place = placements(mesh, spec)
    local = full.detach()
    if any(isinstance(p, Shard) for p in place):
        local = block(local, mesh, place).clone()
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=full.shape,
                              stride=torch.empty(full.shape,
                                                 device="meta").stride())


def gather(t):
    """The whole tensor of a ``DTensor`` on every rank, detached: its local
    block gathered over each mesh dim that shards it, the innermost first,
    by list-form ``all_gather`` (which gloo also takes for CUDA tensors;
    ``DTensor.full_tensor`` crashes there).  A replicated ``DTensor``'s
    block, or a plain tensor, is not copied."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return t.detach()
    mesh, local = t.device_mesh, t.to_local().detach()
    for axis, p in reversed(list(zip(mesh.mesh_dim_names, t.placements))):
        if isinstance(p, Shard):
            group = mesh.get_group(axis)
            parts = [torch.empty_like(local)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, local.contiguous(), group=group)
            local = torch.cat(parts, dim=p.dim)
    return local


# the leaves a tensor-parallel rank splits, by state-dict name: (the
# reference's anchor the split follows, the dim of this rank's block)
_LAYER = r"^(dense_layers|moe_layers|enc_layers|dec_layers)\.\d+\."
_ATTN = r"(" + _LAYER + r"(attn|xattn)|^shared_attn\.attn)\."
_MLP = r"(" + _LAYER + r"|^shared_attn\.)mlp\."
_SSD = r"^(ssm_layers|pre_layers|group_layers)\.\d+\.(\d+\.)?mamba\."
_TP_LEAVES = (
    ("heads", re.compile(_ATTN + r"w(q|k|v|uq)\.w$"), 1),
    ("heads", re.compile(_ATTN + r"w[qkv]\.b$"), 0),
    ("heads", re.compile(_ATTN + r"wo\.w$"), 0),
    ("heads", re.compile(r"^site_lora\.\d+\.[qkv]\.b$"), 1),
    ("latent", re.compile(_LAYER + r"attn\.wu[kv]\.w$"), 1),
    ("mlp", re.compile(_MLP + r"w[ig]\.w$"), 1),
    ("mlp", re.compile(_MLP + r"wo\.w$"), 0),
    ("ssd", re.compile(_SSD + r"(A_log|D|dt_bias|norm\.scale|out_proj\.w)$"),
     0),
    ("experts", re.compile(r"^moe_layers\.\d+\.moe\.w[igo]\.w$"), 0),
    ("vocab", re.compile(r"^lm_head\.w$"), 1),
    ("table", re.compile(r"^embed\.table$"), 0),
)


def tp_blocks(named: dict, cfg, mesh, *, mode: str = "serve") -> dict:
    """``{state-dict name: dim}`` of the leaves a rank computes with as its
    block over ``model`` (``dim`` the split one, the block
    ``chunk(m, dim)[model rank]``), ``None`` for a leaf it computes with
    whole.  Shape-only: ``mesh`` needs its axis names and extents.

    * the attentions' ``wq``, ``wk``, ``wv`` (and their biases; MLA's
      ``wuq``; the enc-dec's cross-attention; the hybrid's shared block
      and each site's LoRA ``b``) by columns, in KV-head groups, and
      their ``wo`` by rows, where the KV heads divide the axis (the
      ``"heads"`` layout); in the ``"rows"`` layout they are whole, and
      so is each site's LoRA ``a``;
    * MLA's ``wuk`` and ``wuv`` by head columns in training; a serving
      rank holds them whole (design (a)): its prefill takes their head
      columns and its absorbed decode their latent rows, views of one
      tensor, where head blocks would need ``q_eff`` and ``ctx``
      exchanged over ``model`` in every decode step;
    * the MLPs' ``wi`` and ``wg`` by columns and their ``wo`` by rows;
    * the SSD's ``A_log``, ``D``, ``dt_bias`` and norm scale on this
      rank's heads and ``out_proj`` by rows, where the heads divide the
      axis; the fused ``in_proj`` and the conv stay whole (their
      ``[z | x | B | C | dt]`` segments are no one block per rank, and
      every rank reads all of B and C: ``ssm._tp_projections``);
    * the routed experts' stacks (E, ., .) on their expert dim: this
      rank's E / m experts, as ``moe_apply_sharded`` runs them;
    * ``lm_head`` by vocab columns; ``embed.table`` by vocab rows when
      serving (a vocab-parallel lookup, and the tied head), whole in
      training, where the lookup reads it whole and the tied head takes
      its rows (``tensor_parallel.scatter``);
    * everything else whole: the norms, ``frontend_proj``, MLA's ``wdq``,
      ``wdkv`` and ``wkr``, the router and the shared experts."""
    from .tensor_parallel import plan
    tp = plan(cfg, mesh)
    out = dict.fromkeys(named)
    if tp is None:
        return out
    split = {"heads": tp.heads, "latent": tp.heads and mode == "train",
             "mlp": tp.mlp, "ssd": tp.ssd, "vocab": tp.vocab,
             "table": mode == "serve" and tp.vocab,
             "experts": bool(cfg.moe) and cfg.num_experts % tp.size == 0}
    for name in named:
        for anchor, pattern, dim in _TP_LEAVES:
            if split[anchor] and pattern.match(name):
                out[name] = dim
    return out
