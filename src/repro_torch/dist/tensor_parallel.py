"""Tensor parallelism over the mesh's ``model`` axis as per-rank code: the
port's stand-in for what GSPMD builds from the reference's ``constrain``
anchors.

The reference names a layout (``constrain(x, "dp", None, "tp")``) and
lets the compiler split the ops around it and insert the collectives.
The port runs one program per rank, so the model code itself computes
with this rank's block of each weight (``sharding.tp_blocks``) and calls
the collectives that layout implies, as Megatron writes them:

* ``copy_in``: the identity forward, an all-reduce of the gradient
  backward: the entry of a tensor every model rank holds whole into
  per-rank work (each rank's gradient is the part its block gives);
* ``reduce_out``: an all-reduce forward, the identity backward: the sum
  of the ranks' partials (a row-split matmul), whose gradient reaches
  each partial once;
* ``gather``: an all-gather along a dim forward, this rank's slice of
  the gradient backward (query rows back into the replicated residual);
* ``scatter``: this rank's slice forward, an all-gather of the gradient
  backward (a whole weight used as its block, the tied table's head).

Each is the exact identity, with no collective, on a ``model`` axis of
size 1.  ``plan`` decides what a config splits on a mesh, for every
family: the attention (GQA, MLA, the hybrid's shared block, the
enc-dec's three), the MLP's hidden, the SSD's heads and the vocab.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist

def tp_size(mesh) -> int:
    """The extent of ``mesh``'s ``model`` axis (1 without one)."""
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.shape[tuple(mesh.mesh_dim_names).index("model")])


def tp_rank(mesh) -> int:
    """This rank's coordinate on the ``model`` axis (0 without one)."""
    if tp_size(mesh) == 1:
        return 0
    return mesh.get_local_rank("model")


def tp_group(mesh):
    """The process group of this rank's ``model`` axis."""
    return mesh.get_group("model")


@dataclasses.dataclass(frozen=True)
class Plan:
    """What a config splits on a mesh: the one place the split is decided.
    ``heads``: the attention's KV heads (MLA's heads) divide the axis (the
    ``"heads"`` layout, else query rows or whole, ``context.tp_layout``);
    ``mlp``: the MLP's hidden does; ``ssd``: the SSD's heads do; ``vocab``:
    the padded vocab of the head and the table does; ``cache``: the
    attention cache's block as the reference's ``cache_specs`` picks it,
    ``"heads"``, ``"head_dim"``, or ``"length"`` (the rank's block of
    positions) where neither divides, ``"latent"`` for MLA's (the last dim
    of ``ckv`` and of ``kr``, each where it divides), ``"whole"`` without
    attention.  Shape-only: ``rank`` and ``group`` ask the mesh when first
    read."""
    mesh: object
    size: int
    heads: bool
    mlp: bool
    ssd: bool
    vocab: bool
    cache: str

    @functools.cached_property
    def rank(self) -> int:
        return tp_rank(self.mesh)

    @functools.cached_property
    def group(self):
        return tp_group(self.mesh)

    def block(self, t, dim: int):
        """This rank's block of ``t`` along ``dim`` (a view)."""
        return t.chunk(self.size, dim=dim)[self.rank]


def plan(cfg, mesh=None):
    """The ``Plan`` of ``cfg`` on ``mesh`` (the installed one by default),
    or ``None`` where nothing splits: no mesh, or a ``model`` axis of 1."""
    if mesh is None:
        from .context import get_mesh
        mesh = get_mesh()
    m = tp_size(mesh)
    if m == 1:
        return None
    if cfg.attention == "none":
        heads, cache = False, "whole"
    elif cfg.attention == "mla":
        # MHA: _attn_constrain reads the heads of a (B, S, H, 1, hd) query
        heads, cache = cfg.num_heads % m == 0, "latent"
    else:
        heads = cfg.num_kv_heads % m == 0
        cache = ("heads" if heads else
                 "head_dim" if cfg.head_dim % m == 0 else "length")
    ssd = cfg.family in ("ssm", "hybrid") and cfg.ssm_heads % m == 0
    return Plan(mesh=mesh, size=m, heads=heads, mlp=cfg.d_ff % m == 0,
                ssd=ssd, vocab=cfg.padded_vocab % m == 0, cache=cache)


def all_gather(x, dim: int, tp):
    """The ranks' blocks of ``x`` concatenated along ``dim`` (no autograd:
    the sharded train step's block gradients made whole).  The blocks
    land in one (m, ...) buffer, which is the result itself along dim 0
    (no second copy of a gathered table)."""
    x = x.contiguous()
    out = x.new_empty((tp.size,) + tuple(x.shape))
    dist.all_gather(list(out.unbind(0)), x, group=tp.group)
    if dim == 0:
        return out.reshape((-1,) + tuple(x.shape[1:]))
    return torch.cat(out.unbind(0), dim=dim)


class CopyIn(torch.autograd.Function):
    """``apply(x, group)``: the identity forward; the backward sums the
    gradient over ``group``: each rank's is the part its block gives."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class ReduceOut(torch.autograd.Function):
    """``apply(x, group)``: the sum over ``group`` forward; the identity
    backward, so the gradient reaches each rank's partial once."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return all_gather(x, dim, tp)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.block(grad, ctx.dim).contiguous(), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return tp.block(x, dim).clone()

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.dim, ctx.tp), None, None


def copy_in(x, tp):
    """Identity forward; the gradient all-reduced over ``tp``'s group."""
    if tp is None or tp.size == 1:
        return x
    return CopyIn.apply(x, tp.group)


def reduce_out(x, tp):
    """The sum over ``tp``'s group forward; the identity backward."""
    if tp is None or tp.size == 1:
        return x
    return ReduceOut.apply(x, tp.group)


def gather(x, dim: int, tp):
    """The ranks' blocks concatenated along ``dim`` (in rank order)
    forward; this rank's block of the gradient backward."""
    if tp is None or tp.size == 1:
        return x
    return _Gather.apply(x, dim, tp)


def scatter(x, dim: int, tp):
    """This rank's block along ``dim`` forward; the gradient's blocks
    gathered whole backward."""
    if tp is None or tp.size == 1:
        return x
    return _Scatter.apply(x, dim, tp)


def reduce_sum(x, tp):
    """The sum over ``tp``'s group forward and backward: a sum that each
    rank consumes in its own per-rank code (the gated norm's sum of
    squares over the SSD's channels), whose gradient is the ranks' sum."""
    return copy_in(reduce_out(x, tp), tp)


def all_max(x, tp):
    """The elementwise max over ``tp``'s group (no gradient)."""
    if tp is None or tp.size == 1:
        return x
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=tp.group)
    return out
