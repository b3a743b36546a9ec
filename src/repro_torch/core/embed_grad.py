"""BLCO-style embedding-gradient accumulation — the paper's technique inside
the LM training path, in plain PyTorch.

The backward pass of a token-embedding lookup is a sparse MTTKRP: the gradient
of the (V, D) table is X_(1) @ G where X is the sparse (vocab x position)
occurrence tensor of the batch and G the upstream gradients — i.e. many sparse
indexed updates into a dense table, with exactly the update-conflict structure
the paper attacks (hot tokens = dense fibers).

Two resolutions, mirroring ``core/mttkrp.py``:

* ``scatter``  — naive per-token scatter-add (the COO baseline);
* ``segment``  — sort token ids (the 1-D analogue of ALTO linearization
  ordering), discover runs on the fly, segment-reduce, and issue one update
  per *distinct token* instead of per token occurrence (the BLCO conflict
  resolution): a sort + segmented reduction + low-duplicate scatter.

Selectable per config via ``embed_grad={"scatter","segment"}``.  The JAX
package's ``repro.core.embed_grad`` is the reference; each step here is its
counterpart (``argsort`` stable like ``jnp.argsort``, ``index_add_`` for
``segment_sum`` and the ``.at[].add`` scatters, ``scatter_reduce_("amax")``
for ``.at[].max``).
"""
from __future__ import annotations

import torch


def _grad_scatter(ids, g, vocab):
    """ids: (T,) int; g: (T, D).  One update per token occurrence."""
    out = torch.zeros((vocab, g.shape[-1]), dtype=g.dtype, device=g.device)
    return out.index_add_(0, ids.long(), g)


def _grad_segment(ids, g, vocab):
    """ids: (B, S); g: (B, S, D).  The sort is per batch row, as in the
    reference (row-local under a data-parallel split); only the final
    per-segment scatter touches the table."""
    b, s = ids.shape
    d = g.shape[-1]
    order = torch.argsort(ids, dim=1, stable=True)       # row-local sort
    sid = torch.gather(ids, 1, order)
    sg = torch.gather(g, 1, order[..., None].expand(b, s, d))
    flags = torch.cat(
        [torch.ones((b, 1), dtype=torch.int32, device=ids.device),
         (sid[:, 1:] != sid[:, :-1]).to(torch.int32)], dim=1)
    seg = torch.cumsum(flags, dim=1) - 1                 # per-row segment ids
    flat_seg = (seg + torch.arange(b, device=ids.device)[:, None] * s
                ).reshape(-1)
    seg_sums = torch.zeros((b * s, d), dtype=g.dtype, device=g.device)
    seg_sums.index_add_(0, flat_seg, sg.reshape(b * s, d))
    seg_tgt = torch.zeros((b * s,), dtype=ids.dtype, device=ids.device)
    seg_tgt.scatter_reduce_(0, flat_seg, sid.reshape(-1), "amax")
    out = torch.zeros((vocab, d), dtype=g.dtype, device=g.device)
    return out.index_add_(0, seg_tgt.long(), seg_sums)


class _EmbeddingLookup(torch.autograd.Function):
    """Forward: a gather.  Backward: the table's gradient by ``method``."""

    @staticmethod
    def forward(ctx, table, ids, method):
        ctx.save_for_backward(ids)
        ctx.vocab = table.shape[0]
        ctx.method = method
        flat = table.index_select(0, ids.reshape(-1).long())
        return flat.reshape(ids.shape + (table.shape[-1],))

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        if ctx.method == "segment":
            ids2 = ids.reshape(ids.shape[0], -1) if ids.dim() >= 2 \
                else ids.reshape(1, -1)
            g3 = g.reshape(ids2.shape + (g.shape[-1],))
            dtable = _grad_segment(ids2, g3, ctx.vocab)
        elif ctx.method == "scatter":
            dtable = _grad_scatter(ids.reshape(-1),
                                   g.reshape(-1, g.shape[-1]), ctx.vocab)
        else:
            raise ValueError(f"unknown embed_grad method {ctx.method!r}")
        return dtable, None, None


def embedding_lookup(table, ids, method: str = "segment"):
    """table: (V, D); ids: int tensor (any shape). Returns ids.shape + (D,)."""
    return _EmbeddingLookup.apply(table, ids, method)
