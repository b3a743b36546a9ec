"""Mixture-of-Experts with sort-based, capacity-bounded dispatch: the
port's counterpart of ``repro.models.moe``.

The dispatch is the same machinery as the paper's conflict resolution:
tokens are *sorted by expert id* (a stable sort, as ``jnp.argsort`` is),
per-expert runs become segments, and each expert processes a
fixed-capacity contiguous slab.  FLOPs scale with E x C x d x ff =
active-expert FLOPs x capacity_factor.  Every shape comes from the input's
shape and the config alone, so a decode step reads nothing on the host.

Where the reference scatters, the port gathers (each kept (expert, slot)
holds exactly one sorted position, and each routed (token, j) has exactly
one sorted position, the inverse of the sort): the slabs are gathered from
the sorted tokens, and the combine gathers each token's k contributions
and adds them in the order the reference's scatter-add adds them (by
expert id), rounding in the compute dtype after each.  No atomics, so the
result does not change between runs on the card.

Experts shard over a mesh's ``model`` axis (expert parallelism,
``moe_apply_sharded``): per-rank code, one ``all_reduce`` over ``model``
per layer and no all-to-all.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.tensor_parallel import CopyIn, ReduceOut

from .modules import _param, linear, linear_init, normal_


def moe_init(generator, cfg, dtype, device=None) -> nn.Module:
    d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    kw = dict(dtype=dtype, device=device)
    scale_in = d ** -0.5
    scale_out = ff ** -0.5 / (2 * cfg.num_layers) ** 0.5
    p = nn.Module()
    p.router = linear_init(generator, d, e, **kw)
    # stacked expert weights: (E, d, ff) / (E, ff, d)
    p.wi = _expert_w(generator, e, d, ff, scale_in, **kw)
    p.wg = _expert_w(generator, e, d, ff, scale_in, **kw)
    p.wo = _expert_w(generator, e, ff, d, scale_out, **kw)
    if cfg.num_shared_experts:
        sff = cfg.moe_d_ff * cfg.num_shared_experts
        p.shared_wi = linear_init(generator, d, sff, **kw)
        p.shared_wg = linear_init(generator, d, sff, **kw)
        p.shared_wo = linear_init(generator, sff, d, scale=scale_out, **kw)
    return p


def _expert_w(generator, e, a, b, scale, *, dtype, device) -> nn.Module:
    p = nn.Module()
    normal_(_param(p, "w", (e, a, b), dtype, device), generator, scale)
    return p


def capacity(cfg, t: int) -> int:
    """Slots per expert for ``t`` tokens: the reference's rounding, on the
    host, from shapes alone."""
    return int(max(1, round(t * cfg.top_k / cfg.num_experts
                            * cfg.capacity_factor)))


def moe_layer(p, cfg, x):
    """``moe_apply``, or ``moe_apply_sharded`` under a mesh with a
    ``model`` axis (``x`` then holds this rank's rows of the batch)."""
    from repro_torch.dist import get_mesh
    mesh = get_mesh()
    if mesh is not None and "model" in (mesh.mesh_dim_names or ()):
        return moe_apply_sharded(p, cfg, x, mesh)
    return moe_apply(p, cfg, x)


def _route(p, cfg, xt):
    """(gates (T,E) f32, top-k gates renormalised (T,k), top-k experts)."""
    logits = torch.matmul(xt.to(torch.float32),
                          p.router.w.to(torch.float32))
    gates = torch.softmax(logits, dim=-1)
    top_g, top_e = torch.topk(gates, cfg.top_k, dim=-1)     # (T,k)
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)
    return gates, top_g, top_e


def _aux(gates, top_e, e: int):
    """The router's load-balancing loss (returned for the trainer)."""
    t, k = top_e.shape
    me = gates.mean(dim=0)                                  # (E,)
    ce = torch.zeros((e,), dtype=torch.float32, device=gates.device
                     ).index_add_(0, top_e.reshape(-1), torch.ones(
                         (t * k,), dtype=torch.float32,
                         device=gates.device)) / (t * k)
    return e * torch.sum(me * ce)


def _shared(p, cfg, xt, combined):
    if cfg.num_shared_experts:
        sh = F.silu(linear(p.shared_wg, xt)) * linear(p.shared_wi, xt)
        combined = combined + linear(p.shared_wo, sh)
    return combined


def _experts(xt, top_e, top_g, wi, wg, wo, lo: int, cap: int):
    """The routed tokens through the experts ``[lo, lo + E_l)`` whose
    weights ``wi``, ``wg``, ``wo`` hold (E_l, ., .), in ``xt``'s dtype:
    each token's gate-weighted sum of its kept contributions from these
    experts, (T, D).  A (token, j) routed to another expert, or past its
    expert's ``cap`` slots, contributes exactly 0."""
    t, d = xt.shape
    k = top_e.shape[1]
    el = wi.shape[0]
    dev = xt.device
    # ---- sort-based dispatch (the BLCO sort+segment pattern) ----------------
    local = top_e.reshape(-1) - lo                          # (T*k,)
    mine = (local >= 0) & (local < el)
    key = torch.where(mine, local, el)                      # others last
    order = torch.argsort(key, stable=True)                 # group by expert
    se = key[order]
    stok = torch.arange(t, device=dev).repeat_interleave(k)[order]

    # the first sorted position of each expert (t*k for an empty one) and,
    # for each slab slot, the sorted position it holds if any
    pos_in_e = torch.arange(t * k, device=dev)
    first_of_e = torch.full((el + 1,), t * k, dtype=pos_in_e.dtype,
                            device=dev).scatter_reduce_(
        0, se, pos_in_e, "amin", include_self=True)
    at = first_of_e[:el, None] + torch.arange(cap, device=dev)[None, :]
    safe_at = torch.clamp(at, max=t * k - 1)
    filled = (at < t * k) & (se[safe_at] == torch.arange(
        el, device=dev)[:, None])                           # (E_l, C)

    # dispatch: (E_l, C, D) slabs
    slabs = torch.where(filled[..., None], xt[stok[safe_at]], 0)

    # expert FFN (swiglu) on slabs: E_l x C x d x ff
    h = F.silu(torch.bmm(slabs, wg)) * torch.bmm(slabs, wi)
    out_slabs = torch.bmm(h, wo)

    # combine: each routed (token, j) reads its slot back, gate-weighted
    slot = pos_in_e - first_of_e[se]
    keep = (slot < cap) & (se < el)                         # overflow drops
    safe_e = torch.clamp(se, max=el - 1)
    safe_slot = torch.where(keep, slot, cap - 1)
    gathered = torch.where(keep[:, None], out_slabs[safe_e, safe_slot], 0)
    sg = top_g.reshape(-1)[order]
    return _combine(gathered * sg[:, None].to(xt.dtype), order, top_e, t, k)


def moe_apply(p, cfg, x):
    """x: (B,S,D) -> ((B,S,D), aux). Top-k routing, capacity-bounded sort
    dispatch."""
    cd = x.dtype
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, top_g, top_e = _route(p, cfg, xt)
    combined = _experts(xt, top_e, top_g, p.wi.w.to(cd), p.wg.w.to(cd),
                        p.wo.w.to(cd), 0, capacity(cfg, b * s))
    combined = _shared(p, cfg, xt, combined)
    aux_loss = _aux(gates, top_e, cfg.num_experts)
    return combined.reshape(b, s, d).to(x.dtype), aux_loss


# ------------------------------------------------- expert parallelism (SPMD)
def _data_mean(aux, mesh):
    """``aux`` averaged over the mesh's data axes (the reference's
    ``pmean(aux, dp)``), with the gradient of this rank's own ``aux``: the
    rank's gradients are those of its data shard, which the sharded train
    step averages over the data axes."""
    from repro_torch.core.distributed import axis_group
    from repro_torch.dist.context import _resolve
    dp = _resolve(mesh, "dp")
    if dp is None:
        return aux
    group, _ = axis_group(mesh, dp)
    n = dist.get_world_size(group)
    if n == 1:
        return aux
    mean = aux.detach().clone()
    dist.all_reduce(mean, group=group)
    return mean / n + (aux - aux.detach())


def moe_apply_sharded(p, cfg, x, mesh):
    """Expert-parallel MoE over ``mesh``'s ``model`` axis, as per-rank code:
    the reference's ``moe_apply_sharded``.

    ``x``: this rank's rows of the batch (B_l, S, D), the same on every
    rank of its model axis.  Model rank ``col`` owns the experts
    ``[col * E/tp, (col + 1) * E/tp)``: ``p``'s expert weights hold either
    all E (the rank takes its block, and their gradient is summed over
    the model axis, so every model rank ends with the whole stack's) or
    only this block.  Each rank gates every token (the router is
    replicated), runs the tokens routed to its experts with the capacity
    of its own token count, and the per-token combine is one ``all_reduce``
    over ``model`` — no all-to-all.  ``aux`` is this data shard's, averaged
    over the data axes.  Shared experts stay outside, on every rank.
    """
    names = tuple(mesh.mesh_dim_names)
    tp = mesh.size(names.index("model"))
    group = mesh.get_group("model")
    e = cfg.num_experts
    assert e % tp == 0, (e, tp)
    el = e // tp
    lo = mesh.get_local_rank("model") * el
    cd = x.dtype
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, top_g, top_e = _route(p, cfg, xt)
    aux = _data_mean(_aux(gates, top_e, e), mesh)

    ws = []
    for w in (p.wi.w, p.wg.w, p.wo.w):
        if w.shape[0] == e and tp > 1:
            w = CopyIn.apply(w, group)[lo:lo + el]
        elif w.shape[0] != el:
            raise ValueError(f"expert weights of {w.shape[0]} experts: "
                             f"neither all {e} nor this rank's {el}")
        ws.append(w.to(cd))
    if tp > 1:
        xt_in, g_in = CopyIn.apply(xt, group), CopyIn.apply(top_g, group)
    else:
        xt_in, g_in = xt, top_g
    out = _experts(xt_in, top_e, g_in, *ws, lo, capacity(cfg, b * s))
    if tp > 1:
        out = ReduceOut.apply(out, group)          # one collective
    out = _shared(p, cfg, xt, out)
    return out.reshape(b, s, d).to(x.dtype), aux.to(torch.float32)


def _combine(contrib, order, top_e, t: int, k: int):
    """contrib: (T*k, D), one row per sorted position.  Each token's sum of
    its k rows, as the reference's ``zeros.at[stok].add(...)`` adds them:
    in sorted order (by expert id, a token routes to k distinct experts),
    rounding in the rows' dtype after each addition; by gathers, with no
    scatter."""
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=order.device)
    by_expert = torch.argsort(top_e, dim=-1)                # (T,k)
    rows = torch.gather(inverse.reshape(t, k), 1, by_expert)
    out = torch.zeros((t, contrib.shape[1]), dtype=contrib.dtype,
                      device=contrib.device)
    for j in range(k):
        out = out + contrib[rows[:, j]]
    return out
