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

Expert parallelism over a mesh's ``model`` axis (the reference's
``moe_apply_sharded``) waits for the mesh substrate (ROADMAP queue 1,
13.5): with such a mesh set, ``moe_layer`` raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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
    """``moe_apply``, or the reference's ``moe_apply_sharded`` under a mesh
    with a ``model`` axis, which the port does not run yet."""
    from repro_torch.dist import get_mesh
    mesh = get_mesh()
    if mesh is not None and "model" in (mesh.mesh_dim_names or ()):
        raise NotImplementedError(
            "expert parallelism over the mesh's 'model' axis (the "
            "reference's moe_apply_sharded) needs the mesh substrate, "
            "ROADMAP queue 1, item 13.5")
    return moe_apply(p, cfg, x)


def moe_apply(p, cfg, x):
    """x: (B,S,D) -> ((B,S,D), aux). Top-k routing, capacity-bounded sort
    dispatch."""
    compute_dtype = x.dtype
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    t = b * s
    dev = x.device
    xt = x.reshape(t, d)

    logits = torch.matmul(xt.to(torch.float32),
                          p.router.w.to(torch.float32))
    gates = torch.softmax(logits, dim=-1)
    top_g, top_e = torch.topk(gates, k, dim=-1)             # (T,k)
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)

    # ---- sort-based dispatch (the BLCO sort+segment pattern) ----------------
    flat_e = top_e.reshape(-1)                              # (T*k,)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)              # group by expert
    se, stok = flat_e[order], flat_tok[order]

    cap = capacity(cfg, t)
    # the first sorted position of each expert (t*k for an empty one) and,
    # for each slab slot, the sorted position it holds if any
    pos_in_e = torch.arange(t * k, device=dev)
    first_of_e = torch.full((e,), t * k, dtype=pos_in_e.dtype,
                            device=dev).scatter_reduce_(
        0, se, pos_in_e, "amin", include_self=True)
    at = first_of_e[:, None] + torch.arange(cap, device=dev)[None, :]
    safe_at = torch.clamp(at, max=t * k - 1)
    filled = (at < t * k) & (se[safe_at] == torch.arange(
        e, device=dev)[:, None])                            # (E, C)

    # dispatch: (E, C, D) slabs
    slabs = torch.where(filled[..., None], xt[stok[safe_at]].to(
        compute_dtype), 0)

    # expert FFN (swiglu) on slabs: E x C x d x ff
    wi = p.wi.w.to(compute_dtype)
    wg = p.wg.w.to(compute_dtype)
    wo = p.wo.w.to(compute_dtype)
    h = F.silu(torch.bmm(slabs, wg)) * torch.bmm(slabs, wi)
    out_slabs = torch.bmm(h, wo)

    # combine: each routed (token, j) reads its slot back, gate-weighted
    slot = pos_in_e - first_of_e[se]
    keep = slot < cap                                       # overflow drops
    safe_slot = torch.where(keep, slot, cap - 1)
    gathered = torch.where(keep[:, None], out_slabs[se, safe_slot], 0)
    sg = top_g.reshape(-1)[order]
    combined = _combine(gathered * sg[:, None].to(compute_dtype), order,
                        top_e, t, k)

    if cfg.num_shared_experts:
        sh = F.silu(linear(p.shared_wg, xt)) * linear(p.shared_wi, xt)
        combined = combined + linear(p.shared_wo, sh)

    # router z-loss / aux load-balancing loss (returned for the trainer)
    me = gates.mean(dim=0)                                  # (E,)
    ce = torch.zeros((e,), dtype=torch.float32, device=dev).index_add_(
        0, flat_e, torch.ones((t * k,), dtype=torch.float32, device=dev)) \
        / (t * k)
    aux_loss = e * torch.sum(me * ce)
    return combined.reshape(b, s, d).to(x.dtype), aux_loss


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
