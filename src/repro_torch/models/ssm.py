"""Mamba2 block via the SSD (state-space duality) chunked algorithm
[arXiv:2405.21060]: the port's counterpart of ``repro.models.ssm``.

Training/prefill runs the chunked SSD decomposition: quadratic
attention-like compute *within* chunks (batched matmuls) + a linear
inter-chunk state recurrence (a loop over n_chunks steps, the reference's
``lax.scan``).  Decode is the O(1) recurrent state update, written into
the caller's state in place.  Both paths share parameters; decode state
is (conv cache, SSM state).  Under a mesh whose ``model`` axis divides the
SSD's heads, both are per-rank code over this rank's heads, in the layout
of the reference's anchors (x, B, C and dt on heads) and of its
``cache_specs`` (the state on heads, the conv ring on a 1/m block of its
channels).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist import tensor_parallel as tpar
from repro_torch.dist.context import constrain

from .modules import _param, linear, linear_init, normal_, rmsnorm, \
    rmsnorm_init


def mamba2_init(generator, cfg, dtype, device=None) -> nn.Module:
    d = cfg.d_model
    di = cfg.d_inner
    h = cfg.ssm_heads
    g, n = cfg.ssm_groups, cfg.ssm_state
    kw = dict(dtype=dtype, device=device)
    p = nn.Module()
    nn.init.zeros_(_param(p, "A_log", (h,), dtype, device))  # A = -exp(A_log)
    nn.init.ones_(_param(p, "D", (h,), dtype, device))
    nn.init.zeros_(_param(p, "dt_bias", (h,), dtype, device))
    p.norm = rmsnorm_init(di, dtype, device=device)
    p.out_proj = linear_init(generator, di, d,
                             scale=di ** -0.5 / (2 * cfg.num_layers) ** 0.5,
                             **kw)

    def conv(name, width):
        normal_(_param(p, name, (cfg.conv_width, width), dtype, device),
                generator, cfg.conv_width ** -0.5)

    if getattr(cfg, "ssm_split_proj", False):
        # separate projections: every weight TP-shards cleanly
        p.z_proj = linear_init(generator, d, di, **kw)
        p.x_proj = linear_init(generator, d, di, **kw)
        p.b_proj = linear_init(generator, d, g * n, **kw)
        p.c_proj = linear_init(generator, d, g * n, **kw)
        p.dt_proj = linear_init(generator, d, h, **kw)
        for name, width in (("x", di), ("b", g * n), ("c", g * n)):
            conv(f"conv_w{name}", width)
            nn.init.zeros_(_param(p, f"conv_b{name}", (width,), dtype,
                                  device))
    else:
        # fused in_proj -> [z (di), x (di), B (g*n), C (g*n), dt (h)]
        p.in_proj = linear_init(generator, d, 2 * di + 2 * g * n + h, **kw)
        conv("conv_w", di + 2 * g * n)
        nn.init.zeros_(_param(p, "conv_b", (di + 2 * g * n,), dtype, device))
    return p


def _causal_conv(xbc, w, b):
    """Depthwise causal conv1d, accumulated in f32. xbc: (B,S,C); w: (W,C)."""
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(width):
        out = out + pad[:, i:i + xbc.shape[1]].to(torch.float32) * \
            w[i].to(torch.float32)
    return F.silu(out + b.to(torch.float32)).to(xbc.dtype)


def _ssd_plan(cfg):
    """``tensor_parallel.plan`` where it splits the SSD's heads, else None."""
    tp = tpar.plan(cfg)
    return tp if tp is not None and tp.ssd else None


def _fused(p):
    """(in_proj's weight, conv weight, conv bias) of the fused layout:
    ``[z | x | B | C | dt]`` columns and ``[x | B | C]`` channels (the
    split projections concatenated)."""
    if hasattr(p, "in_proj"):
        return p.in_proj.w, p.conv_w, p.conv_b
    return (torch.cat([p.z_proj.w, p.x_proj.w, p.b_proj.w, p.c_proj.w,
                       p.dt_proj.w], dim=1),
            torch.cat([p.conv_wx, p.conv_wb, p.conv_wc], dim=1),
            torch.cat([p.conv_bx, p.conv_bb, p.conv_bc]))


def _head_block(cfg, tp):
    """(first head, heads) of this rank's SSD block (all without ``tp``)."""
    if tp is None:
        return 0, cfg.ssm_heads
    hl = cfg.ssm_heads // tp.size
    return tp.rank * hl, hl


def _tp_projections(p, cfg, u, tp):
    """(z, x, B, C, dt), the causal conv applied, for this rank's heads
    (all of them without ``tp``): ``in_proj`` and the conv (the split
    projections concatenated, ``_fused``) held whole, each behind
    ``copy_in`` (their gradients summed over ``model``: the rank's own
    columns plus its part of B's and C's), and indexed at this rank's
    columns: its heads' z, x and dt, every group's B and C.  The fused
    ``[z | x | B | C | dt]`` segments are no one block per rank, so
    ``sharding.tp_blocks`` keeps these leaves whole rather than cut each
    segment.  The conv is channel-local: its x channels are this rank's
    heads'."""
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    hd = cfg.ssm_head_dim
    h0, hl = _head_block(cfg, tp)
    w, cw, cb = (tpar.copy_in(t, tp) for t in _fused(p))
    if hl != cfg.ssm_heads:
        xs = slice(h0 * hd, (h0 + hl) * hd)
        dt0 = 2 * di + 2 * gn + h0
        w = torch.cat([w[:, xs], w[:, di:2 * di][:, xs],
                       w[:, 2 * di:2 * di + 2 * gn], w[:, dt0:dt0 + hl]],
                      dim=1)
        cw = torch.cat([cw[:, xs], cw[:, di:]], dim=1)
        cb = torch.cat([cb[xs], cb[di:]])
    zxbcdt = torch.matmul(u, w.to(u.dtype))
    dl = hl * hd
    xbc = _causal_conv(zxbcdt[..., dl:2 * dl + 2 * gn], cw, cb)
    return (zxbcdt[..., :dl], xbc[..., :dl], xbc[..., dl:dl + gn],
            xbc[..., dl + gn:], zxbcdt[..., -hl:])


def _to_heads(m, cfg, h0, hl, dim):
    """Groups (..., G, N) broadcast to the heads ``h0 .. h0 + hl``."""
    rep = cfg.ssm_heads // cfg.ssm_groups
    if hl == cfg.ssm_heads:
        return torch.repeat_interleave(m, rep, dim=dim)
    idx = torch.arange(h0, h0 + hl, device=m.device) // rep
    return m.index_select(dim, idx)


def _gated_norm(p, cfg, y, z, tp):
    """The gated RMSNorm over ``d_inner``; with ``tp``, over this rank's
    channels, the sum of squares summed over ``model`` first."""
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    if tp is None:
        return rmsnorm(p.norm, y, cfg.norm_eps)
    yf = y.to(torch.float32)
    var = tpar.reduce_sum((yf * yf).sum(dim=-1, keepdim=True), tp) \
        / cfg.d_inner
    out = yf * torch.rsqrt(var + cfg.norm_eps)
    return (out * p.norm.scale.to(torch.float32)).to(y.dtype)


def mamba2_apply(p, cfg, u):
    """Train/prefill. u: (B,S,D) -> (B,S,D) via chunked SSD.  Under a mesh
    that splits the SSD's heads (``tensor_parallel.Plan.ssd``): this
    rank's heads (``_tp_projections``; its blocks of ``A_log``, ``D``,
    ``dt_bias`` and the norm's scale), their chunked SSD and inter-chunk
    scan, which are local, the gated norm over every channel, its rows of
    ``out_proj``, then the sum over ``model``."""
    f32 = torch.float32
    b, s, _ = u.shape
    g, n = cfg.ssm_groups, cfg.ssm_state
    hd = cfg.ssm_head_dim
    q = min(cfg.ssd_chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is no multiple of the SSD chunk {q}")
    nc = s // q

    tp = _ssd_plan(cfg)
    h0, h = _head_block(cfg, tp)
    if p.A_log.shape[0] != h:
        raise ValueError(f"A_log holds {p.A_log.shape[0]} heads: not this "
                         f"rank's block of {cfg.ssm_heads}")
    u = tpar.copy_in(u, tp)
    z, x, bmat, cmat, dt = _tp_projections(p, cfg, u, tp)
    x = x.reshape(b, s, h, hd)
    bmat = bmat.reshape(b, s, g, n)
    cmat = cmat.reshape(b, s, g, n)
    # broadcast groups to heads
    bmat = _to_heads(bmat, cfg, h0, h, 2)                     # (B,S,H,N)
    cmat = _to_heads(cmat, cfg, h0, h, 2)
    # SSD head parallelism: the head dim over ``model`` (the anchors)
    x = constrain(x, "dp", None, "tp", None)
    bmat = constrain(bmat, "dp", None, "tp", None)
    cmat = constrain(cmat, "dp", None, "tp", None)
    dt = constrain(dt, "dp", None, "tp")

    dt = F.softplus(dt.to(f32) + p.dt_bias.to(f32))           # (B,S,H)
    a = -torch.exp(p.A_log.to(f32))                           # (H,)
    da = dt * a[None, None, :]                                # (B,S,H) decay log

    # chunk reshape; B/C in fp32 by default, bf16 under cfg.ssd_bf16
    ssd_dt = u.dtype if getattr(cfg, "ssd_bf16", False) else f32
    xq = x.reshape(b, nc, q, h, hd)
    bq = bmat.reshape(b, nc, q, h, n).to(ssd_dt)
    cq = cmat.reshape(b, nc, q, h, n).to(ssd_dt)
    dtq = dt.reshape(b, nc, q, h)
    daq = da.reshape(b, nc, q, h)
    da_cs = torch.cumsum(daq, dim=2)                          # within-chunk cumsum
    da_tot = da_cs[:, :, -1]                                  # (B,nc,H)

    # --- intra-chunk (quadratic within chunk, like masked attention) --------
    # L[b,c,h,i,j] = exp(da_cs_i - da_cs_j) * dt_j   for j <= i
    diff = da_cs[:, :, :, None, :] - da_cs[:, :, None, :, :]  # (B,nc,i,j,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=u.device))
    # masked before the exp, where the reference masks after it: the same
    # values, but above the diagonal diff grows with the chunk (about
    # 0.7 q at init) and exp overflows to inf past q ~ 128, whose zero
    # cotangent then gives 0 * inf = NaN in the backward
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                  -torch.inf))
    scores = torch.einsum("bcihn,bcjhn->bcijh", cq, bq).to(f32) \
        * decay * dtq[:, :, None, :, :]
    # the scores are rounded to the compute dtype before the product with x
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores.to(u.dtype), xq)

    # --- chunk states + inter-chunk recurrence ------------------------------
    # state contribution of chunk c: sum_j exp(da_tot - da_cs_j) dt_j B_j x_j
    w = torch.exp(da_tot[:, :, None, :] - da_cs) * dtq        # (B,nc,q,H)
    states = torch.einsum("bcjhn,bcjh,bcjhp->bchnp", bq.to(f32), w,
                          xq.to(f32))                         # (B,nc,H,N,P)

    s_prev = torch.zeros((b, h, n, hd), dtype=f32, device=u.device)
    prev = []
    for c in range(nc):                                       # emit state BEFORE chunk
        prev.append(s_prev)
        s_prev = s_prev * torch.exp(da_tot[:, c])[..., None, None] \
            + states[:, c]
    prev_states = torch.stack(prev, dim=1)                    # (B,nc,H,N,P)

    # y_inter[i] = C_i . S_prev * exp(da_cs_i)
    y_inter = torch.einsum("bcihn,bchnp->bcihp",
                           cq.to(f32) * torch.exp(da_cs)[..., None],
                           prev_states).to(u.dtype)

    y = (y_intra + y_inter).reshape(b, s, h, hd)
    y = y + x * p.D.to(u.dtype)[None, None, :, None]
    y = _gated_norm(p, cfg, y.reshape(b, s, h * hd), z, tp)
    return tpar.reduce_out(linear(p.out_proj, y), tp)


def mamba2_decode_init(cfg, batch, dtype=torch.float32, *, device=None,
                       mesh=None):
    """One layer's decode state: the conv ring (B, W-1, C) of the
    ``[x | B | C]`` channels and the SSM state (B, H, N, P).  With a
    ``mesh`` whose ``model`` axis splits the config, this rank's blocks
    as the reference's ``cache_specs`` splits them: ``ssm`` on its heads,
    ``conv`` on one contiguous 1/m block of the channels (each where the
    axis divides the dim; whole otherwise)."""
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    h, hd = cfg.ssm_heads, cfg.ssm_head_dim
    conv_c = di + 2 * g * n
    m = tpar.tp_size(mesh)
    if m > 1:
        h = h // m if h % m == 0 else h
        conv_c = conv_c // m if conv_c % m == 0 else conv_c
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_c), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, h, n, hd), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode(p, cfg, u, state):
    """One-token decode. u: (B,1,D); state: dict(conv, ssm), one layer's
    views, updated in place. O(1) per token. Returns (out, state).  Under
    a splitting mesh ``state`` holds this rank's blocks
    (``mamba2_decode_init``): its block of the conv channels (the new
    token's columns of the whole ``in_proj`` at those channels, the
    depthwise conv, which is channel-local), the conv outputs gathered
    over ``model`` (a few thousand values a row), then its heads' x, dt
    and SSM state with every group's B and C (all heads where the plan
    does not split them), the gated norm's sum of squares and
    ``out_proj``'s rows summed over ``model``."""
    tp = tpar.plan(cfg)
    f32 = torch.float32
    b = u.shape[0]
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    g, n, hd = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    c_all = di + 2 * gn
    w, cw, cb = _fused(p)
    cl = state["conv"].shape[-1]
    c0 = 0 if cl == c_all else tp.rank * cl
    xbc = torch.matmul(u, w[:, di + c0:di + c0 + cl].to(u.dtype))  # (B,1,cl)
    conv_in = torch.cat([state["conv"], xbc.to(state["conv"].dtype)], dim=1)
    acc = (conv_in.to(f32) * cw[:, c0:c0 + cl].to(f32)[None]).sum(dim=1) \
        + cb[c0:c0 + cl].to(f32)
    xbc1 = F.silu(acc).to(u.dtype)                            # (B,cl)
    if cl != c_all:
        xbc1 = tpar.gather(xbc1, 1, tp)
    heads = _ssd_plan(cfg)
    h0, h = _head_block(cfg, heads)
    if state["ssm"].shape[1] != h:
        raise ValueError(f"an SSM state of {state['ssm'].shape[1]} heads: "
                         f"not this rank's {h}")
    xs = slice(h0 * hd, (h0 + h) * hd)
    z = torch.matmul(u, w[:, xs].to(u.dtype))
    dt = torch.matmul(u, w[:, 2 * di + 2 * gn + h0:
                           2 * di + 2 * gn + h0 + h].to(u.dtype))
    x = xbc1[:, xs].reshape(b, h, hd)
    bvec = _to_heads(xbc1[:, di:di + gn].reshape(b, g, n), cfg, h0, h,
                     1).to(f32)                               # (B,H,N)
    cvec = _to_heads(xbc1[:, di + gn:].reshape(b, g, n), cfg, h0, h,
                     1).to(f32)
    dt1 = F.softplus(dt[:, 0].to(f32) + p.dt_bias.to(f32))    # (B,H)
    a = -torch.exp(p.A_log.to(f32))
    decay = torch.exp(dt1 * a[None])                          # (B,H)
    ssm = state["ssm"] * decay[..., None, None] + torch.einsum(
        "bhn,bh,bhp->bhnp", bvec, dt1, x.to(f32))
    y = torch.einsum("bhn,bhnp->bhp", cvec, ssm).to(u.dtype)
    y = y + x * p.D.to(u.dtype)[None, :, None]
    y = _gated_norm(p, cfg, y.reshape(b, 1, h * hd), z, heads)
    state["conv"].copy_(conv_in[:, 1:])
    state["ssm"].copy_(ssm)
    return tpar.reduce_out(linear(p.out_proj, y), heads), state
