"""Mamba2 block via the SSD (state-space duality) chunked algorithm
[arXiv:2405.21060]: the port's counterpart of ``repro.models.ssm``.

Training/prefill runs the chunked SSD decomposition: quadratic
attention-like compute *within* chunks (batched matmuls) + a linear
inter-chunk state recurrence (a loop over n_chunks steps, the reference's
``lax.scan``).  Decode is the O(1) recurrent state update, written into
the caller's state in place.  Both paths share parameters; decode state
is (conv cache, SSM state).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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


def _split_proj(cfg, zxbcdt):
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * g * n]
    dt = zxbcdt[..., -h:]
    return z, xbc, dt


def _causal_conv(xbc, w, b):
    """Depthwise causal conv1d, accumulated in f32. xbc: (B,S,C); w: (W,C)."""
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(width):
        out = out + pad[:, i:i + xbc.shape[1]].to(torch.float32) * \
            w[i].to(torch.float32)
    return F.silu(out + b.to(torch.float32)).to(xbc.dtype)


def _projections(p, cfg, u):
    """(z, x, B, C, dt) with causal conv applied; fused or split weights."""
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    if hasattr(p, "in_proj"):
        z, xbc, dt = _split_proj(cfg, linear(p.in_proj, u))
        xbc = _causal_conv(xbc, p.conv_w, p.conv_b)
        return (z, xbc[..., :di], xbc[..., di:di + g * n],
                xbc[..., di + g * n:], dt)
    z = linear(p.z_proj, u)
    dt = linear(p.dt_proj, u)
    x = _causal_conv(linear(p.x_proj, u), p.conv_wx, p.conv_bx)
    bm = _causal_conv(linear(p.b_proj, u), p.conv_wb, p.conv_bb)
    cm = _causal_conv(linear(p.c_proj, u), p.conv_wc, p.conv_bc)
    return z, x, bm, cm, dt


def mamba2_apply(p, cfg, u):
    """Train/prefill. u: (B,S,D) -> (B,S,D) via chunked SSD."""
    f32 = torch.float32
    b, s, _ = u.shape
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    hd = cfg.ssm_head_dim
    q = min(cfg.ssd_chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is no multiple of the SSD chunk {q}")
    nc = s // q

    z, x, bmat, cmat, dt = _projections(p, cfg, u)
    x = x.reshape(b, s, h, hd)
    bmat = bmat.reshape(b, s, g, n)
    cmat = cmat.reshape(b, s, g, n)
    # broadcast groups to heads
    rep = h // g
    bmat = torch.repeat_interleave(bmat, rep, dim=2)          # (B,S,H,N)
    cmat = torch.repeat_interleave(cmat, rep, dim=2)
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
    y = y.reshape(b, s, di)
    y = rmsnorm(p.norm, y * F.silu(z.to(f32)).to(u.dtype), cfg.norm_eps)
    return linear(p.out_proj, y)


def mamba2_decode_init(cfg, batch, dtype=torch.float32, *, device=None):
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    h, hd = cfg.ssm_heads, cfg.ssm_head_dim
    conv_c = di + 2 * g * n
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_c), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, h, n, hd), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode(p, cfg, u, state):
    """One-token decode. u: (B,1,D); state: dict(conv, ssm), one layer's
    views, updated in place. O(1) per token. Returns (out, state)."""
    f32 = torch.float32
    b = u.shape[0]
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    hd = cfg.ssm_head_dim

    if hasattr(p, "in_proj"):
        zxbcdt = linear(p.in_proj, u)
        conv_w_full, conv_b_full = p.conv_w, p.conv_b
    else:   # split projections: materialize the fused layout for the cache
        zxbcdt = torch.cat(
            [linear(p.z_proj, u), linear(p.x_proj, u), linear(p.b_proj, u),
             linear(p.c_proj, u), linear(p.dt_proj, u)], dim=-1)
        conv_w_full = torch.cat([p.conv_wx, p.conv_wb, p.conv_wc], dim=1)
        conv_b_full = torch.cat([p.conv_bx, p.conv_bb, p.conv_bc])
    z, xbc, dt = _split_proj(cfg, zxbcdt)                     # (B,1,*)
    # rolling conv cache
    conv_in = torch.cat([state["conv"], xbc.to(state["conv"].dtype)], dim=1)
    w = conv_w_full.to(f32)
    acc = (conv_in.to(f32) * w[None]).sum(dim=1) + conv_b_full.to(f32)
    xbc1 = F.silu(acc).to(u.dtype)                            # (B,C)

    x = xbc1[:, :di].reshape(b, h, hd)
    bvec = xbc1[:, di:di + g * n].reshape(b, g, n)
    cvec = xbc1[:, di + g * n:].reshape(b, g, n)
    rep = h // g
    bvec = torch.repeat_interleave(bvec, rep, dim=1).to(f32)  # (B,H,N)
    cvec = torch.repeat_interleave(cvec, rep, dim=1).to(f32)

    dt1 = F.softplus(dt[:, 0].to(f32) + p.dt_bias.to(f32))    # (B,H)
    a = -torch.exp(p.A_log.to(f32))
    decay = torch.exp(dt1 * a[None])                          # (B,H)

    ssm = state["ssm"] * decay[..., None, None] + torch.einsum(
        "bhn,bh,bhp->bhnp", bvec, dt1, x.to(f32))
    y = torch.einsum("bhn,bhnp->bhp", cvec, ssm).to(u.dtype)
    y = y + x * p.D.to(u.dtype)[None, :, None]
    y = y.reshape(b, 1, di)
    y = rmsnorm(p.norm, y * F.silu(z.to(f32)).to(u.dtype), cfg.norm_eps)
    state["conv"].copy_(conv_in[:, 1:])
    state["ssm"].copy_(ssm)
    return linear(p.out_proj, y), state
