"""Decoder-LM spine for the dense / vlm / MoE / SSM / hybrid families: the
port's counterpart of ``repro.models.transformer``.

  dense  — [attn, mlp] x L                     (stablelm, qwen, minicpm,
                                                danube)
  vlm    — the dense backbone over precomputed patch embeddings (internvl2)
  moe    — [attn, moe] x L (+ leading dense)   (dbrx, deepseek-v2/MLA)
  ssm    — [mamba2] x L                        (mamba2-370m)
  hybrid — mamba2 spine + one SHARED attention block applied every k layers
           with per-site LoRA                  (zamba2)

The enc-dec family is ``encdec.py``.  The parameters live in ``nn.Module``
containers named as the reference's pytree (``embed``, ``frontend_proj``,
``dense_layers``, ``moe_layers``, ``ssm_layers``, ``pre_layers``,
``group_layers``, ``shared_attn``, ``site_lora``, ``ln_f``, ``lm_head``);
the reference stacks a group's layers on leading axes for ``lax.scan``
(two for the hybrid's ``group_layers``: groups x layers per group), the
port keeps one container per layer in an ``nn.ModuleList`` (a list of
lists for ``group_layers``) and loops over them.  The math is in
functions of (params, cfg, ...), as in the reference, so one set of
weights runs under another config's compute dtype; ``Transformer``'s
methods call them with its own config.  The reference's ``constrain``
anchors stand at its sites (``repro_torch.dist.constrain``: per-rank code,
so they return their input); under a mesh whose ``model`` axis splits the
config (``dist.tensor_parallel.plan``) the layers compute with this
rank's blocks where the anchors split them: the attention (``attention``;
the hybrid's shared block through the same code, its per-site LoRA
carried by the projections), the SSD's heads (``ssm``), the MLP's hidden,
the vocab of the head (``forward`` returns this rank's
vocab block of the logits, ``parallel_cross_entropy`` reduces over the
blocks) and of the table when serving holds its block, and the decode
cache (``init_cache(mesh=)``).  Training's loss is here too
(``parallel_cross_entropy``, ``loss_fn``), and ``forward`` runs each
layer, and each hybrid group around its layers, under
``torch.utils.checkpoint`` when gradients are on, the reference's
``jax.checkpoint`` around its scan bodies (``_remat``).

The token embedding uses ``repro_torch.core.embedding_lookup`` — the
paper's sort+segment conflict resolution on the embedding-gradient MTTKRP
(cfg.embed_grad selects it).
"""
from __future__ import annotations

import dataclasses
import functools
import types

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.core.embed_grad import embedding_lookup
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.dist.context import constrain, get_mesh, tp_cache_layout

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .modules import (_param, dtype_of, embedding_init, linear, linear_init,
                      normal_, rmsnorm, rmsnorm_init)


# ------------------------------------------------------------------------ MLP
def mlp_init(generator, cfg, dtype, d_ff: int, device=None) -> nn.Module:
    d = cfg.d_model
    kw = dict(dtype=dtype, device=device)
    scale_out = d_ff ** -0.5 / (2 * max(1, cfg.num_layers)) ** 0.5
    p = nn.Module()
    p.wi = linear_init(generator, d, d_ff, **kw)
    if cfg.mlp_type == "swiglu":
        p.wg = linear_init(generator, d, d_ff, **kw)
    p.wo = linear_init(generator, d_ff, d, scale=scale_out, **kw)
    return p


def mlp_apply(p, cfg, x):
    """The MLP; under a mesh that splits its hidden, this rank's columns
    of ``wi``/``wg``, its rows of ``wo``, then the sum over ``model``."""
    tp = tpar.plan(cfg)
    tp = tp if tp is not None and tp.mlp else None
    if tp is not None and p.wi.w.shape[1] != cfg.d_ff // tp.size:
        raise ValueError(f"the MLP's wi holds {p.wi.w.shape[1]} columns: not "
                         f"this rank's block of {cfg.d_ff}")
    x = tpar.copy_in(x, tp)
    if cfg.mlp_type == "swiglu":
        h = F.silu(linear(p.wg, x)) * linear(p.wi, x)
    else:
        h = F.gelu(linear(p.wi, x), approximate="tanh")   # jax.nn.gelu
    h = constrain(h, "dp", None, "tp")     # ff-sharded hidden anchor
    return tpar.reduce_out(linear(p.wo, h), tp)


# ------------------------------------------------------------------- layers
def _attn_init(generator, cfg, dtype, device):
    return attn.mla_init(generator, cfg, dtype, device) \
        if cfg.attention == "mla" else attn.gqa_init(generator, cfg, dtype,
                                                     device)


def dense_layer_init(generator, cfg, dtype, device=None, *,
                     use_moe: bool = False) -> nn.Module:
    p = nn.Module()
    p.ln1 = rmsnorm_init(cfg.d_model, dtype, device=device)
    p.attn = _attn_init(generator, cfg, dtype, device)
    p.ln2 = rmsnorm_init(cfg.d_model, dtype, device=device)
    if use_moe:
        p.moe = moe_mod.moe_init(generator, cfg, dtype, device)
    else:
        p.mlp = mlp_init(generator, cfg, dtype, cfg.d_ff, device)
    return p


def dense_layer_apply(p, cfg, x, positions, *, impl):
    """One [attn, mlp | moe] layer: (x, the layer's MoE aux loss, 0 for
    an MLP)."""
    x = constrain(x, "dp", None, None)     # residual-stream anchor
    h = rmsnorm(p.ln1, x, cfg.norm_eps)
    if cfg.attention == "mla":
        h = attn.mla_apply(p.attn, cfg, h, positions=positions, impl=impl)
    else:
        h = attn.gqa_apply(p.attn, cfg, h, positions=positions, impl=impl)
    x = x + h
    h = rmsnorm(p.ln2, x, cfg.norm_eps)
    if hasattr(p, "moe"):
        h, aux = moe_mod.moe_layer(p.moe, cfg, h)
    else:
        h = mlp_apply(p.mlp, cfg, h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, aux


def ssm_layer_init(generator, cfg, dtype, device=None) -> nn.Module:
    p = nn.Module()
    p.ln = rmsnorm_init(cfg.d_model, dtype, device=device)
    p.mamba = ssm_mod.mamba2_init(generator, cfg, dtype, device)
    return p


def ssm_layer_apply(p, cfg, x):
    return x + ssm_mod.mamba2_apply(p.mamba, cfg,
                                    rmsnorm(p.ln, x, cfg.norm_eps))


# ------------------------------------------------------ hybrid (zamba2-like)
def _lora_init(generator, d_in, d_out, rank, dtype, device=None) -> nn.Module:
    p = nn.Module()
    normal_(_param(p, "a", (d_in, rank), dtype, device), generator,
            d_in ** -0.5)
    nn.init.zeros_(_param(p, "b", (rank, d_out), dtype, device))
    return p


def shared_attn_init(generator, cfg, dtype, device=None) -> nn.Module:
    """The one shared transformer block of zamba2 (attn + mlp)."""
    p = nn.Module()
    p.ln1 = rmsnorm_init(cfg.d_model, dtype, device=device)
    p.attn = attn.gqa_init(generator, cfg, dtype, device)
    p.ln2 = rmsnorm_init(cfg.d_model, dtype, device=device)
    p.mlp = mlp_init(generator, cfg, dtype, cfg.d_ff, device)
    return p


def site_lora_init(generator, cfg, dtype, device=None) -> nn.Module:
    h, kv, hd, d, r = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                       cfg.d_model, cfg.shared_attn_lora_rank)
    p = nn.Module()
    p.q = _lora_init(generator, d, h * hd, r, dtype, device)
    p.k = _lora_init(generator, d, kv * hd, r, dtype, device)
    p.v = _lora_init(generator, d, kv * hd, r, dtype, device)
    return p


def _site_qkv(p, lora):
    """The shared attention's projections with this site's LoRA deltas
    (``attention._project``): ``wq``, ``wk``, ``wv`` each carrying its
    ``(a, b)``, ``wo`` and the rotary frequencies the shared block's."""
    def proj(lin, lo):
        out = types.SimpleNamespace(w=lin.w, lora=(lo.a, lo.b))
        if hasattr(lin, "b"):
            out.b = lin.b
        return out
    return types.SimpleNamespace(wq=proj(p.wq, lora.q), wk=proj(p.wk, lora.k),
                                 wv=proj(p.wv, lora.v), wo=p.wo,
                                 freqs=p.freqs)


def _no_window(cfg):
    """The shared block attends every earlier position, as the
    reference's passes no window."""
    return cfg if cfg.sliding_window is None else dataclasses.replace(
        cfg, sliding_window=None)


def shared_attn_apply(shared, lora, cfg, x, positions, *, impl):
    """Shared block with per-site LoRA deltas on q/k/v projections: the
    GQA attention (``attention.gqa_apply``, its layouts over ``model``
    included) over the shared weights plus this site's deltas, then the
    shared MLP."""
    h = rmsnorm(shared.ln1, x, cfg.norm_eps)
    x = x + attn.gqa_apply(_site_qkv(shared.attn, lora), _no_window(cfg), h,
                           positions=positions, impl=impl)
    h2 = rmsnorm(shared.ln2, x, cfg.norm_eps)
    return x + mlp_apply(shared.mlp, cfg, h2)


def _shared_attn_decode(shared, lora, cfg, h, ck, cv, pos: int):
    """The shared block at one decode position, this site's LoRA added to
    the shared projections (``attention.gqa_decode``); writes k and v at
    ``pos`` into this site's cache views in place."""
    hh = rmsnorm(shared.ln1, h, cfg.norm_eps)
    a, _, _ = attn.gqa_decode(_site_qkv(shared.attn, lora), _no_window(cfg),
                              hh, ck, cv, pos)
    h = h + a
    hh = rmsnorm(shared.ln2, h, cfg.norm_eps)
    return h + mlp_apply(shared.mlp, cfg, hh)


def hybrid_group_counts(cfg) -> tuple[int, int, int]:
    """(pre_layers, groups, layers_per_group) covering cfg.num_layers."""
    k = cfg.shared_attn_every
    groups = cfg.num_layers // k
    pre = cfg.num_layers - groups * k
    return pre, groups, k


# ----------------------------------------------------------------- the model
class Transformer(nn.Module):
    """The parameters of a dense / vlm / moe / ssm / hybrid decoder LM,
    and ``forward``, ``loss``, ``init_cache`` and ``decode_step`` under
    its own config."""

    def __init__(self, cfg, *, device, generator):
        super().__init__()
        self.cfg = cfg
        dtype = dtype_of(cfg.param_dtype)
        kw = dict(device=device)

        def stack(n, init):
            return nn.ModuleList(init() for _ in range(n))

        self.embed = embedding_init(generator, cfg.padded_vocab, cfg.d_model,
                                    dtype, device=device)
        if cfg.input_mode == "embeddings":
            fd = cfg.frontend_dim or cfg.d_model
            self.frontend_proj = linear_init(generator, fd, cfg.d_model,
                                             dtype=dtype, device=device)
        if cfg.family in ("dense", "moe", "vlm"):
            n_moe = cfg.num_layers - cfg.first_dense_layers if cfg.moe else 0
            n_dense = cfg.num_layers - n_moe
            if n_dense:
                self.dense_layers = stack(n_dense, lambda: dense_layer_init(
                    generator, cfg, dtype, use_moe=False, **kw))
            if n_moe:
                self.moe_layers = stack(n_moe, lambda: dense_layer_init(
                    generator, cfg, dtype, use_moe=True, **kw))
        elif cfg.family == "ssm":
            self.ssm_layers = stack(cfg.num_layers, lambda: ssm_layer_init(
                generator, cfg, dtype, **kw))
        elif cfg.family == "hybrid":
            pre, groups, per = hybrid_group_counts(cfg)
            if pre:
                self.pre_layers = stack(pre, lambda: ssm_layer_init(
                    generator, cfg, dtype, **kw))
            self.group_layers = stack(groups, lambda: stack(
                per, lambda: ssm_layer_init(generator, cfg, dtype, **kw)))
            self.shared_attn = shared_attn_init(generator, cfg, dtype, **kw)
            self.site_lora = stack(groups, lambda: site_lora_init(
                generator, cfg, dtype, **kw))
        else:
            raise ValueError(cfg.family)
        self.ln_f = rmsnorm_init(cfg.d_model, dtype, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = linear_init(generator, cfg.d_model,
                                       cfg.padded_vocab, dtype=dtype,
                                       device=device)

    def forward(self, batch, *, impl: str | None = None):
        return forward(self, self.cfg, batch, impl=impl)

    def loss(self, batch):
        return loss_fn(self, self.cfg, batch)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        return init_cache(self.cfg, batch, max_len, dtype,
                          device=self.embed.table.device, mesh=get_mesh())

    def decode_step(self, cache, tokens, pos: int):
        return decode_step(self, self.cfg, cache, tokens, pos)


def init_params(cfg, *, device=None, generator=None) -> Transformer:
    """The model's parameters on ``device``, drawn from ``generator``
    (left unset without one, for a caller that loads them)."""
    return Transformer(cfg, device=device, generator=generator)


def with_params(model, params: dict):
    """A model of ``model``'s class and config holding ``params``
    (state-dict names to tensors, taken as they are, not copied) and
    ``model``'s rotary buffers: the out-of-place train step's new model."""
    new = type(model)(model.cfg, device="meta", generator=None)
    new.load_state_dict(params, assign=True)
    for name, buf in model.named_buffers():
        module, _, attr = name.rpartition(".")
        setattr(new.get_submodule(module), attr, buf)
    return new


#: the ops whose outputs each ``remat_policy`` keeps for the backward,
#: as ``jax.checkpoint_policies`` name them: a dot with batch dims is an
#: ``aten.bmm`` here (the attention einsums), one without an ``aten.mm``
#: (every ``linear``); all else is recomputed
_SAVED_OPS = {
    "nothing_saveable": (),
    "dots_saveable": (torch.ops.aten.mm.default, torch.ops.aten.bmm.default),
    "dots_with_no_batch_dims_saveable": (torch.ops.aten.mm.default,),
}


def _remat(fn, cfg):
    """``fn`` under ``torch.utils.checkpoint`` when gradients are on, the
    reference's ``jax.checkpoint(fn, policy=...)``: the backward recomputes
    what ``cfg.remat_policy`` does not save.  With gradients off, ``fn``
    itself.  The layers draw no random numbers, so no RNG state is kept."""
    saved = _SAVED_OPS[cfg.remat_policy]
    context_fn = functools.partial(
        ckpt.create_selective_checkpoint_contexts, list(saved)) if saved \
        else ckpt.noop_context_fn

    def run(*args, **kw):
        if not torch.is_grad_enabled():
            return fn(*args, **kw)
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=context_fn, **kw)
    return run


def _embed_in(p, cfg, batch, compute_dtype):
    if cfg.input_mode == "embeddings":
        return linear(p.frontend_proj, batch["embeds"].to(compute_dtype))
    return token_embeds(p.embed.table, batch["tokens"], cfg, compute_dtype)


def token_embeds(table, tokens, cfg, compute_dtype):
    """The tokens' rows of ``table`` scaled by sqrt(d_model): a lookup over
    this rank's block of vocab rows where a serving rank holds it
    (``_vocab_parallel_lookup``)."""
    tp = _vocab_plan(cfg)
    if tp is not None and table.shape[0] != cfg.padded_vocab:
        x = _vocab_parallel_lookup(table, tokens, cfg, compute_dtype, tp)
    else:
        x = embedding_lookup(table, tokens, cfg.embed_grad).to(compute_dtype)
    # the reference scales by a weakly typed Python float, which JAX
    # rounds to the compute dtype before the product
    return x * _rounded(cfg.d_model ** 0.5, compute_dtype)


def _vocab_plan(cfg):
    """``tensor_parallel.plan`` where it splits the vocab, else None."""
    tp = tpar.plan(cfg)
    return tp if tp is not None and tp.vocab else None


def _vocab_parallel_lookup(table, tokens, cfg, compute_dtype, tp):
    """The lookup over this rank's block of vocab rows: an id outside the
    block reads zeros, and the sum over ``model`` holds each id's row
    exactly (one rank's row plus zeros), so no step gathers the table."""
    vl = cfg.padded_vocab // tp.size
    if table.shape[0] != vl:
        raise ValueError(f"a table of {table.shape[0]} rows: neither the "
                         f"whole {cfg.padded_vocab} nor this rank's block")
    local = tokens - tp.rank * vl
    inside = (local >= 0) & (local < vl)
    x = embedding_lookup(table, torch.where(inside, local, 0),
                         cfg.embed_grad).to(compute_dtype)
    x = torch.where(inside[..., None], x, 0)
    return tpar.reduce_out(x, tp)


def _rounded(value: float, dtype) -> float:
    """``value`` rounded to ``dtype`` on the host."""
    return float(torch.tensor(value, dtype=dtype))


def _head(p, cfg, x):
    """The f32 logits; under a mesh that splits the vocab, this rank's
    block of them, (..., padded_vocab / m): its columns of ``lm_head``, or
    its rows of the tied table (of the whole table, as training holds it,
    through ``scatter``: the head's gradient lands on these rows only,
    beside the lookup's, which every model rank computes whole once)."""
    x = rmsnorm(p.ln_f, x, cfg.norm_eps)
    tp = _vocab_plan(cfg)
    x = tpar.copy_in(x, tp)
    if cfg.tie_embeddings:
        table = p.embed.table
        if tp is not None and table.shape[0] == cfg.padded_vocab:
            table = tpar.scatter(table, 0, tp)
        elif tp is not None and table.shape[0] != cfg.padded_vocab // tp.size:
            raise ValueError(f"a table of {table.shape[0]} rows: neither the "
                             f"whole {cfg.padded_vocab} nor this rank's block")
        logits = torch.matmul(x, table.to(x.dtype).T)
    else:
        if tp is not None and \
                p.lm_head.w.shape[1] != cfg.padded_vocab // tp.size:
            raise ValueError(f"lm_head holds {p.lm_head.w.shape[1]} columns: "
                             f"not this rank's block of {cfg.padded_vocab}")
        logits = linear(p.lm_head, x)
    return logits.to(torch.float32)


def forward(params, cfg, batch, *, impl: str | None = None):
    """batch: {"tokens": (B,S)} or {"embeds": (B,S,Fd)}. Returns (logits,
    aux); aux is the MoE layers' summed aux loss, 0 for the others.  Under
    a mesh that splits the vocab the logits are this rank's block."""
    cd = dtype_of(cfg.compute_dtype)
    x = _embed_in(params, cfg, batch, cd)
    s = x.shape[1]
    if impl is None:
        impl = "chunked" if s > 8192 else "full"
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.family in ("dense", "moe", "vlm"):
        layer = _remat(dense_layer_apply, cfg)
        for group in ("dense_layers", "moe_layers"):
            if not hasattr(params, group):
                continue
            auxes = []
            for lp in getattr(params, group):
                x, aux = layer(lp, cfg, x, positions, impl=impl)
                auxes.append(aux)
            aux_total = aux_total + torch.stack(auxes).sum()
    elif cfg.family == "ssm":
        layer = _remat(ssm_layer_apply, cfg)
        for lp in params.ssm_layers:
            x = layer(lp, cfg, x)
    elif cfg.family == "hybrid":
        layer = _remat(ssm_layer_apply, cfg)
        for lp in getattr(params, "pre_layers", ()):
            x = layer(lp, cfg, x)
        group = _remat(_hybrid_group, cfg)
        for glayers, lora in zip(params.group_layers, params.site_lora):
            x = group(glayers, lora, params.shared_attn, cfg, x, positions,
                      impl)
    else:
        raise ValueError(cfg.family)
    logits = constrain(_head(params, cfg, x), "dp", None, "tp")
    return logits, aux_total              # keep vocab sharded


def _hybrid_group(glayers, lora, shared, cfg, x, positions, impl):
    """One hybrid group: its SSM layers, each under ``_remat``, then the
    shared block with this site's LoRA."""
    layer = _remat(ssm_layer_apply, cfg)
    for lp in glayers:
        x = layer(lp, cfg, x)
    return shared_attn_apply(shared, lora, cfg, x, positions, impl=impl)


def parallel_cross_entropy(logits, labels, tp=None):
    """Per-position cross entropy, written as the reference writes it for
    a vocab-sharded tensor: ``logsumexp`` minus the logit picked by a
    comparison with an int32 iota (no gather), so the two packages round
    the same sums.  logits: (B, S, V) f32; labels: (B, S) int.

    With ``tp`` (a ``tensor_parallel.Plan``) ``logits`` is this rank's
    vocab block and the reductions run over the blocks: the max over
    ``model`` (no gradient), then one sum of the block's exps and its
    picked logit (zero where the iota's block does not hold the label)."""
    if tp is not None:
        return _parallel_ce_blocks(logits, labels, tp)
    lse = torch.logsumexp(logits, dim=-1)                       # (B,S)
    vocab_iota = torch.arange(logits.shape[-1], dtype=torch.int32,
                              device=logits.device)
    vocab_iota = constrain(vocab_iota, "tp")       # shard w/ logits
    picked = torch.where(vocab_iota == labels[..., None], logits,
                         0.0).sum(dim=-1)                       # (B,S)
    return lse - picked


def _parallel_ce_blocks(logits, labels, tp):
    vl = logits.shape[-1]
    top = tpar.all_max(logits.detach().amax(dim=-1), tp)          # (B,S)
    vocab_iota = torch.arange(tp.rank * vl, (tp.rank + 1) * vl,
                              dtype=torch.int32, device=logits.device)
    picked = torch.where(vocab_iota == labels[..., None], logits,
                         0.0).sum(dim=-1)
    sums = tpar.reduce_out(torch.stack(
        [torch.exp(logits - top[..., None]).sum(dim=-1), picked]), tp)
    return top + torch.log(sums[0]) - sums[1]


def loss_fn(params, cfg, batch):
    """Next-token CE + the MoE aux loss. batch needs "labels":
    (B,S) int. Returns (loss, {"nll", "aux"})."""
    logits, aux = forward(params, cfg, batch)
    nll = parallel_cross_entropy(logits, batch["labels"], _vocab_plan(cfg))
    loss = nll.mean() + 0.01 * aux
    return loss, {"nll": nll.mean(), "aux": aux}


# ------------------------------------------------------------------- decode
def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device=None, mesh=None):
    """The decode cache, zeroed: per layer k and v (or MLA's compressed
    ckv and kr) of ``max_len`` positions in ``dtype``, the SSM layers'
    f32 conv ring and state, the hybrid's per-site k and v.  With a
    ``mesh`` whose ``model`` axis splits the config, each leaf is this
    rank's block as the reference's ``cache_specs`` splits it
    (``attention_cache``, ``ssm.mamba2_decode_init``; shape-only, no
    process group)."""
    def states(*lead):
        st = ssm_mod.mamba2_decode_init(cfg, batch, device=device, mesh=mesh)
        return {k: v.expand(lead + v.shape).contiguous()
                for k, v in st.items()}

    if cfg.family in ("dense", "moe", "vlm"):
        L = cfg.num_layers
        if cfg.attention == "mla":
            m = tpar.tp_size(mesh)
            lora, rope = cfg.kv_lora_rank, cfg.rope_head_dim
            if m > 1:
                lora = lora // m if lora % m == 0 else lora
                rope = rope // m if rope % m == 0 else rope
            return {"ckv": torch.zeros((L, batch, max_len, lora),
                                       dtype=dtype, device=device),
                    "kr": torch.zeros((L, batch, max_len, rope),
                                      dtype=dtype, device=device)}
        shape = attention_cache(cfg, (L, batch), max_len, mesh)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.family == "ssm":
        return {"ssm": states(cfg.num_layers)}
    if cfg.family == "hybrid":
        pre, groups, per = hybrid_group_counts(cfg)
        shape = attention_cache(cfg, (groups, batch), max_len, mesh)
        return {"pre": states(pre) if pre else {},
                "groups": states(groups, per),
                "attn_k": torch.zeros(shape, dtype=dtype, device=device),
                "attn_v": torch.zeros(shape, dtype=dtype, device=device)}
    raise ValueError(cfg.family)


def attention_cache(cfg, lead: tuple, length: int, mesh=None) -> tuple:
    """The shape of a (lead..., S, KV, hd) k or v cache of ``length``
    positions: whole, or with ``mesh`` this rank's block over ``model``
    (``dist.context.tp_cache_layout``): its KV heads, its slice of
    ``head_dim``, or its ``ceil(S / m)`` positions."""
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    layout = "whole" if mesh is None else tp_cache_layout(cfg, mesh)
    m = tpar.tp_size(mesh)
    if layout == "heads":
        kvh //= m
    elif layout == "head_dim":
        hd //= m
    elif layout == "length":
        length = -(-length // m)
    return tuple(lead) + (length, kvh, hd)


def _at(states: dict, index) -> dict:
    """One layer's views of a stacked state tree."""
    return {k: v[index] for k, v in states.items()}


@torch.no_grad()
def decode_step(params, cfg, cache, tokens, pos: int):
    """One decode step. tokens: (B,1) int (or embeds (B,1,Fd)); pos: the
    current position, a Python int.  Writes each layer's cache entries
    (k and v, MLA's ckv and kr, the SSM's conv ring and state) at ``pos``
    into ``cache`` in place; returns (logits (B,1,V), cache)."""
    cd = dtype_of(cfg.compute_dtype)
    batch = {"tokens": tokens} if cfg.input_mode == "tokens" \
        else {"embeds": tokens}
    x = _embed_in(params, cfg, batch, cd)

    def ssm_layer(lp, h, state):
        y, _ = ssm_mod.mamba2_decode(lp.mamba, cfg,
                                     rmsnorm(lp.ln, h, cfg.norm_eps), state)
        return h + y

    if cfg.family in ("dense", "moe", "vlm"):
        off = 0
        for group in ("dense_layers", "moe_layers"):
            layers = getattr(params, group, ())
            for i, lp in enumerate(layers, start=off):
                hh = rmsnorm(lp.ln1, x, cfg.norm_eps)
                if cfg.attention == "mla":
                    a, _, _ = attn.mla_decode(lp.attn, cfg, hh,
                                              cache["ckv"][i],
                                              cache["kr"][i], pos)
                else:
                    a, _, _ = attn.gqa_decode(lp.attn, cfg, hh,
                                              cache["k"][i], cache["v"][i],
                                              pos)
                x = x + a
                hh = rmsnorm(lp.ln2, x, cfg.norm_eps)
                if hasattr(lp, "moe"):
                    m, _ = moe_mod.moe_layer(lp.moe, cfg, hh)
                else:
                    m = mlp_apply(lp.mlp, cfg, hh)
                x = x + m
            off += len(layers)
    elif cfg.family == "ssm":
        for i, lp in enumerate(params.ssm_layers):
            x = ssm_layer(lp, x, _at(cache["ssm"], i))
    elif cfg.family == "hybrid":
        for i, lp in enumerate(getattr(params, "pre_layers", ())):
            x = ssm_layer(lp, x, _at(cache["pre"], i))
        for g, (glayers, lora) in enumerate(zip(params.group_layers,
                                                params.site_lora)):
            for i, lp in enumerate(glayers):
                x = ssm_layer(lp, x, _at(cache["groups"], (g, i)))
            x = _shared_attn_decode(params.shared_attn, lora, cfg, x,
                                    cache["attn_k"][g], cache["attn_v"][g],
                                    pos)
    else:
        raise ValueError(cfg.family)
    return _head(params, cfg, x), cache
