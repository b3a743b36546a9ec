"""The MoE (with MLA), SSM, hybrid and enc-dec families on the card, each
at full width over a cut depth: decode against the port's own forward
(f32, the reference's bound 2e-3, the MoE at a capacity no expert's load
passes), the card against the CPU on the same weights (f32 within
``CARD_CPU_F32``), ``moe_apply`` on identical inputs with equal routing,
greedy ``generate`` repeatable bit for bit, and a decode step that reads
nothing on the host (``torch.cuda.set_sync_debug_mode("error")``).

Every test is marked ``gpu`` and takes the ``cuda`` fixture, which skips
where no card is present.  This file imports only the port:

    PYTHONPATH=src python -m pytest -m gpu -s tests/test_torch_families_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model, moe
from repro_torch.models.model import family, init_params
from repro_torch.serving import ServeConfig, Server

pytestmark = pytest.mark.gpu

CONSISTENCY_TOL = 2e-3     # decode vs forward, tests/test_models.py's
CARD_CPU_F32 = 1e-4        # cuBLAS vs the CPU's GEMMs, f32 without TF32
# one config per family at full width, its depth cut (the hybrid at 4
# layers every 2: two groups of two; the MoE with 32 routed experts)
CUTS = {
    "mamba2-370m": dict(num_layers=2),
    "zamba2-1.2b": dict(num_layers=4, shared_attn_every=2),
    "seamless-m4t-large-v2": dict(num_layers=2, encoder_layers=2),
    "deepseek-v2-236b": dict(num_layers=2, num_experts=32),
    "dbrx-132b": dict(num_layers=2, num_experts=4),
}
FRAMES = 16                # the enc-dec's frame embeddings


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _cfg(arch, **changes):
    return dataclasses.replace(get_config(arch), **CUTS[arch], **changes)


def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _batch(cfg, b, s, dev, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).to(dev)}
    if cfg.is_encdec:
        out["embeds"] = torch.from_numpy(rng.standard_normal(
            (b, FRAMES, cfg.frontend_dim)).astype(np.float32)).to(dev)
    return out


def _cache(model, cfg, b, max_len, dtype, batch):
    if cfg.is_encdec:
        cache = model.init_cache(b, max_len, enc_len=FRAMES, dtype=dtype)
        return model.prefill_memory(cache, batch["embeds"])
    return model.init_cache(b, max_len, dtype=dtype)


@pytest.mark.parametrize("arch", list(CUTS))
def test_decode_matches_forward_at_full_width(cuda, arch):
    changes = dict(compute_dtype="float32")
    cfg = _cfg(arch, **changes)
    if cfg.moe:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    model = build_model(cfg, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0))
    batch = _batch(cfg, 2, 16, cuda)
    with torch.no_grad():
        ref, _ = model.forward(batch)
    cache = _cache(model, cfg, 2, 16, torch.float32, batch)
    dec = torch.cat([model.decode_step(cache, batch["tokens"][:, t:t + 1],
                                       t)[0] for t in range(16)], dim=1)
    rel = _rel(dec, ref)
    print(f"{arch} {CUTS[arch]}: decode vs forward {rel:.3e}")
    assert rel < CONSISTENCY_TOL


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b",
                                  "seamless-m4t-large-v2",
                                  "deepseek-v2-236b"])
def test_card_matches_cpu_on_the_same_weights(cuda, arch):
    cfg = _cfg(arch, compute_dtype="float32")
    card = build_model(cfg, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(1))
    cpu = init_params(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    batch = _batch(cfg, 2, 16, "cpu", seed=2)
    with torch.no_grad():
        got, _ = family(cfg).forward(card, cfg, {k: v.to(cuda)
                                                 for k, v in batch.items()})
        want, _ = family(cfg).forward(cpu, cfg, batch)
    rel = _rel(got, want)
    print(f"{arch}: card vs CPU, f32, {rel:.3e}")
    assert rel <= CARD_CPU_F32


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_moe_apply_on_the_card_matches_the_cpu(cuda, cd):
    """deepseek's MoE layer (32 routed experts, 2 shared) on identical
    inputs: the routing equal, the outputs within the dtype's bound."""
    cfg = _cfg("deepseek-v2-236b")
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cd]
    p = moe.moe_init(torch.Generator(cuda).manual_seed(3), cfg,
                     torch.float32, device=cuda)
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator(
        cuda).manual_seed(4), device=cuda).to(dt)
    with torch.no_grad():
        got, aux = moe.moe_apply(p, cfg, x)
        q = moe.moe_init(None, cfg, torch.float32, device="cpu")
        q.load_state_dict({k: v.cpu() for k, v in p.state_dict().items()})
        want, want_aux = moe.moe_apply(q, cfg, x.cpu())

        def picks(mod, h):
            g = torch.softmax(h.reshape(-1, cfg.d_model).float()
                              @ mod.router.w.float(), dim=-1)
            return torch.topk(g, cfg.top_k, dim=-1)[1].cpu()
        assert torch.equal(picks(p, x), picks(q, x.cpu()))
    tol = CARD_CPU_F32 if cd == "float32" else 2e-2
    assert _rel(got.float(), want.float()) <= tol
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)


@pytest.mark.parametrize("arch", list(CUTS))
def test_generate_is_repeatable_and_reads_nothing_on_the_host(cuda, arch):
    """Greedy ``generate`` in the config's bf16 twice: equal tokens (the
    MoE's combine gathers, no atomics); then one decode step under
    ``set_sync_debug_mode("error")``."""
    cfg = _cfg(arch)
    model = build_model(cfg, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(5))
    srv = Server(cfg, ServeConfig(max_len=16), model, device=cuda)
    prompts = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    a, b = srv.generate(prompts, 10), srv.generate(prompts, 10)
    assert np.array_equal(a, b)
    batch = _batch(cfg, 2, 1, cuda)
    with torch.inference_mode():
        cache = _cache(model, cfg, 2, 4, torch.bfloat16, batch)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, _ = model.decode_step(cache, batch["tokens"], 0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(logits).all())
