"""The port's dense LM, its server and ``embed_grad`` on the card, at
minicpm-2b's full width with 2 layers: decode against the port's own
forward (f32, the reference's bound 2e-3), the card against the CPU on
the same weights (f32 within ``CARD_CPU_F32``, bf16 within the bf16
logits tolerance), greedy ``generate`` repeatable bit for bit, and the
embedding gradient's segment resolution against the scatter and the
autograd backward.  One test checks that asking for the card without
one raises, and runs wherever the file does.

Every test is marked ``gpu``; those that need the card take the ``cuda``
fixture, which skips where no card is present.  This file imports only
the port:

    PYTHONPATH=src python -m pytest -m gpu -s tests/test_torch_serving_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import embedding_lookup
from repro_torch.core.embed_grad import _grad_scatter, _grad_segment
from repro_torch.examples import serve_lm
from repro_torch.models import build_model, transformer
from repro_torch.serving import ServeConfig, Server

pytestmark = pytest.mark.gpu

CONSISTENCY_TOL = 2e-3     # decode vs forward, tests/test_models.py's
CARD_CPU_F32 = 1e-4        # cuBLAS vs the CPU's GEMMs, f32 without TF32
BF16_TOL = 2e-2            # the bf16 logits tolerance of the CPU tests
EMBED_TOL = 2e-4           # segment vs scatter, tests/test_embed_grad.py's


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _minicpm(layers=2, **changes):
    return dataclasses.replace(get_config("minicpm-2b"), num_layers=layers,
                               **changes)


def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _tokens(cfg, shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, cfg.vocab_size, shape).astype(np.int32))


def test_decode_matches_forward_at_full_width(cuda):
    cfg = _minicpm(compute_dtype="float32")
    model = build_model(cfg, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0))
    toks = _tokens(cfg, (2, 16)).to(cuda)
    with torch.no_grad():
        ref, _ = model.forward({"tokens": toks})
    cache = model.init_cache(2, 16, dtype=torch.float32)
    dec = torch.cat([model.decode_step(cache, toks[:, t:t + 1], t)[0]
                     for t in range(16)], dim=1)
    rel = _rel(dec, ref)
    print(f"decode vs forward, minicpm-2b width, 2 layers: {rel:.3e}")
    assert rel < CONSISTENCY_TOL


def test_card_matches_cpu_on_the_same_weights(cuda):
    cfg = _minicpm()
    card = build_model(cfg, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(1))
    cpu = transformer.init_params(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks = _tokens(cfg, (2, 16), seed=1)
    for cd, tol in (("float32", CARD_CPU_F32), ("bfloat16", BF16_TOL)):
        c = dataclasses.replace(cfg, compute_dtype=cd)
        with torch.no_grad():
            got, _ = transformer.forward(card, c, {"tokens": toks.to(cuda)})
            want, _ = transformer.forward(cpu, c, {"tokens": toks})
        rel = _rel(got, want)
        print(f"card vs CPU, {cd}: {rel:.3e}")
        assert rel <= tol, (cd, rel)


def test_generate_is_repeatable_bit_for_bit(cuda):
    cfg = _minicpm()
    model = build_model(cfg, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(2))
    srv = Server(cfg, ServeConfig(max_len=36), model, device=cuda)
    prompts = _tokens(cfg, (4, 12), seed=2).numpy()
    a = srv.generate(prompts, 24)
    b = srv.generate(prompts, 24)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (4, 24) and (a < cfg.padded_vocab).all()
    solo = srv.generate(prompts[:1], 24)
    print(f"batch row 0 vs alone: {int((solo[0] == a[0]).sum())} of 24 agree")


def test_serve_lm_on_the_card(cuda):
    assert serve_lm.main([]) == 0


def test_embed_grad_segment_matches_scatter(cuda):
    cfg = get_config("minicpm-2b")
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(
        (rng.zipf(1.3, size=(8, 2048)) % cfg.padded_vocab).astype(np.int32)
    ).to(cuda)
    g = torch.randn((8, 2048, cfg.d_model), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(3))
    seg = _grad_segment(ids, g, cfg.padded_vocab)
    sc = _grad_scatter(ids.reshape(-1), g.reshape(-1, cfg.d_model),
                       cfg.padded_vocab)
    torch.testing.assert_close(seg, sc, rtol=EMBED_TOL, atol=EMBED_TOL)
    # the backward is _grad_segment itself: bitwise where index_add_ takes
    # its deterministic form
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        table = torch.zeros((cfg.padded_vocab, cfg.d_model), device=cuda,
                            requires_grad=True)
        embedding_lookup(table, ids, "segment").backward(g)
        want = _grad_segment(ids, g, cfg.padded_vocab)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(table.grad, want)


def test_asking_for_the_card_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("minicpm-2b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, device="cuda")
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(cfg, ServeConfig(), model, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main([])
