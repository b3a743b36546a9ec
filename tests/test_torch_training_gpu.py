"""The port's training path on the card: one f32 step at minicpm-2b's
full width over 2 layers against the CPU on the same weights, the
in-place step against the out-of-place one and the Trainer's restart
against a straight run (each within ``RESUME_TOL`` under
``torch.use_deterministic_algorithms``), a step with no host sync in it,
and the entry points.  One test checks that asking for the
card without one raises, and runs wherever the file does.

Every test is marked ``gpu``; those that need the card take the ``cuda``
fixture, which skips where no card is present.  This file imports only
the port:

    PYTHONPATH=src python -m pytest -m gpu -s tests/test_torch_training_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.examples import train_lm
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, transformer
from repro_torch.optim import adamw
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.trainer import put_batch

pytestmark = pytest.mark.gpu

# card vs CPU, f32 without TF32: the loss and the grad norm differ in the
# GEMMs' order of additions; a parameter by at most a tenth of lr (AdamW
# normalises each gradient element: tests/test_torch_trainer.py)
CARD_CPU_TOL = 1e-5
PARAM_ATOL_LR = 0.1
# a rerun or a restart within the reference test's own bound
# (tests/test_trainer.py::test_resume_bit_exact), under
# torch.use_deterministic_algorithms: in the default mode index_add_'s
# atomics reorder the embedding gradient's sums, and AdamW's
# normalisation carries that to a few lr in places at full width
# (chip_smoke.py's [train] prints it)
RESUME_TOL = 1e-6
OPT = adamw.AdamWConfig(peak_lr=3e-4, warmup=2, total_steps=6,
                        schedule="wsd")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


def _data(cfg, b=1, s=128):
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, global_batch=b,
                                  seq_len=s))


def _state(model, opt=OPT):
    return {"params": model, "opt": adamw.init_state(model, opt)}


def test_train_step_card_matches_cpu(cuda):
    cfg = dataclasses.replace(get_config("minicpm-2b"), num_layers=2,
                              compute_dtype="float32")
    card = build_model(cfg, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(1))
    cpu = transformer.init_params(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    batch = _data(cfg).batch_at(0)
    step = steps.make_train_step(cfg, OPT)
    cn, cm = step(_state(card), put_batch(batch, cuda))
    hn, hm = step(_state(cpu), put_batch(batch, "cpu"))
    for k in ("loss", "grad_norm"):
        rel = abs(float(cm[k]) - float(hm[k])) / abs(float(hm[k]))
        print(f"card vs CPU {k}: {rel:.3e}")
        assert rel <= CARD_CPU_TOL
    hp = dict(hn["params"].named_parameters())
    lr = float(hm["lr"])
    worst = max(float((p.detach().cpu() - hp[k].detach()).abs().max())
                for k, p in cn["params"].named_parameters())
    print(f"card vs CPU parameters: {worst / lr:.4f} lr")
    assert worst <= PARAM_ATOL_LR * lr


def test_in_place_step_matches_out_of_place(cuda, deterministic):
    cfg = get_config("minicpm-2b").reduced()
    gen = torch.Generator(cuda)
    a = _state(build_model(cfg, device=cuda, generator=gen.manual_seed(2)))
    b = _state(build_model(cfg, device=cuda, generator=gen.manual_seed(2)))
    out_of_place = steps.make_train_step(cfg, OPT)
    in_place = steps.make_train_step(cfg, OPT, donate=True)
    data = _data(cfg, 4, 64)
    for i in range(3):
        batch = put_batch(data.batch_at(i), cuda)
        a, ma = out_of_place(a, batch)
        params = b["params"]
        b, mb = in_place(b, batch)
        assert b["params"] is params
        assert abs(float(ma["loss"]) - float(mb["loss"])) <= \
            RESUME_TOL * abs(float(ma["loss"]))
    pa = dict(a["params"].named_parameters())
    for k, p in b["params"].named_parameters():
        torch.testing.assert_close(p, pa[k], rtol=RESUME_TOL,
                                   atol=RESUME_TOL)
    assert int(b["opt"]["step"]) == 3


def test_train_step_makes_no_host_sync(cuda):
    """The step reads nothing back: the schedule, the norm and the lr
    stay on the card (a warm-up step first, outside the check)."""
    cfg = get_config("minicpm-2b").reduced()
    state = _state(build_model(cfg, device=cuda))
    step = steps.make_train_step(cfg, OPT, donate=True)
    data = _data(cfg, 2, 32)
    state, _ = step(state, put_batch(data.batch_at(0), cuda))
    batch = put_batch(data.batch_at(1), cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, met = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(met["loss"]))


def test_trainer_restart_on_the_card(cuda, deterministic, tmp_path):
    cfg = get_config("minicpm-2b").reduced()
    data = _data(cfg, 4, 64)

    def run(d, total):
        tr = Trainer(TrainerConfig(total_steps=total, ckpt_dir=str(d),
                                   ckpt_every=3, ckpt_async=True),
                     cfg, OPT, steps.make_train_step(cfg, OPT), data,
                     init_generator=torch.Generator(cuda).manual_seed(4),
                     device=cuda)
        return tr, tr.run()

    straight, out = run(tmp_path / "a", 6)
    run(tmp_path / "b", 3)
    resumed, out2 = run(tmp_path / "b", 6)
    assert resumed.start_step == 3 and out2["final_step"] == 6
    pa = dict(straight.state["params"].named_parameters())
    worst = 0.0
    for k, p in resumed.state["params"].named_parameters():
        worst = max(worst, float((p - pa[k]).detach().abs().max()))
        torch.testing.assert_close(p, pa[k], rtol=RESUME_TOL,
                                   atol=RESUME_TOL)
    print(f"restart vs straight on the card: {worst:.3e}")


def test_entry_points_on_the_card(cuda, tmp_path):
    assert train_lm.main(["--steps", "20", "--ckpt-dir",
                          str(tmp_path / "a")]) == 0
    assert launch_train.main(["--arch", "minicpm-2b", "--reduced",
                              "--steps", "10", "--ckpt-dir",
                              str(tmp_path / "b")]) == 0


def test_asking_for_the_card_without_one_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("minicpm-2b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainerConfig(ckpt_dir=str(tmp_path)), cfg, OPT,
                steps.make_train_step(cfg, OPT), _data(cfg))
    for main, argv in ((train_lm.main, []),
                       (launch_train.main, ["--arch", "minicpm-2b",
                                            "--reduced"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv + ["--ckpt-dir", str(tmp_path / "x")])
