"""Batched serving loop: prefill + streaming decode, the port's
counterpart of ``repro.serving.decode``.

Greedy/temperature sampling over batched requests.  The server runs the
model's own ``decode_step`` one token at a time, prefill included, as the
reference does; each new token is read to the host once, where it is
written into the result.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 256
    temperature: float = 0.0          # 0 = greedy
    seed: int = 0


def _sample(logits, temperature: float, generator):
    """A draw from softmax(logits / temperature) per row, by the Gumbel-max
    trick (``jax.random.categorical``'s law; the draws are the port's)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits / temperature - torch.log(-torch.log(u)),
                        dim=-1)


class Server:
    """Serves ``model`` (``repro_torch.models.build_model``'s) on
    ``device``, the card unless the caller asks for the CPU; the model's
    parameters must lie there."""

    def __init__(self, cfg, serve_cfg: ServeConfig, model, *,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        held = {p.device for p in model.parameters()}
        if any(d.type != self.device.type or (
                self.device.index is not None and d.index != self.device.index)
               for d in held):
            raise ValueError(f"the model's parameters lie on {held}, the "
                             f"server runs on {self.device}")
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.model = model

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, n_new: int) -> np.ndarray:
        """prompts: (B, P) int32 token prompts (right-aligned, no padding
        support needed for the synthetic path). Returns (B, n_new) int32."""
        b, plen = prompts.shape
        max_len = self.serve_cfg.max_len
        if plen + n_new > max_len:
            raise ValueError(f"{plen} prompt + {n_new} new tokens exceed "
                             f"max_len {max_len}")
        cache = self.model.init_cache(b, max_len)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.serve_cfg.seed)
        toks = torch.as_tensor(np.asarray(prompts, dtype=np.int32)
                               ).to(self.device)

        # prefill token-by-token, as the reference does
        logits = None
        for t in range(plen):
            logits, cache = self.model.decode_step(cache, toks[:, t:t + 1], t)
        out = np.zeros((b, n_new), dtype=np.int32)
        for i in range(n_new):
            lg = logits[:, -1]
            if self.serve_cfg.temperature > 0:
                tok = _sample(lg, self.serve_cfg.temperature, gen)
            else:
                tok = torch.argmax(lg, dim=-1)
            tok = tok.to(torch.int32)[:, None]
            out[:, i] = tok[:, 0].cpu().numpy()
            logits, cache = self.model.decode_step(cache, tok, plen + i)
        return out
