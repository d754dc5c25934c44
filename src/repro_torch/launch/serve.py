"""Serving steps: prefill and single-token decode (KV cache), and the
``generate`` loop.

``serve_step`` is ONE new token against a cache of ``seq_len``. For SWA
variants the cache is a ring buffer of ``window`` slots
(models/attention.py). Every entry point takes ``device=None`` meaning the
GPU, and raises without one; pass ``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.models.common import Params, resolve_device


def make_serve_step(cfg: ModelConfig, *, device=None) -> Callable:
    device = resolve_device(device)

    @torch.no_grad()
    def serve_step(frozen: Params, lora: Optional[Params], cache: Params,
                   inputs: torch.Tensor, t) -> Tuple[torch.Tensor, Params]:
        inputs = torch.as_tensor(inputs, device=device)
        return model_lib.decode_step(frozen, lora, cache, inputs, t, cfg)

    return serve_step


def make_prefill_step(cfg: ModelConfig, *, impl: str = "chunked",
                      device=None) -> Callable:
    device = resolve_device(device)

    @torch.no_grad()
    def prefill_step(frozen: Params, lora: Optional[Params],
                     inputs: torch.Tensor) -> torch.Tensor:
        inputs = torch.as_tensor(inputs, device=device)
        logits, _ = model_lib.prefill(frozen, lora, inputs, cfg, impl=impl)
        return logits

    return prefill_step


@torch.no_grad()
def generate(cfg: ModelConfig, frozen: Params, lora: Optional[Params],
             prompt: torch.Tensor, max_new: int, *, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             device=None) -> torch.Tensor:
    """Greedy/sampled autoregressive generation.

    prompt: (B, S0) tokens (or (B, S0, d) embeds). Returns (B, max_new)
    int32. Sampling (``temperature > 0``) draws from ``generator``, which
    must live on the device."""
    device = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=device)
    b = prompt.shape[0]
    s0 = prompt.shape[1]
    cache = model_lib.init_cache(cfg, b, s0 + max_new, device=device)
    serve_step = make_serve_step(cfg, device=device)

    # prefill token-by-token through the cache (exercises the decode path)
    logits = None
    for t in range(s0):
        logits, cache = serve_step(frozen, lora, cache, prompt[:, t:t + 1], t)
    out = []
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    if generator is None and temperature > 0:
        generator = torch.Generator(device=device).manual_seed(0)
    for i in range(max_new):
        out.append(tok)
        logits, cache = serve_step(frozen, lora, cache, tok, s0 + i)
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator
                                    ).to(torch.int32)
        else:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    return torch.cat(out, dim=1)
