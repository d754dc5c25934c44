"""Serving on the port: batched autoregressive decoding with KV/SSM caches
for every model family (reduced configs).

    python -m repro_torch.launch.serve_multiarch [--device cpu]

The twin of the reference's ``examples/serve_multiarch.py``: dense GQA
full-cache, Mamba2 constant state, hybrid attention + SSM, MoE top-k
routing, and an embeds frontend (a MusicGen stub: one decode step from a
frame embedding); then multi-tenant continuous batching (one frozen
backbone, a bank of three LoRA adapters gathered per slot in each decode
tick, chunked prefill, and channel-aware admission sharing the edge band
with SL training). ``device=None`` is the GPU and raises without one.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.launch.serve import generate
from repro_torch.models import model as M
from repro_torch.models.common import Params, describe_device, resolve_device

ARCHS = ["qwen3-0.6b", "granite-moe-3b-a800m", "mamba2-370m", "hymba-1.5b",
         "qwen2-7b"]


def serve_arch(cfg: ModelConfig, params: Params, prompt: torch.Tensor, *,
               max_new: int = 12, temperature: float = 0.8,
               generator: Optional[torch.Generator] = None,
               device=None) -> torch.Tensor:
    """``generate`` ``max_new`` tokens after ``prompt`` (B, S0) and print
    one line; returns the (B, max_new) tokens."""
    dev = resolve_device(device)
    t0 = time.time()
    toks = generate(cfg, params["frozen"], params["lora"], prompt,
                    max_new=max_new, temperature=temperature,
                    generator=generator, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"{cfg.name:24s} [{cfg.family:6s}] generated {tuple(toks.shape)} "
          f"in {dt:5.1f}s  sample={toks[0, :6].tolist()}")
    return toks


def frame_decode(cfg: ModelConfig, params: Params, frame: torch.Tensor, *,
                 device=None) -> torch.Tensor:
    """One decode step of an embeds-mode decoder from a (B, 1, d) frame
    embedding at position 0; returns the logits."""
    dev = resolve_device(device)
    cache = M.init_cache(cfg, frame.shape[0], 16, device=dev)
    with torch.no_grad():
        logits, _ = M.decode_step(params["frozen"], params["lora"], cache,
                                  frame.to(dev), 0, cfg)
    print(f"{cfg.name:24s} [{cfg.family:6s}] one decode step from a frame "
          f"embedding -> logits {tuple(logits.shape)}")
    return logits


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"== five families, reduced, on {describe_device(dev)} ==")
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        params = M.init_params(0, cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        prompt = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen,
                               device=dev, dtype=torch.int32)
        out[arch] = serve_arch(
            cfg, params, prompt, max_new=12, temperature=0.8,
            generator=torch.Generator(device=dev).manual_seed(2), device=dev)

    # embeds-mode arch: the frontend stub provides frame embeddings; decode
    # then feeds generated tokens through the decoder's own embedding table
    cfg = get_config("musicgen-large").reduced()
    params = M.init_params(0, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    frame = torch.randn((1, 1, cfg.d_model), generator=gen, device=dev) * 0.02
    out[cfg.name] = frame_decode(cfg, params, frame, device=dev)
    continuous_batching_demo(device=dev)
    return out


def continuous_batching_demo(device=None) -> Dict[str, Any]:
    """Multi-tenant continuous batching: one frozen backbone, a bank of
    fleet LoRA adapters gathered per slot in each decode tick, chunked
    prefill, and channel-aware admission sharing the edge band with SL
    training. Returns the engine's summary."""
    from repro_torch.serving import (AdapterBank, ChannelAdmissionController,
                                     Request, ServingEngine)

    dev = resolve_device(device)
    cfg = get_config("qwen3-0.6b").reduced()
    params = M.init_params(0, cfg, dev)
    bank = AdapterBank([M.init_params(s, cfg, dev)["lora"]
                        for s in (0, 7, 13)])
    ctl = ChannelAdmissionController(bandwidth_hz=2e5,
                                     training_reserve_frac=0.5,
                                     token_rate_per_s=200.0, seed=0)
    eng = ServingEngine(cfg, params["frozen"], bank, slots=3, max_len=64,
                        prefill_chunk=4, admission=ctl, device=dev)
    rng = np.random.default_rng(0)
    for i in range(6):
        eng.submit(Request(uid=i,
                           prompt=rng.integers(0, cfg.vocab_size, 4 + i,
                                               dtype=np.int32),
                           max_new=8, adapter_id=i % bank.n))
    stats = eng.run_until_drained()
    print(f"continuous batching: {stats['completed']} reqs x "
          f"{bank.n} adapters, {stats['tokens']} tokens in "
          f"{stats['ticks']} ticks + {stats['prefills']} prefill chunks "
          f"({stats['tokens_per_sec']:.1f} tok/s on {describe_device(dev)}, "
          f"ttft {stats['mean_ttft_s']:.2f}s)")
    adm = stats["admission"]
    for aid, t in adm["tenants"].items():
        print(f"  tenant adapter={aid}: {t['admitted']} admitted, "
              f"{t['blocked_attempts']} blocked attempts, "
              f"mean demand {t['mean_demand_hz'] / 1e3:.1f} kHz "
              f"of {adm['capacity_hz'] / 1e3:.0f} kHz serving capacity")
    return stats


if __name__ == "__main__":
    main()
