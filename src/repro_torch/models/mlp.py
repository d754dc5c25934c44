"""SwiGLU MLP (dense archs) with LoRA adapters."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (Params, TensorParallel, dense_init,
                                       dtype_of, init_lora_pair, lora_dense,
                                       maybe_lora, row_parallel_dense, silu)


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype, device=None
             ) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(gen, d, f, dtype, device),
        "w_up": dense_init(gen, d, f, dtype, device),
        "w_down": dense_init(gen, f, d, dtype, device),
    }


def init_mlp_lora(gen: torch.Generator, cfg: ModelConfig, device=None
                  ) -> Params:
    r, d, f = cfg.lora.rank, cfg.d_model, cfg.d_ff
    out: Params = {}
    ldt = dtype_of(cfg.lora.dtype)
    t = cfg.lora.targets
    if "w_gate" in t:
        out["w_gate"] = init_lora_pair(gen, d, f, r, ldt, device)
    if "w_up" in t:
        out["w_up"] = init_lora_pair(gen, d, f, r, ldt, device)
    if "w_down" in t:
        out["w_down"] = init_lora_pair(gen, f, d, r, ldt, device)
    return out


def mlp_forward(params: Params, lora: Optional[Params], x: torch.Tensor,
                cfg: ModelConfig, use_lora_kernel: bool = False,
                tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """SwiGLU. With ``tp`` and a width the model axis divides, the gate and
    up projections are column-parallel (this rank's block of ``d_ff``) and
    the down projection row-parallel (summed over "model")."""
    s = cfg.lora.scale
    g = lora_dense(x, params["w_gate"], maybe_lora(lora, "w_gate"), s,
                   use_kernel=use_lora_kernel)
    u = lora_dense(x, params["w_up"], maybe_lora(lora, "w_up"), s,
                   use_kernel=use_lora_kernel)
    if tp is not None and tp.splits(cfg.d_ff):
        return row_parallel_dense(silu(g) * u, params["w_down"],
                                  maybe_lora(lora, "w_down"), s, tp,
                                  use_lora_kernel)
    return lora_dense(silu(g) * u, params["w_down"],
                      maybe_lora(lora, "w_down"), s,
                      use_kernel=use_lora_kernel)
