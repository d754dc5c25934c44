"""Per-family layer blocks (pre-norm residual). Only the dense families
(dense, audio, vlm) are ported; the others raise and name the roadmap item
that ports them."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import Params, init_rms_norm, rms_norm

DENSE_FAMILIES = ("dense", "audio", "vlm")

_NOT_PORTED = {
    "ssm": "ROADMAP.md Queue 1, the SSM and hybrid families item "
           "(models/mamba.py, kernel ssd_intra_chunk)",
    "hybrid": "ROADMAP.md Queue 1, the SSM and hybrid families item "
              "(models/mamba.py, kernel ssd_intra_chunk)",
    "moe": "ROADMAP.md Queue 1, the MoE family item (models/moe.py)",
}


def require_dense(cfg: ModelConfig) -> None:
    if cfg.family in DENSE_FAMILIES:
        return
    where = _NOT_PORTED.get(cfg.family, "ROADMAP.md Queue 1")
    raise NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported to repro_torch "
        f"yet: {where}")


def init_layer(gen: torch.Generator, cfg: ModelConfig, dtype, device=None
               ) -> Params:
    require_dense(cfg)
    return {
        "norm1": init_rms_norm(cfg.d_model, device=device),
        "attn": attn_mod.init_attention(gen, cfg, dtype, device),
        "norm2": init_rms_norm(cfg.d_model, device=device),
        "mlp": mlp_mod.init_mlp(gen, cfg, dtype, device),
    }


def init_layer_lora(gen: torch.Generator, cfg: ModelConfig, device=None
                    ) -> Params:
    require_dense(cfg)
    return {
        "attn": attn_mod.init_attention_lora(gen, cfg, device),
        "mlp": mlp_mod.init_mlp_lora(gen, cfg, device),
    }


def _lget(lora: Optional[Params], key: str) -> Optional[Params]:
    return lora.get(key) if lora is not None else None


def layer_forward(params: Params, lora: Optional[Params], x: torch.Tensor,
                  cfg: ModelConfig, *, positions: torch.Tensor,
                  impl: str = "chunked", use_lora_kernel: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence layer. Returns (x, aux_loss)."""
    require_dense(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, params["norm1"], cfg.rms_eps)
    attn_out, _ = attn_mod.attention_forward(
        params["attn"], _lget(lora, "attn"), h, cfg, positions=positions,
        impl=impl, use_lora_kernel=use_lora_kernel)
    x = x + attn_out
    h2 = rms_norm(x, params["norm2"], cfg.rms_eps)
    x = x + mlp_mod.mlp_forward(params["mlp"], _lget(lora, "mlp"), h2, cfg,
                                use_lora_kernel)
    return x, aux


def init_layer_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device=None) -> Params:
    require_dense(cfg)
    return {"kv": attn_mod.init_kv_cache(cfg, batch, max_len, dtype, device)}


def layer_prefill(params: Params, lora: Optional[Params], x: torch.Tensor,
                  cache: Params, cfg: ModelConfig, *, positions: torch.Tensor,
                  use_lora_kernel: bool = False
                  ) -> Tuple[torch.Tensor, Params]:
    """Cache-writing multi-token prefill through a layer. x: (B,C,d);
    ``positions``: (C,) absolute positions of the chunk. The cache is
    updated in place."""
    require_dense(cfg)
    h = rms_norm(x, params["norm1"], cfg.rms_eps)
    attn_out, cache["kv"] = attn_mod.attention_prefill(
        params["attn"], _lget(lora, "attn"), h, cache["kv"], cfg,
        positions=positions, use_lora_kernel=use_lora_kernel)
    x = x + attn_out
    h2 = rms_norm(x, params["norm2"], cfg.rms_eps)
    x = x + mlp_mod.mlp_forward(params["mlp"], _lget(lora, "mlp"), h2, cfg,
                                use_lora_kernel)
    return x, cache


def layer_decode(params: Params, lora: Optional[Params], x: torch.Tensor,
                 cache: Params, cfg: ModelConfig, *, t,
                 use_lora_kernel: bool = False
                 ) -> Tuple[torch.Tensor, Params]:
    """One-token decode through a layer. x: (B,1,d). The cache is updated
    in place."""
    require_dense(cfg)
    h = rms_norm(x, params["norm1"], cfg.rms_eps)
    attn_out, cache["kv"] = attn_mod.attention_decode(
        params["attn"], _lget(lora, "attn"), h, cache["kv"], cfg, t=t,
        use_lora_kernel=use_lora_kernel)
    x = x + attn_out
    h2 = rms_norm(x, params["norm2"], cfg.rms_eps)
    x = x + mlp_mod.mlp_forward(params["mlp"], _lget(lora, "mlp"), h2, cfg,
                                use_lora_kernel)
    return x, cache
