"""Per-family layer blocks (pre-norm residual), stacked along a leading
layer axis by ``models.model``.

Families: dense, audio and vlm (attention + SwiGLU MLP), moe (attention +
mixture of experts), ssm (a Mamba-2 block alone) and hybrid (attention and
a Mamba-2 block in parallel on the same input, averaged, then the MLP)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import moe_shard_map
from repro_torch.models.common import (Params, TensorParallel,
                                       init_rms_norm, rms_norm)

ATTN_FAMILIES = ("dense", "moe", "hybrid", "audio", "vlm")


def init_layer(gen: torch.Generator, cfg: ModelConfig, dtype, device=None
               ) -> Params:
    p: Params = {"norm1": init_rms_norm(cfg.d_model, device=device)}
    if cfg.family == "ssm":
        p["mamba"] = mamba_mod.init_mamba(gen, cfg, dtype, device)
        return p
    p["attn"] = attn_mod.init_attention(gen, cfg, dtype, device)
    p["norm2"] = init_rms_norm(cfg.d_model, device=device)
    if cfg.family == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = mlp_mod.init_mlp(gen, cfg, dtype, device)
    if cfg.family == "hybrid":
        p["mamba"] = mamba_mod.init_mamba(gen, cfg, dtype, device)
    return p


def init_layer_lora(gen: torch.Generator, cfg: ModelConfig, device=None
                    ) -> Params:
    p: Params = {}
    if cfg.family == "ssm":
        p["mamba"] = mamba_mod.init_mamba_lora(gen, cfg, device)
        return p
    p["attn"] = attn_mod.init_attention_lora(gen, cfg, device)
    if cfg.family == "moe":
        p["moe"] = moe_mod.init_moe_lora(gen, cfg, device)
    else:
        p["mlp"] = mlp_mod.init_mlp_lora(gen, cfg, device)
    if cfg.family == "hybrid":
        p["mamba"] = mamba_mod.init_mamba_lora(gen, cfg, device)
    return p


def _lget(lora: Optional[Params], key: str) -> Optional[Params]:
    return lora.get(key) if lora is not None else None


def _moe_dispatch(params: Params, lora: Optional[Params], h: torch.Tensor,
                  cfg: ModelConfig, use_lora_kernel: bool,
                  tp: Optional[TensorParallel] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route to the expert-parallel path when a mesh is active
    (``moe_shard_map``: inside the tensor-parallel model ``h`` is this
    rank's block of the batch, else the whole batch); on one card,
    ``moe_forward``."""
    strategy = moe_shard_map.select_strategy(cfg)
    if strategy is not None and tp is not None:
        return moe_shard_map.moe_forward_tp(params, lora, h, cfg, strategy,
                                            tp.batch)
    if strategy is not None:
        return moe_shard_map.moe_forward_dist(params, lora, h, cfg, strategy)
    return moe_mod.moe_forward(params, lora, h, cfg, use_lora_kernel)


def _ffn(params: Params, lora: Optional[Params], x: torch.Tensor,
         cfg: ModelConfig, use_lora_kernel: bool,
         tp: Optional[TensorParallel] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second residual branch: (x + mlp or moe of norm2(x), aux)."""
    h2 = rms_norm(x, params["norm2"], cfg.rms_eps)
    if cfg.family == "moe":
        out, aux = _moe_dispatch(params["moe"], _lget(lora, "moe"), h2, cfg,
                                 use_lora_kernel, tp)
        return x + out, aux
    return x + mlp_mod.mlp_forward(params["mlp"], _lget(lora, "mlp"), h2, cfg,
                                   use_lora_kernel, tp), None


def layer_forward(params: Params, lora: Optional[Params], x: torch.Tensor,
                  cfg: ModelConfig, *, positions: torch.Tensor,
                  impl: str = "chunked", use_lora_kernel: bool = False,
                  tp: Optional[TensorParallel] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence layer. Returns (x, aux_loss). ``impl`` picks the
    attention score path and the SSM scan (``"flash"``: the kernels).
    ``tp``: this rank of a tensor-parallel mesh (attention and the dense
    MLP on their blocks; the Mamba block and the norms replicated, as
    ``param_specs`` lays them out)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, params["norm1"], cfg.rms_eps)
    if cfg.family == "ssm":
        x = x + mamba_mod.mamba_forward(params["mamba"], _lget(lora, "mamba"),
                                        h, cfg, use_lora_kernel, impl)
        return x, aux
    attn_out, _ = attn_mod.attention_forward(
        params["attn"], _lget(lora, "attn"), h, cfg, positions=positions,
        impl=impl, use_lora_kernel=use_lora_kernel, tp=tp)
    if cfg.family == "hybrid":
        ssm_out = mamba_mod.mamba_forward(params["mamba"],
                                          _lget(lora, "mamba"), h, cfg,
                                          use_lora_kernel, impl)
        x = x + 0.5 * (attn_out + ssm_out)
    else:
        x = x + attn_out
    x, moe_aux = _ffn(params, lora, x, cfg, use_lora_kernel, tp)
    return x, aux if moe_aux is None else moe_aux


def init_layer_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device=None) -> Params:
    c: Params = {}
    if cfg.family != "ssm":
        c["kv"] = attn_mod.init_kv_cache(cfg, batch, max_len, dtype, device)
    if cfg.has_ssm:
        c["ssm"] = mamba_mod.init_ssm_cache(cfg, batch, dtype, device)
    return c


def layer_prefill(params: Params, lora: Optional[Params], x: torch.Tensor,
                  cache: Params, cfg: ModelConfig, *, positions: torch.Tensor,
                  use_lora_kernel: bool = False
                  ) -> Tuple[torch.Tensor, Params]:
    """Cache-writing multi-token prefill through a layer. x: (B,C,d);
    ``positions``: (C,) absolute positions of the chunk. The cache is
    updated in place.

    Attention-only families: the SSM-bearing ones carry cumulative state and
    go through ``model.decode_scan`` instead (``model.prefill_chunk``
    raises for them)."""
    h = rms_norm(x, params["norm1"], cfg.rms_eps)
    attn_out, cache["kv"] = attn_mod.attention_prefill(
        params["attn"], _lget(lora, "attn"), h, cache["kv"], cfg,
        positions=positions, use_lora_kernel=use_lora_kernel)
    x, _ = _ffn(params, lora, x + attn_out, cfg, use_lora_kernel)
    return x, cache


def layer_decode(params: Params, lora: Optional[Params], x: torch.Tensor,
                 cache: Params, cfg: ModelConfig, *, t,
                 use_lora_kernel: bool = False,
                 tp: Optional[TensorParallel] = None
                 ) -> Tuple[torch.Tensor, Params]:
    """One-token decode through a layer. x: (B,1,d). The cache is updated
    in place. ``tp``: this rank of a mesh (``x``, ``t`` and the cache its
    blocks): attention over the rank's slots, the Mamba block on its
    channels and state, the dense MLP column- and row-parallel and the MoE
    through ``moe_forward_tp``, as in ``layer_forward``."""
    h = rms_norm(x, params["norm1"], cfg.rms_eps)
    if cfg.family == "ssm":
        out, cache["ssm"] = mamba_mod.mamba_decode(
            params["mamba"], _lget(lora, "mamba"), h, cache["ssm"], cfg, tp)
        return x + out, cache
    attn_out, cache["kv"] = attn_mod.attention_decode(
        params["attn"], _lget(lora, "attn"), h, cache["kv"], cfg, t=t,
        use_lora_kernel=use_lora_kernel, tp=tp)
    if cfg.family == "hybrid":
        ssm_out, cache["ssm"] = mamba_mod.mamba_decode(
            params["mamba"], _lget(lora, "mamba"), h, cache["ssm"], cfg, tp)
        x = x + 0.5 * (attn_out + ssm_out)
    else:
        x = x + attn_out
    x, _ = _ffn(params, lora, x, cfg, use_lora_kernel, tp)
    return x, cache
