"""GQA attention: init, full-sequence (prefill) forward, cached decode.

Three score paths:
  * ``naive``   — full (Sq, Skv) score matrix; oracle for tests, and the path
                  of every cached step (decode, chunked prefill).
  * ``chunked`` — same signature; delegates to ``naive`` (see its docstring).
  * ``flash``   — the CUDA kernel in ``repro_torch.kernels.flash_attention``
                  (the counterpart of the reference's ``pallas``).

Supports causal masking, sliding windows (SWA), GQA head grouping, RoPE,
qk-norm (Qwen3) and QKV bias (Qwen2).

The cache functions update the cache they are given IN PLACE and return it:
the reference returns a new cache from every step, which on this side would
copy the whole cache once per token.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (ACC_DTYPE, Params, apply_rope,
                                       dense_init, dtype_of, init_lora_pair,
                                       init_rms_norm, lora_dense, maybe_lora,
                                       rms_norm)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype, device=None
                   ) -> Params:
    d, q_dim, kv_dim = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p: Params = {
        "wq": dense_init(gen, d, q_dim, dtype, device),
        "wk": dense_init(gen, d, kv_dim, dtype, device),
        "wv": dense_init(gen, d, kv_dim, dtype, device),
        "wo": dense_init(gen, q_dim, d, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((q_dim,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv_dim,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv_dim,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(cfg.resolved_head_dim, device=device)
        p["k_norm"] = init_rms_norm(cfg.resolved_head_dim, device=device)
    return p


def init_attention_lora(gen: torch.Generator, cfg: ModelConfig, device=None
                        ) -> Params:
    r = cfg.lora.rank
    d, q_dim, kv_dim = cfg.d_model, cfg.q_dim, cfg.kv_dim
    out: Params = {}
    t = cfg.lora.targets
    ldt = dtype_of(cfg.lora.dtype)
    if "wq" in t:
        out["wq"] = init_lora_pair(gen, d, q_dim, r, ldt, device)
    if "wk" in t:
        out["wk"] = init_lora_pair(gen, d, kv_dim, r, ldt, device)
    if "wv" in t:
        out["wv"] = init_lora_pair(gen, d, kv_dim, r, ldt, device)
    if "wo" in t:
        out["wo"] = init_lora_pair(gen, q_dim, d, r, ldt, device)
    return out


# ---------------------------------------------------------------------------
# Score paths
# ---------------------------------------------------------------------------


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1)


def naive_attention(q, k, v, *, causal: bool, window: int,
                    q_positions, k_positions) -> torch.Tensor:
    """q: (B,Sq,Hq,D); k,v: (B,Skv,Hkv,D). Oracle path."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, sq, hkv, group, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(ACC_DTYPE),
                          k.to(ACC_DTYPE)) / math.sqrt(float(d))
    mask = k_positions[:, None, :] <= q_positions[:, :, None]  # (B,Sq,Skv)
    if not causal:
        mask = torch.ones_like(mask)
    if window:
        mask = mask & (k_positions[:, None, :]
                       > (q_positions[:, :, None] - window))
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(ACC_DTYPE))
    return out.reshape(b, sq, hq, d).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, window: int,
                      q_positions, k_positions) -> torch.Tensor:
    """Same signature and result as ``naive_attention``, to which it
    delegates: the reference's chunked path exists to bound the memory of a
    lowered graph; here the bounded-memory path is ``impl="flash"``."""
    return naive_attention(q, k, v, causal=causal, window=window,
                           q_positions=q_positions, k_positions=k_positions)


def attention_scores(q, k, v, *, impl: str, causal: bool, window: int,
                     q_positions, k_positions) -> torch.Tensor:
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_positions=q_positions, k_positions=k_positions)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_positions=q_positions,
                                 k_positions=k_positions)
    if impl == "flash":
        from repro_torch.kernels import ops as kernel_ops
        return kernel_ops.flash_attention(q, k, v, causal=causal, window=window,
                                          q_positions=q_positions,
                                          k_positions=k_positions)
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------------------
# Forward (prefill) and cached decode
# ---------------------------------------------------------------------------


def _qkv(params: Params, lora: Optional[Params], x: torch.Tensor,
         cfg: ModelConfig, positions: torch.Tensor, use_lora_kernel: bool):
    """Projections, head split, qk-norm and RoPE shared by every path."""
    scale = cfg.lora.scale
    q = lora_dense(x, params["wq"], maybe_lora(lora, "wq"), scale,
                   params.get("bq"), use_kernel=use_lora_kernel)
    k = lora_dense(x, params["wk"], maybe_lora(lora, "wk"), scale,
                   params.get("bk"), use_kernel=use_lora_kernel)
    v = lora_dense(x, params["wv"], maybe_lora(lora, "wv"), scale,
                   params.get("bv"), use_kernel=use_lora_kernel)
    q = _split_heads(q, cfg.n_heads)
    k = _split_heads(k, cfg.n_kv_heads)
    v = _split_heads(v, cfg.n_kv_heads)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.rms_eps)
        k = rms_norm(k, params["k_norm"], cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_forward(params: Params, lora: Optional[Params], x: torch.Tensor,
                      cfg: ModelConfig, *, positions: torch.Tensor,
                      impl: str = "chunked",
                      use_lora_kernel: bool = False
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention. Returns (out, {"k","v"} post-RoPE for cache)."""
    q, k, v = _qkv(params, lora, x, cfg, positions, use_lora_kernel)
    out = attention_scores(q, k, v, impl=impl, causal=True,
                           window=cfg.sliding_window,
                           q_positions=positions, k_positions=positions)
    out = out.reshape(x.shape[0], x.shape[1], cfg.q_dim)
    out = lora_dense(out, params["wo"], maybe_lora(lora, "wo"),
                     cfg.lora.scale, use_kernel=use_lora_kernel)
    return out, {"k": k, "v": v}


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device=None) -> Dict[str, torch.Tensor]:
    """Per-layer cache. SWA archs keep a ring buffer of ``window`` slots.

    ``cfg.kv_cache_dtype == 'int8'``: k/v stored int8 with one f32 scale per
    (slot, kv-head)."""
    slots = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, slots, cfg.n_kv_heads, cfg.resolved_head_dim)
    if cfg.kv_cache_dtype == "int8":
        sshape = (batch, slots, cfg.n_kv_heads, 1)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quant_kv(x: torch.Tensor):
    xf = x.to(torch.float32)
    scale = torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    # torch.round is round-half-to-even, as jnp.round
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _cache_abs_positions(t: torch.Tensor, slots: int, window: int, b: int
                         ) -> torch.Tensor:
    """(B, slots) absolute position held by each cache slot after the write
    at position(s) ``t`` (scalar or per-row (B,) vector).

    Linear cache: slot j holds position j (stale j > t masked causally).
    Ring (SWA):   slot j holds ``t - ((t - j) mod W)`` — valid iff >= 0.
    """
    j = torch.arange(slots, dtype=torch.int32, device=t.device)
    if window and window <= slots:
        tb = t[:, None] if t.ndim else t.expand(b)[:, None]
        abs_pos = tb - torch.remainder(tb - j[None, :], slots)
        return torch.where(abs_pos >= 0, abs_pos,
                           torch.full_like(abs_pos, 2**30))  # unwritten slots
    return j.expand(b, slots)


def _dequant_views(cache: Dict[str, torch.Tensor], dtype, int8: bool):
    if int8:
        k_cache = (cache["k"].to(torch.float32) * cache["k_scale"]).to(dtype)
        v_cache = (cache["v"].to(torch.float32) * cache["v_scale"]).to(dtype)
        return k_cache, v_cache
    return cache["k"], cache["v"]


def _write_kv(cache: Dict[str, torch.Tensor], k: torch.Tensor,
              v: torch.Tensor, slot: torch.Tensor, dtype, int8: bool
              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Write one token per row at ``slot`` (scalar or (B,) vector), in place.

    Returns (cache, dequantized k view, dequantized v view)."""
    if int8:
        kq, ks = _quant_kv(k)
        vq, vs = _quant_kv(v)
        entries = (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))
    else:
        entries = (("k", k), ("v", v))
    slot = slot.to(torch.long)
    for name, val in entries:
        val = val.to(cache[name].dtype)
        if slot.ndim:                                      # per-row slots
            rows = torch.arange(val.shape[0], device=val.device)
            cache[name][rows, slot] = val[:, 0]
        else:
            cache[name].index_copy_(1, slot.reshape(1), val)
    k_cache, v_cache = _dequant_views(cache, dtype, int8)
    return cache, k_cache, v_cache


def attention_decode(params: Params, lora: Optional[Params], x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], cfg: ModelConfig, *,
                     t, use_lora_kernel: bool = False
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (B,1,d); t: int32 absolute position — a scalar
    (whole batch at one position) or a (B,) vector (continuous-batching
    serving: every row at its own position). The cache is updated in place.

    Full cache: write at slot ``t``, attend over slots ``<= t``.
    Ring (SWA): write at ``t % W``; slot j holds absolute position
    ``t - ((t - j) mod W)`` — valid iff >= 0.
    """
    b = x.shape[0]
    t = torch.as_tensor(t, dtype=torch.int32, device=x.device)
    pos = t[:, None] if t.ndim else t.expand(b)[:, None]
    q, k, v = _qkv(params, lora, x, cfg, pos, use_lora_kernel)

    slots = cache["k"].shape[1]
    slot = torch.remainder(t, slots)
    cache, k_cache, v_cache = _write_kv(
        cache, k, v, slot, x.dtype, cfg.kv_cache_dtype == "int8")
    k_positions = _cache_abs_positions(t, slots, cfg.sliding_window, b)

    out = naive_attention(q, k_cache, v_cache, causal=True,
                          window=cfg.sliding_window,
                          q_positions=pos, k_positions=k_positions)
    out = out.reshape(b, 1, cfg.q_dim)
    out = lora_dense(out, params["wo"], maybe_lora(lora, "wo"),
                     cfg.lora.scale, None, use_lora_kernel)
    return out, cache


def attention_prefill(params: Params, lora: Optional[Params], x: torch.Tensor,
                      cache: Dict[str, torch.Tensor], cfg: ModelConfig, *,
                      positions: torch.Tensor, use_lora_kernel: bool = False
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cached multi-token prefill: one parallel pass over a prompt chunk.

    x: (B, C, d) chunk hidden states; ``positions``: (C,) absolute positions
    shared across the batch (chunks are fed in order, so the chunk occupies
    a contiguous position range). Writes the chunk's K/V into the cache in
    place (linear slot ``p``; ring slot ``p mod W`` — requires C <= slots so
    one chunk never overwrites itself) and attends over the WHOLE cache with
    the same masking semantics as ``attention_decode``, which is what makes
    chunk i see chunks < i. Returns (out (B, C, q_dim), cache).
    """
    b, c, _ = x.shape
    positions = positions.to(torch.int32)
    pos = positions[None, :].expand(b, c)
    q, k, v = _qkv(params, lora, x, cfg, pos, use_lora_kernel)

    slots = cache["k"].shape[1]
    idx = torch.remainder(positions, slots).to(torch.long)   # (C,)
    int8 = cfg.kv_cache_dtype == "int8"
    if int8:
        kq, ks = _quant_kv(k)
        vq, vs = _quant_kv(v)
        entries = (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))
    else:
        entries = (("k", k), ("v", v))
    for name, val in entries:
        cache[name].index_copy_(1, idx, val.to(cache[name].dtype))
    k_cache, v_cache = _dequant_views(cache, x.dtype, int8)

    k_positions = _cache_abs_positions(positions[-1], slots,
                                       cfg.sliding_window, b)
    out = naive_attention(q, k_cache, v_cache, causal=True,
                          window=cfg.sliding_window,
                          q_positions=pos, k_positions=k_positions)
    out = out.reshape(b, c, cfg.q_dim)
    out = lora_dense(out, params["wo"], maybe_lora(lora, "wo"),
                     cfg.lora.scale, None, use_lora_kernel)
    return out, cache
