"""GQA attention: init, full-sequence (prefill) forward, cached decode.

Three score paths:
  * ``naive``   — full (Sq, Skv) score matrix; oracle for tests, and the path
                  of every cached step (decode, chunked prefill).
  * ``chunked`` — same signature and result; the queries in blocks, so a
                  long sequence never holds its whole score matrix.
  * ``flash``   — the CUDA kernel in ``repro_torch.kernels.flash_attention``
                  (the counterpart of the reference's ``pallas``, a name
                  taken here for the same route). It has no backward.

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

from repro_torch import shardctx
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (ACC_DTYPE, Params, TensorParallel,
                                       apply_rope, dense_init, dtype_of,
                                       init_lora_pair, init_rms_norm,
                                       lora_dense, maybe_lora,
                                       row_parallel_dense, rms_norm)

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


def _masked_scores(q, k, *, causal: bool, window: int, q_positions,
                   k_positions) -> torch.Tensor:
    """f32 scores (B, Hkv, group, Sq, Skv), masked positions at NEG_INF."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(ACC_DTYPE),
                          k.to(ACC_DTYPE)) / math.sqrt(float(d))
    mask = k_positions[:, None, :] <= q_positions[:, :, None]  # (B,Sq,Skv)
    if not causal:
        mask = torch.ones_like(mask)
    if window:
        mask = mask & (k_positions[:, None, :]
                       > (q_positions[:, :, None] - window))
    return torch.where(mask[:, None, None, :, :], scores,
                       torch.full_like(scores, NEG_INF))


def naive_attention(q, k, v, *, causal: bool, window: int,
                    q_positions, k_positions) -> torch.Tensor:
    """q: (B,Sq,Hq,D); k,v: (B,Skv,Hkv,D). Oracle path."""
    b, sq, hq, d = q.shape
    scores = _masked_scores(q, k, causal=causal, window=window,
                            q_positions=q_positions, k_positions=k_positions)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(ACC_DTYPE))
    return out.reshape(b, sq, hq, d).to(q.dtype)


def combined_attention(q, k, v, *, window: int, q_positions, k_positions,
                       tp: TensorParallel) -> torch.Tensor:
    """``naive_attention`` (causal) over the keys of every rank of the model
    axis, each rank holding a block of them (a decode cache's slots): each
    rank's softmax over its keys, unnormalised (row max ``m_r``, sum
    ``l_r``, ``o_r = sum_k p v``), rescaled by ``exp(m_r - M)`` to the
    global max ``M`` (one pmax) and summed (one psum of ``o`` and ``l``
    together): ``o / l``, the same on every rank of "model"."""
    b, sq, hq, d = q.shape
    scores = _masked_scores(q, k, causal=True, window=window,
                            q_positions=q_positions, k_positions=k_positions)
    m = scores.amax(dim=-1)                                  # (b,h,g,q)
    p = torch.exp(scores - m[..., None])
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.to(ACC_DTYPE))
    alpha = torch.exp(m - tp.mesh.pmax(m, "model"))
    ol = tp.psum(torch.cat([o * alpha[..., None],
                            (p.sum(dim=-1) * alpha)[..., None]], dim=-1))
    out = ol[..., :d] / ol[..., d:]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


#: the reference's block sizes: inputs within one block take the naive path
BLOCK_Q, BLOCK_K = 512, 1024


def chunked_attention(q, k, v, *, causal: bool, window: int,
                      q_positions, k_positions) -> torch.Tensor:
    """Same signature and result as ``naive_attention``, with the memory of
    the reference's chunked path: the queries in blocks of ``BLOCK_Q``, each
    block against every key as ``naive_attention`` does it (the same
    products, the same softmax row by row), so the f32 scores of a long
    sequence take ``BLOCK_Q x Skv`` at a time, not ``Sq x Skv`` (a 32k
    prompt's would take 120 GB a row at qwen2-7b's 28 heads). The products
    are the reference's: its online softmax also takes every (query block,
    key block) pair. Inputs within one block of each take the naive path
    whole, as in the reference."""
    sq = q.shape[1]
    if sq <= BLOCK_Q and k.shape[1] <= BLOCK_K:
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_positions=q_positions,
                               k_positions=k_positions)
    return torch.cat([
        naive_attention(q[:, i:i + BLOCK_Q], k, v, causal=causal,
                        window=window,
                        q_positions=q_positions[:, i:i + BLOCK_Q],
                        k_positions=k_positions)
        for i in range(0, sq, BLOCK_Q)], dim=1)


def attention_scores(q, k, v, *, impl: str, causal: bool, window: int,
                     q_positions, k_positions) -> torch.Tensor:
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_positions=q_positions, k_positions=k_positions)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_positions=q_positions,
                                 k_positions=k_positions)
    if impl in ("flash", "pallas"):
        from repro_torch.kernels import ops as kernel_ops
        return kernel_ops.flash_attention(q, k, v, causal=causal, window=window,
                                          q_positions=q_positions,
                                          k_positions=k_positions)
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------------------
# Forward (prefill) and cached decode
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Tensor parallelism: the heads of a rank
# ---------------------------------------------------------------------------


def tp_layout(cfg: ModelConfig, m: int) -> Dict:
    """How attention lies on a model axis of ``m`` ranks. ``param_specs``
    splits ``wq``/``wk``/``wv`` by their flat columns wherever ``m``
    divides them, heads or not; the reference's hint
    ``constrain(q, "dp", None, "model", None)`` splits the query heads only
    where ``m`` divides ``n_heads``. So:

      * ``"q"``: ``"split"`` (each rank its ``n_heads / m`` heads),
        ``"gathered"`` (the columns split off head boundaries: gathered
        over "model", every rank all heads) or ``"replicated"`` (``wq``
        whole on every rank);
      * ``"kv"``: ``"split"`` (a rank's kv columns are exactly the kv heads
        its query heads read), ``"gathered"`` (the split cuts or misses
        them: gathered, then each rank takes the heads it needs, as GSPMD's
        reshard does) or ``"replicated"``;
      * the heads a rank runs attention on (rank 0's kv heads, and whether
        its query heads read them as whole GQA groups, ``"grouped"``, or
        one kv head each, ``"expanded"``)."""
    heads = m > 1 and cfg.n_heads % m == 0
    q_cols = m > 1 and cfg.q_dim % m == 0
    kv_cols = m > 1 and cfg.kv_dim % m == 0
    kv_split = heads and cfg.n_kv_heads % m == 0
    sel = _kv_heads(cfg, m, 0)
    return {"q": "split" if heads else "gathered" if q_cols else "replicated",
            "kv": ("split" if kv_split else "gathered" if kv_cols
                   else "replicated"),
            "q_heads_per_rank": cfg.n_heads // m if heads else cfg.n_heads,
            "kv_heads_per_rank": (sel[1] - sel[0] if isinstance(sel, tuple)
                                  else len(sel)),
            "kv_read": "grouped" if isinstance(sel, tuple) else "expanded",
            "model_axis": m}


def _kv_heads(cfg: ModelConfig, m: int, index: int):
    """The kv heads the query heads of rank ``index`` read: ``(lo, hi)``
    when they read kv heads ``lo..hi-1`` in whole GQA groups of equal size,
    else one kv head index per query head."""
    if not (m > 1 and cfg.n_heads % m == 0):
        return (0, cfg.n_kv_heads)
    group = cfg.n_heads // cfg.n_kv_heads
    hq = cfg.n_heads // m
    need = [h // group for h in range(index * hq, (index + 1) * hq)]
    lo, hi = need[0], need[-1] + 1
    per = hq // (hi - lo)
    if hq % (hi - lo) == 0 and need == [lo + i // per for i in range(hq)]:
        return (lo, hi)
    return need


def _tp_heads(q, k, v, cfg: ModelConfig, tp: TensorParallel):
    """This rank's query heads and the kv heads they read, from its blocks
    of the q/k/v projections (``tp_layout``)."""
    lay = tp_layout(cfg, tp.size)
    hd, b = cfg.resolved_head_dim, tp.batch
    # the reference's hint constrain(q, "dp", None, "model", None), taken on
    # the flat columns: split where its guard splits the heads
    q = shardctx.constrain(
        q, "dp", None, "model" if lay["q"] == "split" else None,
        have=(b, None, None if lay["q"] == "replicated" else "model"))
    kv_have = (b, None, None if lay["kv"] == "replicated" else "model")
    kv_tag = "model" if lay["kv"] == "split" else None
    k = shardctx.constrain(k, "dp", None, kv_tag, have=kv_have)
    v = shardctx.constrain(v, "dp", None, kv_tag, have=kv_have)
    q = _split_heads(q, q.shape[-1] // hd)
    k = _split_heads(k, k.shape[-1] // hd)
    v = _split_heads(v, v.shape[-1] // hd)
    if lay["kv"] != "split":
        sel = _kv_heads(cfg, tp.size, tp.index)
        if isinstance(sel, tuple):
            k, v = k[:, :, sel[0]:sel[1]], v[:, :, sel[0]:sel[1]]
        else:
            idx = torch.as_tensor(sel, device=k.device)
            k, v = k.index_select(2, idx), v.index_select(2, idx)
    return q, k, v


def _gather_columns(ys, widths, tp: TensorParallel):
    """Each of ``ys`` whole along its last dim of global width ``widths``:
    those ``param_specs`` split over "model" (its guard: the axis divides
    the width) gathered in one all-gather of their blocks side by side."""
    split = [tp.splits(n) for n in widths]
    parts = [y for y, s in zip(ys, split) if s]
    if not parts:
        return ys
    sizes = [y.shape[-1] for y in parts]
    joined = tp.mesh.gather(torch.cat(parts, dim=-1), "model", -1)
    joined = joined.reshape(*joined.shape[:-1], tp.size, sum(sizes))
    blocks = iter(torch.split(joined, sizes, dim=-1))
    return tuple(next(blocks).flatten(-2) if s else y
                 for y, s in zip(ys, split))


def _qkv(params: Params, lora: Optional[Params], x: torch.Tensor,
         cfg: ModelConfig, positions: torch.Tensor, use_lora_kernel: bool,
         tp: Optional[TensorParallel] = None, heads: str = "rank"):
    """Projections, head split, qk-norm and RoPE shared by every path.
    ``tp``: the projections are this rank's column blocks, and the heads
    returned this rank's (``heads="rank"``, ``_tp_heads``) or all of them
    (``heads="all"``: the split columns gathered over "model",
    ``_gather_columns``)."""
    scale = cfg.lora.scale
    q = lora_dense(x, params["wq"], maybe_lora(lora, "wq"), scale,
                   params.get("bq"), use_kernel=use_lora_kernel)
    k = lora_dense(x, params["wk"], maybe_lora(lora, "wk"), scale,
                   params.get("bk"), use_kernel=use_lora_kernel)
    v = lora_dense(x, params["wv"], maybe_lora(lora, "wv"), scale,
                   params.get("bv"), use_kernel=use_lora_kernel)
    if tp is not None and heads == "rank":
        q, k, v = _tp_heads(q, k, v, cfg, tp)
    else:
        if tp is not None:
            q, k, v = _gather_columns((q, k, v),
                                      (cfg.q_dim, cfg.kv_dim, cfg.kv_dim), tp)
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
                      use_lora_kernel: bool = False,
                      tp: Optional[TensorParallel] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention. Returns (out, {"k","v"} post-RoPE for cache;
    with ``tp``, this rank's heads). With ``tp`` the projections run on this
    rank's blocks (``tp_layout``) and ``wo`` is row-parallel where the model
    axis divides ``q_dim``: the rank's block of the heads' output times its
    rows of ``wo``, summed over "model"."""
    q, k, v = _qkv(params, lora, x, cfg, positions, use_lora_kernel, tp)
    out = attention_scores(q, k, v, impl=impl, causal=True,
                           window=cfg.sliding_window,
                           q_positions=positions, k_positions=positions)
    out = out.reshape(x.shape[0], x.shape[1], q.shape[2] * q.shape[3])
    return _out_proj(params, lora, out, cfg, use_lora_kernel, tp), \
        {"k": k, "v": v}


def _out_proj(params: Params, lora: Optional[Params], out: torch.Tensor,
              cfg: ModelConfig, use_lora_kernel: bool,
              tp: Optional[TensorParallel]) -> torch.Tensor:
    """``wo`` on the heads' output: with ``tp``, ``out`` is this rank's
    heads or all of them, and ``wo`` row-parallel where the model axis
    divides ``q_dim``: the rank's block of the columns times its rows,
    summed over "model"."""
    if tp is not None and tp.splits(cfg.q_dim):
        # every rank ran all heads where the heads do not split: its block
        out = shardctx.constrain(out, "dp", None, "model",
                                 have=(tp.batch, None, "model"
                                       if out.shape[-1] < cfg.q_dim
                                       else None))
        return row_parallel_dense(out, params["wo"], maybe_lora(lora, "wo"),
                                  cfg.lora.scale, tp, use_lora_kernel)
    return lora_dense(out, params["wo"], maybe_lora(lora, "wo"),
                      cfg.lora.scale, use_kernel=use_lora_kernel)


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


def _cache_abs_positions(t: torch.Tensor, slots: int, window: int, b: int,
                         lo: int = 0, hi: Optional[int] = None
                         ) -> torch.Tensor:
    """(B, hi - lo) absolute position held by each cache slot ``lo..hi-1``
    (default all ``slots``; on a mesh, this rank's global slots) after the
    write at position(s) ``t`` (scalar or per-row (B,) vector).

    Linear cache: slot j holds position j (stale j > t masked causally).
    Ring (SWA):   slot j holds ``t - ((t - j) mod W)`` — valid iff >= 0.
    """
    hi = slots if hi is None else hi
    j = torch.arange(lo, hi, dtype=torch.int32, device=t.device)
    if window and window <= slots:
        tb = t[:, None] if t.ndim else t.expand(b)[:, None]
        abs_pos = tb - torch.remainder(tb - j[None, :], slots)
        return torch.where(abs_pos >= 0, abs_pos,
                           torch.full_like(abs_pos, 2**30))  # unwritten slots
    return j.expand(b, hi - lo)


def _dequant_views(cache: Dict[str, torch.Tensor], dtype, int8: bool):
    if int8:
        k_cache = (cache["k"].to(torch.float32) * cache["k_scale"]).to(dtype)
        v_cache = (cache["v"].to(torch.float32) * cache["v_scale"]).to(dtype)
        return k_cache, v_cache
    return cache["k"], cache["v"]


def _write_kv(cache: Dict[str, torch.Tensor], k: torch.Tensor,
              v: torch.Tensor, slot: torch.Tensor, dtype, int8: bool,
              lo: Optional[int] = None
              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Write one token per row at ``slot`` (scalar or (B,) vector), in place.
    ``lo``: the cache is this rank's block of the slots from global slot
    ``lo`` on, and a row is written only where the block holds its slot
    (a masked write: the owner may differ row by row).

    Returns (cache, dequantized k view, dequantized v view)."""
    if int8:
        kq, ks = _quant_kv(k)
        vq, vs = _quant_kv(v)
        entries = (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))
    else:
        entries = (("k", k), ("v", v))
    slot = slot.to(torch.long)
    if lo is not None:
        n = cache["k"].shape[1]
        slot = slot - lo
        mine = (slot >= 0) & (slot < n)
        slot = slot.clamp(0, n - 1)
    for name, val in entries:
        val = val.to(cache[name].dtype)
        if slot.ndim:                                      # per-row slots
            rows = torch.arange(val.shape[0], device=val.device)
            if lo is not None:
                val = torch.where(mine[:, None, None, None], val,
                                  cache[name][rows, slot][:, None])
            cache[name][rows, slot] = val[:, 0]
        else:
            if lo is not None:
                val = torch.where(mine, val, cache[name].index_select(
                    1, slot.reshape(1)))
            cache[name].index_copy_(1, slot.reshape(1), val)
    k_cache, v_cache = _dequant_views(cache, dtype, int8)
    return cache, k_cache, v_cache


def attention_decode(params: Params, lora: Optional[Params], x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], cfg: ModelConfig, *,
                     t, use_lora_kernel: bool = False,
                     tp: Optional[TensorParallel] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (B,1,d); t: int32 absolute position — a scalar
    (whole batch at one position) or a (B,) vector (continuous-batching
    serving: every row at its own position). The cache is updated in place.

    Full cache: write at slot ``t``, attend over slots ``<= t``.
    Ring (SWA): write at ``t % W``; slot j holds absolute position
    ``t - ((t - j) mod W)`` — valid iff >= 0.

    ``tp``: this rank of a mesh, ``x`` and ``t`` its block of the batch,
    ``cache`` its block under ``sharding.cache_specs`` (``tp.slots``: its
    global slot range). See ``_attention_decode_tp``.
    """
    b = x.shape[0]
    t = torch.as_tensor(t, dtype=torch.int32, device=x.device)
    pos = t[:, None] if t.ndim else t.expand(b)[:, None]
    if tp is not None:
        return _attention_decode_tp(params, lora, x, cache, cfg, t, pos,
                                    use_lora_kernel, tp)
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


def _attention_decode_tp(params: Params, lora: Optional[Params],
                         x: torch.Tensor, cache: Dict[str, torch.Tensor],
                         cfg: ModelConfig, t: torch.Tensor, pos: torch.Tensor,
                         use_lora_kernel: bool, tp: TensorParallel
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``attention_decode`` on a rank of a mesh. The projections run on the
    rank's column blocks and are gathered into every head (the new token's
    k and v go into the cache whole). The cache holds all kv heads of a
    block of the slots (``cache_specs``: slots over "model"): the slot's
    owner writes it (a masked write), slot ``j`` of the block is global
    slot ``lo + j`` (the ring's modulus the global count), and each rank's
    softmax over its slots is combined over "model"
    (``combined_attention``). Where the model axis does not divide the
    slots the cache is whole on every rank: each rank runs its heads
    (``tp_layout``) over all slots, no combine. ``wo`` as in the forward
    (``_out_proj``)."""
    b = x.shape[0]
    q, k, v = _qkv(params, lora, x, cfg, pos, use_lora_kernel, tp,
                   heads="all")
    lo, hi, slots = tp.slots
    split = hi - lo < slots
    cache, k_cache, v_cache = _write_kv(
        cache, k, v, torch.remainder(t, slots), x.dtype,
        cfg.kv_cache_dtype == "int8", lo if split else None)
    k_positions = _cache_abs_positions(t, slots, cfg.sliding_window, b,
                                       lo, hi)
    if split:
        out = combined_attention(q, k_cache, v_cache,
                                 window=cfg.sliding_window, q_positions=pos,
                                 k_positions=k_positions, tp=tp)
    else:
        lay = tp_layout(cfg, tp.size)
        if lay["q"] == "split":
            hq = lay["q_heads_per_rank"]
            q = q[:, :, tp.index * hq:(tp.index + 1) * hq]
        sel = _kv_heads(cfg, tp.size, tp.index)
        if isinstance(sel, tuple):
            k_cache, v_cache = (c[:, :, sel[0]:sel[1]]
                                for c in (k_cache, v_cache))
        else:
            idx = torch.as_tensor(sel, device=x.device)
            k_cache, v_cache = (c.index_select(2, idx)
                                for c in (k_cache, v_cache))
        out = naive_attention(q, k_cache, v_cache, causal=True,
                              window=cfg.sliding_window, q_positions=pos,
                              k_positions=k_positions)
    out = out.reshape(b, 1, q.shape[2] * q.shape[3])
    return _out_proj(params, lora, out, cfg, use_lora_kernel, tp), cache


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
