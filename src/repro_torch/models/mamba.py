"""Mamba-2 (SSD, arXiv:2405.21060) block: chunked parallel scan for
train/prefill, O(1)-state recurrence for decode.

Single B/C group (ngroups=1), head structure (nh heads x hp head_dim).
``ssd_chunked`` is the plain scan, the oracle the ``ssd_intra_chunk``
kernel path (``kernels.ops.ssd_scan``) is held against; ``mamba_forward``
takes either (``impl``). ``mamba_decode`` updates the cache it is given IN
PLACE, as the attention cache functions do.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (ACC_DTYPE, Params, TensorParallel,
                                       dense_init, dtype_of, init_lora_pair,
                                       init_rms_norm, lora_dense, maybe_lora,
                                       rms_norm, silu)


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype, device=None
               ) -> Params:
    d = cfg.d_model
    di, ns, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads
    conv_ch = di + 2 * ns
    f32 = torch.float32
    # in_proj -> [z(di), x(di), B(ns), C(ns), dt(nh)]
    in_proj = dense_init(gen, d, 2 * di + 2 * ns + nh, dtype, device)
    conv_w = (torch.randn((cfg.ssm_conv_width, conv_ch), generator=gen,
                          dtype=f32, device=device)
              / math.sqrt(cfg.ssm_conv_width)).to(dtype)
    u = torch.rand((nh,), generator=gen, dtype=f32, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "a_log": torch.log(torch.arange(1, nh + 1, dtype=f32, device=device)),
        "d_skip": torch.ones((nh,), dtype=f32, device=device),
        "gate_norm": init_rms_norm(di, device=device),
        "out_proj": dense_init(gen, di, d, dtype, device),
    }


def init_mamba_lora(gen: torch.Generator, cfg: ModelConfig, device=None
                    ) -> Params:
    r, d, di = cfg.lora.rank, cfg.d_model, cfg.ssm_d_inner
    ldt = dtype_of(cfg.lora.dtype)
    return {
        "in_proj": init_lora_pair(gen, d, 2 * di + 2 * cfg.ssm_state
                                  + cfg.ssm_n_heads, r, ldt, device),
        "out_proj": init_lora_pair(gen, di, d, r, ldt, device),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. xbc: (B,L,C); w: (W,C). prefix: (B,W-1,C).
    The taps are summed in order i = 0..W-1 in the activation dtype."""
    width, length = w.shape[0], xbc.shape[1]
    if prefix is None:
        prefix = xbc.new_zeros((xbc.shape[0], width - 1, xbc.shape[2]))
    xp = torch.cat([prefix, xbc], dim=1)
    out = xp[:, 0:length] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + length] * w[i]
    return silu(out + b)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as the reference's ``jax.nn.softplus`` computes
    it (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    """in_proj output -> (z, x, B, C, dt_raw)."""
    di, ns, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads
    return torch.split(proj, [di, di, ns, ns, nh], dim=-1)


def ssd_chunked(xt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. xt: (B,L,nh,hp) pre-multiplied by dt; a: (B,L,nh) = A*dt
    (<=0); B,C: (B,L,ns). Returns (y: (B,L,nh,hp), h_final: (B,nh,hp,ns))."""
    b, length, nh, hp = xt.shape
    ns = B.shape[-1]
    pad = (-length) % chunk
    if pad:
        xt = F.pad(xt, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = xt.shape[1] // chunk
    xt = xt.reshape(b, nc, chunk, nh, hp).to(ACC_DTYPE)
    a = a.reshape(b, nc, chunk, nh).to(ACC_DTYPE)
    Bc = B.reshape(b, nc, chunk, ns).to(ACC_DTYPE)
    Cc = C.reshape(b, nc, chunk, ns).to(ACC_DTYPE)

    cum = torch.cumsum(a, dim=2)                         # (b,nc,cl,nh)
    # intra-chunk (quadratic within chunk). The mask goes in before the
    # exp: the same values as the reference's where(causal, exp(seg), 0),
    # but exp(seg) of a future j overflows to inf in a long or steep chunk,
    # and the reference's gradient there is 0 * inf = nan
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,i,j,nh)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xt.device))
    decay = torch.exp(torch.where(
        causal[None, None, :, :, None], seg,
        torch.full((), -math.inf, dtype=ACC_DTYPE, device=xt.device)))
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)     # (b,nc,i,j)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * decay, xt)

    # chunk-final states
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)         # (b,nc,cl,nh)
    states = torch.einsum("bcjnh,bcjhp->bchpn",
                          Bc[..., None] * dec_end[:, :, :, None, :], xt)

    # inter-chunk recurrence
    a_tot = torch.exp(cum[:, :, -1, :])                  # (b,nc,nh)
    h = (torch.zeros((b, nh, hp, ns), dtype=ACC_DTYPE, device=xt.device)
         if h0 is None else h0.to(ACC_DTYPE))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * a_tot[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                 # (b,nc,nh,hp,ns)

    y_off = (torch.einsum("bcin,bchpn->bcihp", Cc, h_prev)
             * torch.exp(cum)[..., None])
    y = (y_diag + y_off).reshape(b, nc * chunk, nh, hp)
    return y[:, :length], h


def mamba_forward(params: Params, lora: Optional[Params], x: torch.Tensor,
                  cfg: ModelConfig, use_lora_kernel: bool = False,
                  impl: str = "chunked") -> torch.Tensor:
    """Full-sequence forward. x: (B,L,d) -> (B,L,d). ``impl="flash"`` runs
    the scan through the ``ssd_intra_chunk`` kernel (``ops.ssd_scan``; no
    backward), any other value through ``ssd_chunked``."""
    di, nh, hp = cfg.ssm_d_inner, cfg.ssm_n_heads, cfg.ssm_head_dim
    proj = lora_dense(x, params["in_proj"], maybe_lora(lora, "in_proj"),
                      cfg.lora.scale, use_kernel=use_lora_kernel)
    z, xs, B, C, dt_raw = _split_proj(proj, cfg)
    xbc = _causal_conv(torch.cat([xs, B, C], dim=-1), params["conv_w"],
                       params["conv_b"])
    xs, B, C = torch.split(xbc, [di, cfg.ssm_state, cfg.ssm_state], dim=-1)
    dt = _softplus(dt_raw.to(torch.float32) + params["dt_bias"])
    A = -torch.exp(params["a_log"])                      # (nh,)
    bsz, length = x.shape[0], x.shape[1]
    xh = xs.reshape(bsz, length, nh, hp)
    xt = xh.to(ACC_DTYPE) * dt[..., None]
    a = dt * A
    if impl == "flash":
        from repro_torch.kernels import ops as kernel_ops

        # B and C are column slices of xbc: hand the kernel whole f32 rows
        B, C = (t.to(ACC_DTYPE).contiguous() for t in (B, C))
        y, _ = kernel_ops.ssd_scan(xt, a, B, C, cfg.ssm_chunk)
    else:
        y, _ = ssd_chunked(xt, a, B, C, cfg.ssm_chunk)
    y = y + params["d_skip"][:, None] * xh.to(ACC_DTYPE)
    y = y.reshape(bsz, length, di).to(x.dtype)
    y = rms_norm(y * silu(z), params["gate_norm"], cfg.rms_eps)
    return lora_dense(y, params["out_proj"], maybe_lora(lora, "out_proj"),
                      cfg.lora.scale, use_kernel=use_lora_kernel)


# ---------------------------------------------------------------------------
# Decode (recurrent, O(1) per token)
# ---------------------------------------------------------------------------


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device=None
                   ) -> Dict[str, torch.Tensor]:
    di, ns, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads
    hp = cfg.ssm_head_dim
    return {
        "h": torch.zeros((batch, nh, hp, ns), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, di + 2 * ns),
                            dtype=dtype, device=device),
    }


def mamba_decode(params: Params, lora: Optional[Params], x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], cfg: ModelConfig,
                 tp: Optional[TensorParallel] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B,1,d) -> (y: (B,1,d), cache). The new state and the shifted
    conv window are written into ``cache`` in place. The adapters take the
    plain product whatever the caller's kernel route, as in the reference.

    ``tp``: this rank of a mesh, ``x`` its block of the batch and ``cache``
    its block under ``sharding.cache_specs``. The projections are
    replicated (``param_specs``); the rank convolves its block of the conv
    channels and updates its block of ``h`` (over heads, or over the head
    dim where "model" does not divide the heads: both updates are
    elementwise in the head dim, so either split is exact), each gathered
    over "model" after."""
    di, ns, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads
    hp = cfg.ssm_head_dim
    f32 = torch.float32
    proj = lora_dense(x, params["in_proj"], maybe_lora(lora, "in_proj"),
                      cfg.lora.scale)
    z, xs, B, C, dt_raw = _split_proj(proj, cfg)
    xbc_t = torch.cat([xs, B, C], dim=-1)                # (B,1,conv_ch)
    w, bias = params["conv_w"], params["conv_b"]
    conv_split = tp is not None and cache["conv"].shape[-1] < xbc_t.shape[-1]
    if conv_split:
        xbc_t, w, bias = (tp.mesh.split(v, "model", -1)
                          for v in (xbc_t, w, bias))
    conv_in = torch.cat([cache["conv"], xbc_t], dim=1)   # (B,W,conv_ch)
    out = conv_in[:, 0:1] * w[0]
    for i in range(1, w.shape[0]):
        out = out + conv_in[:, i:i + 1] * w[i]
    xbc = silu(out + bias)                               # (B,1,conv_ch)
    if conv_split:
        xbc = tp.mesh.gather(xbc, "model", -1)
    xs, B, C = torch.split(xbc, [di, ns, ns], dim=-1)
    dt = _softplus(dt_raw.to(f32) + params["dt_bias"])[:, 0]
    A = -torch.exp(params["a_log"])
    a = torch.exp(dt * A)                                # (B,nh)
    xh = xs[:, 0].reshape(-1, nh, hp).to(f32)
    xt = xh * dt[..., None]
    Bv, Cv = B[:, 0].to(f32), C[:, 0].to(f32)
    d_skip = params["d_skip"][:, None]
    h_dim = None
    if tp is not None:
        # the dim of h this rank holds a block of: heads, else head dim
        h_dim = next((dim for dim, n in ((1, nh), (2, hp))
                      if cache["h"].shape[dim] < n), None)
    if h_dim is not None:
        xh, xt = (tp.mesh.split(v, "model", h_dim) for v in (xh, xt))
        if h_dim == 1:
            a, d_skip = tp.mesh.split(a, "model", 1), \
                tp.mesh.split(d_skip, "model", 0)
    h = (cache["h"] * a[:, :, None, None]
         + torch.einsum("bhp,bn->bhpn", xt, Bv))
    y = torch.einsum("bhpn,bn->bhp", h, Cv) + d_skip * xh
    if h_dim is not None:
        y = tp.mesh.gather(y, "model", h_dim)
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_in[:, 1:])
    y = y.reshape(-1, 1, di).to(x.dtype)
    y = rms_norm(y * silu(z), params["gate_norm"], cfg.rms_eps)
    y = lora_dense(y, params["out_proj"], maybe_lora(lora, "out_proj"),
                   cfg.lora.scale)
    return y, cache
