"""The kernels in the model's layouts (counterpart of the reference's
``kernels/ops.py``). Each function hands a CUDA tensor to the hand-written
kernel and a CPU tensor to the kernel's plain version; the choice is made by
the wrappers in ``lora_matmul``, ``flash_attention``, ``flash_decode`` and
``ssd_scan``, by the tensor's device alone.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import lora_matmul as _lm
from repro_torch.kernels import ssd_scan as _ssd


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Fused y = x @ W + scale*(x @ A) @ B. Leading dims of x are flattened."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = _lm.lora_matmul(x2, w, a, b, scale)
    return y.reshape(*lead, w.shape[-1])


def lora_matmul_grouped(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, ids: torch.Tensor,
                        scale: float = 1.0) -> torch.Tensor:
    """Multi-tenant fused LoRA: y[g] = x[g] @ W + scale*(x[g] @ A[ids[g]])
    @ B[ids[g]]. x: (G, M, K) or (G, K); a: (E, K, r); b: (E, r, N);
    ids: (G,) int32 adapter index per request row."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[:, None, :]
    y = _lm.lora_matmul_grouped(x, w, a, b, ids, scale)
    return y[:, 0] if squeeze else y


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_positions=None, k_positions=None) -> torch.Tensor:
    """GQA-aware wrapper. q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D);
    returns (B, Sq, Hq, D).

    ``q_positions`` / ``k_positions`` are accepted and ignored, as in the
    reference: the kernel's positions are ``0..S-1``; position vectors of
    another kind (ring-buffer decode) stay on ``naive_attention``. The
    tensors go to the kernel as permuted views; K and V are never broadcast
    over the head group."""
    del q_positions, k_positions
    out = _fa.flash_attention(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                              v.permute(0, 2, 1, 3), causal=causal,
                              window=window)
    return out.permute(0, 2, 1, 3)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, t: Union[int, torch.Tensor], *,
                 window: int = 0) -> torch.Tensor:
    """One-token GQA decode attention. q: (B, 1, Hq, D); caches:
    (B, S, Hkv, D); ``t`` one position for every row, a Python int or a
    0-d int32 / int64 tensor on q's device. Returns (B, 1, Hq, D).
    Ring-buffer SWA caches use
    window == slots semantics (models/attention.py). The caches are read in
    place through a permuted view; the reference's transposed copy of the
    whole cache is not made."""
    b, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    qf = q[:, 0].reshape(b, hkv, hq // hkv, d)
    out = _fd.flash_decode(qf, k_cache.permute(0, 2, 1, 3),
                           v_cache.permute(0, 2, 1, 3), t, window=window)
    return out.reshape(b, 1, hq, d)


def ssd_scan(xt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, chunk: int, h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full SSD scan: the intra-chunk kernel, then the inter-chunk
    recurrence (a Python loop over chunks) and the ``C_i . h_prev .
    exp(cum_i)`` correction in torch. Same contract as
    ``models.mamba.ssd_chunked``: xt (B, L, nh, hp); a (B, L, nh);
    B, C (B, L, ns). Returns (y (B, L, nh, hp) f32, h_final (B, nh, hp, ns)
    f32)."""
    b, length, nh, hp = xt.shape
    ns = B.shape[-1]
    f32 = torch.float32
    xt, a, B, C = (x.to(f32) for x in (xt, a, B, C))
    pad = (-length) % chunk
    if pad:
        xt = F.pad(xt, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = xt.shape[1] // chunk
    C_c = C.reshape(b, nc, chunk, ns)
    y_diag, states, dec = _ssd.ssd_intra_chunk(
        xt.reshape(b, nc, chunk, nh, hp), a.reshape(b, nc, chunk, nh),
        B.reshape(b, nc, chunk, ns), C_c)
    states = states.transpose(3, 4)                    # (b, nc, nh, hp, ns)
    a_tot = dec[:, :, -1, :, 1]                        # (b, nc, nh)
    h = (torch.zeros((b, nh, hp, ns), dtype=f32, device=xt.device)
         if h0 is None else h0.to(f32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * a_tot[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)               # (b, nc, nh, hp, ns)
    # C_i . h_prev * exp(cum_i), contracted over ns before the decay is
    # applied (the reference's einsum broadcasts the decay over ns first)
    y_off = (torch.einsum("bcin,bchpn->bcihp", C_c, h_prev)
             * dec[..., 0][..., None])
    y = (y_diag + y_off).reshape(b, nc * chunk, nh, hp)
    return y[:, :length], h
