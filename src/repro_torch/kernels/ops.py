"""The kernels in the model's layouts (counterpart of the reference's
``kernels/ops.py``). Each function hands a CUDA tensor to the hand-written
kernel and a CPU tensor to the kernel's plain version; the choice is made by
the wrappers in ``lora_matmul`` and ``flash_attention``, by the tensor's
device alone.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lora_matmul as _lm


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
