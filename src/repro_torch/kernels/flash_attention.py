"""Flash attention: online softmax over KV tiles, causal and sliding-window
masks, grouped-query heads.

Replaces: the Pallas TPU kernel ``flash_attention`` of
``src/repro/kernels/flash_attention.py``. CUDA source:
``csrc/flash_attention.cu`` (built and bound by ``_build``).

Bound on this card: at the prefill shape (sequence 1024, head dim 64) the
work is bound by operations; the (Sq, Skv) score matrix never reaches device
memory, K and V are read through ``kv_head = q_head // group`` instead of a
copy broadcast over the group, and the tensors are addressed through their
strides, so the model's (batch, seq, head, dim) layout is used in place.

Positions are ``0..S-1`` on both sides, masked scores are ``-1e30``, and the
softmax denominator is clamped at ``1e-20``, as in the TPU kernel.

The wrapper launches the kernel for a CUDA tensor, or raises; it uses the
plain version only for a CPU tensor. ``flash_attention.launches`` counts.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128)
NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version. q: (..., Hq, Sq, D); k, v: (..., Hkv, Skv, D) with
    ``Hq`` a multiple of ``Hkv``; positions = arange. Scores, softmax and
    the weighted sum are f32; the result is cast to q.dtype."""
    f32 = torch.float32
    hq, sq, d = q.shape[-3:]
    hkv, skv = k.shape[-3], k.shape[-2]
    group = hq // hkv
    kf = k.to(f32).repeat_interleave(group, dim=-3)
    vf = v.to(f32).repeat_interleave(group, dim=-3)
    s = torch.matmul(q.to(f32), kf.transpose(-1, -2)) / math.sqrt(float(d))
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vf).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, D) or (BH, Sq, D); k, v: (B, Hkv, Skv, D) or
    (BHkv, Skv, D). Query head ``h`` reads kv head ``h // (Hq // Hkv)``.

    The first three dims may be strided views (e.g. a permuted
    (B, S, H, D) tensor); the last dim must be contiguous. The output has
    q's shape and strides. float32 or bfloat16; head dim 16, 32, 64 or 128.
    """
    if q.ndim not in (3, 4) or k.ndim != q.ndim or v.ndim != q.ndim:
        raise ValueError("flash_attention takes 3-D or 4-D q, k, v alike")
    squeeze = q.ndim == 3
    if squeeze:
        q, k, v = q[None], k[None], v[None]
    bsz, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape != (bsz, hkv, skv, d) or v.shape != k.shape or hq % hkv:
        raise ValueError(
            f"shapes do not agree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes q, k, v all float32 or all "
                        f"bfloat16, not {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    window = int(window)
    if window < 0:
        raise ValueError("window must be >= 0")

    if q.device.type == "cpu":
        out = flash_attention_ref(q, k, v, causal=causal, window=window)
        return out[0] if squeeze else out
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention has no kernel for {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if 0 in (bsz, hq, sq, skv):
        raise ValueError("flash_attention takes no empty q, k or v")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)          # keeps q's strides when q is dense
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bsz, hq, hkv, sq, skv, d, *strides, int(bool(causal)), window,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out[0] if squeeze else out


flash_attention.launches = 0
