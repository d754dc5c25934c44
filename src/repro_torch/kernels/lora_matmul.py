"""Fused LoRA products: ``Y = X @ W + s * (X @ A) @ B`` for one adapter
(``lora_matmul``) and for a bank of adapters picked per request
(``lora_matmul_grouped``).

Replaces: the Pallas TPU kernels ``lora_matmul`` and ``lora_matmul_grouped``
of ``src/repro/kernels/lora_matmul.py``. CUDA source:
``csrc/lora_matmul.cu`` (built and bound by ``_build``).

Bound on this card: at the serving shapes (64 rows of a prefill chunk, one
row per request in a decode tick) both are bound by bytes, those of ``W``.
The kernels read ``W`` once per tile of rows, keep ``X @ A`` out of device
memory and add the rank-r correction before the output leaves the registers;
the grouped kernel reads each request's adapter through ``ids`` from the bank
where it lies, so no gathered copy is made for it. The grouped kernel has two
versions in the CUDA source: the first takes any shape with 2-byte loads; the
launcher picks the wide one (16-byte loads) where N and r are whole 16-byte
vectors and W and the bank are 16-byte aligned.

Rounding order (kernel and plain version alike; it follows the reference's
``kernels/ref.py``): ``W``, ``A``, ``B`` are cast to the activation dtype
(once, by the caller, if it wants to avoid the cast per call); every product
accumulates in f32; ``X @ A`` is rounded to the activation dtype before it
meets ``B``; ``X @ W + s * correction`` is rounded once at the end.

The wrappers launch the kernel for a CUDA tensor, or raise; they use the
plain version only for a CPU tensor. ``<wrapper>.launches`` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
MAX_RANK = 64


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def lora_matmul_ref(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """x: (M, K); w: (K, N); a: (K, r); b: (r, N) -> (M, N) in x.dtype."""
    f32 = torch.float32
    xf = x.to(f32)
    y = xf @ w.to(x.dtype).to(f32)
    xa = (xf @ a.to(x.dtype).to(f32)).to(x.dtype)
    y = y + scale * (xa.to(f32) @ b.to(x.dtype).to(f32))
    return y.to(x.dtype)


def lora_matmul_grouped_ref(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                            b: torch.Tensor, ids: torch.Tensor,
                            scale: float = 1.0) -> torch.Tensor:
    """x: (G, M, K); w: (K, N); a: (E, K, r); b: (E, r, N); ids: (G,)."""
    f32 = torch.float32
    idx = ids.to(torch.long)
    xf = x.to(f32)
    y = xf @ w.to(x.dtype).to(f32)
    ag = a[idx].to(x.dtype).to(f32)                    # (G, K, r)
    bg = b[idx].to(x.dtype).to(f32)                    # (G, r, N)
    xa = (xf @ ag).to(x.dtype)
    y = y + scale * (xa.to(f32) @ bg)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, x on {like.device}")
    if t.dtype != like.dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, x has {like.dtype}")


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """x: (M, K); w: (K, N); a: (K, r); b: (r, N) -> (M, N) in x.dtype.

    Any M, K, N (ragged edges are masked in the kernel), r <= 64; float32 or
    bfloat16. ``w``, ``a``, ``b`` of another float dtype are cast to
    ``x.dtype`` first."""
    if x.ndim != 2 or w.ndim != 2 or a.ndim != 2 or b.ndim != 2:
        raise ValueError("lora_matmul takes 2-D x, w, a, b")
    m, k = x.shape
    n = w.shape[1]
    r = a.shape[1]
    if w.shape[0] != k or a.shape[0] != k or b.shape != (r, n):
        raise ValueError(
            f"shapes do not agree: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"a {tuple(a.shape)}, b {tuple(b.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"lora_matmul takes float32 or bfloat16, not {x.dtype}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside 1..{MAX_RANK}")
    w, a, b = w.to(x.dtype), a.to(x.dtype), b.to(x.dtype)
    for name, t in (("w", w), ("a", a), ("b", b)):
        _check(name, t, x)
    if x.device.type == "cpu":
        return lora_matmul_ref(x, w, a, b, scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"lora_matmul has no kernel for device {x.device}")
    if m == 0:
        return x.new_empty((0, n))
    x, w, a, b = (t.contiguous() for t in (x, w, a, b))
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.load("lora_matmul")
    with torch.cuda.device(x.device):
        code = lib.lora_matmul_launch(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            y.data_ptr(), m, k, n, r, float(scale),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "lora_matmul")
    lora_matmul.launches += 1
    return y


lora_matmul.launches = 0


def lora_matmul_grouped(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, ids: torch.Tensor,
                        scale: float = 1.0) -> torch.Tensor:
    """``y[g] = x[g] @ W + s * (x[g] @ A[ids[g]]) @ B[ids[g]]``.

    x: (G, M, K) per-request activations; w: (K, N) shared frozen weight;
    a: (E, K, r), b: (E, r, N) the adapter bank; ids: (G,) int32 adapter of
    each request. Returns (G, M, N) in x.dtype. The bank may be strided
    along its first axis (each adapter's own matrix must be contiguous): the
    kernel offsets the bank pointers by ``ids[g]`` times that stride."""
    if x.ndim != 3 or w.ndim != 2 or a.ndim != 3 or b.ndim != 3:
        raise ValueError("lora_matmul_grouped takes x (G,M,K), w (K,N), "
                         "a (E,K,r), b (E,r,N)")
    g, m, k = x.shape
    n = w.shape[1]
    e, _, r = a.shape
    if w.shape[0] != k or a.shape[1] != k or b.shape != (e, r, n) \
            or ids.shape != (g,):
        raise ValueError(
            f"shapes do not agree: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"a {tuple(a.shape)}, b {tuple(b.shape)}, ids {tuple(ids.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(
            f"lora_matmul_grouped takes float32 or bfloat16, not {x.dtype}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside 1..{MAX_RANK}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be an integer tensor, not {ids.dtype}")
    w, a, b = w.to(x.dtype), a.to(x.dtype), b.to(x.dtype)
    for name, t in (("w", w), ("a", a), ("b", b)):
        _check(name, t, x)
    if ids.device != x.device:
        raise ValueError(f"ids is on {ids.device}, x on {x.device}")
    if x.device.type == "cpu":
        return lora_matmul_grouped_ref(x, w, a, b, ids, scale)
    if x.device.type != "cuda":
        raise RuntimeError(
            f"lora_matmul_grouped has no kernel for device {x.device}")
    if g * m == 0:
        return x.new_empty((g, m, n))
    x, w = x.contiguous(), w.contiguous()
    if not a[0].is_contiguous():
        a = a.contiguous()
    if not b[0].is_contiguous():
        b = b.contiguous()
    ids = ids.to(torch.int32).contiguous()
    y = torch.empty((g, m, n), dtype=x.dtype, device=x.device)
    lib = _build.load("lora_matmul")
    with torch.cuda.device(x.device):
        code = lib.lora_matmul_grouped_launch(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            ids.data_ptr(), y.data_ptr(), g * m, m, k, n, r,
            a.stride(0) if e > 1 else k * r, b.stride(0) if e > 1 else r * n,
            float(scale), int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "lora_matmul_grouped")
    lora_matmul_grouped.launches += 1
    return y


lora_matmul_grouped.launches = 0
