"""Shared building blocks: norms, rotary embeddings, initializers, LoRA dense.

Models are plain functions over nested dicts of tensors: ``init_*`` returns
a nested dict, the forward functions consume it. Matmuls accumulate in f32
whatever the storage dtype (PyTorch's bf16 matmul does so internally and
rounds its result once, which is the reference's "f32 accumulate, cast to
the activation dtype" order).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Union

import torch

Params = Dict[str, Any]

ACC_DTYPE = torch.float32


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``None`` means the GPU, and raises without one: no entry point
    quietly carries on on the CPU. Tests pass ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available and no device was given; "
                "pass device='cpu' explicitly to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def describe_device(device: torch.device) -> str:
    """The name a result carries of the device it ran on: the card's name
    (``torch.cuda.get_device_name``), else the torch device string."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def make_generator(seed: Union[int, torch.Generator],
                   device: torch.device) -> torch.Generator:
    """An int seed becomes a generator on ``device``; a generator passes."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


# ---------------------------------------------------------------------------
# Nested-dict helpers (what jax.tree_util is to the reference)
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """The leaves (in ``tree_leaves`` order) in the nesting of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_structure(tree):
    """Hashable description of the dict nesting (keys only)."""
    if isinstance(tree, dict):
        return tuple((k, tree_structure(v)) for k, v in tree.items())
    return None


def tree_take(tree, i):
    """Index every leaf's leading axis (a view, no copy)."""
    return tree_map(lambda v: v[i], tree)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    xf = x.to(ACC_DTYPE)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * scale.to(ACC_DTYPE)).to(x.dtype)


def init_rms_norm(dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.ones((dim,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int32.

    The head dim is split in halves (not interleaved pairs); angles in f32."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]  # (...,seq,1,hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device=None) -> torch.Tensor:
    std = 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype,
               device=None) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


def init_lora_pair(gen: torch.Generator, in_dim: int, out_dim: int, rank: int,
                   dtype=torch.float32, device=None) -> Params:
    # A ~ N(0, 1/r), B = 0 (standard LoRA init: delta starts at zero)
    a = torch.randn((in_dim, rank), generator=gen, dtype=torch.float32,
                    device=device) / math.sqrt(rank)
    return {"a": a.to(dtype),
            "b": torch.zeros((rank, out_dim), dtype=dtype, device=device)}


def lora_dense(
    x: torch.Tensor,
    w: torch.Tensor,
    lora: Optional[Params],
    scale: float,
    bias: Optional[torch.Tensor] = None,
    use_kernel: bool = False,
) -> torch.Tensor:
    """y = x @ W (+bias) + scale * (x @ A) @ B.

    ``use_kernel=True`` routes through the fused CUDA kernels
    (``repro_torch.kernels.ops``): a 2-D adapter pair goes to
    ``lora_matmul``, a per-row pair (leaves ``(B, K, r)`` / ``(B, r, N)``,
    multi-tenant serving) to ``lora_matmul_grouped``. The default is the
    plain path, which keeps the reference's rounding order: ``x@W``, ``x@A``
    and the scaled correction are each accumulated in f32 and rounded to
    the activation dtype before they are added; bias last.
    """
    if use_kernel and lora is not None:
        from repro_torch.kernels import ops as kernel_ops

        if lora["a"].ndim == 3:
            # per-row adapters (multi-tenant serving: one gathered pair per
            # request row) -> grouped kernel
            ids = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
            y = kernel_ops.lora_matmul_grouped(x, w, lora["a"], lora["b"],
                                               ids, scale)
        else:
            y = kernel_ops.lora_matmul(x, w, lora["a"], lora["b"], scale)
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y
    y = torch.matmul(x, w.to(x.dtype))
    if lora is not None:
        xa = torch.matmul(x, lora["a"].to(x.dtype))
        # the scale multiplies the f32 product before the one rounding
        corr = scale * torch.matmul(xa.to(ACC_DTYPE),
                                    lora["b"].to(x.dtype).to(ACC_DTYPE))
        y = y + corr.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def maybe_lora(lora_tree: Optional[Params], name: str) -> Optional[Params]:
    if lora_tree is None:
        return None
    return lora_tree.get(name)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x.to(ACC_DTYPE)).to(x.dtype)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_id: int = -100) -> torch.Tensor:
    """Mean next-token CE over the labels that are not ``ignore_id``.
    logits: (B,S,V) float, taken in f32; labels: (B,S) int."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).to(torch.long)[..., None])[..., 0]
    nll = logz - gold
    mask = (labels != ignore_id).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors on ``device``: integer leaves
    (tokens, labels) as int64, the index type of a gather; float leaves
    (embeds, smashed data) keep their dtype."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if not t.is_floating_point():
            t = t.to(torch.long)
        out[k] = t.to(device)
    return out
