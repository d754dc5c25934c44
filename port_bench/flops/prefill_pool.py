"""Operations a prompt's prefill needs (multiply and add counted as two):
the seven projections and their LoRA pairs at every prompt token, causal
attention of each chunk's queries over the keys before them (within the
window, where the config has one), and the head at the one position whose
logits give the first token. Elementwise work (norms, RoPE, biases, SwiGLU's
product) is not counted, as ``torch.utils.flop_counter`` does not count it.
Work the program does beyond this (attention over masked cache slots,
logits of padded vocabulary rows) is not counted either."""
from __future__ import annotations

from port_bench.reference.model import Dims


def linear_per_token(dims: Dims, rank: int) -> float:
    d, f = dims.d, dims.ffn
    q, kv = dims.heads * dims.head_dim, dims.kv_heads * dims.head_dim
    proj = 2 * (d * q + 2 * d * kv + q * d + 3 * d * f)
    lora = 2 * rank * ((d + q) + 2 * (d + kv) + (q + d) + 2 * (d + f)
                       + (f + d))
    return proj + lora


def attention_pairs(t0: int, c: int, window: int) -> int:
    """(query, key) pairs of a chunk of ``c`` queries at positions
    ``t0 .. t0 + c - 1`` under the causal (and window) mask."""
    if not window:
        return c * t0 + c * (c + 1) // 2
    return sum(min(t0 + i + 1, window) for i in range(c))


def attention_ops(dims: Dims, pairs: int) -> float:
    """QK^T and PV over ``pairs`` for every query head."""
    return 4.0 * dims.heads * dims.head_dim * pairs


def head_ops(dims: Dims) -> float:
    return 2.0 * dims.d * dims.vocab


def chunk_ops(dims: Dims, rank: int, t0: int, c: int, last: bool) -> float:
    ops = dims.layers * (c * linear_per_token(dims, rank)
                         + attention_ops(dims, attention_pairs(
                             t0, c, dims.window)))
    return ops + (head_ops(dims) if last else 0.0)


def request_ops(dims: Dims, rank: int, prompt_len: int, chunk: int) -> float:
    n = prompt_len // chunk
    return sum(chunk_ops(dims, rank, i * chunk, chunk, i == n - 1)
               for i in range(n))
