"""Operations a local epoch of split LoRA fine-tuning needs (multiply and
add counted as two) on a mini-batch of ``batch`` rows of ``seq`` tokens:

* forward: the projections, LoRA pairs and causal attention of every layer,
  and the head at every position (the loss reads them all);
* backward: the gradient of every activation back to the first layer's
  projections (frozen weights take no gradient of their own: one product a
  projection, not two), the LoRA factors' gradients and the activations'
  through them, attention's four products, and the head's gradient into
  the hidden states. The first layer's q / k / v inputs depend on no
  adapter, so neither their gradient through W nor through A is needed;
* the AdamW update of every adapter parameter.

So this is about 2 + 1 passes of the forward's products, not the 6 N D of
a step that trains every weight. Elementwise work is not counted, as
``torch.utils.flop_counter`` does not count it."""
from __future__ import annotations

from port_bench.flops.prefill_pool import (attention_ops, attention_pairs,
                                           linear_per_token)
from port_bench.reference.model import Dims

#: AdamW's operations per parameter (two moments, their corrections, the
#: square root, the quotient and the step)
ADAM_OPS = 14


def adapter_params(dims: Dims, rank: int) -> int:
    d, f = dims.d, dims.ffn
    q, kv = dims.heads * dims.head_dim, dims.kv_heads * dims.head_dim
    return dims.layers * rank * ((d + q) + 2 * (d + kv) + (q + d)
                                 + 2 * (d + f) + (f + d))


def matmul_ops(dims: Dims, rank: int, batch: int, seq: int) -> float:
    """The products of one epoch, forward and backward."""
    tokens = batch * seq
    d = dims.d
    q, kv = dims.heads * dims.head_dim, dims.kv_heads * dims.head_dim
    lin = linear_per_token(dims, rank)
    lora = 2 * rank * ((d + q) + 2 * (d + kv) + (q + d) + 2 * (d + dims.ffn)
                       + (dims.ffn + d))
    proj = lin - lora
    attn = attention_ops(dims, attention_pairs(0, seq, dims.window)) * batch
    head = 2.0 * d * dims.vocab * tokens
    forward = dims.layers * (tokens * lin + attn) + head
    # layer 0's q / k / v: no gradient into their input, through W or A
    first_inputs = tokens * (2 * d * (q + 2 * kv) + 3 * 2 * d * rank)
    backward = (dims.layers * (tokens * (proj + 2 * lora) + 2 * attn)
                + head - first_inputs)
    return forward + backward


def epoch_ops(dims: Dims, rank: int, batch: int, seq: int) -> float:
    return (matmul_ops(dims, rank, batch, seq)
            + ADAM_OPS * adapter_params(dims, rank))
