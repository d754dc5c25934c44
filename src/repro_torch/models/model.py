"""Full model assembly: init, layer-range forward, logits, cached decode.

Parameters come in two trees:
  * ``frozen`` — the pre-trained backbone;
  * ``lora``   — the adapters (only the A/B matrices train).

Layer params are stacked along a leading ``n_layers`` axis, as in the
reference, and run by a Python loop over views of that axis. The
full-sequence forward trains: ``forward_loss`` and ``forward_hidden`` run
under autograd (``core.splitting``, ``launch.train``), with each layer
recomputed in the backward when ``remat`` is set. Serving runs under
``torch.no_grad()`` (``launch.serve``, ``serving.engine``). The cache is a
nested dict whose leaves are ``(n_layers, batch, ...)``; the decode and
prefill functions update it IN PLACE and return it.

Split learning support: ``forward_hidden(..., lo, hi)`` runs layers
``[lo, hi)`` only. ``lo == 0`` includes the embedding; ``hi == n_layers``
is the natural server end (final norm + LM head live with the loss).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.common import (ACC_DTYPE, Params, dtype_of,
                                       embed_init, init_rms_norm,
                                       make_generator, resolve_device,
                                       rms_norm, softmax_cross_entropy,
                                       tree_map, tree_take)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(seed: Union[int, torch.Generator], cfg: ModelConfig,
                device=None) -> Params:
    """Full parameter tree {"frozen": ..., "lora": ...} on ``device``
    (``None``: the GPU; raises without one). ``seed`` is an int or a
    ``torch.Generator`` that lives on that device."""
    device = resolve_device(device)
    gen = make_generator(seed, device)
    dtype = dtype_of(cfg.dtype)
    embed = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device)
    head = None
    if not cfg.tie_embeddings:
        head = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device).T
    layers = _stack_layers(lambda: blocks.init_layer(gen, cfg, dtype, device),
                           cfg.n_layers)
    lora_layers = _stack_layers(lambda: blocks.init_layer_lora(gen, cfg, device),
                                cfg.n_layers)
    frozen: Params = {
        "embed": embed,
        "layers": layers,
        "final_norm": init_rms_norm(cfg.d_model, device=device),
    }
    if head is not None:
        frozen["head"] = head
    return {"frozen": frozen, "lora": {"layers": lora_layers}}


def abstract_params(cfg: ModelConfig) -> Params:
    """The full tree on ``meta``: shapes and dtypes, nothing allocated (the
    dry run's path for kimi-k2-1t-a32b, which fits no card)."""
    return init_params(0, cfg, device="meta")


def _stack_layers(make_layer, n: int) -> Params:
    """``n`` calls of ``make_layer`` stacked along a new leading axis, each
    copied into its slot as it is made: the peak is the stack and one layer,
    not two stacks (internvl2-26b's layers take 37.5 GB in bf16)."""
    first = make_layer()
    out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), first)
    for i in range(n):
        layer = first if i == 0 else make_layer()
        tree_map(lambda dst, x: dst[i].copy_(x), out, layer)
    return out


def slice_layers(tree: Params, lo: int, hi: int) -> Params:
    return tree_map(lambda x: x[lo:hi], tree)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def embed_inputs(frozen: Params, batch_inputs: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """tokens (B,S) int -> (B,S,d); or pass-through for 'embeds' mode."""
    if cfg.input_mode == "embeds":
        return batch_inputs.to(dtype_of(cfg.dtype))
    return frozen["embed"][batch_inputs.to(torch.long)]


def forward_hidden(frozen: Params, lora: Optional[Params],
                   inputs: torch.Tensor, cfg: ModelConfig, *, lo: int = 0,
                   hi: Optional[int] = None,
                   positions: Optional[torch.Tensor] = None,
                   impl: str = "chunked", remat: bool = True,
                   use_lora_kernel: bool = False,
                   inputs_embedded: Optional[bool] = None,
                   lora_sliced: bool = False, unroll: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run layers [lo, hi). By default ``lo==0`` means ``inputs`` are
    tokens/embeds and the embedding is applied; otherwise ``inputs`` are
    hidden states (smashed data). ``inputs_embedded=True`` forces the
    hidden-state interpretation (server stage at cut 0).

    ``remat``: under autograd each layer runs inside
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), which
    keeps its inputs only and recomputes it in the backward; without grad
    it changes nothing. ``unroll`` is the reference's (a Python loop over
    layers is already unrolled) and changes nothing.
    Returns (hidden, aux_loss_sum)."""
    del unroll
    hi = cfg.n_layers if hi is None else hi
    if inputs_embedded is None:
        inputs_embedded = lo != 0
    x = inputs if inputs_embedded else embed_inputs(frozen, inputs, cfg)
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device).expand(x.shape[0],
                                                         x.shape[1])

    layer_params = slice_layers(frozen["layers"], lo, hi)
    if lora is None:
        layer_lora = None
    elif lora_sliced:  # caller already holds exactly the [lo,hi) adapters
        layer_lora = lora["layers"]
    else:
        layer_lora = slice_layers(lora["layers"], lo, hi)

    remat = remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(hi - lo):
        lp = tree_take(layer_params, i)
        ll = tree_take(layer_lora, i) if layer_lora is not None else None
        if remat:
            x, aux_l = checkpoint(blocks.layer_forward, lp, ll, x, cfg,
                                  positions=positions, impl=impl,
                                  use_lora_kernel=use_lora_kernel,
                                  use_reentrant=False)
        else:
            x, aux_l = blocks.layer_forward(lp, ll, x, cfg,
                                            positions=positions, impl=impl,
                                            use_lora_kernel=use_lora_kernel)
        aux = aux + aux_l
    return x, aux


class _MmF32Out(torch.autograd.Function):
    """``torch.mm(x, w, out_dtype=f32)`` (CUDA only) with a backward, which
    that overload lacks. The gradients are what JAX gives for a dot with
    ``preferred_element_type=f32``: each product of the f32 cotangent is
    accumulated in f32 and rounded once to its operand's dtype."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=ACC_DTYPE)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g, w.to(ACC_DTYPE).t()).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(x2.to(ACC_DTYPE).t(), g).to(w.dtype)
        return dx, dw


def _matmul_f32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with an f32 result that was never rounded to a narrower type.
    x: (..., K); w: (K, N). A ``meta`` trace takes the card's branch, so the
    dry run counts the bytes the card moves."""
    if x.dtype == ACC_DTYPE:
        return torch.matmul(x, w)
    if x.is_cuda or x.is_meta:
        x2 = x.reshape(-1, x.shape[-1])
        return _MmF32Out.apply(x2, w).reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.to(ACC_DTYPE), w.to(ACC_DTYPE))


def logits_from_hidden(frozen: Params, x: torch.Tensor, cfg: ModelConfig
                       ) -> torch.Tensor:
    """f32 logits over the padded vocabulary; pad columns at -1e30."""
    x = rms_norm(x, frozen["final_norm"], cfg.rms_eps)
    head = frozen["head"] if not cfg.tie_embeddings else frozen["embed"].T
    logits = _matmul_f32_out(x, head.to(x.dtype))
    if cfg.padded_vocab != cfg.vocab_size:
        valid = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    return logits


def forward_loss(frozen: Params, lora: Optional[Params], batch: Dict[str, Any],
                 cfg: ModelConfig, *, impl: str = "chunked",
                 remat: bool = True, use_lora_kernel: bool = False,
                 unroll: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy of the whole model on ``batch``
    (``tokens`` or ``embeds``, and ``labels``), plus the layers' aux loss."""
    inputs = batch["embeds"] if cfg.input_mode == "embeds" else batch["tokens"]
    x, aux = forward_hidden(frozen, lora, inputs, cfg, impl=impl, remat=remat,
                            use_lora_kernel=use_lora_kernel, unroll=unroll)
    logits = logits_from_hidden(frozen, x, cfg)
    return softmax_cross_entropy(logits, batch["labels"]) + aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None
               ) -> Params:
    """Zeroed cache, leaves ``(n_layers, batch, ...)``, on ``device``
    (``None``: the GPU; raises without one)."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    one = blocks.init_layer_cache(cfg, batch, max_len, dtype, device)
    return tree_map(
        lambda x: torch.zeros((cfg.n_layers,) + tuple(x.shape), dtype=x.dtype,
                              device=device), one)


def decode_step(frozen: Params, lora: Optional[Params], cache: Params,
                inputs: torch.Tensor, t, cfg: ModelConfig,
                *, use_lora_kernel: bool = False
                ) -> Tuple[torch.Tensor, Params]:
    """One token for the whole stack. inputs: (B,1) tokens or (B,1,d) embeds;
    t: int32 position — scalar (lock-step batch) or (B,) vector (continuous
    batching: each row decodes at its own position). Returns
    (logits (B,vocab), cache); the cache is updated in place."""
    x = embed_inputs(frozen, inputs, cfg)
    t = torch.as_tensor(t, dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        lp = tree_take(frozen["layers"], i)
        ll = tree_take(lora["layers"], i) if lora is not None else None
        x, _ = blocks.layer_decode(lp, ll, x, tree_take(cache, i), cfg, t=t,
                                   use_lora_kernel=use_lora_kernel)
    logits = logits_from_hidden(frozen, x, cfg)
    return logits[:, 0], cache


def decode_scan(frozen: Params, lora: Optional[Params], cache: Params,
                tokens: torch.Tensor, t0, cfg: ModelConfig,
                *, use_lora_kernel: bool = False
                ) -> Tuple[torch.Tensor, Params]:
    """Consume C tokens with C sequential ``decode_step``s. tokens: (B, C)
    int; t0: scalar int32 position of tokens[:, 0]. Returns (logits after
    the last token (B, vocab), cache)."""
    t0 = torch.as_tensor(t0, dtype=torch.int32, device=tokens.device)
    logits = torch.zeros((tokens.shape[0], cfg.padded_vocab), dtype=ACC_DTYPE,
                         device=tokens.device)
    for i in range(tokens.shape[1]):
        logits, cache = decode_step(frozen, lora, cache, tokens[:, i:i + 1],
                                    t0 + i, cfg,
                                    use_lora_kernel=use_lora_kernel)
    return logits, cache


def prefill_chunk(frozen: Params, lora: Optional[Params], cache: Params,
                  tokens: torch.Tensor, t0, cfg: ModelConfig,
                  *, use_lora_kernel: bool = False
                  ) -> Tuple[torch.Tensor, Params]:
    """Parallel multi-token prefill against the decode cache: one forward
    over a C-token chunk that writes K/V where ``decode_step`` would have,
    position by position. tokens: (B, C) int; t0: scalar int32 position
    of tokens[:, 0]. Returns (last-position logits (B, vocab), cache); the
    cache is updated in place."""
    if cfg.has_ssm:
        raise ValueError(
            f"prefill_chunk does not support family={cfg.family!r} "
            "(cumulative SSM state); use decode_scan")
    x = embed_inputs(frozen, tokens, cfg)
    positions = (torch.as_tensor(t0, dtype=torch.int32, device=x.device)
                 + torch.arange(tokens.shape[1], dtype=torch.int32,
                                device=x.device))
    for i in range(cfg.n_layers):
        lp = tree_take(frozen["layers"], i)
        ll = tree_take(lora["layers"], i) if lora is not None else None
        x, _ = blocks.layer_prefill(lp, ll, x, tree_take(cache, i), cfg,
                                    positions=positions,
                                    use_lora_kernel=use_lora_kernel)
    logits = logits_from_hidden(frozen, x[:, -1:], cfg)
    return logits[:, 0], cache


def prefill(frozen: Params, lora: Optional[Params], inputs: torch.Tensor,
            cfg: ModelConfig, *, impl: str = "chunked"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward: returns (last-position logits, full hidden). LoRA
    goes through the plain ``lora_dense`` path here, as in the reference."""
    x, _ = forward_hidden(frozen, lora, inputs, cfg, impl=impl)
    logits = logits_from_hidden(frozen, x[:, -1:], cfg)
    return logits[:, 0], x
