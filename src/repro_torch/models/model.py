"""Full model assembly: init, layer-range forward, logits, cached decode.

Parameters come in two trees:
  * ``frozen`` — the pre-trained backbone;
  * ``lora``   — the adapters (only the A/B matrices train).

Layer params are stacked along a leading ``n_layers`` axis, as in the
reference, and run by a Python loop over views of that axis. Everything here
is inference: callers run it under ``torch.no_grad()`` (``launch.serve`` and
``serving.engine`` do). The cache is a nested dict whose leaves are
``(n_layers, batch, ...)``; the decode and prefill functions update it IN
PLACE and return it.

Split learning support: ``forward_hidden(..., lo, hi)`` runs layers
``[lo, hi)`` only. ``lo == 0`` includes the embedding; ``hi == n_layers``
is the natural server end (final norm + LM head live with the loss).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.common import (ACC_DTYPE, Params, dtype_of,
                                       embed_init, init_rms_norm,
                                       make_generator, resolve_device,
                                       rms_norm, tree_map, tree_take)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(seed: Union[int, torch.Generator], cfg: ModelConfig,
                device=None) -> Params:
    """Full parameter tree {"frozen": ..., "lora": ...} on ``device``
    (``None``: the GPU; raises without one). ``seed`` is an int or a
    ``torch.Generator`` that lives on that device."""
    blocks.require_dense(cfg)
    device = resolve_device(device)
    gen = make_generator(seed, device)
    dtype = dtype_of(cfg.dtype)
    embed = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device)
    head = None
    if not cfg.tie_embeddings:
        head = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device).T
    layers = _stack([blocks.init_layer(gen, cfg, dtype, device)
                     for _ in range(cfg.n_layers)])
    lora_layers = _stack([blocks.init_layer_lora(gen, cfg, device)
                          for _ in range(cfg.n_layers)])
    frozen: Params = {
        "embed": embed,
        "layers": layers,
        "final_norm": init_rms_norm(cfg.d_model, device=device),
    }
    if head is not None:
        frozen["head"] = head
    return {"frozen": frozen, "lora": {"layers": lora_layers}}


def _stack(trees) -> Params:
    return tree_map(lambda *xs: torch.stack(xs), *trees)


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
                   impl: str = "chunked", use_lora_kernel: bool = False,
                   inputs_embedded: Optional[bool] = None,
                   lora_sliced: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run layers [lo, hi). By default ``lo==0`` means ``inputs`` are
    tokens/embeds and the embedding is applied; otherwise ``inputs`` are
    hidden states (smashed data). ``inputs_embedded=True`` forces the
    hidden-state interpretation (server stage at cut 0).
    Returns (hidden, aux_loss_sum)."""
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

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(hi - lo):
        lp = tree_take(layer_params, i)
        ll = tree_take(layer_lora, i) if layer_lora is not None else None
        x, aux_l = blocks.layer_forward(lp, ll, x, cfg, positions=positions,
                                        impl=impl,
                                        use_lora_kernel=use_lora_kernel)
        aux = aux + aux_l
    return x, aux


def _matmul_f32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with an f32 result that was never rounded to a narrower type.
    x: (..., K); w: (K, N)."""
    if x.dtype == ACC_DTYPE:
        return torch.matmul(x, w)
    if x.is_cuda:
        x2 = x.reshape(-1, x.shape[-1])
        return torch.mm(x2, w, out_dtype=ACC_DTYPE).reshape(
            *x.shape[:-1], w.shape[-1])
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
