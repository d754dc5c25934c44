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

Tensor parallelism. Under ``shardctx.mesh_ctx`` of a ``LiveMesh`` of
several ranks, the full-sequence forward (``forward_hidden``,
``forward_loss``, ``prefill``) runs Megatron-style on the mesh, with each
rank's blocks of the parameters (``launch.sharding.shard_params``): the
inputs are the global batch on every rank, split over the data axes at the
model's input (``LiveMesh.enter``, where the data axes divide the batch:
the reference's ``constrain(x, "dp", None, None)``); attention and the
dense MLP run on the rank's columns and rows; the embedding and the head
are split over the vocabulary; the prefill's logits (the whole vocabulary)
and the loss leave the mesh the same on every rank (``LiveMesh.leave``).
The decode step (``decode_step``, ``decode_scan``) runs on the mesh too,
against this rank's block of the cache under ``launch.sharding.
cache_specs`` (KV slots over "model", the SSM state over heads or head
dim, the conv window over channels, the batch over the data axes), which
it updates in place: attention combines each rank's softmax over its
slots (``attention.combined_attention``); per-row adapter banks come as
this rank's blocks under ``launch.sharding.lora_specs``; the logits leave
the mesh the same on every rank. The cache-writing chunked prefill
(``prefill_chunk``) runs on one rank's whole parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import shardctx
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.common import (ACC_DTYPE, Params, TensorParallel,
                                       dtype_of, embed_init, init_rms_norm,
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
    not two stacks (internvl2-26b's layers take 37.5 GB in bf16). A stack of
    one is that layer itself, viewed with the leading axis (one layer of
    kimi-k2-1t-a32b takes 34 GB in bf16)."""
    first = make_layer()
    if n == 1:
        return tree_map(lambda x: x[None], first)
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


def tensor_parallel(batch: int) -> Optional[TensorParallel]:
    """The active ``LiveMesh`` of several ranks as the layers see it, for a
    global batch of ``batch`` rows (split over the data axes where they
    divide it); None without one."""
    mesh = shardctx.live()
    if mesh is None:
        return None
    return TensorParallel(mesh, shardctx.guarded_spec((batch,), "dp")[0])


def _enter(x: Optional[torch.Tensor], tp: Optional[TensorParallel]):
    """A global input's block of the batch on this rank."""
    if x is None or tp is None or tp.batch is None:
        return x
    return tp.mesh.enter(x, tp.batch)


def embed_inputs(frozen: Params, batch_inputs: torch.Tensor, cfg: ModelConfig,
                 tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """tokens (B,S) int -> (B,S,d); or pass-through for 'embeds' mode.
    With ``tp`` the table is this rank's block: of the vocabulary (a lookup
    of the rows it holds, zero elsewhere, summed over "model"), or, where
    the model axis does not divide the vocabulary, of ``d`` (gathered)."""
    if cfg.input_mode == "embeds":
        return batch_inputs.to(dtype_of(cfg.dtype))
    ids = batch_inputs.to(torch.long)
    emb = frozen["embed"]
    if tp is None or not (tp.splits(cfg.padded_vocab)
                          or tp.splits(cfg.d_model)):
        return emb[ids]
    if not tp.splits(cfg.padded_vocab):
        return tp.mesh.gather(emb[ids], "model", -1)
    rows = emb.shape[0]
    local = ids - tp.index * rows
    inside = (local >= 0) & (local < rows)
    out = emb[local.clamp(0, rows - 1)]
    return tp.psum(torch.where(inside[..., None], out,
                               torch.zeros_like(out)))


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
    hidden-state interpretation (server stage at cut 0). On a tensor-
    parallel mesh (module docstring) ``inputs`` and ``positions`` are
    global and the hidden states returned are this rank's block of the
    batch.

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
    tp = tensor_parallel(inputs.shape[0])
    inputs, positions = _enter(inputs, tp), _enter(positions, tp)
    x = inputs if inputs_embedded else embed_inputs(frozen, inputs, cfg, tp)
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
                                  use_lora_kernel=use_lora_kernel, tp=tp,
                                  use_reentrant=False)
        else:
            x, aux_l = blocks.layer_forward(lp, ll, x, cfg,
                                            positions=positions, impl=impl,
                                            use_lora_kernel=use_lora_kernel,
                                            tp=tp)
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


def _local_logits(frozen: Params, x: torch.Tensor, cfg: ModelConfig,
                  tp: Optional[TensorParallel]) -> Tuple[torch.Tensor, bool]:
    """(f32 logits, whether they are this rank's block of the vocabulary);
    pad columns at -1e30. With ``tp`` the head is this rank's block of the
    vocabulary (``head``'s columns, or the tied ``embed``'s rows), or where
    the model axis does not divide the vocabulary, of ``d`` (the partial
    logits summed over "model")."""
    x = rms_norm(x, frozen["final_norm"], cfg.rms_eps)
    head = frozen["head"] if not cfg.tie_embeddings else frozen["embed"].T
    vocab_split = tp is not None and tp.splits(cfg.padded_vocab)
    if tp is not None and not vocab_split and tp.splits(cfg.d_model):
        x = tp.mesh.split(x, "model", -1)
        logits = tp.psum(_matmul_f32_out(x, head.to(x.dtype)))
    else:
        logits = _matmul_f32_out(x, head.to(x.dtype))
    if cfg.padded_vocab != cfg.vocab_size:
        first = tp.index * logits.shape[-1] if vocab_split else 0
        valid = torch.arange(first, first + logits.shape[-1],
                             device=x.device) < cfg.vocab_size
        logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    return logits, vocab_split


def logits_from_hidden(frozen: Params, x: torch.Tensor, cfg: ModelConfig,
                       tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """f32 logits over the padded vocabulary; pad columns at -1e30. With
    ``tp``: ``x`` is this rank's block of the batch, and the logits are its
    rows over the whole vocabulary (gathered over "model")."""
    logits, vocab_split = _local_logits(frozen, x, cfg, tp)
    if vocab_split:
        logits = tp.mesh.gather(logits, "model", -1)
    return logits


def _vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                        tp: TensorParallel) -> torch.Tensor:
    """Each token's -log p(label) from this rank's block of the
    vocabulary: the log-sum-exp and the label's logit summed over "model"
    (the max shift is taken over the whole vocabulary, no gradient)."""
    logits = logits.to(torch.float32)
    cols = logits.shape[-1]
    shift = tp.mesh.pmax(logits.amax(-1), "model")
    logz = shift + torch.log(tp.psum(
        torch.exp(logits - shift[..., None]).sum(-1)))
    local = labels.clamp(min=0).to(torch.long) - tp.index * cols
    inside = (local >= 0) & (local < cols)
    gold = torch.gather(logits, -1, local.clamp(0, cols - 1)[..., None])[..., 0]
    return logz - tp.psum(torch.where(inside, gold, torch.zeros_like(gold)))


def _mean_nll_tp(logits: torch.Tensor, vocab_split: bool,
                 labels: torch.Tensor, tp: TensorParallel,
                 ignore_id: int = -100) -> torch.Tensor:
    """``softmax_cross_entropy`` of the whole batch from this rank's block
    of it: the masked sums added over the data axes."""
    if vocab_split:
        nll = _vocab_parallel_nll(logits, labels, tp)
    else:
        logits = logits.to(torch.float32)
        nll = torch.logsumexp(logits, dim=-1) - torch.gather(
            logits, -1, labels.clamp(min=0).to(torch.long)[..., None])[..., 0]
    mask = (labels != ignore_id).to(torch.float32)
    total, count = torch.sum(nll * mask), torch.sum(mask)
    if tp.batch is not None:
        total = tp.mesh.psum(total, tp.batch)
        count = tp.mesh.psum(count, tp.batch)
    return total / torch.clamp(count, min=1.0)


def loss_from_hidden(frozen: Params, x: torch.Tensor, labels: torch.Tensor,
                     aux: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The mean next-token cross-entropy of ``x`` against ``labels``, plus
    ``aux``. On a tensor-parallel mesh ``x`` is this rank's block of the
    batch (``forward_hidden``'s), ``labels`` the global labels, and the
    loss is the whole batch's on every rank, counted once
    (``LiveMesh.leave``): the head is split over the vocabulary and the
    log-softmax with it."""
    tp = tensor_parallel(labels.shape[0])
    if tp is None:
        return softmax_cross_entropy(logits_from_hidden(frozen, x, cfg),
                                     labels) + aux
    logits, vocab_split = _local_logits(frozen, x, cfg, tp)
    loss = _mean_nll_tp(logits, vocab_split, _enter(labels, tp), tp) + aux
    return tp.mesh.leave(loss, ())


def forward_loss(frozen: Params, lora: Optional[Params], batch: Dict[str, Any],
                 cfg: ModelConfig, *, impl: str = "chunked",
                 remat: bool = True, use_lora_kernel: bool = False,
                 unroll: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy of the whole model on ``batch``
    (``tokens`` or ``embeds``, and ``labels``), plus the layers' aux loss."""
    inputs = batch["embeds"] if cfg.input_mode == "embeds" else batch["tokens"]
    x, aux = forward_hidden(frozen, lora, inputs, cfg, impl=impl, remat=remat,
                            use_lora_kernel=use_lora_kernel, unroll=unroll)
    return loss_from_hidden(frozen, x, batch["labels"], aux, cfg)


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


def _decode_slots(cache: Params, tp: TensorParallel, batch: int,
                  cfg: ModelConfig, slots: Optional[int]
                  ) -> Tuple[int, int, int]:
    """This rank's global slot range and the global slot count of a decode
    cache given as its block (``TensorParallel.slots``). ``slots`` is the
    global count; None reads it from the block, which is unambiguous
    unless the model axis does not divide the block's slots (a whole cache
    of such a count, or a block of ``m`` times it): then it raises."""
    from repro_torch.launch.sharding import slot_range
    local = cache["kv"]["k"].shape[2]
    if slots is None:
        if local % tp.size:
            raise ValueError(
                f"a cache block of {local} slots on a model axis of "
                f"{tp.size}: whole, or a block of {local * tp.size}; pass "
                "the global slot count (slots=)")
        slots = local * tp.size
    lo, hi = slot_range(cfg, tp.mesh, slots, batch)
    if hi - lo != local:
        raise ValueError(f"the cache block holds {local} slots; "
                         f"cache_specs gives this rank {hi - lo} of {slots}")
    return lo, hi, slots


def decode_step(frozen: Params, lora: Optional[Params], cache: Params,
                inputs: torch.Tensor, t, cfg: ModelConfig,
                *, use_lora_kernel: bool = False,
                slots: Optional[int] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One token for the whole stack. inputs: (B,1) tokens or (B,1,d) embeds;
    t: int32 position — scalar (lock-step batch) or (B,) vector (continuous
    batching: each row decodes at its own position). Returns
    (logits (B,vocab), cache); the cache is updated in place.

    On a tensor-parallel mesh (module docstring) ``inputs`` and ``t`` are
    global, ``frozen`` and ``lora`` this rank's blocks, ``cache`` its block
    under ``cache_specs`` (``slots``: the cache's global slot count, read
    from the block when that is unambiguous), and the logits the whole
    batch's on every rank."""
    tp = tensor_parallel(inputs.shape[0])
    if tp is not None and cfg.family != "ssm":
        tp = dataclasses.replace(tp, slots=_decode_slots(
            cache, tp, inputs.shape[0], cfg, slots))
    x = embed_inputs(frozen, _enter(inputs, tp), cfg, tp)
    t = torch.as_tensor(t, dtype=torch.int32, device=x.device)
    if t.ndim:
        t = _enter(t, tp)
    for i in range(cfg.n_layers):
        lp = tree_take(frozen["layers"], i)
        ll = tree_take(lora["layers"], i) if lora is not None else None
        x, _ = blocks.layer_decode(lp, ll, x, tree_take(cache, i), cfg, t=t,
                                   use_lora_kernel=use_lora_kernel, tp=tp)
    logits = logits_from_hidden(frozen, x, cfg, tp)
    if tp is not None:
        logits = tp.mesh.leave(logits, tp.batch or ())
    return logits[:, 0], cache


def decode_scan(frozen: Params, lora: Optional[Params], cache: Params,
                tokens: torch.Tensor, t0, cfg: ModelConfig,
                *, use_lora_kernel: bool = False,
                slots: Optional[int] = None
                ) -> Tuple[torch.Tensor, Params]:
    """Consume C tokens with C sequential ``decode_step``s. tokens: (B, C)
    int; t0: scalar int32 position of tokens[:, 0]. Returns (logits after
    the last token (B, vocab), cache). On a mesh as ``decode_step``."""
    t0 = torch.as_tensor(t0, dtype=torch.int32, device=tokens.device)
    logits = torch.zeros((tokens.shape[0], cfg.padded_vocab), dtype=ACC_DTYPE,
                         device=tokens.device)
    for i in range(tokens.shape[1]):
        logits, cache = decode_step(frozen, lora, cache, tokens[:, i:i + 1],
                                    t0 + i, cfg,
                                    use_lora_kernel=use_lora_kernel,
                                    slots=slots)
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
    goes through the plain ``lora_dense`` path here, as in the reference.
    On a tensor-parallel mesh the logits are the whole batch's over the
    whole vocabulary on every rank, the hidden states this rank's block."""
    x, _ = forward_hidden(frozen, lora, inputs, cfg, impl=impl)
    tp = tensor_parallel(inputs.shape[0])
    logits = logits_from_hidden(frozen, x[:, -1:], cfg, tp)[:, 0]
    if tp is not None:
        logits = tp.mesh.leave(logits, tp.batch or ())
    return logits, x
