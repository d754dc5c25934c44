"""Top-k mixture-of-experts MLP with capacity-based scatter/gather dispatch.

Dispatch drops tokens past capacity: per-expert capacity
``C = ceil(T*k/E * cf)``, rounded up to a multiple of 8; tokens beyond it
are dropped (Switch/GShard semantics). The dispatch is a scatter into an
``(E, C, d)`` buffer, not a one-hot matmul, so the expert products cost the
active compute only.

Determinism: the routing is the reference's to the bit. Top-k puts the
lower expert index first on ties (``jax.lax.top_k``'s order; ``torch.topk``
promises none), ranks come from a stable sort, the scatter into the buffer
is exact in any order (kept ``(expert, slot)`` pairs are unique; dropped
rows add exact zeros), and the combine adds each token's k contributions in
order ``j = 0..k-1`` instead of through an unordered atomic scatter.

LoRA: one adapter on the block's (d -> d) output, ``out_adapter``, through
two plain products (adapting 40-384 experts per layer would defeat PEFT).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (ACC_DTYPE, Params, dense_init,
                                       dtype_of, init_lora_pair, silu)


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device=None
             ) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    std = 1.0 / math.sqrt(d)

    def normal(shape, scale):
        # scaled in place: one f32 draw at a time (kimi-k2-1t-a32b's w_gate
        # is 22.5 GB in f32), the same values as an out-of-place product
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(scale)

    p: Params = {
        "router": normal((d, e), std),   # the router stays f32 (standard)
        "w_gate": normal((e, d, f), std).to(dtype),
        "w_up": normal((e, d, f), std).to(dtype),
        "w_down": normal((e, f, d), 1.0 / math.sqrt(f)).to(dtype),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": dense_init(gen, d, fs, dtype, device),
            "w_up": dense_init(gen, d, fs, dtype, device),
            "w_down": dense_init(gen, fs, d, dtype, device),
        }
    return p


def init_moe_lora(gen: torch.Generator, cfg: ModelConfig, device=None
                  ) -> Params:
    r, d = cfg.lora.rank, cfg.d_model
    return {"out_adapter": init_lora_pair(gen, d, d, r,
                                          dtype_of(cfg.lora.dtype), device)}


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to 8 for tiling


def group_capacity(n_items: int, n_groups: int, cf: float) -> int:
    """Slots per group for n_items spread over n_groups, cf headroom."""
    c = int(math.ceil(n_items / n_groups * cf))
    return max(8, -(-c // 8) * 8)


def within_capacity(pos: torch.Tensor, cap: int,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dispatch's one drop rule: an item is kept where its rank within
    its group (``pos``) is below the group's capacity ``cap`` (and, given
    ``valid``, where it is a real item and not an empty slot)."""
    keep = pos < cap
    return keep if valid is None else valid & keep


def group_counts(groups: torch.Tensor, n_groups: int) -> torch.Tensor:
    """(n_groups,) int64 count of each id in ``groups`` (n,): the integers
    ``torch.bincount(groups, minlength=n_groups)`` gives, at a length fixed
    by ``n_groups`` and not by the data, so the count also traces on the
    ``meta`` device (where ``bincount`` has no kernel)."""
    groups = groups.to(torch.long)
    return torch.zeros(n_groups, dtype=torch.long,
                       device=groups.device).scatter_add_(
        0, groups, torch.ones_like(groups))


def ranks_within_groups(groups: torch.Tensor, n_groups: int) -> torch.Tensor:
    """groups: (n,) int group ids -> within-group rank (original order),
    via a stable sort: O(n log n), no (n, G) one-hot cumsum."""
    n = groups.shape[0]
    groups = groups.to(torch.long)
    order = torch.argsort(groups, stable=True)
    counts = group_counts(groups, n_groups)
    offsets = torch.cumsum(counts, dim=0) - counts
    rank_sorted = (torch.arange(n, dtype=torch.long, device=groups.device)
                   - offsets[groups[order]])
    return torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)


def route(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates, idx), each (T, k): the k largest probabilities of each row,
    the lower expert index first where two are equal."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_forward(params: Params, lora: Optional[Params], x: torch.Tensor,
                cfg: ModelConfig, use_lora_kernel: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss). ``use_lora_kernel`` is accepted and
    ignored, as in the reference: the adapter takes two plain products."""
    del use_lora_kernel
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(t, cfg)
    xf = x.reshape(t, d)
    dev = x.device

    logits = torch.matmul(xf.to(torch.float32), params["router"])  # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = route(probs, k)                             # (T,k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # Load-balancing aux loss (Switch eq. 4): E * sum_e f_e * P_e
    me = torch.mean(probs, dim=0)                            # (E,)
    ce = group_counts(idx[:, 0], e).to(torch.float32) / t
    aux = e * torch.sum(me * ce) * cfg.router_aux_coef

    # --- dispatch: sort-based position assignment (within-expert rank) -----
    flat_e = idx.reshape(-1)                                 # (T*k,)
    pos = ranks_within_groups(flat_e, e)
    keep = within_capacity(pos, cap)
    pos_c = torch.where(keep, pos, torch.zeros_like(pos))
    tok = torch.arange(t, device=dev).repeat_interleave(k)   # (T*k,)

    dispatch = torch.where(keep[:, None], xf[tok],
                           torch.zeros((), dtype=x.dtype, device=dev))
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=dev).index_put(
        (flat_e, pos_c), dispatch, accumulate=True)

    # --- expert compute: (E, C, d) x (E, d, f), f32 accumulate ------------
    g = torch.bmm(buf, params["w_gate"].to(x.dtype))
    u = torch.bmm(buf, params["w_up"].to(x.dtype))
    y = torch.bmm(silu(g) * u, params["w_down"].to(x.dtype))

    # --- combine: each token's k contributions added in order -------------
    w = (gates.reshape(-1) * keep).to(x.dtype)
    contrib = (y[flat_e, pos_c] * w[:, None]).reshape(t, k, d)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]

    if cfg.n_shared_experts:
        sp = params["shared"]
        sg = torch.matmul(xf, sp["w_gate"].to(x.dtype))
        su = torch.matmul(xf, sp["w_up"].to(x.dtype))
        out = out + torch.matmul(silu(sg) * su, sp["w_down"].to(x.dtype))

    out = out.reshape(b, s, d)
    if lora is not None:
        la = lora["out_adapter"]
        adapt = torch.matmul(torch.matmul(x, la["a"].to(x.dtype)),
                             la["b"].to(x.dtype))
        out = out + cfg.lora.scale * adapt
    return out, aux.to(ACC_DTYPE)
