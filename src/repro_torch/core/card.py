"""CARD — Cut lAyer and computing Resource Decision (Alg. 1, Sec. IV).

  P2 -> (upper layer) closed-form server frequency, Eq. (16):
      f* = clip(Q, F_min^{m,S}, F_max^S),
      Q  = cbrt( w (E_max - E_min) / (2 xi (1-w) (D_max - D_min)) )
  P2 -> (lower layer) brute-force over c in {0..I}: O(I).

Baselines from Sec. V-B:
  server-only — c = 0 (device runs only the embedding module);
  device-only — c = I (device runs embedding + all decoders);
plus static-cut and random-cut baselines for wider comparison.

A port of the reference's ``core/card.py``: the scalar oracle in Python
floats as there, and the batched fleet grids, which the reference jit-compiles,
as plain tensor programs on the context's device (no Python branching on
tensor values, ``where``-selection, ``argmin``'s first-index tie rule). The
tiered and hierarchical half is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.cost_model import BatchedRoundContext, RoundContext


@dataclass(frozen=True)
class Decision:
    """One device-round CARD decision: ``cut`` layers stay on the device,
    the server runs at ``frequency`` Hz; ``delay`` is the round time in
    seconds (Eq. 7), ``energy`` the server energy in joules (Eq. 11), and
    ``cost`` their Eq. 12 scalarization."""
    cut: int
    frequency: float
    cost: float
    delay: float
    energy: float


class DeadlineSpec(NamedTuple):
    """Straggler-aware deadline objective (churn extension, cf. Efficient
    Split Federated Learning, arXiv:2504.14667).

    The server closes rounds at a deadline; a decision whose nominal delay
    already exceeds it misses with probability 1, one that only misses when
    the device straggles (delay * mean slowdown > deadline) misses with the
    straggler probability, and every decision additionally risks the
    device's dropout. CARD's scalarized cost (Eq. 12) gains
    ``penalty * P(miss)`` so the (cut, f) choice trades delay/energy against
    the round actually committing. All fields are plain floats.
    """
    deadline_s: float
    p_dropout: float = 0.0
    p_straggler: float = 0.0
    slowdown: float = 1.0      # E[slowdown | straggler event]
    penalty: float = 1.0


def miss_probability(delay: torch.Tensor, spec: DeadlineSpec) -> torch.Tensor:
    """P(decision with nominal ``delay`` misses the round deadline) — tensor
    broadcasting over arbitrarily shaped delay tensors."""
    one = torch.ones_like(delay)
    p_late = torch.where(delay > spec.deadline_s, one,
                         torch.where(delay * spec.slowdown > spec.deadline_s,
                                     one * spec.p_straggler, one * 0.0))
    return spec.p_dropout + (1.0 - spec.p_dropout) * p_late


def _miss_probability_scalar(delay: float, spec: DeadlineSpec) -> float:
    """Float64 twin of :func:`miss_probability` for the scalar oracle."""
    if delay > spec.deadline_s:
        p_late = 1.0
    elif delay * spec.slowdown > spec.deadline_s:
        p_late = spec.p_straggler
    else:
        p_late = 0.0
    return spec.p_dropout + (1.0 - spec.p_dropout) * p_late


def optimal_frequency(ctx: RoundContext) -> float:
    """Eq. (16). Note Q is independent of c — the frequency subproblem and
    the cut subproblem decouple exactly as the paper exploits."""
    d_min, d_max, e_min, e_max = ctx.corners()
    w, xi = ctx.sim.w, ctx.sim.xi
    if w >= 1.0:
        return ctx.server.f_max
    q = ((w * (e_max - e_min))
         / (2.0 * xi * (1.0 - w) * max(d_max - d_min, 1e-12))) ** (1.0 / 3.0)
    return float(np.clip(q, ctx.f_min(), ctx.server.f_max))


def _evaluate(ctx: RoundContext, cut: int, f: float, corners,
              deadline: Optional[DeadlineSpec] = None) -> Decision:
    delay = ctx.round_delay(cut, f)
    cost = ctx.cost(cut, f, corners)
    if deadline is not None:
        cost += deadline.penalty * _miss_probability_scalar(delay, deadline)
    return Decision(cut=cut, frequency=f, cost=cost, delay=delay,
                    energy=ctx.server_energy(cut, f))


def card(ctx: RoundContext, *, respect_memory: bool = True,
         deadline: Optional[DeadlineSpec] = None) -> Decision:
    """Alg. 1: f* once (line 1), then brute-force c (lines 3-9).

    With ``deadline``, each candidate's cost is penalized by its round-miss
    probability (straggler-aware deadline objective), and every cut gains a
    *rescue* frequency candidate — the server flat out at ``f_max``, the
    delay-minimal point Eq. (16) cannot reach because its closed form does
    not see the deadline. The rescue wins only when its penalized cost is
    strictly lower, so a slack deadline reproduces nominal CARD exactly."""
    corners = ctx.corners()
    f_star = optimal_frequency(ctx)
    max_cut = (ctx.max_feasible_cut() if respect_memory
               else ctx.workload.cfg.n_layers)
    best: Optional[Decision] = None
    for c in range(0, max_cut + 1):
        cand = _evaluate(ctx, c, f_star, corners, deadline)
        if deadline is not None:
            rescue = _evaluate(ctx, c, ctx.server.f_max, corners, deadline)
            if rescue.cost < cand.cost:
                cand = rescue
        if best is None or cand.cost < best.cost:
            best = cand
    assert best is not None
    return best


def card_joint_bruteforce(ctx: RoundContext, *, n_freq: int = 200,
                          respect_memory: bool = True) -> Decision:
    """Exhaustive (f, c) grid — the optimality oracle for tests."""
    corners = ctx.corners()
    freqs = np.linspace(ctx.f_min(), ctx.server.f_max, n_freq)
    max_cut = (ctx.max_feasible_cut() if respect_memory
               else ctx.workload.cfg.n_layers)
    best: Optional[Decision] = None
    for c in range(0, max_cut + 1):
        for f in freqs:
            cand = _evaluate(ctx, c, float(f), corners)
            if best is None or cand.cost < best.cost:
                best = cand
    assert best is not None
    return best


# --- Benchmarks (Sec. V-B) ---------------------------------------------------


def server_only(ctx: RoundContext) -> Decision:
    """Devices fine-tune the embedding module only; server does the rest.
    Server runs flat out (no energy-aware DVFS) — the energy-hungry baseline."""
    return _evaluate(ctx, 0, ctx.server.f_max, ctx.corners())


def device_only(ctx: RoundContext) -> Decision:
    """Devices fine-tune embedding + all transformer decoders locally."""
    # device-only ignores the memory mask: that is precisely its weakness
    cut = ctx.workload.cfg.n_layers
    return _evaluate(ctx, cut, ctx.f_min(), ctx.corners())


def static_cut(ctx: RoundContext, cut: int) -> Decision:
    """Fixed split (the 'static strategies' the paper argues against)."""
    f_star = optimal_frequency(ctx)
    return _evaluate(ctx, cut, f_star, ctx.corners())


def random_cut(ctx: RoundContext, rng: np.random.Generator) -> Decision:
    """Baseline: uniform cut in [0, n_layers] from ``rng``, frequency
    still chosen by Eq. 16 (via ``static_cut``)."""
    cut = int(rng.integers(0, ctx.workload.cfg.n_layers + 1))
    return static_cut(ctx, cut)


# ---------------------------------------------------------------------------
# Batched CARD — the whole (rounds x devices x cuts) grid as tensor programs
# ---------------------------------------------------------------------------


class BatchedDecision(NamedTuple):
    """Per-(round, device) decisions; every field is an (R, D) tensor."""
    cuts: torch.Tensor        # int32
    freqs: torch.Tensor       # Hz
    costs: torch.Tensor       # Eq. 12 scalarized cost
    delays: torch.Tensor      # Eq. 10 total round delay, s
    energies: torch.Tensor    # Eq. 11 server energy, J
    d_device: torch.Tensor    # delay breakdown: device compute
    d_uplink: torch.Tensor    #                  uplink (smashed + adapters)
    d_server: torch.Tensor    #                  server compute
    d_downlink: torch.Tensor  #                  downlink (grads + adapters)


def batched_optimal_frequency(bctx: BatchedRoundContext,
                              corners=None) -> torch.Tensor:
    """Eq. (16) per (round, device): Q depends only on the corners, which
    depend on the channel draw — hence an (R, D) tensor of f* in Hz."""
    if corners is None:
        corners = bctx.corners()
    d_min, d_max, e_min, e_max = corners
    # w is data (see BatchedRoundContext): guard the 1-w division and
    # select the pure-delay w=1 endpoint with where, not Python control flow
    q = ((bctx.w * (e_max - e_min))
         / (2.0 * bctx.xi * torch.clamp(1.0 - bctx.w, min=1e-12)
            * torch.clamp(d_max - d_min, min=1e-12))) ** (1.0 / 3.0)
    f = torch.minimum(torch.maximum(q, bctx.f_min()[None, :]),
                      torch.full_like(q, bctx.server_f_max))
    return torch.where(bctx.w >= 1.0, torch.full_like(f, bctx.server_f_max),
                       f)


def _batched_evaluate(bctx: BatchedRoundContext, cuts: torch.Tensor,
                      f: torch.Tensor, corners,
                      deadline: Optional[DeadlineSpec] = None
                      ) -> BatchedDecision:
    """Metrics for fixed per-(round, device) decisions (cuts, f): (R, D)."""
    c = cuts.long()[..., None]
    parts = bctx.delay_components(c, f)
    delays = parts.total[..., 0]
    costs = bctx.cost(c, f, corners)[..., 0]
    if deadline is not None:
        costs = costs + deadline.penalty * miss_probability(delays, deadline)
    return BatchedDecision(
        cuts=cuts.to(torch.int32),
        freqs=torch.broadcast_to(f, bctx.shape),
        costs=costs,
        delays=delays,
        energies=bctx.server_energy(c, f)[..., 0],
        d_device=parts.device_comp[..., 0], d_uplink=parts.uplink[..., 0],
        d_server=parts.server_comp[..., 0], d_downlink=parts.downlink[..., 0])


def _grid(bctx: BatchedRoundContext) -> torch.Tensor:
    return torch.arange(bctx.n_cuts, device=bctx.device)


def _mask_infeasible(bctx: BatchedRoundContext, cost: torch.Tensor,
                     grid: torch.Tensor) -> torch.Tensor:
    infeasible = grid[None, None, :] > bctx.max_cut[None, :, None]
    return torch.where(infeasible, torch.full_like(cost, float("inf")), cost)


def batched_card(bctx: BatchedRoundContext, *,
                 respect_memory: bool = True,
                 deadline: Optional[DeadlineSpec] = None) -> BatchedDecision:
    """Alg. 1 for the whole fleet: closed-form f* per (round, device), then
    the brute-force over cuts becomes one argmin over the cost tensor.
    ``deadline`` adds the straggler-aware miss-probability penalty and the
    per-cut f_max rescue candidate (same objective as the scalar path)."""
    corners = bctx.corners()
    f_star = batched_optimal_frequency(bctx, corners)
    grid = _grid(bctx)
    freqs = f_star
    cost = bctx.cost(grid, f_star, corners)                 # (R, D, C)
    if deadline is not None:
        def penalized(f):
            base = bctx.cost(grid, f, corners)              # (R, D, C)
            return base + deadline.penalty * miss_probability(
                bctx.round_delay(grid, f), deadline)

        cost = penalized(f_star)
        rescue_cost = penalized(torch.full_like(f_star, bctx.server_f_max))
        use_rescue = rescue_cost < cost                     # strict, like
        cost = torch.where(use_rescue, rescue_cost, cost)   # the scalar path
    if respect_memory:
        cost = _mask_infeasible(bctx, cost, grid)
    best = torch.argmin(cost, dim=-1).to(torch.int32)       # (R, D)
    if deadline is not None:
        picked = torch.take_along_dim(use_rescue, best.long()[..., None],
                                      dim=-1)[..., 0]
        freqs = torch.where(picked, torch.full_like(f_star,
                                                    bctx.server_f_max),
                            f_star)
    return _batched_evaluate(bctx, best, freqs, corners, deadline)


def batched_card_joint_bruteforce(bctx: BatchedRoundContext, *,
                                  n_freq: int = 200,
                                  respect_memory: bool = True
                                  ) -> BatchedDecision:
    """Exhaustive (f, c) grid over a leading frequency axis — the
    optimality oracle for the batched path. O(F * R * D * C) memory: use
    small fleets (tests), not production sweeps."""
    corners = bctx.corners()
    grid = _grid(bctx)
    steps = torch.linspace(0.0, 1.0, n_freq, device=bctx.device)
    f_lo = bctx.f_min()
    fgrid = f_lo[None, :] + steps[:, None] * (bctx.server_f_max
                                              - f_lo[None, :])  # (F, D)
    costs = torch.stack([
        bctx.cost(grid, torch.broadcast_to(fk, bctx.shape), corners)
        for fk in fgrid])                                   # (F, R, D, C)
    if respect_memory:
        costs = _mask_infeasible(bctx, costs, grid)
    flat = costs.permute(1, 2, 3, 0)                        # (R, D, C, F)
    flat = flat.reshape(bctx.shape + (bctx.n_cuts * n_freq,))
    idx = torch.argmin(flat, dim=-1)
    best_c = (idx // n_freq).to(torch.int32)
    n_dev = bctx.shape[1]
    f_sel = fgrid[idx % n_freq,
                  torch.arange(n_dev, device=bctx.device)[None, :]]
    return _batched_evaluate(bctx, best_c, f_sel, corners)


def batched_server_only(bctx: BatchedRoundContext) -> BatchedDecision:
    """Baseline: cut 0 (everything on the server) at ``server_f_max`` Hz
    for every (round, device) lane; all outputs are (R, D)."""
    cuts = torch.zeros(bctx.shape, dtype=torch.int32, device=bctx.device)
    return _batched_evaluate(
        bctx, cuts, torch.full(bctx.shape, bctx.server_f_max,
                               dtype=torch.float32, device=bctx.device),
        bctx.corners())


def batched_device_only(bctx: BatchedRoundContext) -> BatchedDecision:
    """Baseline: cut n_layers (everything on the device) at the minimum
    feasible server frequency in Hz; all outputs are (R, D)."""
    cuts = torch.full(bctx.shape, bctx.n_cuts - 1, dtype=torch.int32,
                      device=bctx.device)
    f = torch.broadcast_to(bctx.f_min(), bctx.shape)
    return _batched_evaluate(bctx, cuts, f, bctx.corners())


def batched_static_cut(bctx: BatchedRoundContext, cut) -> BatchedDecision:
    """``cut`` may be a scalar or an (R, D) tensor (e.g. random-cut draws)."""
    corners = bctx.corners()
    f_star = batched_optimal_frequency(bctx, corners)
    cuts = torch.broadcast_to(
        torch.as_tensor(cut, dtype=torch.int32, device=bctx.device),
        bctx.shape)
    return _batched_evaluate(bctx, cuts, f_star, corners)
