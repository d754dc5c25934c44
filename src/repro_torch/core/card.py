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
tensor values, ``where``-selection, ``argmin``'s first-index tie rule); the
tiered grid the same way, and the hierarchical assignment stage as the
reference's host numpy, verbatim.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.cost_model import (BatchedRoundContext, RoundContext,
                                         TieredRoundContext)


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


# ---------------------------------------------------------------------------
# Hierarchical CARD — a tier of servers with device -> server assignment
# ---------------------------------------------------------------------------
#
# SplitLLM (arXiv:2501.13318) hierarchical setting: stage 1 assigns each
# device to one server of the tier (capacity-constrained), stage 2 runs
# per-server CARD exactly as before. The assignment objective is device-
# separable — each (server, device) pair is priced at the device's *optimal*
# CARD cost under that server (mean over the round batch) — so the two
# stages decouple the same way Eq. 16 decouples f from c: the per-server
# grids are computed once for all S servers and the assignment is a pure
# host-side matching over the (S, D) price matrix.


class TierDecision(NamedTuple):
    """Per-(server, round, device) best-response CARD grids; every field is
    an (S, R, D) tensor. ``costs`` is what the assignment stage prices;
    ``delays`` are seconds, ``energies`` joules, ``freqs`` Hz. ``d_server``
    is the server-compute share of ``delays`` — the term that contends when
    one server hosts many devices (parallel-SL round folding)."""
    cuts: torch.Tensor
    freqs: torch.Tensor
    costs: torch.Tensor
    delays: torch.Tensor
    energies: torch.Tensor
    d_server: torch.Tensor


def tiered_optimal_frequency(tctx: TieredRoundContext,
                             corners=None) -> torch.Tensor:
    """Eq. (16) per (server, round, device): same closed form as
    :func:`batched_optimal_frequency` with per-server DVFS bounds."""
    if corners is None:
        corners = tctx.corners()
    d_min, d_max, e_min, e_max = corners
    q = ((tctx.w * (e_max - e_min))
         / (2.0 * tctx.xi * torch.clamp(1.0 - tctx.w, min=1e-12)
            * torch.clamp(d_max - d_min, min=1e-12))) ** (1.0 / 3.0)
    f_hi = torch.broadcast_to(tctx.server_f_max[:, None, None], tctx.shape)
    f = torch.minimum(torch.maximum(q, tctx.f_min()[:, None, :]), f_hi)
    return torch.where(tctx.w >= 1.0, f_hi, f)


def tiered_card_grid(tctx: TieredRoundContext, *,
                     respect_memory: bool = True) -> TierDecision:
    """Alg. 1 for every candidate server at once: closed-form f* per
    (server, round, device), then one argmin over the (S, R, D, C) cost
    tensor (first index on ties). Stage 2 of ``hierarchical_card`` — and,
    gathered along the assignment, identical to running ``batched_card``
    per server."""
    corners = tctx.corners()
    f_star = tiered_optimal_frequency(tctx, corners)
    grid = torch.arange(tctx.n_cuts, device=tctx.device)
    cost = tctx.cost(grid, f_star, corners)                  # (S, R, D, C)
    if respect_memory:
        infeasible = (grid[None, None, None, :]
                      > tctx.max_cut[None, None, :, None])
        cost = torch.where(infeasible, torch.full_like(cost, float("inf")),
                           cost)
    best = torch.argmin(cost, dim=-1).to(torch.int32)        # (S, R, D)
    c = best.long()[..., None]
    parts = tctx.delay_components(c, f_star)
    return TierDecision(
        cuts=best,
        freqs=f_star,
        costs=tctx.cost(c, f_star, corners)[..., 0],
        delays=parts.total[..., 0],
        energies=tctx.server_energy(c, f_star)[..., 0],
        d_server=parts.server_comp[..., 0])


ASSIGN_METHODS = ("greedy", "optimal")


def assign_devices(cost_sd: np.ndarray, capacity: np.ndarray, *,
                   method: str = "greedy") -> np.ndarray:
    """Capacity-constrained device -> server assignment over an (S, D)
    price matrix (float64, NaN/inf = infeasible pair). Returns (D,) int.

    ``"greedy"`` — regret-ordered auction-style pass: devices bid in order
    of decreasing regret (second-best minus best price) and take the
    cheapest server with remaining capacity. Optimal whenever no capacity
    binds (then it degenerates to the per-device argmin); a heuristic
    otherwise — the O(D log D + D S) path for million-device fleets.

    ``"optimal"`` — successive-shortest-path min-cost matching (unit-supply
    transportation problem): devices are assigned one at a time via the
    cheapest chain of reassignments in the residual graph. Exactly optimal
    (the residual graph stays free of negative cycles, the SSP invariant);
    O(D * S^2 * D) worst case — the oracle for tests and small tiers, not
    the million-device path.
    """
    cost_sd = np.asarray(cost_sd, np.float64)
    n_servers, n_devices = cost_sd.shape
    capacity = np.asarray(capacity, np.int64)
    if capacity.shape != (n_servers,):
        raise ValueError(f"capacity shape {capacity.shape} != ({n_servers},)")
    if capacity.sum() < n_devices:
        raise ValueError(f"tier capacity {int(capacity.sum())} < "
                         f"{n_devices} devices")
    if method == "greedy":
        return _assign_greedy(cost_sd, capacity)
    if method == "optimal":
        return _assign_optimal(cost_sd, capacity)
    raise ValueError(f"unknown assignment method {method!r}; "
                     f"expected one of {ASSIGN_METHODS}")


def _assign_greedy(cost_sd: np.ndarray, capacity: np.ndarray) -> np.ndarray:
    n_servers, n_devices = cost_sd.shape
    finite = np.where(np.isfinite(cost_sd), cost_sd, np.inf)
    if n_servers > 1:
        part = np.partition(finite, 1, axis=0)
        regret = part[1] - part[0]                   # (D,)
        regret = np.where(np.isfinite(regret), regret, np.inf)
    else:
        regret = np.zeros(n_devices)
    remaining = capacity.copy()
    assign = np.full(n_devices, -1, np.int64)
    # stable argsort on -regret: ties resolve by device index, deterministic
    for d in np.argsort(-regret, kind="stable"):
        for s in np.argsort(finite[:, d], kind="stable"):
            if remaining[s] > 0 and np.isfinite(finite[s, d]):
                assign[d] = s
                remaining[s] -= 1
                break
        if assign[d] < 0:
            raise ValueError(f"device {d} has no feasible server with "
                             "remaining capacity")
    return assign


def _assign_optimal(cost_sd: np.ndarray, capacity: np.ndarray) -> np.ndarray:
    """Successive shortest augmenting paths (Bellman-Ford over the server
    nodes; path length <= S-1 because the residual graph of a partial
    optimum has no negative cycles)."""
    n_servers, n_devices = cost_sd.shape
    remaining = capacity.copy()
    assign = np.full(n_devices, -1, np.int64)
    members: list = [[] for _ in range(n_servers)]
    for d in range(n_devices):
        dist = np.where(np.isfinite(cost_sd[:, d]), cost_sd[:, d], np.inf)
        pred: list = [None] * n_servers       # (prev_server, moved_device)
        for _ in range(n_servers - 1):
            changed = False
            for s in range(n_servers):
                if not np.isfinite(dist[s]) or not members[s]:
                    continue
                ds = np.asarray(members[s])
                # moving device d' from s to s2 costs c[s2,d'] - c[s,d']
                delta = cost_sd[:, ds] - cost_sd[s, ds][None, :]  # (S, |ds|)
                j = np.nanargmin(np.where(np.isfinite(delta), delta, np.inf),
                                 axis=1)
                step = delta[np.arange(n_servers), j]
                nd = dist[s] + step
                upd = np.isfinite(nd) & (nd < dist - 1e-15)
                for s2 in np.nonzero(upd)[0]:
                    dist[s2] = nd[s2]
                    pred[s2] = (s, int(ds[j[s2]]))
                    changed = True
            if not changed:
                break
        open_servers = np.nonzero(remaining > 0)[0]
        if open_servers.size == 0 or not np.isfinite(
                dist[open_servers]).any():
            raise ValueError(f"device {d} has no feasible augmenting path")
        target = int(open_servers[np.argmin(dist[open_servers])])
        # walk the chain of reassignments back to the direct edge
        s = target
        while pred[s] is not None:
            prev_s, moved = pred[s]
            members[prev_s].remove(moved)
            members[s].append(moved)
            assign[moved] = s
            s = prev_s
        members[s].append(d)
        assign[d] = s
        remaining[target] -= 1
    return assign


def exhaustive_assignment(cost_sd: np.ndarray,
                          capacity: np.ndarray) -> np.ndarray:
    """Brute-force over all S^D capacity-feasible assignments — the oracle
    ``_assign_optimal`` is tested against. Lexicographically-first argmin,
    strictly for small fleets (<= ~8 devices)."""
    import itertools
    cost_sd = np.asarray(cost_sd, np.float64)
    n_servers, n_devices = cost_sd.shape
    if n_servers ** n_devices > 2_000_000:
        raise ValueError(f"{n_servers}^{n_devices} assignments is too many "
                         "to enumerate — use assign_devices")
    best_total, best = np.inf, None
    dev_idx = np.arange(n_devices)
    for combo in itertools.product(range(n_servers), repeat=n_devices):
        a = np.asarray(combo)
        counts = np.bincount(a, minlength=n_servers)
        if (counts > capacity).any():
            continue
        total = cost_sd[a, dev_idx].sum()
        if total < best_total - 1e-15:
            best_total, best = total, a
    if best is None:
        raise ValueError("no capacity-feasible assignment exists")
    return best


class HierarchicalDecision(NamedTuple):
    """The hierarchical_card result, as host numpy arrays.

    ``assignment`` — (D,) int server index per device; ``cuts``/``freqs``/
    ``costs``/``delays``/``energies``/``d_server`` — (R, D) per-device
    decisions under the assigned server (seconds / joules / Hz, as in
    BatchedDecision; ``d_server`` is the server-compute share of
    ``delays``); ``aggregation_s`` — (S, R) per-server backhaul aggregation
    delay; ``server_load`` — (S,) devices per server.
    """
    assignment: np.ndarray
    cuts: np.ndarray
    freqs: np.ndarray
    costs: np.ndarray
    delays: np.ndarray
    energies: np.ndarray
    d_server: np.ndarray
    aggregation_s: np.ndarray
    server_load: np.ndarray


def _grid_to_host(grid: TierDecision) -> Dict[str, np.ndarray]:
    """The whole (S, R, D) grid in one device->host copy: the six fields
    stacked as float32 (the int32 cuts are exact in float32)."""
    stacked = torch.stack([getattr(grid, f).float()
                           for f in TierDecision._fields]).cpu().numpy()
    host = dict(zip(TierDecision._fields, stacked))
    host["cuts"] = host["cuts"].astype(np.int32)
    return host


def _gather_assigned(host: Dict[str, np.ndarray], assign: np.ndarray
                     ) -> Dict[str, np.ndarray]:
    """Select each device's (R,) lane from its assigned server's grid."""
    n_devices = assign.shape[0]
    dev_idx = np.arange(n_devices)
    return {field: host[field][assign, :, dev_idx].T
            for field in TierDecision._fields}


def _hierarchical_readout(tctx: TieredRoundContext, host, a: np.ndarray
                          ) -> HierarchicalDecision:
    """Stage 3: each device's decisions under its assigned server, and the
    per-server backhaul aggregation delay."""
    picked = _gather_assigned(host, a)
    assign_mask = a[None, :] == np.arange(tctx.n_servers)[:, None]
    agg = tctx.aggregation_delay(assign_mask, picked["cuts"]).cpu().numpy()
    return HierarchicalDecision(
        assignment=a.astype(np.int64),
        cuts=picked["cuts"].astype(np.int32),
        freqs=picked["freqs"], costs=picked["costs"],
        delays=picked["delays"], energies=picked["energies"],
        d_server=picked["d_server"],
        aggregation_s=agg,
        server_load=assign_mask.sum(axis=1).astype(np.int64))


def hierarchical_card(tctx: TieredRoundContext, *,
                      respect_memory: bool = True,
                      assign: str = "greedy") -> HierarchicalDecision:
    """Two-stage hierarchical CARD (fleet-of-fleets):

    1. price every (server, device) pair at the device's optimal CARD cost
       under that server (one (S, R, D, C) grid on the context's device,
       mean over rounds in float64 on the host),
    2. assign devices to servers under the tier's capacity
       (:func:`assign_devices`, ``assign="greedy" | "optimal"``),
    3. read each device's per-round (cut, f) decision off its assigned
       server's grid and price the per-server backhaul aggregation.

    Decision-equivalent to exhaustive assignment enumeration for
    ``assign="optimal"`` (tested on fleets <= 8 devices x 2 servers).
    """
    host = _grid_to_host(tiered_card_grid(tctx,
                                          respect_memory=respect_memory))
    cost_sd = host["costs"].astype(np.float64).mean(axis=1)
    a = assign_devices(cost_sd, np.asarray(tctx.capacity), method=assign)
    return _hierarchical_readout(tctx, host, a)


def hierarchical_card_exhaustive(tctx: TieredRoundContext, *,
                                 respect_memory: bool = True
                                 ) -> HierarchicalDecision:
    """The test oracle: exhaustive assignment enumeration over the same
    price matrix, then the identical per-server decision readout."""
    host = _grid_to_host(tiered_card_grid(tctx,
                                          respect_memory=respect_memory))
    cost_sd = host["costs"].astype(np.float64).mean(axis=1)
    a = exhaustive_assignment(cost_sd, np.asarray(tctx.capacity))
    return _hierarchical_readout(tctx, host, a)


def hierarchical_card_scalar(workload, devices, tier, channels, sim, *,
                             respect_memory: bool = True,
                             assign: str = "optimal") -> HierarchicalDecision:
    """Float64 scalar reference oracle for :func:`hierarchical_card`: the
    per-(server, device, round) grids come from the scalar ``card`` loop
    (``RoundContext`` per cell), the assignment from the same matcher.

    ``channels`` is a ``ChannelBatch`` — both paths must consume identical
    link realizations, exactly like the flat engines.
    """
    n_servers = tier.n_servers
    rounds, n_devices = channels.rate_up.shape
    cost_sRD = np.zeros((n_servers, rounds, n_devices))
    cuts = np.zeros((n_servers, rounds, n_devices), np.int32)
    freqs = np.zeros((n_servers, rounds, n_devices))
    delays = np.zeros((n_servers, rounds, n_devices))
    energies = np.zeros((n_servers, rounds, n_devices))
    d_srv = np.zeros((n_servers, rounds, n_devices))
    for s, server in enumerate(tier.servers):
        for m, dev in enumerate(devices):
            for r in range(rounds):
                ctx = RoundContext(workload=workload, device=dev,
                                   server=server,
                                   channel=channels.state(r, m), sim=sim)
                d = card(ctx, respect_memory=respect_memory)
                cost_sRD[s, r, m] = d.cost
                cuts[s, r, m] = d.cut
                freqs[s, r, m] = d.frequency
                delays[s, r, m] = d.delay
                energies[s, r, m] = d.energy
                d_srv[s, r, m] = ctx.delay_components(
                    d.cut, d.frequency).server_comp
    cost_sd = cost_sRD.mean(axis=1)
    a = assign_devices(cost_sd, np.asarray(tier.capacity), method=assign)
    dev_idx = np.arange(n_devices)
    pick = lambda x: x[a, :, dev_idx].T                       # noqa: E731
    picked_cuts = pick(cuts)
    assign_mask = a[None, :] == np.arange(n_servers)[:, None]
    adapter_bits = np.array([8 * workload.adapter_bytes(c, sim.adapter_bytes)
                             for c in range(workload.cfg.n_layers + 1)])
    bits = adapter_bits[picked_cuts]                          # (R, D)
    backhaul = np.asarray(tier.backhaul_bits_per_s)
    agg = (np.where(assign_mask[:, None, :], bits[None], 0.0).sum(axis=-1)
           / backhaul[:, None])
    return HierarchicalDecision(
        assignment=a.astype(np.int64), cuts=picked_cuts,
        freqs=pick(freqs), costs=pick(cost_sRD), delays=pick(delays),
        energies=pick(energies), d_server=pick(d_srv), aggregation_s=agg,
        server_load=assign_mask.sum(axis=1).astype(np.int64))
