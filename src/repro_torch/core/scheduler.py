"""Decision-level fleet simulator (no model execution) — used for the
paper's figures, which need many rounds x devices x policies cheaply.

``simulate_fleet`` reproduces the experiment grid of Sec. V: per round, per
device, draw a channel state, run the policy, log (cut, f, delay, energy).
The numbers feed Fig. 3 / Fig. 4 style benchmarks and the validation
against the paper's 70.8% / 53.1% claims.

Two engines share one cost model:

  engine="vectorized" (default) — all channel states drawn up front
      ((rounds, devices) batch), then the whole (rounds, devices, cuts)
      decision grid runs as float32 tensor programs on the card via
      ``card.batched_card``, and the decisions come back to the host in one
      copy. This is the path that scales to thousand-device heterogeneous
      fleets; with ``mesh=`` (``launch.mesh.FleetMesh``) the devices axis is
      cut into chunks that run one after another (or on several cards),
      bit-identical to the unchunked run — the 10^6-device path.
  engine="scalar" — the original per-(round, device) Python loop in
      float64, kept as the reference oracle; both engines consume identical
      channel realizations, so their logs agree decision-for-decision.

A port of the reference's ``core/scheduler.py``; the scalar engine, the
fault overlay and the reductions are its host numpy, verbatim, so the
scalar engine's log equals the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import card as card_lib
from repro_torch.core.channel import (SEED_STRIDE, WirelessChannel,
                                      draw_channel_matrix)
from repro_torch.core.cost_model import (BatchedRoundContext, RoundContext,
                                         TieredRoundContext, Workload)
from repro_torch.core.faults import (DeadlinePolicy, FaultModel,
                                     FaultRealization)
from repro_torch.core.hardware import (DEFAULT_SIM, EDGE_FLEET,
                                       SERVER_RTX4060TI, DeviceProfile,
                                       SimParams)
from repro_torch.models.common import resolve_device

POLICIES = ("card", "server_only", "device_only", "static", "random")
ENGINES = ("vectorized", "scalar")
LOG_FIELDS = ("cuts", "freqs", "delays", "energies",
              "d_device", "d_uplink", "d_server", "d_downlink")
# every chunk of the devices axis is padded to a multiple of this many
# lanes. On the CPU, torch evaluates ``pow`` (Eq. 16's cube root) in SIMD
# blocks of up to 32 float32 lanes and the last partial block by the scalar
# libm call, which may round one ulp apart; with whole blocks no real lane
# falls in a partial one, so (single-threaded) a lane's value does not
# depend on where the fleet was cut. A CUDA kernel computes every lane the
# same way, padded or not.
LANE_BLOCK = 64


def _masked_mean(a: np.ndarray) -> float:
    """Mean over non-NaN entries; NaN for an all-NaN (or empty) array.

    Dropped devices are logged as NaN — a plain ``.mean()`` would silently
    poison every Fig. 3/4 aggregate the moment one device misses a round.
    """
    a = np.asarray(a, np.float64)
    mask = ~np.isnan(a)
    if not mask.any():
        return float("nan")
    return float(a[mask].mean())


def _masked_rowmax(a: np.ndarray) -> np.ndarray:
    """Per-round max over non-NaN entries; NaN rows where nothing survived
    (avoids numpy's all-NaN-slice RuntimeWarning from ``nanmax``)."""
    filled = np.where(np.isnan(a), -np.inf, a)
    out = filled.max(axis=1)
    return np.where(np.isinf(out), np.nan, out)


@dataclasses.dataclass
class FleetLog:
    """Per-(round, device) output of ``simulate_fleet``: all arrays are
    (rounds, devices) host numpy — ``freqs`` in Hz, ``delays`` (and the
    d_* component breakdown) in seconds, ``energies`` in joules; under
    churn, non-survivor lanes are NaN with ``participation`` marking
    commits."""
    policy: str
    channel_state: str
    rounds: int
    device_names: List[str]
    cuts: np.ndarray        # (rounds, devices)
    freqs: np.ndarray       # (rounds, devices) Hz
    delays: np.ndarray      # (rounds, devices) s
    energies: np.ndarray    # (rounds, devices) J
    # per-component delay breakdown (device / uplink / server / downlink);
    # filled by both engines, enables exact parallel-SL round times
    d_device: Optional[np.ndarray] = None
    d_uplink: Optional[np.ndarray] = None
    d_server: Optional[np.ndarray] = None
    d_downlink: Optional[np.ndarray] = None
    # churn extension (apply_faults): True where the device's round result
    # was committed; non-survivor delay/energy entries are NaN
    participation: Optional[np.ndarray] = None   # bool (rounds, devices)
    round_close_s: Optional[np.ndarray] = None   # (rounds,) server close time
    fault_realization: Optional[FaultRealization] = None

    def mean_delay(self) -> float:
        return _masked_mean(self.delays)

    def mean_energy(self) -> float:
        return _masked_mean(self.energies)

    def survivor_fraction(self) -> float:
        """Fraction of (round, device) slots whose result was committed."""
        if self.participation is None:
            return 1.0
        return float(self.participation.mean())


def _simulate_fleet_scalar(cfg: ModelConfig, *, policy: str,
                           channel_state: str, rounds: int,
                           devices: Sequence[DeviceProfile],
                           server: DeviceProfile, sim: SimParams, seed: int,
                           static_cut: Optional[int], respect_memory: bool,
                           cost_source: str, latency_table,
                           deadline_spec) -> FleetLog:
    """Reference oracle: the original triple loop, one decision at a time."""
    rng = np.random.default_rng(seed)
    channels = [WirelessChannel(channel_state, seed=seed + SEED_STRIDE * m,
                                bandwidth_hz=sim.bandwidth_hz,
                                tx_power_dbm_up=sim.tx_power_dbm_up,
                                tx_power_dbm_down=sim.tx_power_dbm_down,
                                noise_dbm_per_hz=sim.noise_dbm_per_hz)
                for m in range(len(devices))]
    workload = Workload(cfg, sim.mini_batch, sim.seq_len)
    nd = len(devices)
    cuts = np.zeros((rounds, nd), np.int32)
    freqs = np.zeros((rounds, nd))
    delays = np.zeros((rounds, nd))
    energies = np.zeros((rounds, nd))
    parts = {k: np.zeros((rounds, nd))
             for k in ("d_device", "d_uplink", "d_server", "d_downlink")}
    for n in range(rounds):
        for m, dev in enumerate(devices):
            ctx = RoundContext(workload=workload, device=dev, server=server,
                               channel=channels[m].draw(), sim=sim,
                               cost_source=cost_source,
                               latency_table=latency_table)
            if policy == "card":
                d = card_lib.card(ctx, respect_memory=respect_memory,
                                  deadline=deadline_spec)
            elif policy == "server_only":
                d = card_lib.server_only(ctx)
            elif policy == "device_only":
                d = card_lib.device_only(ctx)
            elif policy == "static":
                assert static_cut is not None
                d = card_lib.static_cut(ctx, static_cut)
            elif policy == "random":
                d = card_lib.random_cut(ctx, rng)
            else:
                raise ValueError(f"unknown policy {policy!r}")
            cuts[n, m] = d.cut
            freqs[n, m] = d.frequency
            delays[n, m] = d.delay
            energies[n, m] = d.energy
            br = ctx.delay_components(d.cut, d.frequency)
            parts["d_device"][n, m] = br.device_comp
            parts["d_uplink"][n, m] = br.uplink
            parts["d_server"][n, m] = br.server_comp
            parts["d_downlink"][n, m] = br.downlink
    return FleetLog(policy=policy, channel_state=channel_state, rounds=rounds,
                    device_names=[d.name for d in devices], cuts=cuts,
                    freqs=freqs, delays=delays, energies=energies, **parts)


def fleet_context(cfg: ModelConfig, *, channel_state: str, rounds: int,
                  devices: Sequence[DeviceProfile], server: DeviceProfile,
                  sim: SimParams, seed: int, cost_source: str = "analytic",
                  latency_table=None, device=None) -> BatchedRoundContext:
    """The vectorized engines' input: every (round, device) channel state
    drawn on the host (the scalar engine's streams), and the batched
    context on ``device`` (``None``: the GPU, raising without one)."""
    batch = draw_channel_matrix(channel_state, rounds, len(devices),
                                seed=seed, bandwidth_hz=sim.bandwidth_hz,
                                tx_power_dbm_up=sim.tx_power_dbm_up,
                                tx_power_dbm_down=sim.tx_power_dbm_down,
                                noise_dbm_per_hz=sim.noise_dbm_per_hz)
    workload = Workload(cfg, sim.mini_batch, sim.seq_len)
    return BatchedRoundContext.build(workload, devices, server, batch, sim,
                                     cost_source=cost_source,
                                     latency_table=latency_table,
                                     device=device)


def _shard_pad(t: torch.Tensor, pad: int, value) -> torch.Tensor:
    """Pad the trailing (devices) axis with ``value`` lanes (contiguous).

    Pad lanes are real finite decision problems (rate 1 bit/s, 1 FLOP/s
    device) whose results are sliced off afterwards — padding with NaN/0
    would poison argmin/div inside the grid."""
    fill = torch.full(t.shape[:-1] + (pad,), value, dtype=t.dtype,
                      device=t.device)
    return torch.cat([t, fill], dim=-1)


def _chunk_context(bctx: BatchedRoundContext, lo: int, hi: int, width: int,
                   device: torch.device) -> BatchedRoundContext:
    """Lanes ``[lo, hi)`` of the fleet padded to ``width``, on ``device``."""
    pad = width - (hi - lo)
    ctx = dataclasses.replace(
        bctx,
        peak_flops=_shard_pad(bctx.peak_flops[lo:hi], pad, 1.0),
        max_cut=_shard_pad(bctx.max_cut[lo:hi], pad, 0),
        rate_up=_shard_pad(bctx.rate_up[:, lo:hi], pad, 1.0),
        rate_down=_shard_pad(bctx.rate_down[:, lo:hi], pad, 1.0))
    return dataclasses.replace(ctx, **{
        f.name: getattr(ctx, f.name).to(device)
        for f in dataclasses.fields(ctx)
        if isinstance(getattr(ctx, f.name), torch.Tensor)})


def _decide(ctx: BatchedRoundContext, policy: str, cut_draws,
            static_cut: Optional[int], respect_memory: bool,
            deadline_spec) -> card_lib.BatchedDecision:
    if policy == "card":
        return card_lib.batched_card(ctx, respect_memory=respect_memory,
                                     deadline=deadline_spec)
    if policy == "server_only":
        return card_lib.batched_server_only(ctx)
    if policy == "device_only":
        return card_lib.batched_device_only(ctx)
    if policy == "static":
        assert static_cut is not None
        return card_lib.batched_static_cut(ctx, static_cut)
    if policy == "random":
        return card_lib.batched_static_cut(ctx, cut_draws)
    raise ValueError(f"unknown policy {policy!r}")


def fleet_decisions(bctx: BatchedRoundContext, *, policy: str = "card",
                    seed: int = 0, static_cut: Optional[int] = None,
                    respect_memory: bool = True, deadline_spec=None,
                    mesh=None) -> Dict[str, np.ndarray]:
    """The vectorized engines' decisions over a built context, as host
    arrays (``LOG_FIELDS``, each (rounds, devices): cuts int32, the rest
    float64).

    Without ``mesh`` the whole fleet is one chunk on the context's device;
    with a ``launch.mesh.FleetMesh`` it is ``mesh.n_shards`` chunks, chunk
    ``i`` on ``mesh.devices[i]``. Each chunk's grid is stacked on its device
    and copied to the host once. Bit-identical for any chunking: every
    per-lane quantity — corners, Eq. 16 f*, the argmin over cuts — is
    computed from that device's own lane.
    """
    rounds, nd = bctx.shape
    if policy == "random":
        # same stream the scalar loop consumes for its per-decision draws
        rng = np.random.default_rng(seed)
        draws = torch.as_tensor(rng.integers(0, bctx.n_cuts,
                                             size=(rounds, nd)),
                                device=bctx.device)
    else:
        draws = torch.zeros((rounds, nd), dtype=torch.int64,
                            device=bctx.device)
    n_shards = 1 if mesh is None else mesh.n_shards
    devices = (bctx.device,) if mesh is None else mesh.devices
    width = -(-max(-(-nd // n_shards), 1) // LANE_BLOCK) * LANE_BLOCK
    stacked = []
    for i in range(n_shards):
        lo, hi = min(i * width, nd), min((i + 1) * width, nd)
        ctx = _chunk_context(bctx, lo, hi, width, devices[i])
        chunk_draws = _shard_pad(draws[:, lo:hi], width - (hi - lo),
                                 0).to(devices[i])
        dec = _decide(ctx, policy, chunk_draws, static_cut, respect_memory,
                      deadline_spec)
        stacked.append((lo, hi, torch.stack(
            [getattr(dec, f).float() for f in LOG_FIELDS])))
    out = {f: np.empty((rounds, nd), np.int32 if f == "cuts" else np.float64)
           for f in LOG_FIELDS}
    for lo, hi, chunk in stacked:       # all grids enqueued before a copy
        host = chunk.cpu().numpy()
        for k, f in enumerate(LOG_FIELDS):
            out[f][:, lo:hi] = host[k, :, :hi - lo]
    return out


def _simulate_fleet_vectorized(cfg: ModelConfig, *, policy: str,
                               channel_state: str, rounds: int,
                               devices: Sequence[DeviceProfile],
                               server: DeviceProfile, sim: SimParams,
                               seed: int, static_cut: Optional[int],
                               respect_memory: bool, cost_source: str,
                               latency_table, deadline_spec, device,
                               mesh=None) -> FleetLog:
    """All channel states up front, one grid evaluation per policy on the
    card, one device->host copy of the decisions (per chunk of ``mesh``)."""
    bctx = fleet_context(cfg, channel_state=channel_state, rounds=rounds,
                         devices=devices, server=server, sim=sim, seed=seed,
                         cost_source=cost_source,
                         latency_table=latency_table, device=device)
    host = fleet_decisions(bctx, policy=policy, seed=seed,
                           static_cut=static_cut,
                           respect_memory=respect_memory,
                           deadline_spec=deadline_spec, mesh=mesh)
    return FleetLog(policy=policy, channel_state=channel_state, rounds=rounds,
                    device_names=[d.name for d in devices], **host)


def _simulate_fleet_sharded(cfg: ModelConfig, *, mesh, **kwargs) -> FleetLog:
    """The vectorized engine with the *devices* axis cut into
    ``mesh.n_shards`` padded chunks (``launch.mesh.FleetMesh``), each run on
    its own card or one after another on one — the 10^6-device path, whose
    memory is one chunk's grid.

    Bit-identical to ``engine="vectorized"``: there is no cross-device
    reduction anywhere in ``batched_card``, so cutting the axis changes
    data placement, never values. Channel draws stay on the host (same
    ``draw_channel_matrix`` stream); pad lanes are trimmed off the result.
    """
    return _simulate_fleet_vectorized(cfg, mesh=mesh, **kwargs)


def apply_faults(log: FleetLog, realization: FaultRealization,
                 deadline: Optional[DeadlinePolicy] = None) -> FleetLog:
    """Overlay a fault realization on a decision log (both engines share
    this, so fault handling can never make them drift).

    Decisions stay as made — the server cannot know in advance who will
    straggle — but what the fleet *experiences* changes: straggler factors
    stretch the device-compute and radio delay components, outages add a
    retransmission stall, and dropped-out / departed devices never report.
    With a :class:`DeadlinePolicy`, the server closes each round at the
    ``quantile`` of that round's *predicted* (nominal decision) delays over
    its members; devices whose realized delay exceeds it are late and
    dropped from the round (partial aggregation). Non-survivor delay/energy
    entries become NaN — all ``FleetLog`` reductions are NaN-safe.
    """
    if realization.active.shape != log.delays.shape:
        raise ValueError(f"realization shape {realization.active.shape} != "
                         f"log shape {log.delays.shape}")
    started = realization.participating           # active & not dropped out
    # realized per-component delays (stall folded into the uplink term so
    # components still sum to the realized total)
    dev = log.d_device * realization.compute_slowdown
    up = (log.d_uplink * realization.link_slowdown
          + np.where(realization.outage, realization.outage_stall_s, 0.0))
    down = log.d_downlink * realization.link_slowdown
    # untouched entries keep the logged total verbatim (re-summing the
    # components reorders float rounding) — the zero-fault degenerate case
    # must be bit-identical to the fault-free log
    untouched = ((realization.compute_slowdown == 1.0)
                 & (realization.link_slowdown == 1.0) & ~realization.outage)
    realized = np.where(untouched, log.delays,
                        dev + up + log.d_server + down)

    n_rounds = log.delays.shape[0]
    deadline_s = np.full(n_rounds, np.inf)
    if deadline is not None:
        membered = realization.active.any(axis=1)
        pred = np.where(realization.active, log.delays, np.nan)
        if membered.any():
            deadline_s[membered] = np.nanquantile(
                pred[membered], deadline.quantile, axis=1)
        late = started & (realized > deadline_s[:, None])
    else:
        late = np.zeros_like(started)
    survivors = started & ~late

    # server close time: the deadline if any member failed to report in
    # time, else the last report; NaN when the round had no members at all
    last_report = _masked_rowmax(np.where(survivors, realized, np.nan))
    all_reported = (realization.active == survivors).all(axis=1)
    close_s = np.where(all_reported, last_report,
                       np.where(np.isinf(deadline_s), last_report,
                                deadline_s))

    def _mask(a):
        return np.where(survivors, a, np.nan)

    return dataclasses.replace(
        log, delays=_mask(realized), energies=_mask(log.energies),
        d_device=_mask(dev), d_uplink=_mask(up),
        d_server=_mask(log.d_server), d_downlink=_mask(down),
        participation=survivors, round_close_s=close_s,
        fault_realization=realization)


def simulate_fleet(cfg: ModelConfig, *, policy: str = "card",
                   channel_state: str = "normal", rounds: int = 50,
                   devices: Sequence[DeviceProfile] = EDGE_FLEET,
                   server: DeviceProfile = SERVER_RTX4060TI,
                   sim: SimParams = DEFAULT_SIM, seed: int = 0,
                   static_cut: Optional[int] = None,
                   respect_memory: bool = True,
                   engine: str = "vectorized",
                   cost_source: str = "analytic",
                   latency_table=None,
                   fault_model: Optional[FaultModel] = None,
                   deadline: Optional[DeadlinePolicy] = None,
                   mesh=None, device=None) -> FleetLog:
    """Run ``rounds`` of per-device CARD (or baseline) decisions.

    ``device=None`` is the GPU and raises without one, whatever the engine;
    tests pass ``device="cpu"``.

    ``cost_source="measured"`` routes per-cut compute delays through a
    kernel-calibrated ``measured_cost.LatencyTable`` instead of the paper's
    analytic FLOP counts; both engines honor it identically.

    ``fault_model`` overlays dropout/straggler/outage/membership churn on
    the log (see :func:`apply_faults`); ``fault_model=None`` is bit-exactly
    the fault-free simulation. ``deadline`` sets the round-closing
    policy and, when ``objective_deadline_s`` is set, routes a
    straggler-aware :class:`card.DeadlineSpec` into the CARD objective —
    both engines consume the identical spec.

    ``mesh`` (a ``launch.mesh.FleetMesh`` from ``make_fleet_mesh``) cuts
    the devices axis of the vectorized engine into chunks, each on the
    mesh's card for it — bit-identical to the unsharded vectorized engine,
    it scales the sweep to 10^6 devices.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; expected one of "
                         f"{POLICIES}")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if mesh is not None and engine != "vectorized":
        raise ValueError(f"mesh= requires engine='vectorized', "
                         f"got {engine!r}")
    dev = resolve_device(device)
    deadline_spec = None
    if deadline is not None and deadline.objective_deadline_s is not None:
        deadline_spec = card_lib.DeadlineSpec(
            deadline_s=float(deadline.objective_deadline_s),
            p_dropout=fault_model.dropout_prob if fault_model else 0.0,
            p_straggler=fault_model.straggler_prob if fault_model else 0.0,
            slowdown=fault_model.mean_slowdown if fault_model else 1.0,
            penalty=float(deadline.objective_penalty))
    kwargs = dict(policy=policy, channel_state=channel_state, rounds=rounds,
                  devices=devices, server=server, sim=sim, seed=seed,
                  static_cut=static_cut, respect_memory=respect_memory,
                  cost_source=cost_source, latency_table=latency_table,
                  deadline_spec=deadline_spec)
    if mesh is not None:
        log = _simulate_fleet_sharded(cfg, mesh=mesh, device=dev, **kwargs)
    elif engine == "vectorized":
        log = _simulate_fleet_vectorized(cfg, device=dev, **kwargs)
    else:
        log = _simulate_fleet_scalar(cfg, **kwargs)
    if fault_model is not None:
        realization = fault_model.realize(rounds, len(devices), seed=seed)
        log = apply_faults(log, realization, deadline)
    return log


def parallel_round_stats(log: FleetLog, server: DeviceProfile = SERVER_RTX4060TI,
                         sim: SimParams = DEFAULT_SIM) -> Dict[str, float]:
    """Beyond-paper extension (the paper's cited future work, cf. Wu et al.
    JSAC'23 parallel SL): all M devices train concurrently and the server
    splits its compute among them.

    The paper's protocol is sequential — round time = sum over devices. In
    the parallel variant each device's server-side share runs at 1/M of the
    server throughput (cubic power => same energy per unit work at fixed f),
    while device compute and the per-device radio links genuinely overlap:

      T_seq  = sum_m D_m
      T_par  = max_m (D_m^dev + D_m^up + M * D_m^srv + D_m^down)

    With the per-component breakdown in ``FleetLog`` this is exact (no
    pipelining credit); the legacy upper/lower bounds — which bracketed it
    when only the scalar total was logged — are kept for comparison.
    """
    # All reductions are masked: dropped (NaN) entries contribute nothing
    # to sums, maxes, or means — a churned fleet reports exact round times
    # over its survivors instead of NaN-poisoned aggregates.
    valid = ~np.isnan(log.delays)                         # (R, D)
    survivors = valid.sum(axis=1)                         # (R,)
    t_seq = _masked_mean(np.where(
        survivors > 0, np.where(valid, log.delays, 0.0).sum(axis=1), np.nan))
    # legacy bounds: server-side <= whole delay -> scale everything by M (ub);
    # perfect overlap of communication/device compute (lb)
    t_par_ub = _masked_mean(_masked_rowmax(log.delays * survivors[:, None]))
    t_par_lb = _masked_mean(_masked_rowmax(log.delays))
    out = {"sequential_s": t_seq, "parallel_upper_s": t_par_ub,
           "parallel_lower_s": t_par_lb,
           "speedup_lb": t_seq / t_par_ub if t_par_ub else float("nan"),
           "speedup_ub": t_seq / t_par_lb if t_par_lb else float("nan")}
    if log.d_server is not None:
        # the server splits its compute among that round's survivors only
        per_dev = (log.d_device + log.d_uplink
                   + survivors[:, None] * log.d_server + log.d_downlink)
        t_par = _masked_mean(_masked_rowmax(per_dev))
        out["parallel_exact_s"] = t_par
        out["speedup_exact"] = t_seq / t_par if t_par else float("nan")
    return out


def compare_policies(cfg: ModelConfig, *, rounds: int = 50,
                     channel_states: Sequence[str] = ("good", "normal", "poor"),
                     seed: int = 0, sim: SimParams = DEFAULT_SIM,
                     devices: Sequence[DeviceProfile] = EDGE_FLEET,
                     server: DeviceProfile = SERVER_RTX4060TI,
                     engine: str = "vectorized", device=None
                     ) -> Dict[str, Dict[str, FleetLog]]:
    """The Fig. 4 grid: policy x channel state."""
    out: Dict[str, Dict[str, FleetLog]] = {}
    for policy in ("card", "server_only", "device_only"):
        out[policy] = {}
        for state in channel_states:
            out[policy][state] = simulate_fleet(
                cfg, policy=policy, channel_state=state, rounds=rounds,
                seed=seed, sim=sim, devices=devices, server=server,
                engine=engine, device=device)
    return out


# ---------------------------------------------------------------------------
# Hierarchical (multi-server) fleet sweep
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HierarchicalLog:
    """``simulate_fleet`` summary for a server *tier* (hierarchical SL).

    ``decision`` is the full :class:`card.HierarchicalDecision` (assignment
    (D,), per-device (R, D) grids in s/J/Hz, per-server (S, R)
    ``aggregation_s``); the round-time fields fold the backhaul stage in:
    a round ends when the slowest server has finished its slowest device
    *and* pushed its aggregated adapters upstream.
    """
    channel_state: str
    rounds: int
    n_servers: int
    decision: "card_lib.HierarchicalDecision"
    round_s: np.ndarray          # (rounds,) max over servers incl. backhaul
    server_round_s: np.ndarray   # (S, rounds) per-server close time

    def mean_round_s(self) -> float:
        return float(self.round_s.mean())

    def mean_delay(self) -> float:
        return _masked_mean(self.decision.delays)

    def mean_energy(self) -> float:
        return _masked_mean(self.decision.energies)


def simulate_hierarchical_fleet(cfg: ModelConfig, *,
                                tier, rounds: int = 50,
                                devices: Sequence[DeviceProfile] = EDGE_FLEET,
                                channel_state: str = "normal",
                                sim: SimParams = DEFAULT_SIM, seed: int = 0,
                                assign: str = "greedy",
                                respect_memory: bool = True,
                                device=None) -> HierarchicalLog:
    """One hierarchical CARD sweep: draw the (rounds, devices) channel block
    (same stream as the flat engines), run :func:`card.hierarchical_card`
    against the :class:`hardware.ServerTier` on ``device`` (``None``: the
    GPU, raising without one), and fold per-server parallel round times
    with the backhaul aggregation stage."""
    batch = draw_channel_matrix(channel_state, rounds, len(devices),
                                seed=seed, bandwidth_hz=sim.bandwidth_hz,
                                tx_power_dbm_up=sim.tx_power_dbm_up,
                                tx_power_dbm_down=sim.tx_power_dbm_down,
                                noise_dbm_per_hz=sim.noise_dbm_per_hz)
    workload = Workload(cfg, sim.mini_batch, sim.seq_len)
    tctx = TieredRoundContext.build(workload, devices, tier, batch, sim,
                                    device=device)
    dec = card_lib.hierarchical_card(tctx, respect_memory=respect_memory,
                                     assign=assign)
    # per-server close: slowest assigned device — with the server's compute
    # split among its load (a device's decision prices one d_server share;
    # hosting L devices stretches that share L-fold, exactly the contention
    # rule parallel_round_stats applies to the flat engine) — then the
    # backhaul push
    assign_mask = dec.assignment[None, :] == np.arange(tier.n_servers)[:, None]
    load = np.maximum(dec.server_load, 1)[dec.assignment]       # (D,)
    contended = dec.delays + (load - 1)[None, :] * dec.d_server  # (R, D)
    per_srv = np.where(assign_mask[:, None, :], contended[None], np.nan)
    slowest = np.where(assign_mask.any(axis=1)[:, None],
                       _masked_rowmax(per_srv.reshape(-1, len(devices)))
                       .reshape(tier.n_servers, rounds), 0.0)
    server_round_s = slowest + dec.aggregation_s
    return HierarchicalLog(channel_state=channel_state, rounds=rounds,
                           n_servers=tier.n_servers, decision=dec,
                           round_s=server_round_s.max(axis=0),
                           server_round_s=server_round_s)
