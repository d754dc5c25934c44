"""Analytic delay/energy model — Sec. III of the paper, per architecture.

All quantities are derived from the ``ModelConfig`` so the cost model works
for every assigned architecture, not just the paper's LLaMA-1B:

  eta_D(c)   — FLOPs of the device-side stage at cut layer c (Eq. 7 numerator)
  eta        — FLOPs of the whole fine-tuning step (Eq. 8)
  S(c), S~(c) — smashed data / gradient bytes (Eq. 9); identical across cuts
                for uniform layer stacks (the paper's Fig. 3 observation)
  A(c)       — device-side LoRA adapter bytes (Eq. 9)
  D_{m,n}    — Eq. 10;  E_{m,n} — Eq. 11;  U — Eq. 12.

FLOPs accounting: LoRA fine-tuning needs forward + backward-through-frozen
weights (dX GEMMs) + adapter-gradient GEMMs, i.e. ~2x forward FLOPs + the
(negligible) adapter terms; we count them exactly below. MoE layers count
*active* FLOPs (top-k + shared experts) — this breaks the paper's
"every layer costs the same" symmetry only across families, not within a
uniform stack, so Fig. 3's bimodal-cut finding is preserved per-arch.

A port of the reference's ``core/cost_model.py``: the scalar model in Python
floats (float64) as there, and ``BatchedRoundContext`` as float32 tensors on
an explicit device (the reference's jnp precision). ``TieredRoundContext``
(the hierarchical tier) is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.channel import ChannelBatch, ChannelState
from repro_torch.core.hardware import DeviceProfile, SimParams, fleet_arrays
from repro_torch.models.common import resolve_device


# ---------------------------------------------------------------------------
# FLOPs per component (forward, per token)
# ---------------------------------------------------------------------------


def attn_fwd_flops_per_token(cfg: ModelConfig, seq_len: int) -> float:
    """Forward FLOPs per token of one attention block (QKV/out projections
    plus causal scores at ``seq_len``); 0.0 for attention-free archs."""
    if cfg.is_attention_free:
        return 0.0
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    proj = 2 * d * (q + 2 * kv) + 2 * q * d
    # causal scores + weighted sum: 2 * 2 * (S/2) * q_dim
    scores = 2 * seq_len * q  # (2 matmuls x S x q_dim x ... / 2 causal)
    return proj + scores


def mlp_fwd_flops_per_token(cfg: ModelConfig) -> float:
    """Forward FLOPs per token of one MLP block — gated 3-matmul for dense,
    routed top-k + shared experts + router for MoE, 0.0 for pure SSM."""
    d = cfg.d_model
    if cfg.is_moe:
        routed = 2 * 3 * d * cfg.d_ff * cfg.top_k
        shared = 2 * 3 * d * cfg.d_ff * cfg.n_shared_experts
        router = 2 * d * cfg.n_experts
        return routed + shared + router
    if cfg.family == "ssm":
        return 0.0
    return 2 * 3 * d * cfg.d_ff


def ssm_fwd_flops_per_token(cfg: ModelConfig) -> float:
    """Forward FLOPs per token of one SSM (Mamba-2) block: in/out
    projections, short conv, and the SSD chunked scan; 0.0 without SSM."""
    if not cfg.has_ssm:
        return 0.0
    d, di, ns = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    proj = 2 * d * (2 * di + 2 * ns + cfg.ssm_n_heads) + 2 * di * d
    conv = 2 * cfg.ssm_conv_width * (di + 2 * ns)
    # SSD: intra-chunk quadratic (~2*chunk*di) + state update (~4*di*ns)
    ssd = 2 * cfg.ssm_chunk * di + 4 * di * ns
    return proj + conv + ssd


def lora_fwd_flops_per_token(cfg: ModelConfig) -> float:
    return 2 * cfg.lora_params_per_layer()


def layer_fwd_flops_per_token(cfg: ModelConfig, seq_len: int) -> float:
    return (attn_fwd_flops_per_token(cfg, seq_len)
            + mlp_fwd_flops_per_token(cfg)
            + ssm_fwd_flops_per_token(cfg)
            + lora_fwd_flops_per_token(cfg))


def embed_fwd_flops_per_token(cfg: ModelConfig) -> float:
    return 2 * cfg.d_model  # lookup + scale; head counted server-side


def head_fwd_flops_per_token(cfg: ModelConfig) -> float:
    return 2 * cfg.d_model * cfg.vocab_size


# LoRA training ~= 2x forward (dX GEMMs through frozen weights) + adapter
# gradient GEMMs (~= forward cost of the adapters themselves).
LORA_TRAIN_FACTOR = 2.0

# Fraction of device RAM the frozen backbone may occupy (the rest is
# activations/runtime). Shared by the scalar and batched feasibility masks.
MEM_BUDGET_FRACTION = 0.8


@dataclass(frozen=True)
class Workload:
    """One mini-batch fine-tuning step of (batch x seq) tokens."""
    cfg: ModelConfig
    batch: int
    seq_len: int

    @property
    def tokens(self) -> int:
        return self.batch * self.seq_len

    # ---- eta(c): Eq. 7/8 numerators ---------------------------------------
    def device_flops(self, cut: int) -> float:
        """eta_D(c): embedding + layers [0, cut), fwd+bwd, LoRA-frozen."""
        per_tok = (embed_fwd_flops_per_token(self.cfg)
                   + cut * layer_fwd_flops_per_token(self.cfg, self.seq_len))
        return LORA_TRAIN_FACTOR * per_tok * self.tokens

    def total_flops(self) -> float:
        """eta: the whole model (device + server sides), fwd+bwd."""
        cfg = self.cfg
        per_tok = (embed_fwd_flops_per_token(cfg)
                   + cfg.n_layers * layer_fwd_flops_per_token(cfg, self.seq_len)
                   + head_fwd_flops_per_token(cfg))
        return LORA_TRAIN_FACTOR * per_tok * self.tokens

    def server_flops(self, cut: int) -> float:
        return self.total_flops() - self.device_flops(cut)

    # ---- data sizes: Eq. 9 -------------------------------------------------
    def smashed_bytes(self, cut: int, act_bytes: int) -> float:
        """S(c): activations at the cut + labels. Constant across cuts for a
        uniform stack (matches the paper's observation)."""
        acts = self.tokens * self.cfg.d_model * act_bytes
        labels = self.tokens * 4
        return acts + labels

    def gradient_bytes(self, cut: int, act_bytes: int) -> float:
        """S~(c): gradient of the smashed data."""
        return self.tokens * self.cfg.d_model * act_bytes

    def adapter_bytes(self, cut: int, adapter_bytes: int) -> float:
        """A(c): device-side LoRA adapters for layers [0, cut)."""
        return cut * self.cfg.lora_params_per_layer() * adapter_bytes

    def device_weight_bytes(self, cut: int, weight_bytes: int = 2) -> float:
        """Frozen backbone bytes resident on the device at cut c (for the
        memory-feasibility mask; one-time download excluded from Eq. 9)."""
        per_layer = self.cfg.params_per_layer() * weight_bytes
        embed = self.cfg.vocab_size * self.cfg.d_model * weight_bytes
        return embed + cut * per_layer


# ---------------------------------------------------------------------------
# Pluggable per-layer compute interface
# ---------------------------------------------------------------------------
#
# Every per-cut compute quantity CARD consumes is routed through a
# ``ComputeSource``: three methods returning *effective FLOPs at peak*
# (device side, server side, total).  The analytic FLOPs/frequency path is
# one implementation; ``measured_cost.TableCompute`` — effective FLOPs
# back-converted from a calibrated per-layer latency table — is the other.
# Delay algebra, Eq. 16's closed form, and both CARD engines are agnostic
# to which one is plugged in.


@dataclass(frozen=True)
class AnalyticCompute:
    """The paper's analytic FLOP counts (Sec. III), as a ComputeSource."""
    workload: Workload

    def device_flops(self, cut: int) -> float:
        return self.workload.device_flops(cut)

    def server_flops(self, cut: int) -> float:
        return self.workload.server_flops(cut)

    def total_flops(self) -> float:
        return self.workload.total_flops()


COST_SOURCES = ("analytic", "measured")


def resolve_compute(workload: Workload, cost_source: str = "analytic",
                    latency_table=None):
    """Pick the ComputeSource for ``cost_source``.

    ``"analytic"`` — FLOP counts from the ``Workload`` (paper constants).
    ``"measured"`` — effective FLOPs from a ``measured_cost.LatencyTable``
    calibrated against kernel timings (must be passed as ``latency_table``).
    """
    if cost_source == "analytic":
        return AnalyticCompute(workload)
    if cost_source == "measured":
        if latency_table is None:
            raise ValueError("cost_source='measured' requires a latency_table"
                             " (see repro_torch.core.measured_cost.LatencyTable)")
        from repro_torch.core.measured_cost import TableCompute
        return TableCompute(workload=workload, table=latency_table)
    raise ValueError(f"unknown cost_source {cost_source!r}; "
                     f"expected one of {COST_SOURCES}")


# ---------------------------------------------------------------------------
# Delay & energy (Eqs. 7-11)
# ---------------------------------------------------------------------------


class DelayBreakdown(NamedTuple):
    """Per-component round delay: Eq. 10 split into its four terms.

    Needed for exact parallel-SL round times (Wu et al. JSAC'23 extension):
    in parallel SL only the server-compute term contends across devices, so
    the breakdown — not the scalar total — is what the scheduler must know.
    """
    device_comp: float   # t * device-side compute (Eq. 7 term)
    uplink: float        # smashed data up + adapter upload (Eq. 9)
    server_comp: float   # t * server-side compute (Eq. 8 term)
    downlink: float      # gradients down + adapter download (Eq. 9)

    @property
    def total(self):
        return self.device_comp + self.uplink + self.server_comp + self.downlink


@dataclass(frozen=True)
class RoundContext:
    """Everything CARD needs for one (device, round) decision.

    ``cost_source`` selects the per-layer compute backend: ``"analytic"``
    (paper FLOP counts, the default) or ``"measured"`` (a kernel-calibrated
    ``measured_cost.LatencyTable`` passed as ``latency_table``).
    """
    workload: Workload
    device: DeviceProfile
    server: DeviceProfile
    channel: ChannelState
    sim: SimParams
    cost_source: str = "analytic"
    latency_table: Optional[object] = None

    @cached_property
    def compute(self):
        return resolve_compute(self.workload, self.cost_source,
                               self.latency_table)

    # -- Eq. 7: device computation delay per local epoch
    def device_comp_delay(self, cut: int) -> float:
        return self.compute.device_flops(cut) / self.device.peak_flops

    # -- Eq. 8: server computation delay per local epoch at frequency f
    def server_comp_delay(self, cut: int, f: float) -> float:
        return self.compute.server_flops(cut) / self.server.throughput(f)

    # -- Eqs. 9-10 split by component; the single source of the delay algebra
    def delay_components(self, cut: int, f: float) -> DelayBreakdown:
        w, sim, ch = self.workload, self.sim, self.channel
        t = sim.local_epochs
        adapters = 8 * w.adapter_bytes(cut, sim.adapter_bytes)
        up = (t * 8 * sim.phi * w.smashed_bytes(cut, sim.act_bytes)
              + adapters) / ch.rate_up
        down = (t * 8 * sim.phi * w.gradient_bytes(cut, sim.act_bytes)
                + adapters) / ch.rate_down
        return DelayBreakdown(device_comp=t * self.device_comp_delay(cut),
                              uplink=up,
                              server_comp=t * self.server_comp_delay(cut, f),
                              downlink=down)

    # -- Eq. 9: total transmission delay for a round (bits / (bit/s))
    def transmission_delay(self, cut: int) -> float:
        parts = self.delay_components(cut, self.server.f_max)
        return parts.uplink + parts.downlink

    # -- Eq. 10: total round delay
    def round_delay(self, cut: int, f: float) -> float:
        return self.delay_components(cut, f).total

    # -- Eq. 11: server computational energy for the round
    def server_energy(self, cut: int, f: float) -> float:
        t = self.sim.local_epochs
        return (t * self.sim.xi * f ** 2 * self.compute.server_flops(cut)
                / (self.server.delta * self.server.sigma))

    # -- feasibility: frozen device-side weights must fit device RAM
    def max_feasible_cut(self) -> int:
        cfg = self.workload.cfg
        budget = MEM_BUDGET_FRACTION * self.device.mem_bytes
        for c in range(cfg.n_layers, -1, -1):
            if self.workload.device_weight_bytes(c) <= budget:
                return c
        return 0

    # -- normalization corners (Sec. III-C):
    #    D_max, E_min at (c=I, f=F_min);  D_min, E_max at (c=0, f=F_max)
    def corners(self) -> Tuple[float, float, float, float]:
        cfg = self.workload.cfg
        f_min = self.f_min()
        f_max = self.server.f_max
        d_max = self.round_delay(cfg.n_layers, f_min)
        e_min = self.server_energy(cfg.n_layers, f_min)   # = 0
        d_min = self.round_delay(0, f_max)
        e_max = self.server_energy(0, f_max)
        return d_min, d_max, e_min, e_max

    def f_min(self) -> float:
        """F_min^{m,S} = f_m delta_m sigma_m / (delta_S sigma_S): the server
        must be at least as fast as the device (Sec. III-C)."""
        lower = (self.device.peak_flops
                 / (self.server.delta * self.server.sigma))
        return max(lower, self.server.f_min)

    # -- Eq. 12: scalarized cost
    def cost(self, cut: int, f: float,
             corners: Optional[Tuple[float, float, float, float]] = None
             ) -> float:
        if corners is None:
            corners = self.corners()
        d_min, d_max, e_min, e_max = corners
        w = self.sim.w
        d = self.round_delay(cut, f)
        e = self.server_energy(cut, f)
        dn = (d - d_min) / max(d_max - d_min, 1e-12)
        en = (e - e_min) / max(e_max - e_min, 1e-12)
        return w * dn + (1 - w) * en


# ---------------------------------------------------------------------------
# Batched fleet context — array-in/array-out Eqs. 7-12
# ---------------------------------------------------------------------------


def _per_cut_tables(workload: Workload, sim: SimParams, compute) -> dict:
    """Float64 per-cut tables shared by the batched (and, later, tiered)
    contexts.

    One accounting for both: ``dev_flops``/``srv_flops`` (effective FLOPs,
    Eqs. 7-8), ``up_bits``/``down_bits`` (per-local-epoch phi-compressed
    smashed/gradient bits, Eq. 9), ``adapter_bits`` (once-per-round adapter
    exchange bits), ``weight_bytes`` (frozen device-side backbone bytes for
    the memory-feasibility mask). Every array has shape ``(C,)`` with
    ``C = n_layers + 1`` candidate cuts.
    """
    cuts = range(workload.cfg.n_layers + 1)
    return {
        "dev_flops": np.array([compute.device_flops(c) for c in cuts]),
        "srv_flops": np.array([compute.server_flops(c) for c in cuts]),
        "up_bits": np.array([8 * sim.phi * workload.smashed_bytes(
            c, sim.act_bytes) for c in cuts]),
        "down_bits": np.array([8 * sim.phi * workload.gradient_bytes(
            c, sim.act_bytes) for c in cuts]),
        "adapter_bits": np.array([8 * workload.adapter_bytes(
            c, sim.adapter_bytes) for c in cuts]),
        "weight_bytes": np.array([workload.device_weight_bytes(c)
                                  for c in cuts]),
    }


def _max_cut_per_device(weight_bytes: np.ndarray,
                        mem_bytes: np.ndarray) -> np.ndarray:
    """Largest feasible cut per device: the frozen device-side weights at
    cut c must fit ``MEM_BUDGET_FRACTION`` of device RAM. ``weight_bytes``
    is the per-cut ``(C,)`` table, ``mem_bytes`` the ``(D,)`` fleet array;
    returns int ``(D,)`` (0 when not even the embedding fits)."""
    feas = (weight_bytes[None, :]
            <= MEM_BUDGET_FRACTION * mem_bytes[:, None])       # (D, C)
    return np.where(feas.any(axis=1),
                    feas.shape[1] - 1 - np.argmax(feas[:, ::-1], axis=1),
                    0)


@dataclass(frozen=True)
class BatchedRoundContext:
    """``RoundContext`` for a whole fleet sweep at once.

    Per-cut tables are precomputed in float64 from the scalar ComputeSource
    — analytic ``Workload`` FLOPs or a measured ``LatencyTable``, selected
    by ``build(..., cost_source=...)`` exactly as in ``RoundContext`` (so
    scalar and batched paths share one accounting), then cast to float32
    tensors on the context's device (the reference's jnp precision, so that
    batched decisions can be held to the JAX ones), and the
    delay/energy/cost algebra runs as tensor broadcasting over a ``(rounds,
    devices, cuts)`` tensor. The bimodal cost structure (Fig. 3) keeps the
    argmin far from float32 eps in practice, but a pathologically
    near-tied fleet could pick the other endpoint than the float64 scalar
    oracle. Shape conventions:

      tables       (C,)    — C = n_layers + 1 candidate cuts
      per-device   (D,)
      channel      (R, D)  — one link realization per (round, device)

    ``cuts`` arguments index the tables and may be any shape broadcastable
    against trailing layout ``(R, D, C')`` (typically ``(C,)`` for the full
    grid, or ``(R, D, 1)`` for per-decision evaluation); ``f`` is a scalar
    or an ``(R, D)`` per-decision frequency in Hz.
    """
    # per-cut tables (C,)
    dev_flops: torch.Tensor      # eta_D(c), fwd+bwd FLOPs
    srv_flops: torch.Tensor      # eta - eta_D(c)
    up_bits: torch.Tensor        # per-local-epoch phi-compressed smashed bits
    down_bits: torch.Tensor      # per-local-epoch phi-compressed gradient bits
    adapter_bits: torch.Tensor   # once-per-round adapter exchange bits
    # per-device (D,)
    peak_flops: torch.Tensor
    max_cut: torch.Tensor        # memory-feasibility cap, int32
    # per-(round, device) (R, D)
    rate_up: torch.Tensor
    rate_down: torch.Tensor
    # Eq. 12 weights as 0-d tensors (data, like the reference's traced w)
    w: torch.Tensor
    xi: torch.Tensor
    # static hyperparameters
    local_epochs: int
    server_tp_per_hz: float      # delta_S * sigma_S
    server_f_max: float
    server_f_min: float

    @classmethod
    def build(cls, workload: Workload, devices: Sequence[DeviceProfile],
              server: DeviceProfile, channels: ChannelBatch,
              sim: SimParams, *, cost_source: str = "analytic",
              latency_table=None, device=None) -> "BatchedRoundContext":
        """Tables and fleet arrays as float32 tensors on ``device``
        (``None``: the GPU, raising without one)."""
        dev = resolve_device(device)
        compute = resolve_compute(workload, cost_source, latency_table)
        tables = _per_cut_tables(workload, sim, compute)
        arrs = fleet_arrays(devices)
        # memory feasibility: largest c whose frozen weights fit the budget
        max_cut = _max_cut_per_device(tables["weight_bytes"],
                                      arrs["mem_bytes"])

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float64),
                                   dtype=torch.float32, device=dev)

        return cls(
            dev_flops=f32(tables["dev_flops"]),
            srv_flops=f32(tables["srv_flops"]),
            up_bits=f32(tables["up_bits"]),
            down_bits=f32(tables["down_bits"]),
            adapter_bits=f32(tables["adapter_bits"]),
            peak_flops=f32(arrs["peak_flops"]),
            max_cut=torch.as_tensor(max_cut, dtype=torch.int32, device=dev),
            rate_up=f32(channels.rate_up),
            rate_down=f32(channels.rate_down),
            w=f32(float(sim.w)), xi=f32(float(sim.xi)),
            local_epochs=int(sim.local_epochs),
            server_tp_per_hz=float(server.delta * server.sigma),
            server_f_max=float(server.f_max), server_f_min=float(server.f_min))

    # -- shapes --------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.dev_flops.device

    @property
    def n_cuts(self) -> int:
        return self.dev_flops.shape[0]

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.rate_up.shape)

    def _f_expand(self, f) -> torch.Tensor:
        f = self._as_f32(f)
        return f[..., None] if f.ndim == 2 else f

    def _as_f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _index(self, cuts) -> torch.Tensor:
        return torch.as_tensor(cuts, dtype=torch.long, device=self.device)

    # -- Sec. III-C feasible frequency floor, per device ---------------------
    def f_min(self) -> torch.Tensor:
        """(D,) Hz: the server must be at least as fast as the device."""
        return torch.clamp(self.peak_flops / self.server_tp_per_hz,
                           min=self.server_f_min)

    # -- Eqs. 7-10, per component -------------------------------------------
    def delay_components(self, cuts, f) -> DelayBreakdown:
        """Eq. 10's four terms in seconds, broadcast to ``(R, D, C')``."""
        cuts = self._index(cuts)
        f = self._f_expand(f)
        t = self.local_epochs
        dev = t * self.dev_flops[cuts] / self.peak_flops[:, None]
        srv = t * self.srv_flops[cuts] / (f * self.server_tp_per_hz)
        up = ((t * self.up_bits[cuts] + self.adapter_bits[cuts])
              / self.rate_up[..., None])
        down = ((t * self.down_bits[cuts] + self.adapter_bits[cuts])
                / self.rate_down[..., None])
        dev, up, srv, down = torch.broadcast_tensors(dev, up, srv, down)
        return DelayBreakdown(device_comp=dev, uplink=up,
                              server_comp=srv, downlink=down)

    def round_delay(self, cuts, f) -> torch.Tensor:
        """Eq. 10 total round delay in seconds."""
        return self.delay_components(cuts, f).total

    # -- Eq. 11 --------------------------------------------------------------
    def server_energy(self, cuts, f) -> torch.Tensor:
        """Eq. 11 server energy in joules."""
        cuts = self._index(cuts)
        f = self._f_expand(f)
        return (self.local_epochs * self.xi * f ** 2 * self.srv_flops[cuts]
                / self.server_tp_per_hz)

    # -- normalization corners (Sec. III-C), each (R, D) ---------------------
    def corners(self) -> Tuple[torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor]:
        """(D_min, D_max, E_min, E_max), each (R, D)."""
        last = [self.n_cuts - 1]
        first = [0]
        f_lo = torch.broadcast_to(self.f_min(), self.shape)
        f_hi = torch.full(self.shape, self.server_f_max, dtype=torch.float32,
                          device=self.device)
        d_max = self.round_delay(last, f_lo)[..., 0]
        e_min = self.server_energy(last, f_lo)[..., 0]
        d_min = self.round_delay(first, f_hi)[..., 0]
        e_max = self.server_energy(first, f_hi)[..., 0]
        return d_min, d_max, e_min, e_max

    # -- Eq. 12 --------------------------------------------------------------
    def cost(self, cuts, f, corners=None) -> torch.Tensor:
        """Eq. 12 scalarized cost, broadcast to ``(R, D, C')``."""
        if corners is None:
            corners = self.corners()
        d_min, d_max, e_min, e_max = corners
        d = self.round_delay(cuts, f)
        e = self.server_energy(cuts, f)
        dn = ((d - d_min[..., None])
              / torch.clamp(d_max - d_min, min=1e-12)[..., None])
        en = ((e - e_min[..., None])
              / torch.clamp(e_max - e_min, min=1e-12)[..., None])
        return self.w * dn + (1 - self.w) * en
