"""Hardware profiles: the paper's edge fleet (Table I), the server tier and
the simulation constants (Table II). A copy of the reference's
``core/hardware.py`` (numpy only, bit-identical) without its TPU server
profile, which only the TPU lowering/analysis layer uses.

The paper's throughput model: a processor sustains ``f * delta * sigma``
FLOP/s (GPU frequency x FLOPs/core/cycle x cores), Eq. (7)-(8). Server power
is cubic in frequency, ``P = xi * f^3`` (Sec. III-B).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Tuple

import numpy as np

GIGA = 1e9


@dataclass(frozen=True)
class DeviceProfile:
    """An edge device (or the server) in the paper's cost model."""
    name: str
    platform: str
    f_max: float          # max GPU frequency, Hz
    delta: float          # FLOPs per core per cycle
    sigma: int            # cores
    f_min: float = 0.0    # min frequency (server DVFS lower bound)
    xi: float = 1e-25     # power coefficient, Watt/(cycle/s)^3 (server only)
    mem_bytes: float = 8e9  # device RAM (feasibility mask for huge backbones)

    @property
    def peak_flops(self) -> float:
        return self.f_max * self.delta * self.sigma

    def throughput(self, f: float) -> float:
        return f * self.delta * self.sigma

    def power(self, f: float) -> float:
        return self.xi * f ** 3


# --- Table I ---------------------------------------------------------------

SERVER_RTX4060TI = DeviceProfile(
    name="server", platform="Nvidia RTX 4060Ti",
    f_max=2.46 * GIGA, delta=2.0, sigma=3072, f_min=0.3 * GIGA,
    xi=1e-25, mem_bytes=16e9)

EDGE_FLEET: Tuple[DeviceProfile, ...] = (
    DeviceProfile("device1", "Jetson AGX Orin", 1.3 * GIGA, 2.0, 2048,
                  mem_bytes=32e9),
    DeviceProfile("device2", "Jetson AGX Orin", 1.0 * GIGA, 2.0, 2048,
                  mem_bytes=32e9),
    DeviceProfile("device3", "Jetson AGX Orin", 0.7 * GIGA, 2.0, 1792,
                  mem_bytes=16e9),
    DeviceProfile("device4", "Jetson Orin NX", 0.7 * GIGA, 2.0, 1024,
                  mem_bytes=8e9),
    DeviceProfile("device5", "Jetson AGX Nano", 0.5 * GIGA, 2.0, 512,
                  mem_bytes=4e9),
)


def make_heterogeneous_fleet(n: int, *, seed: int = 0,
                             templates: Tuple[DeviceProfile, ...] = EDGE_FLEET
                             ) -> Tuple[DeviceProfile, ...]:
    """An ``n``-device fleet for scale sweeps: each device is one of the
    Table-I edge platforms with its GPU frequency jittered +-20% (DVFS bins,
    thermal throttling) — the "massive mobile devices" population the paper
    targets, heterogeneous in both platform and clock."""
    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, len(templates), size=n)
    scales = rng.uniform(0.8, 1.2, size=n)
    fleet = []
    for i in range(n):
        t = templates[int(kinds[i])]
        fleet.append(replace(t, name=f"device{i + 1}",
                             f_max=t.f_max * float(scales[i])))
    return tuple(fleet)


# --- Server tier (hierarchical multi-server SL, cf. SplitLLM) --------------


@dataclass(frozen=True)
class ServerTier:
    """A tier of edge servers behind one aggregator (hierarchical SL).

    The paper models a single edge server; SplitLLM (arXiv:2501.13318)
    formulates the tier: each device is assigned to one server, every
    server runs its own DVFS range (``DeviceProfile.f_min``/``f_max``),
    hosts at most ``capacity[s]`` devices per round, and forwards its
    aggregated LoRA adapters to the cloud aggregator over a backhaul link
    of ``backhaul_bits_per_s[s]`` (bit/s).

    ``hierarchical_card`` (``core/card.py``) decides device→server
    assignment against this structure; ``TieredRoundContext``
    (``core/cost_model.py``) broadcasts Eqs. 7-12 over the extra server
    axis.
    """
    servers: Tuple[DeviceProfile, ...]
    capacity: Tuple[int, ...]
    backhaul_bits_per_s: Tuple[float, ...]

    def __post_init__(self):
        if not self.servers:
            raise ValueError("a ServerTier needs at least one server")
        if len(self.capacity) != len(self.servers) \
                or len(self.backhaul_bits_per_s) != len(self.servers):
            raise ValueError(
                f"per-server fields must match len(servers)={len(self.servers)}"
                f": capacity={len(self.capacity)}, "
                f"backhaul={len(self.backhaul_bits_per_s)}")
        if any(c < 1 for c in self.capacity):
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if any(not (b > 0) for b in self.backhaul_bits_per_s):
            raise ValueError("backhaul_bits_per_s must be positive, got "
                             f"{self.backhaul_bits_per_s}")

    @property
    def n_servers(self) -> int:
        return len(self.servers)

    @property
    def total_capacity(self) -> int:
        return sum(self.capacity)


def make_server_tier(n: int, *, base: DeviceProfile = SERVER_RTX4060TI,
                     capacity: int = 1000,
                     backhaul_bits_per_s: float = 1e9,
                     seed: int = 0) -> ServerTier:
    """An ``n``-server tier for hierarchy sweeps: each server is the base
    profile with its clock jittered +-20% (heterogeneous provisioning) and
    its backhaul jittered +-50%, seeded like ``make_heterogeneous_fleet``."""
    rng = np.random.default_rng(seed)
    f_scales = rng.uniform(0.8, 1.2, size=n)
    b_scales = rng.uniform(0.5, 1.5, size=n)
    servers = tuple(replace(base, name=f"server{s + 1}",
                            f_max=base.f_max * float(f_scales[s]))
                    for s in range(n))
    return ServerTier(servers=servers, capacity=(capacity,) * n,
                      backhaul_bits_per_s=tuple(
                          backhaul_bits_per_s * float(b) for b in b_scales))


def tier_arrays(tier: ServerTier) -> Dict[str, "object"]:
    """Stack per-server scalars into numpy arrays for the tiered engine."""
    return {
        "tp_per_hz": np.array([s.delta * s.sigma for s in tier.servers],
                              np.float64),
        "f_max": np.array([s.f_max for s in tier.servers], np.float64),
        "f_min": np.array([s.f_min for s in tier.servers], np.float64),
        "capacity": np.array(tier.capacity, np.int64),
        "backhaul_bits_per_s": np.array(tier.backhaul_bits_per_s, np.float64),
    }


def profile_from_throughput(name: str, flops_per_s: float, *,
                            f_max: float = 1.0 * GIGA,
                            **kwargs) -> DeviceProfile:
    """Express a *measured* sustained throughput in the paper's
    ``f * delta * sigma`` algebra (one core, delta = FLOPs/cycle at
    ``f_max``), so a roofline-fitted host slots into CARD's closed form as
    a device or server profile unchanged."""
    if flops_per_s <= 0 or not np.isfinite(flops_per_s):
        raise ValueError(f"need a positive finite throughput, got "
                         f"{flops_per_s!r}")
    return DeviceProfile(name=name, platform="measured", f_max=f_max,
                         delta=flops_per_s / f_max, sigma=1, **kwargs)


def fleet_arrays(devices) -> Dict[str, "object"]:
    """Stack per-device scalars into numpy arrays for the batched engine."""
    return {
        "peak_flops": np.array([d.peak_flops for d in devices], np.float64),
        "mem_bytes": np.array([d.mem_bytes for d in devices], np.float64),
    }


# --- Table II ---------------------------------------------------------------

@dataclass(frozen=True)
class SimParams:
    """Simulation constants (paper Table II): Eq. 12 weights, compression
    ratios, payload precisions in bytes, and radio parameters (bandwidth
    in Hz, transmit powers in dBm)."""
    xi: float = 1e-25          # server power coefficient
    w: float = 0.2             # delay weight in Eq. (12)
    local_epochs: int = 5      # T_{m,n}
    phi: float = 0.1           # smashed-data/gradient compression ratio
    act_bytes: int = 2         # bf16 activations
    adapter_bytes: int = 4     # fp32 LoRA adapters
    bandwidth_hz: float = 20e6           # per-device allocation
    tx_power_dbm_up: float = 23.0        # device uplink
    tx_power_dbm_down: float = 30.0      # AP downlink
    noise_dbm_per_hz: float = -174.0
    mini_batch: int = 4
    seq_len: int = 512


DEFAULT_SIM = SimParams()
