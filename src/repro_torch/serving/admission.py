"""Channel-aware admission control: serving shares the edge bandwidth budget.

The paper's edge server fine-tunes the fleet over a wireless link
(``core/channel.py``: pathloss -> SNR -> CQI -> spectral efficiency); the
same link streams generated tokens back to users at inference time. The
controller reserves a fraction of the band for SL training and admits a
request only while the unreserved capacity covers the bandwidth its token
stream needs at the efficiency of a per-request channel draw:

    demand_hz = token_rate_per_s * bits_per_token / efficiency(snr_down)

A request that does not fit waits in the engine queue (FIFO); the grant is
released on completion. One head-of-line request is always admitted when
nothing else holds a grant, so a single oversized demand degrades service
instead of deadlocking it. Per-tenant (adapter_id) queueing stats make the
contention visible.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.channel import (CQI_EFFICIENCY, DEFAULT_DISTANCE_M,
                                WirelessChannel, snr_to_efficiency)


class ChannelAdmissionController:
    """Bandwidth-budget admission for the serving engine.

    Parameters mirror ``WirelessChannel``; ``training_reserve_frac`` is the
    share of the band kept for SL fine-tuning traffic, ``token_rate_per_s``
    the per-user token stream rate and ``bits_per_token`` its wire size.
    """

    def __init__(self, *, bandwidth_hz: float = 20e6,
                 training_reserve_frac: float = 0.5,
                 token_rate_per_s: float = 20.0,
                 bits_per_token: float = 32.0,
                 channel_state: str = "normal",
                 distance_m: float = DEFAULT_DISTANCE_M, seed: int = 0):
        if not 0.0 <= training_reserve_frac < 1.0:
            raise ValueError("training_reserve_frac must be in [0, 1)")
        self.channel = WirelessChannel(channel_state, distance_m=distance_m,
                                       bandwidth_hz=bandwidth_hz, seed=seed)
        self.capacity_hz = bandwidth_hz * (1.0 - training_reserve_frac)
        self.reserved_hz = bandwidth_hz - self.capacity_hz
        self.token_rate_per_s = token_rate_per_s
        self.bits_per_token = bits_per_token
        self.used_hz = 0.0
        self._demand_hz: Dict[int, float] = {}      # uid -> bandwidth demand
        self._granted: Dict[int, float] = {}        # uid -> granted demand
        self.forced_admits = 0
        self._tenants: Dict[int, Dict[str, Any]] = {}

    def _tenant(self, adapter_id: int) -> Dict[str, Any]:
        return self._tenants.setdefault(adapter_id, {
            "submitted": 0, "admitted": 0, "completed": 0,
            "blocked_attempts": 0, "wait_s_sum": 0.0, "demand_hz_sum": 0.0,
        })

    def register(self, req) -> None:
        """Draw this request's channel and price its bandwidth demand."""
        state = self.channel.draw()
        eff = max(snr_to_efficiency(state.snr_down_db), CQI_EFFICIENCY[0])
        bps = self.token_rate_per_s * self.bits_per_token
        self._demand_hz[req.uid] = bps / eff
        tenant = self._tenant(req.adapter_id)
        tenant["submitted"] += 1
        tenant["demand_hz_sum"] += self._demand_hz[req.uid]

    def try_admit(self, req, now: float) -> bool:
        demand_hz = self._demand_hz.get(req.uid)
        if demand_hz is None:           # unregistered: admit unmetered
            return True
        tenant = self._tenant(req.adapter_id)
        fits = self.used_hz + demand_hz <= self.capacity_hz
        if not fits and self._granted:
            tenant["blocked_attempts"] += 1
            return False
        if not fits:
            self.forced_admits += 1     # head-of-line liveness
        self.used_hz += demand_hz
        self._granted[req.uid] = demand_hz
        tenant["admitted"] += 1
        tenant["wait_s_sum"] += max(now - req.submitted_at, 0.0)
        return True

    def release(self, req, now: float) -> None:
        granted = self._granted.pop(req.uid, None)
        if granted is None:
            return
        self.used_hz = max(self.used_hz - granted, 0.0)
        if not self._granted:
            self.used_hz = 0.0          # clear float residue at idle
        self._demand_hz.pop(req.uid, None)
        self._tenant(req.adapter_id)["completed"] += 1

    def stats(self) -> Dict[str, Any]:
        tenants = {}
        for aid, t in sorted(self._tenants.items()):
            admitted = t["admitted"]
            tenants[aid] = {
                **t,
                "mean_wait_s": t["wait_s_sum"] / admitted if admitted else None,
                "mean_demand_hz": (t["demand_hz_sum"] / t["submitted"]
                                   if t["submitted"] else None),
            }
        return {
            "capacity_hz": self.capacity_hz,
            "reserved_hz": self.reserved_hz,
            "used_hz": self.used_hz,
            "in_flight": len(self._granted),
            "forced_admits": self.forced_admits,
            "tenants": tenants,
        }
