"""CARD's decision (Alg. 1) worked out again from the paper's cost model
(Sec. III, Eqs. 7-12 and 16): the server frequency in closed form, then the
cut by brute force over every cut the device's memory admits. Plain Python
floats (float64) in the order the equations are written; nothing of the
port.

The FLOP counts are the paper's analytic ones per token: the projections,
the causal scores at the sequence length and the adapters, twice for LoRA
fine-tuning's forward and backward; the head on the server.
"""
from __future__ import annotations

import bisect
import math
from typing import Dict

from port_bench.reference.model import Dims

# 3GPP TS 38.214 Table 5.2.2.1-2: CQI spectral efficiencies and the SNR
# thresholds (dB) at which each CQI is met
CQI_EFFICIENCY = (0.1523, 0.2344, 0.3770, 0.6016, 0.8770, 1.1758, 1.4766,
                  1.9141, 2.4063, 2.7305, 3.3223, 3.9023, 4.5234, 5.1152,
                  5.5547)
CQI_SNR_THRESH_DB = (-6.7, -4.7, -2.3, 0.2, 2.4, 4.3, 5.9, 8.1, 10.3, 11.7,
                     14.1, 16.3, 18.7, 21.0, 22.7)
MEM_BUDGET_FRACTION = 0.8      # of a device's memory the backbone may take
LORA_TRAIN_FACTOR = 2.0


def rate(bandwidth_hz: float, snr_db: float) -> float:
    """Bits/s: the highest CQI whose threshold is met, at least CQI 1."""
    idx = bisect.bisect_right(CQI_SNR_THRESH_DB, snr_db)
    eff = 0.0 if idx == 0 else CQI_EFFICIENCY[idx - 1]
    return bandwidth_hz * max(eff, CQI_EFFICIENCY[0])


class Costs:
    """Eqs. 7-12 for one (device, round)."""

    def __init__(self, dims: Dims, rank: int, job: Dict, sim: Dict,
                 device: Dict, server: Dict, channel: Dict):
        self.L = dims.layers
        d, q = dims.d, dims.heads * dims.head_dim
        kv, f, v = dims.kv_heads * dims.head_dim, dims.ffn, dims.vocab
        s = job["seq_len"]
        self.tokens = job["mini_batch"] * s
        self.t = job["local_epochs"]
        self.sim, self.device, self.server = sim, device, server
        self.lora_params = rank * ((d + q) + 2 * (d + kv) + (q + d)
                                   + 2 * (d + f) + (f + d))
        attn = 2 * d * (q + 2 * kv) + 2 * q * d + 2 * s * q
        layer = attn + 2 * 3 * d * f + 2 * self.lora_params
        self.embed, self.layer, self.head = 2 * d, layer, 2 * d * v
        self.d = d
        attn_params = d * q + 2 * d * kv + q * d + (
            q + 2 * kv if dims.qkv_bias else 0)
        self.params_per_layer = attn_params + 3 * d * f + 2 * d
        self.embed_bytes = v * d * 2
        self.rate_up = rate(channel["bandwidth_hz"], channel["snr_up_db"])
        self.rate_down = rate(channel["bandwidth_hz"],
                              channel["snr_down_db"])
        self.device_peak = device["f_max"] * device["delta"] * device["sigma"]

    def device_flops(self, c):
        return LORA_TRAIN_FACTOR * (self.embed + c * self.layer) * self.tokens

    def total_flops(self):
        return LORA_TRAIN_FACTOR * (self.embed + self.L * self.layer
                                    + self.head) * self.tokens

    def server_flops(self, c):
        return self.total_flops() - self.device_flops(c)

    def delay(self, c, f):
        sim, t = self.sim, self.t
        smashed = self.tokens * self.d * sim["act_bytes"] + self.tokens * 4
        gradient = self.tokens * self.d * sim["act_bytes"]
        adapters = 8 * (c * self.lora_params * sim["adapter_bytes"])
        up = (t * 8 * sim["phi"] * smashed + adapters) / self.rate_up
        down = (t * 8 * sim["phi"] * gradient + adapters) / self.rate_down
        dev = t * (self.device_flops(c) / self.device_peak)
        srv = t * (self.server_flops(c) / (f * self.server["delta"]
                                           * self.server["sigma"]))
        return dev + up + srv + down

    def energy(self, c, f):
        return (self.t * self.sim["xi"] * f ** 2 * self.server_flops(c)
                / (self.server["delta"] * self.server["sigma"]))

    def f_min(self):
        return max(self.device_peak / (self.server["delta"]
                                       * self.server["sigma"]),
                   self.server["f_min"])

    def corners(self):
        f_min, f_max = self.f_min(), self.server["f_max"]
        return (self.delay(0, f_max), self.delay(self.L, f_min),
                self.energy(self.L, f_min), self.energy(0, f_max))

    def max_feasible_cut(self):
        budget = MEM_BUDGET_FRACTION * self.device["mem_bytes"]
        for c in range(self.L, -1, -1):
            if self.embed_bytes + c * self.params_per_layer * 2 <= budget:
                return c
        return 0

    def frequency(self):
        """Eq. 16."""
        d_min, d_max, e_min, e_max = self.corners()
        w, xi = self.sim["w"], self.sim["xi"]
        if w >= 1.0:
            return self.server["f_max"]
        q = ((w * (e_max - e_min))
             / (2.0 * xi * (1.0 - w) * max(d_max - d_min, 1e-12))) ** (1 / 3)
        return min(max(q, self.f_min()), self.server["f_max"])

    def cost(self, c, f):
        """Eq. 12."""
        d_min, d_max, e_min, e_max = self.corners()
        w = self.sim["w"]
        dn = (self.delay(c, f) - d_min) / max(d_max - d_min, 1e-12)
        en = (self.energy(c, f) - e_min) / max(e_max - e_min, 1e-12)
        return w * dn + (1 - w) * en


def decide(costs: Costs):
    """Alg. 1: (cut, frequency, {cut: cost})."""
    f = costs.frequency()
    table = {c: costs.cost(c, f) for c in range(costs.max_feasible_cut() + 1)}
    best = min(table, key=lambda c: (table[c], c))
    return best, f, table


def cut_excess(costs: Costs, cut: int) -> float:
    """How far the program's cut's Eq. 12 cost lies above the best cut's,
    relative to the best's: 0 where the program took the best cut, or one
    that ties it to rounding; ``inf`` for a cut the device cannot hold."""
    best, _, table = decide(costs)
    if cut not in table:
        return math.inf
    return (table[cut] - table[best]) / max(abs(table[best]), 1e-12)
