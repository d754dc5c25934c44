"""Wireless channel model: pathloss -> SNR -> CQI -> MCS spectral efficiency.

The paper (Sec. III-A-2) converts SNR to rate via the 3GPP TS 38.214 CQI->MCS
mapping: ``R = B * y(SNR)`` where ``y`` is the spectral efficiency of the
highest CQI whose SNR threshold is met. Channel states Good/Normal/Poor are
pathloss exponents 2/4/6 (Sec. V-B).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np

# 3GPP TS 38.214 Table 5.2.2.1-2 (4-bit CQI, 64QAM): spectral efficiency and
# the commonly used SNR switching thresholds (dB) from link-level curves.
CQI_EFFICIENCY = (
    0.1523, 0.2344, 0.3770, 0.6016, 0.8770, 1.1758, 1.4766, 1.9141,
    2.4063, 2.7305, 3.3223, 3.9023, 4.5234, 5.1152, 5.5547,
)
CQI_SNR_THRESH_DB = (
    -6.7, -4.7, -2.3, 0.2, 2.4, 4.3, 5.9, 8.1,
    10.3, 11.7, 14.1, 16.3, 18.7, 21.0, 22.7,
)

PATHLOSS_EXPONENT = {"good": 2.0, "normal": 4.0, "poor": 6.0}

# Shared by the scalar and vectorized fleet engines: per-device PRNG streams
# are seeded ``seed + SEED_STRIDE * device_index`` and devices sit at the
# paper's default AP distance. One definition — the engines must not drift.
SEED_STRIDE = 31
DEFAULT_DISTANCE_M = 35.0


_CQI_TABLE = np.concatenate(([0.0], np.asarray(CQI_EFFICIENCY)))


def snr_to_efficiency(snr_db: float) -> float:
    """y(SNR): highest CQI whose threshold is met (0 below CQI-1)."""
    return float(snr_to_efficiency_array(np.asarray(snr_db)))


def snr_to_efficiency_array(snr_db: np.ndarray) -> np.ndarray:
    """Vectorized y(SNR) over an array of SNRs (dB)."""
    idx = np.searchsorted(np.asarray(CQI_SNR_THRESH_DB), snr_db, side="right")
    return _CQI_TABLE[idx]


def pathloss_db(distance_m: float, exponent: float, *,
                ref_loss_db: float = 30.0, ref_dist_m: float = 1.0) -> float:
    return ref_loss_db + 10.0 * exponent * math.log10(
        max(distance_m, ref_dist_m) / ref_dist_m)


@dataclass
class ChannelState:
    """Per-(device, round) link realization."""
    snr_up_db: float
    snr_down_db: float
    bandwidth_hz: float

    @property
    def rate_up(self) -> float:      # R^D in the paper, bits/s
        # floor at CQI-1 (lowest MCS with HARQ retransmission) to avoid outage
        return self.bandwidth_hz * max(snr_to_efficiency(self.snr_up_db),
                                       CQI_EFFICIENCY[0])

    @property
    def rate_down(self) -> float:    # R^S
        return self.bandwidth_hz * max(snr_to_efficiency(self.snr_down_db),
                                       CQI_EFFICIENCY[0])


@dataclass
class ChannelBatch:
    """(rounds, devices) block of link realizations for a whole simulation.

    Rates apply the same CQI-1 floor as ``ChannelState`` so a batched fleet
    sweep sees bit-identical link budgets to per-round scalar draws.
    """
    snr_up_db: np.ndarray       # (rounds, devices)
    snr_down_db: np.ndarray     # (rounds, devices)
    bandwidth_hz: float

    @property
    def rate_up(self) -> np.ndarray:
        eff = np.maximum(snr_to_efficiency_array(self.snr_up_db),
                         CQI_EFFICIENCY[0])
        return self.bandwidth_hz * eff

    @property
    def rate_down(self) -> np.ndarray:
        eff = np.maximum(snr_to_efficiency_array(self.snr_down_db),
                         CQI_EFFICIENCY[0])
        return self.bandwidth_hz * eff

    @property
    def rounds(self) -> int:
        return self.snr_up_db.shape[0]

    @property
    def n_devices(self) -> int:
        return self.snr_up_db.shape[1]

    def state(self, round_idx: int, device_idx: int) -> ChannelState:
        """The scalar ``ChannelState`` view of one (round, device) cell."""
        return ChannelState(
            snr_up_db=float(self.snr_up_db[round_idx, device_idx]),
            snr_down_db=float(self.snr_down_db[round_idx, device_idx]),
            bandwidth_hz=self.bandwidth_hz)


class WirelessChannel:
    """Draws per-round channel states with Rayleigh block fading."""

    def __init__(self, state: str = "normal", *,
                 distance_m: float = DEFAULT_DISTANCE_M,
                 bandwidth_hz: float = 20e6, tx_power_dbm_up: float = 23.0,
                 tx_power_dbm_down: float = 30.0,
                 noise_dbm_per_hz: float = -174.0, fading: bool = True,
                 seed: int = 0):
        if state not in PATHLOSS_EXPONENT:
            raise ValueError(f"channel state must be one of {list(PATHLOSS_EXPONENT)}")
        self.state = state
        self.exponent = PATHLOSS_EXPONENT[state]
        self.distance_m = distance_m
        self.bandwidth_hz = bandwidth_hz
        self.tx_up = tx_power_dbm_up
        self.tx_down = tx_power_dbm_down
        self.noise_dbm = noise_dbm_per_hz + 10 * math.log10(bandwidth_hz)
        self.fading = fading
        self.rng = np.random.default_rng(seed)

    def mean_snr_db(self, uplink: bool) -> float:
        tx = self.tx_up if uplink else self.tx_down
        return tx - pathloss_db(self.distance_m, self.exponent) - self.noise_dbm

    def draw(self) -> ChannelState:
        """One block-fading realization (fixed within a training round)."""
        if self.fading:
            # Rayleigh: |h|^2 ~ Exp(1) -> dB offset
            g_up = 10 * math.log10(max(self.rng.exponential(1.0), 1e-6))
            g_dn = 10 * math.log10(max(self.rng.exponential(1.0), 1e-6))
        else:
            g_up = g_dn = 0.0
        return ChannelState(
            snr_up_db=self.mean_snr_db(True) + g_up,
            snr_down_db=self.mean_snr_db(False) + g_dn,
            bandwidth_hz=self.bandwidth_hz)

    def draw_rounds(self, rounds: int) -> Tuple[np.ndarray, np.ndarray]:
        """``rounds`` block-fading realizations in one shot.

        Consumes the PRNG stream in exactly the order of ``rounds``
        sequential ``draw()`` calls (up, down, up, down, ...), so the
        batched fleet engine reproduces the scalar simulator bit-for-bit.
        Returns ``(snr_up_db, snr_down_db)``, each shaped ``(rounds,)``.
        """
        if self.fading:
            g = 10 * np.log10(np.maximum(
                self.rng.exponential(1.0, size=(rounds, 2)), 1e-6))
            g_up, g_dn = g[:, 0], g[:, 1]
        else:
            g_up = g_dn = np.zeros(rounds)
        return (self.mean_snr_db(True) + g_up,
                self.mean_snr_db(False) + g_dn)


def draw_channel_matrix(state: str, rounds: int, n_devices: int, *,
                        seed: int = 0, seed_stride: int = SEED_STRIDE,
                        distance_m: float = DEFAULT_DISTANCE_M,
                        bandwidth_hz: float = 20e6,
                        tx_power_dbm_up: float = 23.0,
                        tx_power_dbm_down: float = 30.0,
                        noise_dbm_per_hz: float = -174.0,
                        fading: bool = True) -> ChannelBatch:
    """All (rounds x devices) channel states up front, for the fleet engine.

    Device ``m`` gets its own stream seeded ``seed + seed_stride * m`` — the
    same scheme the scalar simulator uses — so scalar and vectorized sweeps
    observe identical link realizations.
    """
    up = np.empty((rounds, n_devices))
    down = np.empty((rounds, n_devices))
    for m in range(n_devices):
        ch = WirelessChannel(state, seed=seed + seed_stride * m,
                             distance_m=distance_m, bandwidth_hz=bandwidth_hz,
                             tx_power_dbm_up=tx_power_dbm_up,
                             tx_power_dbm_down=tx_power_dbm_down,
                             noise_dbm_per_hz=noise_dbm_per_hz, fading=fading)
        up[:, m], down[:, m] = ch.draw_rounds(rounds)
    return ChannelBatch(snr_up_db=up, snr_down_db=down,
                        bandwidth_hz=bandwidth_hz)
