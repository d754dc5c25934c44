"""Fault model for churn-tolerant fleet orchestration.

The paper's protocol assumes every device survives every round; real edge
fleets do not (Efficient Split Federated Learning, arXiv:2504.14667). This
module is the single source of fault realizations for *both* fleet engines
and the live protocol:

  ``FaultModel.realize`` — seeded per-(round, device) arrays: dropout
      (device misses the round), straggler slowdown factors on device
      compute and on the radio link, mid-round link outages, and a
      join/leave membership trajectory (two-state Markov chain).
      Composable with ``channel.draw_channel_matrix``: realizations are
      drawn once, array-shaped, from per-device streams that are disjoint
      from the channel streams, so the scalar and vectorized engines — and
      a protocol run over the same fleet — consume identical faults.

  ``RetryPolicy`` / ``retry_call`` — capped exponential backoff with a
      cumulative timeout budget, for the activation/gradient exchange.

  ``CircuitBreaker`` — evicts repeat offenders for a cool-down window
      (half-open after the cool-down expires).

  ``FaultInjector`` — turns a realization into deterministic
      ``LinkTimeout`` raises for the live protocol (dropout = the link is
      dead all round; outage = the first attempt(s) fail, retries succeed).

Zero-probability faults are exactly the identity: all devices active, no
dropouts, every slowdown factor exactly 1.0 — the degenerate case is
bit-identical to a fault-free simulation.

Numpy only: the port's near-verbatim copy of the JAX package's module, so
the realizations of a seed are bit-identical to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

#: third element of the per-device seed sequence — keeps fault streams
#: disjoint from the channel streams even when both use the same base seed
_FAULT_STREAM = 0xFA


class LinkTimeout(TimeoutError):
    """One activation/gradient exchange attempt timed out (injectable)."""


class ExchangeFailed(RuntimeError):
    """All retries for one exchange exhausted — the device drops the round."""

    def __init__(self, msg: str, *, attempts: int, backoff_s: float):
        super().__init__(msg)
        self.attempts = attempts
        self.backoff_s = backoff_s


# ---------------------------------------------------------------------------
# Fault realization (arrays, shared by both engines)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultRealization:
    """Per-(round, device) fault draws; every array is ``(rounds, devices)``.

    Slowdown factors are exactly 1.0 where no straggler event fired, so a
    zero-probability model leaves delays bit-identical.
    """
    active: np.ndarray            # bool — device is a fleet member this round
    dropout: np.ndarray           # bool — member, but misses the round
    compute_slowdown: np.ndarray  # float >= 1 on device compute
    link_slowdown: np.ndarray     # float >= 1 on uplink/downlink time
    outage: np.ndarray            # bool — mid-round link outage (stall)
    outage_stall_s: float = 1.0   # retransmission stall per outage

    @property
    def rounds(self) -> int:
        return self.active.shape[0]

    @property
    def n_devices(self) -> int:
        return self.active.shape[1]

    @property
    def participating(self) -> np.ndarray:
        """Members that actually start the round (active and not dropped)."""
        return self.active & ~self.dropout

    def realized_delays(self, d_device: np.ndarray, d_uplink: np.ndarray,
                        d_server: np.ndarray,
                        d_downlink: np.ndarray) -> np.ndarray:
        """Nominal per-component delays -> delays the fleet experiences.

        Stragglers stretch the device-compute and radio terms; the server
        term is unaffected (the server does not straggle); an outage adds a
        fixed retransmission stall on top.
        """
        return (d_device * self.compute_slowdown
                + (d_uplink + d_downlink) * self.link_slowdown
                + d_server
                + np.where(self.outage, self.outage_stall_s, 0.0))

    def to_jsonable(self) -> Dict:
        return {
            "schema": "fault-realization/v1",
            "rounds": int(self.rounds),
            "devices": int(self.n_devices),
            "active": self.active.astype(int).tolist(),
            "dropout": self.dropout.astype(int).tolist(),
            "compute_slowdown": self.compute_slowdown.tolist(),
            "link_slowdown": self.link_slowdown.tolist(),
            "outage": self.outage.astype(int).tolist(),
        }


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Seeded generator of :class:`FaultRealization` arrays.

    Probabilities are per (round, device); the membership trajectory is a
    two-state Markov chain (present -> absent with ``leave_prob``, absent ->
    present with ``rejoin_prob``), the rest are i.i.d. draws. Each device
    consumes its own PRNG stream (``[seed, device, _FAULT_STREAM]``), so
    realizations are stable under changes to the fleet size and never alias
    the channel fading streams.
    """
    dropout_prob: float = 0.0
    straggler_prob: float = 0.0
    slowdown_min: float = 1.5     # uniform slowdown factor range when a
    slowdown_max: float = 4.0     # straggler event fires
    outage_prob: float = 0.0
    outage_stall_s: float = 1.0   # retransmission stall per outage
    leave_prob: float = 0.0
    rejoin_prob: float = 0.5
    initial_absent_prob: float = 0.0

    def __post_init__(self):
        for name in ("dropout_prob", "straggler_prob", "outage_prob",
                     "leave_prob", "rejoin_prob", "initial_absent_prob"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p!r}")
        if not 1.0 <= self.slowdown_min <= self.slowdown_max:
            raise ValueError("need 1 <= slowdown_min <= slowdown_max, got "
                             f"({self.slowdown_min}, {self.slowdown_max})")

    @property
    def mean_slowdown(self) -> float:
        """E[slowdown | straggler] — what the deadline objective plans for."""
        return 0.5 * (self.slowdown_min + self.slowdown_max)

    def realize(self, rounds: int, n_devices: int, *,
                seed: int = 0) -> FaultRealization:
        active = np.empty((rounds, n_devices), bool)
        dropout = np.empty((rounds, n_devices), bool)
        comp = np.ones((rounds, n_devices))
        link = np.ones((rounds, n_devices))
        outage = np.empty((rounds, n_devices), bool)
        for m in range(n_devices):
            rng = np.random.default_rng([seed, m, _FAULT_STREAM])
            # fixed draw count per device regardless of the path taken, so
            # realizations are reproducible prefix-stable in `rounds`
            present = rng.random() >= self.initial_absent_prob
            u = rng.random((rounds, 4))         # leave/rejoin, drop, strag, out
            factors = rng.uniform(self.slowdown_min, self.slowdown_max,
                                  size=(rounds, 2))
            for r in range(rounds):
                if present:
                    present = u[r, 0] >= self.leave_prob
                else:
                    present = u[r, 0] < self.rejoin_prob
                active[r, m] = present
            dropout[:, m] = u[:, 1] < self.dropout_prob
            straggler = u[:, 2] < self.straggler_prob
            comp[straggler, m] = factors[straggler, 0]
            link[straggler, m] = factors[straggler, 1]
            outage[:, m] = u[:, 3] < self.outage_prob
        return FaultRealization(active=active, dropout=dropout,
                                compute_slowdown=comp, link_slowdown=link,
                                outage=outage,
                                outage_stall_s=self.outage_stall_s)


@dataclasses.dataclass(frozen=True)
class DeadlinePolicy:
    """How the server closes a round under churn.

    ``quantile`` — the round deadline is this quantile of the *predicted*
    (nominal decision) delays across the round's members; devices whose
    realized delay exceeds it are marked late and dropped from the round.
    ``objective_deadline_s`` — when set, CARD's objective is penalized by
    ``objective_penalty * P(miss the deadline)`` so the (cut, f) decision
    itself accounts for straggler/dropout risk (see ``card.DeadlineSpec``).
    """
    quantile: float = 0.9
    objective_deadline_s: Optional[float] = None
    objective_penalty: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.quantile <= 1.0:
            raise ValueError(f"quantile must be in (0, 1], got "
                             f"{self.quantile!r}")


# ---------------------------------------------------------------------------
# Retry / circuit-breaker primitives (protocol + trainer hardening)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with a cumulative per-exchange budget."""
    max_attempts: int = 3
    base_backoff_s: float = 0.05
    max_backoff_s: float = 1.0
    timeout_s: float = 30.0       # total budget across attempts + backoff

    def backoff_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based: after first failure)."""
        return min(self.base_backoff_s * (2.0 ** (attempt - 1)),
                   self.max_backoff_s)


def retry_call(fn: Callable[[], object], policy: RetryPolicy, *,
               retry_on: Tuple[type, ...] = (LinkTimeout, OSError),
               sleep: Optional[Callable[[float], None]] = None,
               clock: Optional[Callable[[], float]] = None):
    """Run ``fn`` under ``policy``; returns ``(result, attempts, backoff_s)``.

    ``sleep`` defaults to pure accounting (no wall-clock sleep — the
    simulated cost model owns time); pass ``time.sleep`` for real I/O.
    ``clock`` (monotonic seconds) enforces the cumulative timeout budget.
    Raises :class:`ExchangeFailed` when attempts or budget are exhausted.
    """
    total_backoff_s = 0.0
    start = clock() if clock else None
    last: Optional[BaseException] = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn(), attempt, total_backoff_s
        except retry_on as e:  # noqa: PERF203 — retry loop is the point
            last = e
            if attempt == policy.max_attempts:
                break
            pause_s = policy.backoff_s(attempt)
            elapsed_s = (clock() - start) if clock else total_backoff_s
            if elapsed_s + pause_s > policy.timeout_s:
                raise ExchangeFailed(
                    f"timeout budget {policy.timeout_s}s exhausted after "
                    f"{attempt} attempt(s): {e}",
                    attempts=attempt, backoff_s=total_backoff_s) from e
            total_backoff_s += pause_s
            if sleep is not None:
                sleep(pause_s)
    raise ExchangeFailed(
        f"all {policy.max_attempts} attempts failed: {last}",
        attempts=policy.max_attempts, backoff_s=total_backoff_s) from last


class CircuitBreaker:
    """Per-device breaker: repeated failures evict a device for a cool-down.

    Closed (normal) -> open after ``failure_threshold`` *consecutive*
    failures; open blocks the device for ``cooldown_rounds`` rounds, then
    half-opens (one probe allowed; a failure re-opens immediately).
    """

    def __init__(self, *, failure_threshold: int = 3,
                 cooldown_rounds: int = 5):
        if failure_threshold < 1 or cooldown_rounds < 1:
            raise ValueError("failure_threshold and cooldown_rounds must "
                             "be >= 1")
        self.failure_threshold = failure_threshold
        self.cooldown_rounds = cooldown_rounds
        self._failures: Dict[int, int] = {}
        self._open_until: Dict[int, int] = {}

    def allow(self, device_idx: int, round_idx: int) -> bool:
        return round_idx >= self._open_until.get(device_idx, -1)

    def is_open(self, device_idx: int, round_idx: int) -> bool:
        return not self.allow(device_idx, round_idx)

    def record_success(self, device_idx: int) -> None:
        self._failures[device_idx] = 0
        self._open_until.pop(device_idx, None)

    def record_failure(self, device_idx: int, round_idx: int) -> None:
        n = self._failures.get(device_idx, 0) + 1
        self._failures[device_idx] = n
        if n >= self.failure_threshold:
            self._open_until[device_idx] = round_idx + 1 + self.cooldown_rounds
            # half-open: the probe after the cool-down only needs one more
            # failure to re-open
            self._failures[device_idx] = self.failure_threshold - 1

    def evicted(self, round_idx: int) -> List[int]:
        return sorted(d for d, until in self._open_until.items()
                      if round_idx < until)


@dataclasses.dataclass
class FaultInjector:
    """Deterministic link faults for the live protocol, from a realization.

    Dropout / inactive membership: every attempt in that round raises
    (the device is unreachable). Outage: the first
    ``outage_fail_attempts`` attempts raise, then the link recovers —
    exactly the case retries exist for. Rounds beyond the realization wrap
    around (long protocol runs on a short realization).
    """
    realization: FaultRealization
    outage_fail_attempts: int = 1

    def check(self, round_idx: int, device_idx: int, attempt: int) -> None:
        r = round_idx % self.realization.rounds
        if not self.realization.active[r, device_idx]:
            raise LinkTimeout(f"device {device_idx} left the fleet "
                              f"(round {round_idx})")
        if self.realization.dropout[r, device_idx]:
            raise LinkTimeout(f"device {device_idx} dropped round "
                              f"{round_idx}")
        if self.realization.outage[r, device_idx] \
                and attempt <= self.outage_fail_attempts:
            raise LinkTimeout(f"link outage on device {device_idx}, round "
                              f"{round_idx}, attempt {attempt}")

    def is_member(self, round_idx: int, device_idx: int) -> bool:
        r = round_idx % self.realization.rounds
        return bool(self.realization.active[r, device_idx])
