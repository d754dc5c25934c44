"""The SL fine-tuning protocol — Sec. II-B stages 1-5, executed for real.

Each training round, for each participating device:

  Stage 1  LLM splitting: CARD (or a baseline policy) picks (c, f*) from the
           current channel state; adapters split into R^D / R^S.
  Stage 2  Device-side adapter distribution (accounted in Eq. 9).
  Stage 3  FP: device-side forward -> phi-compressed smashed data -> server FP.
  Stage 4  BP: server adapter update -> compressed gradient -> device update.
           (Stages 3-4 repeat for T local epochs.)
  Stage 5  Device-side adapter upload; server merges R = {R^D;R^S}.

The PyTorch computation is real (split_grads + optimizer); the wall-clock /
energy numbers are *simulated* through the paper's cost model driven by the
same workload constants — this is exactly the paper's methodology (a
physical 5-Jetson testbed feeding a delay/energy model). Retries, eviction
and quorum rollback are the reference's, line for line; a rollback keeps
references to the old ``(lora, opt_state)``, which the pure optimizer never
updates in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import card as card_lib
from repro_torch.core.channel import WirelessChannel
from repro_torch.core.cost_model import RoundContext, Workload
from repro_torch.core.faults import (CircuitBreaker, ExchangeFailed,
                                     FaultInjector, RetryPolicy, retry_call)
from repro_torch.core.hardware import DeviceProfile, SimParams
from repro_torch.core.splitting import SplitExecutor
from repro_torch.models.common import Params
from repro_torch.optim import Optimizer, apply_updates

Policy = Callable[[RoundContext], card_lib.Decision]

POLICIES: Dict[str, Policy] = {
    "card": card_lib.card,
    "server_only": card_lib.server_only,
    "device_only": card_lib.device_only,
}


@dataclasses.dataclass
class RoundLog:
    """One (round, device) record of live split fine-tuning: the CARD
    decision (``cut`` layers, ``frequency`` Hz), its modeled ``delay`` in
    seconds and ``server_energy`` in joules, the measured training
    ``loss``, plus churn accounting (``status``/``attempts``/retry
    ``backoff_s``)."""
    round_idx: int
    device: str
    cut: int
    frequency: float
    delay: float
    server_energy: float
    loss: float
    cost: float
    # churn-tolerance accounting
    status: str = "ok"        # ok | dropped | evicted | absent | rolled_back
    attempts: int = 1         # exchange attempts (max over the round's epochs)
    backoff_s: float = 0.0    # retry backoff accumulated over the round


@dataclasses.dataclass
class RoundSummary:
    """Per-round aggregation outcome: how many devices were scheduled vs
    survived churn, and whether the quorum committed the adapter update."""
    round_idx: int
    attempted: int            # devices scheduled this round (member + closed)
    survived: int
    committed: bool           # quorum met -> adapter updates kept


@dataclasses.dataclass
class TrainResult:
    """Everything a fine-tuning run produced: the final LoRA params, the
    flat ``RoundLog`` stream, and per-round commit summaries; the mean_*
    helpers average surviving (``status == "ok"``) rounds only — delay in
    seconds, energy in joules."""
    lora: Params
    logs: List[RoundLog]
    round_summaries: List[RoundSummary] = dataclasses.field(
        default_factory=list)

    def mean_delay(self) -> float:
        return _nanmean_of([l.delay for l in self.logs if l.status == "ok"])

    def mean_energy(self) -> float:
        return _nanmean_of([l.server_energy for l in self.logs
                            if l.status == "ok"])

    def losses(self) -> List[float]:
        return [l.loss for l in self.logs if l.status == "ok"]

    def rounds_committed(self) -> int:
        if not self.round_summaries:
            return len({l.round_idx for l in self.logs})
        return sum(s.committed for s in self.round_summaries)


def _nanmean_of(vals: List[float]) -> float:
    arr = np.asarray(vals, np.float64)
    mask = ~np.isnan(arr)
    return float(arr[mask].mean()) if mask.any() else float("nan")


class SplitFineTuner:
    """Runs the full protocol over a device fleet."""

    def __init__(self, cfg: ModelConfig, frozen: Params, lora: Params,
                 optimizer: Optimizer, *, devices: List[DeviceProfile],
                 server: DeviceProfile, channels: List[WirelessChannel],
                 datasets: List, sim: SimParams, policy: str = "card",
                 static_cut: Optional[int] = None, compress: bool = True,
                 cost_cfg: Optional[ModelConfig] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 quorum: float = 0.5,
                 sleep: Optional[Callable[[float], None]] = None):
        assert len(devices) == len(channels) == len(datasets)
        if not 0.0 <= quorum <= 1.0:
            raise ValueError(f"quorum must be in [0, 1], got {quorum!r}")
        self.cfg = cfg
        # delay/energy accounting may use the FULL-SIZE config while the
        # actual training runs the reduced one (paper methodology:
        # measured testbed feeding an analytic model)
        self.cost_cfg = cost_cfg or cfg
        self.frozen = frozen
        self.lora = lora
        self.optimizer = optimizer
        self.opt_state = optimizer.init(lora)
        self.devices = devices
        self.server = server
        self.channels = channels
        self.datasets = datasets
        self.sim = sim
        self.policy_name = policy
        self.static_cut = static_cut
        self.executor = SplitExecutor(cfg, compress=compress)
        self.rng = np.random.default_rng(7)
        # churn tolerance: injected link faults, retry policy for the
        # activation/gradient exchange, repeat-offender eviction, and the
        # minimum fraction of scheduled devices a round needs to commit
        self.fault_injector = fault_injector
        self.retry_policy = retry_policy or RetryPolicy()
        self.breaker = breaker or CircuitBreaker()
        self.quorum = quorum
        self._sleep = sleep  # None = account backoff without wall-clock sleep

    def _decide(self, ctx: RoundContext) -> card_lib.Decision:
        if self.policy_name == "static":
            assert self.static_cut is not None
            return card_lib.static_cut(ctx, self.static_cut)
        if self.policy_name == "random":
            return card_lib.random_cut(ctx, self.rng)
        return POLICIES[self.policy_name](ctx)

    def _exchange(self, n: int, device_idx: int, fn: Callable[[], object]):
        """One activation/gradient exchange under timeout + capped
        exponential-backoff retries; injected link faults fail attempts.
        Returns ``(result, attempts, backoff_s)``; raises
        :class:`ExchangeFailed` when the retry budget is exhausted."""
        attempt_counter = [0]

        def attempt():
            attempt_counter[0] += 1
            if self.fault_injector is not None:
                self.fault_injector.check(n, device_idx, attempt_counter[0])
            return fn()

        return retry_call(attempt, self.retry_policy, sleep=self._sleep)

    def run_round(self, n: int, device_idx: int) -> RoundLog:
        """One device's round; raises :class:`ExchangeFailed` if the link
        stays down past the retry budget (caller restores state)."""
        dev = self.devices[device_idx]
        chan_state = self.channels[device_idx].draw()
        workload = Workload(self.cost_cfg, self.sim.mini_batch,
                            self.sim.seq_len)
        ctx = RoundContext(workload=workload, device=dev, server=self.server,
                           channel=chan_state, sim=self.sim)
        # Stage 1: splitting decision (cut index mapped onto the trained
        # stack if the cost model uses the full-size config)
        decision = self._decide(ctx)
        cut = decision.cut
        if self.cost_cfg.n_layers != self.cfg.n_layers:
            cut = round(cut * self.cfg.n_layers / self.cost_cfg.n_layers)

        # Stages 2-5: T local epochs of real split training; each epoch's
        # smashed-data/gradient exchange runs under the retry envelope.
        # Only the last epoch's loss is logged, so the device sync happens
        # once after the loop instead of serializing every epoch.
        loss = None
        attempts = 1
        backoff_s = 0.0
        for _ in range(self.sim.local_epochs):
            batch = self.datasets[device_idx].minibatch(
                self.sim.mini_batch, self.sim.seq_len)
            (loss, grads), tries, waited_s = self._exchange(
                n, device_idx,
                lambda b=batch: self.executor.step(self.frozen, self.lora,
                                                   b, cut))
            attempts = max(attempts, tries)
            backoff_s += waited_s
            updates, self.opt_state = self.optimizer.update(
                grads, self.opt_state, self.lora)
            self.lora = apply_updates(self.lora, updates)
        loss_val = float(loss) if loss is not None else float("nan")

        return RoundLog(round_idx=n, device=dev.name, cut=cut,
                        frequency=decision.frequency,
                        delay=decision.delay + backoff_s,
                        server_energy=decision.energy, loss=loss_val,
                        cost=decision.cost, attempts=attempts,
                        backoff_s=backoff_s)

    def _skip_log(self, n: int, device_idx: int, status: str,
                  attempts: int = 0, backoff_s: float = 0.0) -> RoundLog:
        nan = float("nan")
        return RoundLog(round_idx=n, device=self.devices[device_idx].name,
                        cut=-1, frequency=nan, delay=nan, server_energy=nan,
                        loss=nan, cost=nan, status=status, attempts=attempts,
                        backoff_s=backoff_s)

    def run(self, n_rounds: int) -> TrainResult:
        """Run the protocol with graceful degradation: a round commits with
        any quorum of surviving devices; below quorum its adapter updates
        are rolled back (the fleet keeps going either way)."""
        logs: List[RoundLog] = []
        summaries: List[RoundSummary] = []
        for n in range(n_rounds):
            round_state = (self.lora, self.opt_state)
            round_logs: List[RoundLog] = []
            attempted = 0
            survived = 0
            for m in range(len(self.devices)):
                if self.fault_injector is not None \
                        and not self.fault_injector.is_member(n, m):
                    round_logs.append(self._skip_log(n, m, "absent"))
                    continue
                if not self.breaker.allow(m, n):
                    round_logs.append(self._skip_log(n, m, "evicted"))
                    continue
                attempted += 1
                device_state = (self.lora, self.opt_state)
                try:
                    round_logs.append(self.run_round(n, m))
                    self.breaker.record_success(m)
                    survived += 1
                except ExchangeFailed as e:
                    # discard the device's partial round, penalize repeats
                    self.lora, self.opt_state = device_state
                    self.breaker.record_failure(m, n)
                    round_logs.append(self._skip_log(
                        n, m, "dropped", attempts=e.attempts,
                        backoff_s=e.backoff_s))
            needed = max(1, math.ceil(self.quorum * attempted)) \
                if attempted else 1
            committed = survived >= needed
            if not committed:
                self.lora, self.opt_state = round_state
                for rl in round_logs:
                    if rl.status == "ok":
                        rl.status = "rolled_back"
            logs.extend(round_logs)
            summaries.append(RoundSummary(round_idx=n, attempted=attempted,
                                          survived=survived,
                                          committed=committed))
        return TrainResult(lora=self.lora, logs=logs,
                           round_summaries=summaries)
