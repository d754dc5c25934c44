"""Production training loop: train step + periodic eval + checkpointing
with resume + JSONL metrics. The server-side counterpart of the SL protocol
for long-running jobs (the protocol drives rounds; the Trainer owns the
optimizer state, checkpoints and metrics stream). Checkpoints are in the
JAX package's format, so either package resumes the other's.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.core.faults import ExchangeFailed, RetryPolicy, retry_call
from repro_torch.launch.train import make_train_step
from repro_torch.models import model as model_lib
from repro_torch.models.common import Params, batch_to_device
from repro_torch.optim import Optimizer, adamw, warmup_cosine


@dataclass
class TrainerConfig:
    steps: int = 200
    batch: int = 8
    seq_len: int = 64
    lr: float = 3e-3
    warmup: int = 20
    eval_every: int = 50
    eval_batches: int = 4
    checkpoint_every: int = 100
    checkpoint_dir: Optional[str] = None
    microbatches: int = 1
    impl: str = "naive"
    remat: bool = False
    log_path: Optional[str] = None
    # failure semantics: checkpoint/metrics I/O retries with capped backoff,
    # and divergence detection at the (already synced) logging points
    io_retries: int = 3
    io_backoff_s: float = 0.05
    max_nonfinite: int = 3     # consecutive non-finite losses before abort


class TrainingDiverged(RuntimeError):
    """Loss went non-finite for ``max_nonfinite`` consecutive log points."""


class Trainer:
    """Owns (lora, opt_state); the frozen backbone is read-only."""

    def __init__(self, cfg: ModelConfig, frozen: Params, lora: Params,
                 tcfg: TrainerConfig, *,
                 optimizer: Optional[Optimizer] = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.frozen = frozen
        self.lora = lora
        self.optimizer = optimizer or adamw(
            warmup_cosine(tcfg.lr, tcfg.warmup, tcfg.steps))
        self.opt_state = self.optimizer.init(lora)
        self.step = 0
        self.metrics: List[Dict] = []
        self._nonfinite_streak = 0
        self._io_policy = RetryPolicy(max_attempts=max(1, tcfg.io_retries),
                                      base_backoff_s=tcfg.io_backoff_s)
        self._train_step = make_train_step(
            cfg, self.optimizer, impl=tcfg.impl, remat=tcfg.remat,
            microbatches=tcfg.microbatches)

    @torch.no_grad()
    def _eval_loss(self, batch: Dict[str, Any]) -> torch.Tensor:
        batch = batch_to_device(batch, self.frozen["embed"].device)
        return model_lib.forward_loss(self.frozen, self.lora, batch, self.cfg,
                                      impl=self.tcfg.impl, remat=False)

    # --- checkpointing ------------------------------------------------------

    def _ckpt_path(self) -> Optional[str]:
        d = self.tcfg.checkpoint_dir
        return os.path.join(d, "trainer.npz") if d else None

    def save(self) -> None:
        """Checkpoint under I/O retries; a persistently failing filesystem
        degrades to a logged warning instead of killing the run (the next
        checkpoint interval tries again)."""
        path = self._ckpt_path()
        if not path:
            return
        try:
            retry_call(
                lambda: save_checkpoint(path, {"lora": self.lora,
                                               "opt_state": self.opt_state},
                                        step=self.step),
                self._io_policy, retry_on=(OSError,), sleep=time.sleep)
        except ExchangeFailed as e:
            self._log({"kind": "warning",
                       "event": "checkpoint_failed", "error": str(e)})

    def restore(self) -> bool:
        path = self._ckpt_path()
        if not path or not os.path.exists(path):
            return False
        like = {"lora": self.lora, "opt_state": self.opt_state}
        tree, step = load_checkpoint(path, like)
        self.lora = tree["lora"]
        self.opt_state = tree["opt_state"]
        self.step = step
        return True

    # --- loop -----------------------------------------------------------------

    def _log(self, rec: Dict) -> None:
        rec["step"] = self.step
        rec["time"] = time.time()
        self.metrics.append(rec)
        if self.tcfg.log_path:
            try:
                retry_call(lambda: self._append_log_line(rec),
                           self._io_policy, retry_on=(OSError,),
                           sleep=time.sleep)
            except ExchangeFailed:
                # metrics stream is best-effort; in-memory copy is intact
                rec["dropped_from_stream"] = True

    def _append_log_line(self, rec: Dict) -> None:
        with open(self.tcfg.log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _check_finite(self, loss: float) -> None:
        if loss == loss and abs(loss) != float("inf"):
            self._nonfinite_streak = 0
            return
        self._nonfinite_streak += 1
        self._log({"kind": "warning", "event": "nonfinite_loss",
                   "streak": self._nonfinite_streak})
        if self._nonfinite_streak >= self.tcfg.max_nonfinite:
            raise TrainingDiverged(
                f"loss non-finite at {self._nonfinite_streak} consecutive "
                f"log points (step {self.step})")

    def evaluate(self, eval_batches: List[Dict[str, Any]]) -> float:
        losses = [float(self._eval_loss(b)) for b in eval_batches]
        return sum(losses) / max(len(losses), 1)

    def train(self, next_batch: Callable[[], Dict[str, Any]],
              eval_batches: Optional[List[Dict[str, Any]]] = None) -> Dict:
        t = self.tcfg
        t0 = time.time()
        while self.step < t.steps:
            loss, self.lora, self.opt_state = self._train_step(
                self.frozen, self.lora, self.opt_state, next_batch())
            self.step += 1
            if self.step % 10 == 0 or self.step == 1:
                # splint: ignore[trace-safety] -- 1-in-10 gated metrics sync
                loss_val = float(loss)
                self._log({"kind": "train", "loss": loss_val})
                self._check_finite(loss_val)
            if eval_batches and t.eval_every \
                    and self.step % t.eval_every == 0:
                self._log({"kind": "eval",
                           "loss": self.evaluate(eval_batches)})
            if t.checkpoint_every and self.step % t.checkpoint_every == 0:
                self.save()
        self.save()
        train_losses = [m["loss"] for m in self.metrics
                        if m["kind"] == "train"]
        return {"final_loss": train_losses[-1] if train_losses else None,
                "steps_per_sec": self.step / max(time.time() - t0, 1e-9),
                "metrics": self.metrics}
