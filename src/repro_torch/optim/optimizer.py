"""Minimal optax-style optimizers over nested dicts of tensors.

Pure functions, as in the reference: ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``, ``apply_updates``.
Nothing is updated in place — ``SplitFineTuner`` rolls a round back by
keeping references to the old ``(lora, opt_state)`` — and nothing carries
autograd history. LoRA-only masking is structural: the trainable tree *is*
the LoRA tree, so the frozen backbone never enters the optimizer. The
schedules and the bias corrections are f32 tensors, ``step`` an int32
tensor, the Adam moments f32, each update cast to its parameter's dtype.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map

Schedule = Callable[[torch.Tensor], torch.Tensor]


def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1
                    ) -> Schedule:
    def fn(step):
        t = torch.clamp(step / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return fn


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1) -> Schedule:
    cos = cosine_schedule(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        warm = lr * step / max(warmup, 1)
        return torch.where(step < warmup, warm, cos(step - warmup))
    return fn


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def _step_zero(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def sgd(schedule: Schedule, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mu": tree_map(torch.zeros_like, params),
                "step": _step_zero(params)}

    @torch.no_grad()
    def update(grads, state, params):
        del params
        step = state["step"] + 1
        lr = schedule(step)
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        updates = tree_map(lambda m: -lr * m, mu)
        return updates, {"mu": mu, "step": step}

    return Optimizer(init, update)


def adamw(schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": _step_zero(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr = schedule(step)
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)

        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(
            lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.to(torch.float32)),
            state["v"], grads)

        def upd(m_, v_, p):
            mhat = m_ / bc1
            vhat = v_ / bc2
            u = -lr * (mhat / (torch.sqrt(vhat) + eps)
                       + weight_decay * p.to(torch.float32))
            return u.to(p.dtype)

        updates = tree_map(upd, m, v, params)
        return updates, {"m": m, "v": v, "step": step}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    """New leaves ``p + u``; ``params`` and ``updates`` are left as they
    were."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
