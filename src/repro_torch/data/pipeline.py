"""Data pipeline: per-device non-IID token streams (the paper's
"geo-distributed personal data"), deterministic and shardable.

The synthetic LM task is *learnable* (a noisy Markov chain per device with a
shared global transition structure), so SL fine-tuning convergence (Eq. 1)
is measurable: loss under the fine-tuned adapters must drop below the
frozen-backbone loss. For the 'embeds' frontends (audio/VLM) the pipeline
emits precomputed frame/patch embeddings per DESIGN.md.

A near-verbatim copy of the JAX package's pipeline in numpy, so the
batches of a seed are bit-identical to the reference's. Batches are numpy;
``models.common.batch_to_device`` moves them to the card. ``batch_specs``
gives the dry run's stand-ins: tensors on ``meta``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig


def synthetic_lm_task(vocab: int, *, seed: int = 0, order_bias: float = 9.0
                      ) -> np.ndarray:
    """A global transition matrix shared by all devices (the 'task').

    The dominant structure is a *seeded successor permutation* — different
    seeds are genuinely different languages, so fine-tuning on a new seed is
    a real domain shift for the LoRA adapters (the paper's premise: a
    pre-trained LLM adapted to geo-distributed personal data)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(vocab, vocab))
    idx = np.arange(vocab)
    successor = rng.permutation(vocab)
    logits[idx, successor] += order_bias
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


@dataclasses.dataclass
class DeviceDataset:
    """D_m: local dataset of device m (Sec. II-A)."""
    device_id: int
    cfg: ModelConfig
    transition: np.ndarray
    size: int
    seed: int
    noise: float = 0.1         # device-specific label noise => non-IID

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def _sample_tokens(self, batch: int, seq_len: int) -> np.ndarray:
        v = self.transition.shape[0]
        out = np.empty((batch, seq_len + 1), np.int32)
        state = self._rng.integers(0, v, size=batch)
        out[:, 0] = state
        for t in range(1, seq_len + 1):
            u = self._rng.random(batch)
            cdf = np.cumsum(self.transition[state], axis=-1)
            state = (u[:, None] < cdf).argmax(-1)
            flip = self._rng.random(batch) < self.noise
            state = np.where(flip, self._rng.integers(0, v, batch), state)
            out[:, t] = state
        return out

    def minibatch(self, batch: int, seq_len: int) -> Dict[str, np.ndarray]:
        """H_{m,n}(t): one mini-batch draw (stage 3, device-side FP)."""
        toks = self._sample_tokens(batch, seq_len)
        ex: Dict[str, np.ndarray] = {
            "labels": toks[:, 1:].astype(np.int32)}
        if self.cfg.input_mode == "embeds":
            # stubbed modality frontend: deterministic embedding of tokens
            d = self.cfg.d_model
            emb_rng = np.random.default_rng(hash((self.seed, "frontend")) % 2**31)
            table = emb_rng.normal(size=(self.transition.shape[0], d)).astype(
                np.float32) * 0.02
            ex["embeds"] = table[toks[:, :-1]]
        else:
            ex["tokens"] = toks[:, :-1].astype(np.int32)
        return ex


def make_fleet_datasets(cfg: ModelConfig, n_devices: int, *, vocab: int = 0,
                        seed: int = 0, sizes: Optional[List[int]] = None
                        ) -> List[DeviceDataset]:
    v = vocab or min(cfg.vocab_size, 512)
    trans = synthetic_lm_task(v, seed=seed)
    sizes = sizes or [2000 + 500 * i for i in range(n_devices)]
    return [DeviceDataset(device_id=m, cfg=cfg, transition=trans,
                          size=sizes[m], seed=seed + 101 * (m + 1),
                          noise=0.05 + 0.03 * m)
            for m in range(n_devices)]


def batch_specs(cfg: ModelConfig, shape: InputShape, cut: int = 0
                ) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input (the reference's
    ShapeDtypeStructs; nothing allocated). ``cut > 0`` (train): the job is
    the SL *server side* — its input is the phi-compressed smashed data at
    the cut, not raw tokens."""
    b, s = shape.global_batch, shape.seq_len

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind == "train" and cut > 0:
        return {"smashed": spec((b, s, cfg.d_model), torch.bfloat16),
                "labels": spec((b, s), torch.int32)}
    if shape.kind in ("train", "prefill"):
        if cfg.input_mode == "embeds":
            inputs = {"embeds": spec((b, s, cfg.d_model), torch.bfloat16)}
        else:
            inputs = {"tokens": spec((b, s), torch.int32)}
        if shape.kind == "train":
            inputs["labels"] = spec((b, s), torch.int32)
        return inputs
    # decode: one new token against a cache of seq_len
    if cfg.input_mode == "embeds":
        return {"embeds": spec((b, 1, cfg.d_model), torch.bfloat16)}
    return {"tokens": spec((b, 1), torch.int32)}
