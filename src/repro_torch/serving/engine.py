"""Multi-tenant continuous-batching serving engine over the cached decode path.

Deploys the SL-fine-tuned *fleet*: a fixed pool of batch slots shares one
stacked KV cache and ONE frozen backbone, while every slot decodes with its
own LoRA adapter — the fleet's adapters are stacked into an
``(n_adapters, ...)`` bank and each slot's pair is gathered per tick
(``AdapterBank``), so one tick serves N users x N adapters.

Per-tick work is a single ``decode_step`` with a per-slot position vector;
prompt chunks are consumed by a multi-token prefill (``model.prefill_chunk``)
before the slot joins the decode pool, so TTFT does not scale as
``len(prompt) x tick_latency``.

Slot recycling is lazy and copy-free: stale KV lanes are hidden by the
causal/ring position masks (a request at position t only ever attends lanes
it has itself written). Admission never touches the cache.

The cache is updated IN PLACE: a tick writes every slot's new K/V into the
shared cache, and a prefill chunk writes into a view of its own slot's lane,
so there is nothing to write back and the other lanes are never touched.
Copying the logits to the host (``.cpu()``) is the one synchronisation of a
tick.

Admission can be gated by a channel-aware controller
(``repro_torch.serving.admission``) so serving and SL training share the
edge bandwidth budget.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.models.common import (Params, dtype_of, resolve_device,
                                       tree_leaves, tree_map, tree_structure)


class AdapterBank:
    """The fleet's LoRA adapters stacked into one ``(n_adapters, ...)`` tree.

    All adapters must share one tree structure and per-leaf shape (they come
    from the same ``init_params`` config, fine-tuned per device). ``stacked``
    leaves are ``(n_adapters, n_layers, ...)``; ``gather(ids)`` returns the
    per-row adapter tree ``decode_step`` consumes (leaves
    ``(n_layers, B, ...)`` so the layer loop slices to ``(B, ...)`` and
    every LoRA matmul batch-broadcasts row-wise).
    """

    def __init__(self, adapters: Sequence[Params]):
        adapters = list(adapters)
        if not adapters:
            raise ValueError("AdapterBank needs at least one adapter")
        ref = tree_structure(adapters[0])
        for i, a in enumerate(adapters[1:], start=1):
            if tree_structure(a) != ref:
                raise ValueError(
                    f"adapter {i} tree structure differs from adapter 0")
        self.n = len(adapters)
        self.stacked: Params = tree_map(lambda *xs: torch.stack(xs), *adapters)

    @staticmethod
    def gather(stacked: Params, ids: torch.Tensor) -> Params:
        """stacked["layers"] leaves (E, n_layers, ...) + ids (B,) ->
        {"layers": leaves (n_layers, B, ...)} (views of one gathered copy)."""
        idx = ids.to(torch.long)
        return {"layers": tree_map(lambda v: v[idx].movedim(0, 1),
                                   stacked["layers"])}


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (S0,) int32 tokens
    max_new: int
    adapter_id: int = 0                 # index into the engine's AdapterBank
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    truncated: bool = False             # max_new clipped at submit()

    @property
    def done(self) -> bool:
        return self.finished_at is not None


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    pos: int = 0                        # next absolute position to write
    fed: int = 0                        # prompt tokens consumed

    @property
    def free(self) -> bool:
        return self.request is None


class ServingEngine:
    """Greedy continuous batching; one decode_step per tick for all slots.

    ``lora`` may be a single adapter tree, a list of adapter trees, or an
    ``AdapterBank`` — requests pick theirs via ``Request.adapter_id``.

    ``on_overflow`` decides what ``submit`` does with a request whose
    ``len(prompt) + max_new`` exceeds ``max_len``: ``"reject"`` raises,
    ``"truncate"`` clips ``max_new`` and sets ``Request.truncated``.

    ``device=None`` means the GPU and raises without one; the parameters
    must already lie on that device.
    """

    def __init__(self, cfg: ModelConfig, frozen: Params,
                 lora: Union[Params, Sequence[Params], AdapterBank, None],
                 *, slots: int = 4, max_len: int = 256,
                 eos_id: Optional[int] = None, prefill_chunk: int = 16,
                 admission=None, on_overflow: str = "reject",
                 use_lora_kernel: bool = False, device=None):
        if on_overflow not in ("reject", "truncate"):
            raise ValueError("on_overflow must be 'reject' or 'truncate'")
        self.device = resolve_device(device)
        if frozen["embed"].device.type != self.device.type:
            raise ValueError(
                f"parameters lie on {frozen['embed'].device}, the engine was "
                f"asked to run on {self.device}")
        self.cfg = cfg
        self.frozen = frozen
        if lora is None:
            self.bank: Optional[AdapterBank] = None
        elif isinstance(lora, AdapterBank):
            self.bank = lora
        elif isinstance(lora, (list, tuple)):
            self.bank = AdapterBank(lora)
        else:
            self.bank = AdapterBank([lora])
        self.n_adapters = 0 if self.bank is None else self.bank.n
        # the bank in the activation dtype, cast once here instead of once
        # per projection per tick (the same rounding either way)
        act = dtype_of(cfg.dtype)
        self._stacked: Optional[Params] = None if self.bank is None else \
            tree_map(lambda v: v.to(act), self.bank.stacked)
        self.n_slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.admission = admission
        self.on_overflow = on_overflow
        self.use_lora_kernel = use_lora_kernel
        self.cache = model_lib.init_cache(cfg, slots, max_len,
                                          device=self.device)
        self.slots = [_Slot() for _ in range(slots)]
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        self.ticks = 0
        self.prefills = 0

        # chunked prefill: parallel cache-writing forward. It writes a
        # chunk's K/V in one scatter, so a chunk must fit in the cache ring
        # (chunk <= slot count of the KV cache).
        self._chunk = 0
        if prefill_chunk > 1 and cfg.input_mode == "tokens":
            kv_slots = int(tree_leaves(self.cache["kv"])[0].shape[2])
            self._chunk = min(prefill_chunk, kv_slots)
            if self._chunk < 2:
                self._chunk = 0

    @staticmethod
    def _lazy_ssm_reset(cache: Params, keep: torch.Tensor) -> Params:
        """KV lanes need no reset at all: the causal/ring position masks in
        ``attention_decode`` only expose lanes the current request has
        itself written. A cache without SSM state passes unchanged; the SSM
        families are not ported yet."""
        if "ssm" not in cache:
            return cache
        raise NotImplementedError(
            "SSM state in the serving cache: ROADMAP.md Queue 1, the SSM "
            "and hybrid families item")

    @torch.no_grad()
    def _step(self, toks: np.ndarray, ts: np.ndarray, ids: np.ndarray
              ) -> torch.Tensor:
        """One decode step over all slots; returns the logits on the card."""
        dev = self.device
        ts_d = torch.as_tensor(ts, device=dev)
        lora_b = None
        if self._stacked is not None:
            lora_b = AdapterBank.gather(self._stacked,
                                        torch.as_tensor(ids, device=dev))
        self.cache = self._lazy_ssm_reset(self.cache, ts_d != 0)
        logits, self.cache = model_lib.decode_step(
            self.frozen, lora_b, self.cache, torch.as_tensor(toks, device=dev),
            ts_d, self.cfg, use_lora_kernel=self.use_lora_kernel)
        return logits

    @torch.no_grad()
    def _prefill(self, toks: np.ndarray, slot: int, t0: int, aid: int
                 ) -> torch.Tensor:
        """Run one chunk on ONE slot's lane: the lane is a view of the
        shared cache, so the chunk's K/V land in place and the other slots'
        in-flight lanes are never touched."""
        lane = tree_map(lambda c: c[:, slot:slot + 1], self.cache)
        lane = self._lazy_ssm_reset(
            lane, torch.as_tensor([t0 != 0], device=self.device))
        lora_b = None
        if self._stacked is not None:
            lora_b = {"layers": tree_map(lambda v: v[aid],
                                         self._stacked["layers"])}
        logits, _ = model_lib.prefill_chunk(
            self.frozen, lora_b, lane,
            torch.as_tensor(toks, device=self.device), t0, self.cfg,
            use_lora_kernel=self.use_lora_kernel)
        return logits

    # --- API -------------------------------------------------------------

    def submit(self, req: Request) -> None:
        if self.bank is not None and not (0 <= req.adapter_id < self.bank.n):
            raise ValueError(
                f"request {req.uid}: adapter_id {req.adapter_id} out of "
                f"range for a bank of {self.bank.n}")
        need = len(req.prompt) + req.max_new
        if need > self.max_len:
            if self.on_overflow == "truncate":
                clipped = self.max_len - len(req.prompt)
                if clipped <= 0:
                    raise ValueError(
                        f"request {req.uid}: prompt of {len(req.prompt)} "
                        f"tokens alone exceeds max_len={self.max_len}")
                req.max_new = clipped
                req.truncated = True
            else:
                raise ValueError(
                    f"request {req.uid}: len(prompt) + max_new = {need} "
                    f"exceeds max_len = {self.max_len}; decode past the "
                    "cache end would corrupt the last cache lane "
                    "(on_overflow='truncate' clips instead)")
        req.submitted_at = time.time()
        if self.admission is not None:
            self.admission.register(req)
        self.queue.append(req)

    def _admit(self) -> None:
        for slot_idx, slot in enumerate(self.slots):
            if not slot.free or not self.queue:
                continue
            req = self.queue[0]
            now = time.time()
            if self.admission is not None \
                    and not self.admission.try_admit(req, now):
                break                   # FIFO: head-of-line blocks the rest
            self.queue.pop(0)
            req.admitted_at = now
            slot.request = req
            slot.pos = 0
            slot.fed = 0
            # NO cache reset here (see _lazy_ssm_reset) — admission is O(1).
            self._prefill_slot(slot_idx, slot, req)

    def _prefill_slot(self, slot_idx: int, slot: _Slot, req: Request) -> None:
        """Consume all full prompt chunks in multi-token steps; any ragged
        tail is fed token-by-token by the decode tick."""
        if not self._chunk:
            return
        n_full = len(req.prompt) // self._chunk
        if n_full == 0:
            return
        logits = None
        for ci in range(n_full):
            lo = ci * self._chunk
            toks = np.asarray(req.prompt[lo:lo + self._chunk],
                              np.int32)[None, :]
            logits = self._prefill(toks, slot_idx, slot.pos, req.adapter_id)
            slot.pos += self._chunk
            slot.fed += self._chunk
            self.prefills += 1
        if slot.fed == len(req.prompt):
            # the whole prompt was chunk-consumed: the first output token
            # comes straight from the prefill logits (this is the TTFT win)
            nxt = int(np.argmax(
                logits.cpu().numpy()[0, :self.cfg.vocab_size]))
            self._emit(slot, req, nxt, time.time())

    def _emit(self, slot: _Slot, req: Request, nxt: int, now: float) -> None:
        """Record one generated token and retire the request when done."""
        if req.first_token_at is None:
            req.first_token_at = now
        req.output.append(nxt)
        hit_eos = self.eos_id is not None and nxt == self.eos_id
        if len(req.output) >= req.max_new or hit_eos \
                or slot.pos >= self.max_len - 1:
            req.finished_at = now
            self.completed.append(req)
            slot.request = None
            if self.admission is not None:
                self.admission.release(req, now)

    def tick(self) -> int:
        """One engine step; returns number of active slots."""
        self._admit()
        active = [s for s in self.slots if not s.free]
        if not active:
            return 0

        toks = np.zeros((self.n_slots, 1), np.int32)
        ts = np.zeros((self.n_slots,), np.int32)
        ids = np.zeros((self.n_slots,), np.int32)
        for i, slot in enumerate(self.slots):
            if slot.free:
                continue
            req = slot.request
            if slot.fed < len(req.prompt):
                toks[i, 0] = int(req.prompt[slot.fed])      # prompt feed
            elif req.output:
                toks[i, 0] = req.output[-1]                  # autoregressive
            ts[i] = slot.pos
            ids[i] = req.adapter_id

        # the copy to the host is the tick's one synchronisation
        logits = self._step(toks, ts, ids).cpu().numpy()
        now = time.time()

        for i, slot in enumerate(self.slots):
            if slot.free:
                continue
            req = slot.request
            slot.pos += 1
            if slot.fed < len(req.prompt):
                slot.fed += 1
                if slot.fed < len(req.prompt):
                    continue            # still consuming the prompt
            nxt = int(np.argmax(logits[i, :self.cfg.vocab_size]))
            self._emit(slot, req, nxt, now)
        self.ticks += 1
        return len(active)

    def run_until_drained(self, max_ticks: int = 10_000) -> Dict[str, Any]:
        t0 = time.time()
        while (self.queue or any(not s.free for s in self.slots)) \
                and self.ticks < max_ticks:
            n = self.tick()
            if n == 0 and self.queue:
                # nothing in flight and the admission controller refused the
                # head of the queue: no future tick can make progress
                break
        return self._summary(time.time() - t0)

    def _summary(self, wall_s: float) -> Dict[str, Any]:
        toks = sum(len(r.output) for r in self.completed)
        in_flight = sum(not s.free for s in self.slots)
        ttfts = [r.first_token_at - r.submitted_at for r in self.completed
                 if r.first_token_at is not None]
        stats: Dict[str, Any] = {
            "completed": len(self.completed),
            "ticks": self.ticks,
            "prefills": self.prefills,
            "tokens": toks,
            "tokens_per_sec": toks / max(wall_s, 1e-9),
            "requests_per_s": len(self.completed) / max(wall_s, 1e-9),
            "mean_ttft_s": float(np.mean(ttfts)) if ttfts else None,
            "drained": not self.queue and in_flight == 0,
            "pending": {"queued": len(self.queue), "in_flight": in_flight},
            "wall_s": wall_s,
        }
        if self.admission is not None:
            stats["admission"] = self.admission.stats()
        return stats
