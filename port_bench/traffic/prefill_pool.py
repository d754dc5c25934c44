"""Driver of the prefill pool: a closed loop of clients, each of which sends
its next prompt when the last one got its first token, into the port's
``ServingEngine`` with chunked prefill and the LoRA kernels on.

A mix file gives the clients, the engine's slots, chunk and cache length,
the prompts' lengths in whole chunks (each block of requests holds every
length in fixed numbers, in an order drawn from the seed, so that every
seed sends the same work), the new tokens a request asks for, and the
tenant adapters a request's adapter is drawn from (Zipf).

The window runs whole engine ticks. Once it has closed, a sample of the
requests it served (the last one in each slot, whose K / V the slot still
holds, and more drawn from the seed, the longest length among them) is
run through the plain reference: each served token's logit below the
reference's best, the logits the engine took that token from against the
reference's, and each layer's K / V in the slots against the reference's.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import clock, harness, roofline, spec, weights
from port_bench.flops import prefill_pool as flops
from port_bench.reference import model as ref
from port_bench.trace import Trace, span

#: seconds of the traced segment that follows the window in a traced run
TRACE_S = 4.0


class Requests:
    """The seeded stream of requests."""

    def __init__(self, mix: Dict, vocab: int, seed: int, stream: int = 0):
        self.rng = spec.rng(seed, spec.REQUESTS, stream)
        self.chunk = int(mix["prefill_chunk"])
        self.block = [int(c) for c, k in zip(mix["chunk_counts"],
                                             mix["per_block"])
                      for _ in range(int(k))]
        ranks = np.arange(1, int(mix["adapters"]) + 1, dtype=np.float64)
        p = ranks ** -float(mix["adapter_zipf_s"])
        self.adapter_p = p / p.sum()
        self.vocab = vocab
        self.max_new = int(mix["max_new"])
        self.pending: List[int] = []
        self.uid = 0

    def make(self, chunks: int):
        from repro_torch.serving.engine import Request
        self.uid += 1
        prompt = self.rng.integers(0, self.vocab, size=chunks * self.chunk,
                                   dtype=np.int32)
        aid = int(self.rng.choice(len(self.adapter_p), p=self.adapter_p))
        return Request(uid=self.uid, prompt=prompt, max_new=self.max_new,
                       adapter_id=aid)

    def next(self):
        if not self.pending:
            self.pending = [int(c) for c in self.rng.permutation(self.block)]
        return self.make(self.pending.pop())


class Logits:
    """Keeps, by request, the logits the engine took each first token from:
    its last prefill chunk's, as the engine's own ``_prefill`` returned them
    (no copy, no synchronisation). Wraps the engine instance's calls."""

    def __init__(self, eng):
        self.by_uid: Dict[int, torch.Tensor] = {}
        prefill, prefill_slot = eng._prefill, eng._prefill_slot
        last: Dict[int, torch.Tensor] = {}

        def watched_prefill(toks, slot, t0, aid):
            last[slot] = out = prefill(toks, slot, t0, aid)
            return out

        def watched_prefill_slot(slot_idx, slot, req):
            prefill_slot(slot_idx, slot, req)
            if slot_idx in last:
                self.by_uid[req.uid] = last.pop(slot_idx)

        eng._prefill = watched_prefill
        eng._prefill_slot = watched_prefill_slot


def _loop(eng, reqs: Requests, until, lanes=()) -> List:
    """Ticks while ``until()``; each finished request's client sends the
    next. Returns the lanes of the last tick: [(slot, request)] (``lanes``
    where no tick ran)."""
    lanes = list(lanes)
    while until():
        before = len(eng.completed)
        with span("engine.tick"):
            eng.tick()
        done = eng.completed[before:]
        # every slot is free at a tick's start, and _admit fills them in
        # order: the i-th request admitted (and, at one new token, finished)
        # in a tick holds slot i
        lanes = list(enumerate(done))
        for _ in done:
            eng.submit(reqs.next())
    return lanes


def lora_shapes(cfg, m: int):
    """(name, M, K, N, r) of each projection's ``lora_matmul`` call."""
    w = weights.widths(cfg)
    return [(p, m, w[i], w[o], cfg.lora.rank)
            for p, (_, i, o) in weights.PROJECTIONS.items()]


def time_lora(cfg, m: int, device) -> List[Dict]:
    """The port's public ``lora_matmul`` at each projection's shape over
    ``m`` rows, bf16, timed by graph replay with W past the L2 cache;
    beside each, the least time the H100 could take by the benchmark's own
    operations and bytes."""
    from repro_torch.kernels.lora_matmul import lora_matmul
    gen = torch.Generator(device=device).manual_seed(0)
    dt = getattr(torch, cfg.dtype)
    rows = []
    for name, mm, k, n, r in lora_shapes(cfg, m):
        x = torch.randn((mm, k), generator=gen, device=device).to(dt)
        a = (torch.randn((k, r), generator=gen, device=device)
             / math.sqrt(k)).to(dt)
        b = (torch.randn((r, n), generator=gen, device=device)
             * weights.B_STD).to(dt)
        copies = max(1, min(16, math.ceil(128e6 / (k * n * 2))))
        ws = [(torch.randn((k, n), generator=gen, device=device)
               / math.sqrt(k)).to(dt) for _ in range(copies)]
        with torch.no_grad():
            t = clock.time_cuda([lambda w=w: lora_matmul(x, w, a, b, 2.0)
                                 for w in ws])
        ops = 2.0 * mm * k * n + 2.0 * mm * k * r + 2.0 * mm * r * n
        nbytes = 2.0 * (mm * k + k * n + k * r + r * n + mm * n)
        bound, by = roofline.bound_s(ops, nbytes, cfg.dtype)
        rows.append({"name": name, "shape": [mm, k, n, r], "time_s": t,
                     "bound_s": bound, "by": by, "calls_per_chunk":
                     cfg.n_layers})
        del ws, x, a, b
    return rows


def run(r) -> Dict:
    from repro_torch.serving.engine import AdapterBank, ServingEngine
    mix, cfg, dev = r.cell.mix, r.cfg, r.device
    chunk = int(mix["prefill_chunk"])
    if int(mix["max_new"]) != 1:
        raise ValueError("the prefill pool serves one new token a request: "
                         "each tick then frees every slot it fills, which "
                         "is what ties a slot's K / V to its request")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    frozen = weights.make_frozen(cfg, r.seed, dev)
    stack = weights.make_adapters(cfg, r.seed, dev, int(mix["adapters"]),
                                  spec.ADAPTERS)
    bank = AdapterBank([weights.adapter(stack, e)
                        for e in range(int(mix["adapters"]))])
    eng = ServingEngine(cfg, frozen, bank, slots=int(mix["slots"]),
                        max_len=int(mix["max_len"]), prefill_chunk=chunk,
                        use_lora_kernel=True, device=dev)
    del bank
    # warm-up: one request of each length the mix sends
    warm = Requests(mix, cfg.vocab_size, r.seed, stream=1)
    for c in sorted(set(int(c) for c in mix["chunk_counts"])):
        eng.submit(warm.make(c))
        eng.tick()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - r.t_start

    # ---- the window -------------------------------------------------------
    reqs = Requests(mix, cfg.vocab_size, r.seed)
    kept = Logits(eng)
    first = len(eng.completed)
    prefills0 = eng.prefills
    win = clock.Window(r.seconds).open()
    for _ in range(int(mix["clients"])):
        eng.submit(reqs.next())
    lanes = _loop(eng, reqs, win.running)
    window_s = win.close(dev)
    served = eng.completed[first:]
    window_prefills = eng.prefills - prefills0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    rec: Dict = {"memory_peak_bytes": peak, "notes": {}}
    in_window = [q for q in served if q.first_token_at is not None
                 and q.first_token_at <= win.wall_close]
    ttfts = [q.first_token_at - q.submitted_at for q in in_window]
    tokens = sum(len(q.prompt) for q in in_window)
    rec["e2e"] = {"prefill_tokens_per_s": tokens / window_s,
                  "setup_s": setup_s}
    rec["attempted"] = len(served)
    rec["failed"] = sum(1 for q in served if not q.output)
    window_ops = sum(flops.request_ops(r.dims, r.rank, len(q.prompt), chunk)
                     for q in in_window)
    rec["layer"] = {
        "window_s": window_s, "window_ops": window_ops, "ttfts": ttfts,
        "window_prefills": window_prefills,
        "queue_waits": [q.admitted_at - q.submitted_at for q in in_window]}
    rec["notes"].update(
        requests=len(in_window), prompt_tokens=tokens, window_s=window_s,
        prefills=window_prefills, ttft_samples=len(ttfts),
        ttft_p50_s=float(np.median(ttfts)) if ttfts else None)

    # ---- the traced segment, the kernel's roofline --------------------------
    if r.trace:
        p0 = eng.prefills
        with Trace(dev) as tr:
            t_end = time.perf_counter() + min(TRACE_S, r.seconds)
            lanes = _loop(eng, reqs, lambda: time.perf_counter() < t_end,
                          lanes)
        served = eng.completed[first:]
        rec["trace"] = tr.summary
        rec["layer"]["trace_prefills"] = eng.prefills - p0
        rec["notes"]["trace_read_s"] = tr.read_s
        if dev.type == "cuda":
            rec["layer"]["lora"] = time_lora(cfg, chunk, dev)

    # ---- the check, once the window has closed ------------------------------
    cache = eng.cache
    del eng
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    picked = sample(r, lanes, served)
    sides = {"program": Engine(cache, lanes, kept.by_uid, picked,
                               cfg.vocab_size)}
    if r.control and lanes:
        sides["control"] = reference_side(r, frozen, stack, picked,
                                          len(lanes), ref.fp8)
        sides["token_altered"] = Altered(sides["program"])
    got, seen = check(r, frozen, stack, picked, lanes, sides)
    rec["notes"].update(seen, check_s=time.perf_counter() - t)
    rec["checks"], rest = harness.compared(got.pop("program"),
                                           r.cell.workload["limits"])
    if rest:
        rec["notes"]["not_compared"] = rest
    if got:
        rec["notes"]["sides"] = got
    return rec


def sample(r, lanes, served) -> List:
    """The requests the reference runs: the last one in each slot, then
    ones drawn from the seed among the served, the longest length first."""
    picked = [q for _, q in lanes]
    taken = {q.uid for q in picked}
    rest = [q for q in served if q.output and q.uid not in taken]
    if not rest:
        return picked
    rng = spec.rng(r.seed, spec.SAMPLE)
    longest = max(len(q.prompt) for q in rest)
    if all(len(q.prompt) < longest for q in picked):
        tops = [q for q in rest if len(q.prompt) == longest]
        picked.append(tops[int(rng.integers(len(tops)))])
        taken.add(picked[-1].uid)
    extra = int(r.cell.mix["sample_requests"]) - (len(picked) - len(lanes))
    pool = [q for q in rest if q.uid not in taken]
    for i in rng.permutation(len(pool))[:max(0, extra)]:
        picked.append(pool[int(i)])
    return picked


class Engine:
    """The program's side of the check: each sampled request's served token
    and the logits it was taken from, and the K / V in the slots."""

    def __init__(self, cache, lanes, logits, picked, vocab: int):
        self.cache, self.lanes, self.vocab = cache, lanes, vocab
        self.picked, self.logits_by_uid = picked, logits

    def token(self, j: int):
        out = self.picked[j].output
        return int(out[0]) if out else None

    def logits(self, j: int):
        lg = self.logits_by_uid.get(self.picked[j].uid)
        return None if lg is None else lg.reshape(-1)[:self.vocab]

    def kv(self, j: int, i: int, n: int):
        slot = self.lanes[j][0]
        return (self.cache["kv"]["k"][i, slot, :n],
                self.cache["kv"]["v"][i, slot, :n])


class Altered(Engine):
    """The program's side with each served token replaced by the next id,
    as a fault where the token is produced would."""

    def __init__(self, side: Engine):
        self.__dict__.update(side.__dict__)

    def token(self, j: int):
        t = super().token(j)
        return None if t is None else (t + 1) % self.vocab


class Reference:
    """The plain reference in the program's place, computed with ``rnd``:
    its own greedy tokens, its logits and the lanes' K / V."""

    def __init__(self, logits, kv):
        self.logits_, self.kv_ = logits, kv

    def token(self, j: int):
        return int(self.logits_[j].argmax())

    def logits(self, j: int):
        return self.logits_[j]

    def kv(self, j: int, i: int, n: int):
        return self.kv_[(j, i)]


def reference_side(r, frozen, stack, picked, lanes: int, rnd) -> Reference:
    kv = {}

    def keep(j, i, k, v):
        if j < lanes:
            kv[(j, i)] = (k, v)

    ref.no_tf32()
    with torch.no_grad():
        logits = ref.prefill(frozen, _prompts(picked),
                             _adapters(stack, picked), r.dims, rnd, keep)
    return Reference(logits, kv)


def _prompts(picked):
    return [torch.as_tensor(q.prompt, dtype=torch.long) for q in picked]


def _adapters(stack, picked):
    return [weights.adapter(stack, q.adapter_id) for q in picked]


def _worst(values) -> float:
    """The largest, where a value that is not finite counts as infinite."""
    return max((v if math.isfinite(v) else math.inf for v in values),
               default=math.inf)


def check(r, frozen, stack, picked, lanes, sides):
    """({side: the numbers compared}, notes). ``served_gap``: the widest gap
    by which a served token's logit lies below the reference's best;
    ``served_logit_err``: the largest |logit - reference logit| at a served
    position; ``kv_rel_err``: the largest relative distance (Frobenius) of
    a layer's K or V in a slot from the reference's. ``picked`` begins with
    the requests that ``lanes`` hold, in their order."""
    if not lanes:
        # no slot holds a request the window served: nothing to compare
        return {name: {"served_gap": math.inf, "served_logit_err": math.inf,
                       "kv_rel_err": math.inf} for name in sides}, {}
    ref.no_tf32()
    kv_errs = {name: [0.0] for name in sides}

    def on_kv(j, i, k, v):
        if j >= len(lanes):
            return
        n = len(picked[j].prompt)
        scales = [torch.linalg.vector_norm(t).item() for t in (k, v)]
        for name, side in sides.items():
            for got, want, scale in zip(side.kv(j, i, n), (k, v), scales):
                err = torch.linalg.vector_norm(got.float() - want).item()
                kv_errs[name].append(err / max(scale, 1e-30))

    with torch.no_grad():
        logits = ref.prefill(frozen, _prompts(picked),
                             _adapters(stack, picked), r.dims, ref.exact,
                             on_kv)
    out = {}
    for name, side in sides.items():
        gaps, errs = [], []
        for j, want in enumerate(logits):
            tok, got = side.token(j), side.logits(j)
            gaps.append(math.inf if tok is None
                        else (want.max() - want[tok]).item())
            errs.append(math.inf if got is None else
                        (got.float().to(want.device) - want).abs().max()
                        .item())
        out[name] = {"served_gap": _worst(gaps),
                     "served_logit_err": _worst(errs),
                     "kv_rel_err": _worst(kv_errs[name])}
    tops = [lg.topk(2).values for lg in logits]
    return out, {"reference_top2_margin_min":
                 min((t[0] - t[1]).item() for t in tops)}
