#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # everything (needs one CUDA device)
    python3 chip_smoke.py --only kernels   # build + kernel checks only

Phases, each of which raises (and so exits non-zero) on failure:

  device   the card's name and power limit, torch and CUDA versions
  build    nvcc builds ``src/repro_torch/csrc/*.cu`` from the checkout
  kernels  every hand-written kernel against its plain PyTorch version on
           the card (main-path shapes and ragged ones, bf16 and f32), then
           timed with CUDA events beside the plain version, one PyTorch
           library call for the same function, and the card's bound
  serve    full-width llama32-1b (32 layers, random weights from a seed),
           four non-zero LoRA adapters, ``ServingEngine`` with the fused
           kernels answering 16 requests; launch counts, tokens, logits
           against the port's own plain LoRA path
  prefill  ``make_prefill_step(impl="flash")`` on (4, 1024) tokens against
           ``impl="naive"``

It imports ``repro_torch`` only (never JAX), needs no network, and prints
one JSON object per line; the line before the last holds the card's name and
power limit, the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# published peaks of one H100 SXM (dense): bytes/s of HBM3, FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

LORA_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}   # x max|want|
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # absolute
KN_SHAPES = ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(calls, warmup: int = 3, iters: int = 20) -> float:
    """Mean device milliseconds per call. ``calls`` is a list of thunks over
    distinct weight buffers, so that weights come from device memory and not
    from the L2 cache, as they do on the main path. One round of the calls is
    captured into a CUDA graph and the graph is replayed between two events:
    several of these kernels are shorter than the host takes to launch them,
    and an eager loop would time the host."""
    for _ in range(warmup):
        for c in calls:
            c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * len(calls))


def randn(rng, shape, dtype, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)
    ).to("cuda").to(dtype)


def n_copies(weight_bytes: int) -> int:
    """Enough distinct weight buffers to exceed the 50 MB L2 twice over."""
    return max(1, min(16, math.ceil(128e6 / max(weight_bytes, 1))))


# ---------------------------------------------------------------------------
# kernels phase
# ---------------------------------------------------------------------------


def check_lora_matmul(rng, m, k, n, r, dtype, scale=0.5):
    from repro_torch.kernels import lora_matmul as lm
    x = randn(rng, (m, k), dtype)
    w = randn(rng, (k, n), dtype)
    a = randn(rng, (k, r), dtype)
    b = randn(rng, (r, n), dtype)
    got = lm.lora_matmul(x, w, a, b, scale)
    torch.cuda.synchronize()
    want = lm.lora_matmul_ref(x, w, a, b, scale).float()
    err = (got.float() - want).abs().max().item()
    tol = LORA_TOL[dtype] * want.abs().max().item()
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(
            f"lora_matmul {(m, k, n, r)} {dtype}: max err {err} > tol {tol}")
    return err, tol


def check_grouped(rng, g, m, k, n, r, e, dtype, ids=None, scale=0.5,
                  strided=False):
    from repro_torch.kernels import lora_matmul as lm
    x = randn(rng, (g, m, k), dtype)
    w = randn(rng, (k, n), dtype)
    a = randn(rng, (e, k, r), dtype)
    b = randn(rng, (e, r, n), dtype)
    if strided:     # a bank laid out as AdapterBank.gather leaves it
        a = torch.stack([a, a], dim=1)[:, 1]
        b = torch.stack([b, b], dim=1)[:, 0]
        assert not a.is_contiguous()
    if ids is None:
        ids = rng.integers(0, e, g)
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.int32, device="cuda")
    got = lm.lora_matmul_grouped(x, w, a, b, ids, scale)
    torch.cuda.synchronize()
    want = lm.lora_matmul_grouped_ref(x, w, a, b, ids, scale).float()
    err = (got.float() - want).abs().max().item()
    tol = LORA_TOL[dtype] * want.abs().max().item()
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(
            f"lora_matmul_grouped {(g, m, k, n, r, e)} {dtype}: "
            f"max err {err} > tol {tol}")
    return err, tol


def check_flash(rng, b, sq, skv, hq, hkv, d, dtype, causal=True, window=0):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    q = randn(rng, (b, sq, hq, d), dtype)
    k = randn(rng, (b, skv, hkv, d), dtype)
    v = randn(rng, (b, skv, hkv, d), dtype)
    if causal:
        got = ops.flash_attention(q, k, v, causal=True, window=window)
    else:           # the (BH, S, D) form of the kernel's own wrapper
        got = fa.flash_attention(
            q.permute(0, 2, 1, 3).reshape(b * hq, sq, d),
            k.permute(0, 2, 1, 3).reshape(b * hkv, skv, d),
            v.permute(0, 2, 1, 3).reshape(b * hkv, skv, d),
            causal=False, window=window
        ).reshape(b, hq, sq, d).permute(0, 2, 1, 3)
    torch.cuda.synchronize()
    want = fa.flash_attention_ref(
        q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
        causal=causal, window=window).permute(0, 2, 1, 3).float()
    err = (got.float() - want).abs().max().item()
    tol = ATTN_TOL[dtype]
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(
            f"flash_attention {(b, sq, skv, hq, hkv, d)} window={window} "
            f"causal={causal} {dtype}: max err {err} > tol {tol}")
    return err, tol


def bound(bytes_moved: float, flops: float, dtype):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_lora_matmul(rng, m, k, n, r, dtype, scale=2.0):
    from repro_torch.kernels import lora_matmul as lm
    es = torch.finfo(dtype).bits // 8
    copies = n_copies(k * n * es)
    x = randn(rng, (m, k), dtype)
    ws = [randn(rng, (k, n), dtype) for _ in range(copies)]
    a = randn(rng, (k, r), dtype, 0.25)
    b = randn(rng, (r, n), dtype, 0.02)
    err, tol = check_lora_matmul(rng, m, k, n, r, dtype, scale)
    ms = time_ms([lambda w=w: lm.lora_matmul(x, w, a, b, scale) for w in ws])
    plain = time_ms([lambda w=w: lm.lora_matmul_ref(x, w, a, b, scale)
                     for w in ws], iters=5)
    lib = time_ms([lambda w=w: torch.addmm(x @ w, x @ a, b, alpha=scale)
                   for w in ws])
    bytes_moved = es * (m * k + k * n + k * r + r * n + m * n)
    flops = 2.0 * m * k * n + 2.0 * m * k * r + 2.0 * m * r * n
    b_ms, by = bound(bytes_moved, flops, dtype)
    return {"shape": {"M": m, "K": k, "N": n, "r": r}, "dtype": str(dtype),
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain,
            "library_ms": lib, "bound_ms": b_ms, "bound_by": by}


def time_grouped(rng, g, k, n, r, e, dtype, scale=2.0):
    from repro_torch.kernels import lora_matmul as lm
    es = torch.finfo(dtype).bits // 8
    copies = n_copies(k * n * es)
    x = randn(rng, (g, 1, k), dtype)
    ws = [randn(rng, (k, n), dtype) for _ in range(copies)]
    a = randn(rng, (e, k, r), dtype, 0.25)
    b = randn(rng, (e, r, n), dtype, 0.02)
    ids_np = np.arange(g) % e
    ids = torch.as_tensor(ids_np, dtype=torch.int32, device="cuda")
    idl = ids.long()
    err, tol = check_grouped(rng, g, 1, k, n, r, e, dtype, ids=ids_np,
                             scale=scale)
    calls = [lambda w=w: lm.lora_matmul_grouped(x, w, a, b, ids, scale)
             for w in ws]
    ms = time_ms(calls)
    # The same work through the kernel's first version: the launcher takes it
    # for a W that is not 16-byte aligned, so W is laid one element off.
    offs = [torch.empty(k * n + 1, dtype=dtype, device="cuda")[1:].view(k, n)
            for _ in ws]
    for off, w in zip(offs, ws):
        off.copy_(w)
    assert all(off.data_ptr() % 16 for off in offs)
    first_ms = time_ms([lambda w=w: lm.lora_matmul_grouped(x, w, a, b, ids,
                                                           scale)
                        for w in offs])
    plain = time_ms([lambda w=w: lm.lora_matmul_grouped_ref(x, w, a, b, ids,
                                                            scale)
                     for w in ws], iters=5)
    lib = time_ms([lambda w=w: torch.baddbmm(
        (x[:, 0] @ w)[:, None], torch.bmm(x, a[idl]), b[idl], alpha=scale)
        for w in ws])
    used = len(set(ids_np.tolist()))
    bytes_moved = es * (g * k + k * n + used * (k * r + r * n) + g * n) + 4 * g
    flops = g * (2.0 * k * n + 2.0 * k * r + 2.0 * r * n)
    b_ms, by = bound(bytes_moved, flops, dtype)
    return {"shape": {"G": g, "M": 1, "K": k, "N": n, "r": r, "E": e},
            "dtype": str(dtype), "max_abs_err": err, "tol": tol, "ms": ms,
            "first_version_ms": first_ms, "plain_ms": plain,
            "library_ms": lib, "bound_ms": b_ms, "bound_by": by}


def time_flash(rng, b, s, hq, hkv, d, dtype):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    es = torch.finfo(dtype).bits // 8
    q = randn(rng, (b, s, hq, d), dtype)
    k = randn(rng, (b, s, hkv, d), dtype)
    v = randn(rng, (b, s, hkv, d), dtype)
    err, tol = check_flash(rng, b, s, s, hq, hkv, d, dtype)
    ms = time_ms([lambda: ops.flash_attention(q, k, v, causal=True)],
                 iters=10)
    qp, kp, vp = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    plain = time_ms([lambda: fa.flash_attention_ref(qp, kp, vp, causal=True)],
                    iters=5)
    lib = time_ms([lambda: F.scaled_dot_product_attention(
        qp, kp, vp, is_causal=True, enable_gqa=True)], iters=10)
    pairs = s * (s + 1) // 2                      # unmasked (query, key) pairs
    bytes_moved = es * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    flops = 4.0 * d * pairs * b * hq
    b_ms, by = bound(bytes_moved, flops, dtype)
    return {"shape": {"B": b, "S": s, "Hq": hq, "Hkv": hkv, "D": d,
                      "causal": True, "window": 0},
            "dtype": str(dtype), "max_abs_err": err, "tol": tol, "ms": ms,
            "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
            "bound_by": by}


def phase_kernels(seed: int):
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: full f32
    rng = np.random.default_rng(seed)
    f32, bf16 = torch.float32, torch.bfloat16
    worst = {}

    def note(name, dtype, res):
        key = f"{name}/{str(dtype).split('.')[-1]}"
        err, tol = res
        if key not in worst or err / tol > worst[key][0] / worst[key][1]:
            worst[key] = (err, tol)

    for dtype in (f32, bf16):
        for mkn in ((37, 53, 41, 3), (33, 70, 65, 2), (100, 96, 72, 8),
                    (256, 128, 512, 16), (64, 64, 64, 4), (70, 130, 90, 20),
                    (65, 257, 129, 40), (1, 2048, 2048, 16)):
            note("lora_matmul", dtype, check_lora_matmul(rng, *mkn, dtype))
        for k, n in KN_SHAPES:
            note("lora_matmul", dtype,
                 check_lora_matmul(rng, 64, k, n, 16, dtype, 2.0))
        for gmknre in ((3, 1, 64, 48, 4, 2), (4, 8, 128, 128, 8, 4),
                       (2, 5, 100, 72, 4, 5), (6, 1, 256, 96, 16, 3),
                       (5, 3, 1100, 70, 16, 3), (9, 2, 53, 41, 3, 4),
                       # whole 16-byte vectors: the wide version's shapes
                       (5, 3, 1100, 72, 16, 3), (9, 2, 530, 40, 8, 4),
                       (3, 1, 300, 96, 32, 2), (4, 2, 130, 64, 64, 3)):
            note("lora_matmul_grouped", dtype,
                 check_grouped(rng, *gmknre, dtype))
        note("lora_matmul_grouped", dtype,
             check_grouped(rng, 8, 1, 2048, 512, 16, 4, dtype,
                           ids=[3, 3, 0, 2, 2, 2, 1, 0], strided=True))
        for k, n in KN_SHAPES:
            note("lora_matmul_grouped", dtype,
                 check_grouped(rng, 8, 1, k, n, 16, 4, dtype,
                               ids=[0, 1, 2, 3, 0, 1, 2, 3], scale=2.0))
        for args, kw in (((2, 65, 65, 4, 4, 16), {}),
                         ((2, 63, 63, 4, 4, 16), {}),
                         ((2, 130, 130, 4, 4, 16), {"window": 64}),
                         ((2, 127, 127, 4, 4, 16), {"window": 32}),
                         ((1, 65, 65, 8, 2, 16), {}),
                         ((2, 40, 40, 4, 4, 16), {}),
                         ((2, 128, 128, 8, 2, 32), {"window": 64}),
                         ((2, 200, 200, 4, 2, 64), {}),
                         ((2, 200, 200, 4, 2, 64), {"window": 64}),
                         ((2, 96, 96, 25, 5, 16), {"window": 64}),
                         ((1, 150, 150, 2, 1, 128), {}),
                         ((2, 70, 150, 4, 2, 32), {"causal": False}),
                         ((1, 1024, 1024, 32, 8, 64), {})):
            note("flash_attention", dtype,
                 check_flash(rng, *args, dtype, **kw))
    emit({"phase": "kernels", "checked": {
        k: {"max_abs_err": e, "tol": t} for k, (e, t) in worst.items()}})

    # timing at the shapes the main path gives the kernels (bf16)
    rows = {"lora_matmul": [], "lora_matmul_grouped": [], "flash_attention": []}
    for k, n in KN_SHAPES:
        rows["lora_matmul"].append(time_lora_matmul(rng, 64, k, n, 16, bf16))
        rows["lora_matmul_grouped"].append(
            time_grouped(rng, 8, k, n, 16, 4, bf16))
    rows["flash_attention"].append(time_flash(rng, 4, 1024, 32, 8, 64, bf16))
    emit({"phase": "kernel_times", "by_shape": rows})
    return rows


# ---------------------------------------------------------------------------
# serve and prefill phases
# ---------------------------------------------------------------------------


def make_adapter(cfg, seed: int, device):
    """One LoRA tree with the standard A and a seeded NON-ZERO B (std 0.02):
    the standard B = 0 would make every adapter compute the backbone."""
    from repro_torch.models import blocks
    from repro_torch.models.common import tree_map
    gen = torch.Generator(device=device).manual_seed(seed)
    layers = [blocks.init_layer_lora(gen, cfg, device)
              for _ in range(cfg.n_layers)]
    lora = {"layers": tree_map(lambda *xs: torch.stack(xs), *layers)}
    rng = np.random.default_rng(seed)
    for group in lora["layers"].values():
        for pair in group.values():
            b = rng.standard_normal(tuple(pair["b"].shape)).astype(np.float32)
            pair["b"] = torch.from_numpy(b * 0.02).to(device).to(pair["b"].dtype)
    return lora


def phase_serve_and_prefill(seed: int, n_requests: int, profile: bool):
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.models import model as M
    from repro_torch.serving import AdapterBank, Request, ServingEngine

    dev = torch.device("cuda")
    cfg = get_config("llama32-1b")
    t0 = time.time()
    params = M.init_params(seed, cfg)                # device=None: the card
    frozen = params["frozen"]
    adapters = [make_adapter(cfg, seed + 1 + i, dev) for i in range(4)]
    bank = AdapterBank(adapters)
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "seconds": time.time() - t0,
          "param_bytes": sum(x.numel() * x.element_size()
                             for x in _leaves(frozen))})

    rng = np.random.default_rng(seed)
    lens = rng.integers(70, 201, n_requests)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size, int(lens[i]),
                                        dtype=np.int64).astype(np.int32),
                    max_new=32, adapter_id=i % 4) for i in range(n_requests)]
    eng = ServingEngine(cfg, frozen, bank, slots=8, max_len=512,
                        prefill_chunk=64, use_lora_kernel=True)
    # warm-up outside the measured run: one chunk and one tick on a second
    # engine, so the run below does not pay for first-call set-up
    warm = ServingEngine(cfg, frozen, bank, slots=8, max_len=512,
                         prefill_chunk=64, use_lora_kernel=True)
    warm.submit(Request(uid=-1, prompt=reqs[0].prompt[:65].copy(), max_new=2))
    warm.run_until_drained()
    del warm
    torch.cuda.synchronize()

    # ---- the main path: counts set to 0 just before, read just after ----
    kernels.reset_launch_counts()
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    prefill_flash = make_prefill_step(cfg, impl="flash")
    tok_rng = np.random.default_rng(seed + 100)
    toks = torch.as_tensor(tok_rng.integers(0, cfg.vocab_size, (4, 1024)),
                           device=dev)
    t1 = time.time()
    logits_flash = prefill_flash(frozen, adapters[0], toks)
    torch.cuda.synchronize()
    prefill_s = time.time() - t1
    counts = kernels.launch_counts()
    # ----------------------------------------------------------------------

    n_proj = len(cfg.lora.targets) * cfg.n_layers          # 7 x 32
    assert stats["drained"] and stats["completed"] == n_requests, stats
    for r in reqs:
        assert len(r.output) == 32, (r.uid, len(r.output))
        assert all(0 <= t < cfg.vocab_size for t in r.output), r.uid
    assert stats["prefills"] == sum(int(n) // 64 for n in lens), stats
    assert counts["lora_matmul_grouped"] == n_proj * stats["ticks"], counts
    assert counts["lora_matmul"] == n_proj * stats["prefills"], counts
    assert counts["flash_attention"] == cfg.n_layers, counts
    emit({"phase": "serve", "gpu": gpu_line(), "requests": n_requests,
          "slots": 8, "max_len": 512, "prefill_chunk": 64, "max_new": 32,
          "prompt_lens": [int(n) for n in lens],
          **{k: stats[k] for k in ("completed", "ticks", "prefills", "tokens",
                                   "tokens_per_sec", "requests_per_s",
                                   "mean_ttft_s", "wall_s", "drained")},
          "launches": counts})

    step_breakdown(cfg, frozen, bank, toks, profile)

    # One decode tick and one prefill chunk on fresh caches, fused kernels
    # against the port's own plain LoRA path. In f32 the two paths differ by
    # summation order only, which pins the wiring down tightly. In bf16 they
    # round at different places (the fused kernels round once per projection,
    # the plain path three times) and 32 random-weight layers amplify that,
    # so each is also held against the f32 logits: the kernel path must be
    # about as close to them as the plain path is.
    from repro_torch.models.common import tree_map
    ids = torch.as_tensor([0, 1, 2, 3, 0, 1, 2, 3], device=dev)
    tok = torch.full((8, 1), 1234, dtype=torch.int32, device=dev)
    ts = torch.zeros((8,), dtype=torch.int32, device=dev)
    ctoks = toks[:1, :64]
    f32_tol, bf16_tol = 2e-3, 1.0
    frozen32 = tree_map(lambda v: v.float(), frozen)
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def tick_and_chunk(fz, c, act, use_kernel):
        stacked = tree_map(lambda v: v.to(act), bank.stacked)
        lora_b = AdapterBank.gather(stacked, ids)
        one = {"layers": tree_map(lambda v: v[1], stacked["layers"])}
        with torch.no_grad():
            tick, _ = M.decode_step(fz, lora_b, M.init_cache(c, 8, 64), tok,
                                    ts, c, use_lora_kernel=use_kernel)
            chunk, _ = M.prefill_chunk(fz, one, M.init_cache(c, 1, 128),
                                       ctoks, 0, c, use_lora_kernel=use_kernel)
        return tick, chunk

    def err(x, y):
        return (x - y).abs().max().item()

    k32 = tick_and_chunk(frozen32, cfg32, torch.float32, True)
    p32 = tick_and_chunk(frozen32, cfg32, torch.float32, False)
    kbf = tick_and_chunk(frozen, cfg, torch.bfloat16, True)
    pbf = tick_and_chunk(frozen, cfg, torch.bfloat16, False)
    report = {"phase": "serve_logits", "f32_tol": f32_tol,
              "bf16_tol": bf16_tol,
              "logit_abs_max": p32[0].abs().max().item()}
    for i, what in enumerate(("tick", "chunk")):
        report[what] = {
            "f32_kernel_vs_plain": err(k32[i], p32[i]),
            "bf16_kernel_vs_plain": err(kbf[i], pbf[i]),
            "bf16_kernel_vs_f32": err(kbf[i], p32[i]),
            "bf16_plain_vs_f32": err(pbf[i], p32[i])}
    # same token, same position, four adapters: rows differ by adapter only
    report["diff_between_adapters"] = err(kbf[0][0], kbf[0][1])
    report["diff_same_adapter"] = err(kbf[0][0], kbf[0][4])
    emit(report)
    for what in ("tick", "chunk"):
        r = report[what]
        assert all(math.isfinite(v) for v in r.values()), r
        assert r["f32_kernel_vs_plain"] <= f32_tol, r
        assert r["bf16_kernel_vs_plain"] <= bf16_tol, r
        assert r["bf16_kernel_vs_f32"] <= 2.0 * r["bf16_plain_vs_f32"] + 0.05, r
    assert report["diff_between_adapters"] > bf16_tol, report
    assert (report["diff_same_adapter"]
            <= 0.1 * report["diff_between_adapters"]), report

    # prefill: flash kernel against the naive path, last-position logits;
    # f32 tightly, bf16 (the main path's run above) against the f32 logits
    naive32 = make_prefill_step(cfg32, impl="naive")(frozen32, adapters[0], toks)
    flash32 = make_prefill_step(cfg32, impl="flash")(frozen32, adapters[0], toks)
    naive_bf = make_prefill_step(cfg, impl="naive")(frozen, adapters[0], toks)
    torch.cuda.synchronize()
    assert logits_flash.shape == (4, cfg.padded_vocab)
    assert logits_flash.dtype == torch.float32
    assert torch.isfinite(logits_flash[:, :cfg.vocab_size]).all()
    pre = {"f32_flash_vs_naive": err(flash32, naive32),
           "bf16_flash_vs_naive": err(logits_flash, naive_bf),
           "bf16_flash_vs_f32": err(logits_flash, naive32),
           "bf16_naive_vs_f32": err(naive_bf, naive32)}
    emit({"phase": "prefill", "batch": 4, "seq": 1024, "impl": "flash",
          "seconds": prefill_s, "f32_tol": f32_tol, "bf16_tol": bf16_tol,
          **pre, "flash_attention_launches": counts["flash_attention"]})
    assert pre["f32_flash_vs_naive"] <= f32_tol, pre
    assert pre["bf16_flash_vs_naive"] <= bf16_tol, pre
    assert pre["bf16_flash_vs_f32"] <= 2.0 * pre["bf16_naive_vs_f32"] + 0.05, pre
    return counts


def step_breakdown(cfg, frozen, bank, toks, profile: bool):
    """Where a decode tick and a prefill chunk spend their time: host wall
    time of one step that ends in a synchronise, with the fused kernels and
    with the plain LoRA path, beside the share that the LoRA kernels' own
    times (from the kernels phase) would explain. With ``profile``, one tick
    under ``torch.profiler`` and the device time by kernel name."""
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_map
    from repro_torch.serving import AdapterBank
    dev = torch.device("cuda")
    stacked = tree_map(lambda v: v.to(torch.bfloat16), bank.stacked)
    ids = torch.as_tensor([0, 1, 2, 3, 0, 1, 2, 3], device=dev)
    tok = torch.full((8, 1), 1234, dtype=torch.int32, device=dev)
    one = {"layers": tree_map(lambda v: v[1], stacked["layers"])}
    cache = M.init_cache(cfg, 8, 512)
    lane = M.init_cache(cfg, 1, 512)

    def tick(use_kernel, t):
        ts = torch.full((8,), t, dtype=torch.int32, device=dev)
        lora_b = AdapterBank.gather(stacked, ids)
        logits, _ = M.decode_step(frozen, lora_b, cache, tok, ts, cfg,
                                  use_lora_kernel=use_kernel)
        return logits.cpu()

    def chunk(use_kernel, t):
        logits, _ = M.prefill_chunk(frozen, one, lane, toks[:1, :64], 0, cfg,
                                    use_lora_kernel=use_kernel)
        return logits.cpu()

    out = {"phase": "step_breakdown", "gpu": gpu_line()}
    with torch.no_grad():
        for name, fn in (("tick", tick), ("chunk", chunk)):
            for use_kernel in (True, False):
                for t in range(2):
                    fn(use_kernel, 100 + t)
                torch.cuda.synchronize()
                t0 = time.time()
                for t in range(5):
                    fn(use_kernel, 102 + t)
                torch.cuda.synchronize()
                key = f"{name}_{'kernels' if use_kernel else 'plain'}_wall_ms"
                out[key] = (time.time() - t0) / 5 * 1e3
        if profile:
            from torch.profiler import ProfilerActivity, profile as prof
            with prof(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as p:
                tick(True, 110)
                torch.cuda.synchronize()
            rows = sorted(p.key_averages(),
                          key=lambda e: -getattr(e, "device_time_total", 0.0))
            out["tick_device_us_by_kernel"] = [
                {"name": e.key[:60], "calls": e.count,
                 "device_us": getattr(e, "device_time_total", 0.0)}
                for e in rows[:12]]
    emit(out)


def _leaves(tree):
    from repro_torch.models.common import tree_leaves
    return tree_leaves(tree)


# ---------------------------------------------------------------------------


SOURCES = {
    "lora_matmul": ("src/repro_torch/csrc/lora_matmul.cu",
                    "src/repro/kernels/lora_matmul.py:73"),
    "lora_matmul_grouped": ("src/repro_torch/csrc/lora_matmul.cu",
                            "src/repro/kernels/lora_matmul.py:170"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:107"),
}
# the shape whose numbers head each kernel's entry (all shapes: "by_shape")
HEADLINE = {"lora_matmul": 2, "lora_matmul_grouped": 2, "flash_attention": 0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--only", choices=("kernels",), default=None,
                    help="stop after the build and kernels phases")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one decode tick with torch.profiler")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this check runs on the GPU only", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (nothing is printed without the program)
    t_start = time.time()
    card = gpu_line()
    emit({"phase": "device", "gpu": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    from repro_torch.kernels import _build
    seconds = _build.build_all(force=True)
    for name in _build.SOURCES:
        _build.load(name)
    usage = {name: [ln for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in _build.build_logs.items()}
    emit({"phase": "build", "seconds": seconds, "sources": list(_build.SOURCES),
          "ptxas": usage})

    rows = phase_kernels(args.seed)
    if args.only == "kernels":
        emit({"phase": "done", "only": "kernels",
              "seconds": time.time() - t_start})
        return 0

    counts = phase_serve_and_prefill(args.seed, args.requests, args.profile)

    kernels_line = []
    for name, by_shape in rows.items():
        head = by_shape[HEADLINE[name]]
        kernels_line.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": counts[name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "dtype": head["dtype"],
            "tol": head["tol"], "kernel_ms": head["ms"],
            "max_err": head["max_abs_err"], "by_shape": by_shape})
    emit({"phase": "total", "seconds": time.time() - t_start})
    emit({"kernels": kernels_line})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
