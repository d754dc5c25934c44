#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # everything (needs one CUDA device)
    python3 chip_smoke.py --only kernels   # build + kernel checks only
    python3 chip_smoke.py --only train     # the train phase only
    python3 chip_smoke.py --only families  # build + the families phase
    python3 chip_smoke.py --only fleet     # build + smoke calibrate + fleet
    python3 chip_smoke.py --only calibrate # the calibrate phase alone
    python3 chip_smoke.py --only registry  # build + the registry phase
    python3 chip_smoke.py --only dryrun    # the dryrun phase alone
    python3 chip_smoke.py --only bench     # build + the bench phase, full grid

Phases, each of which raises (and so exits non-zero) on failure:

  device   the card's name and power limit, torch and CUDA versions
  build    nvcc builds ``src/repro_torch/csrc/*.cu`` from the checkout; the
           count of tensor-core instructions (HGMMA, HMMA) in each
           library's SASS (``cuobjdump -sass``)
  kernels  every hand-written kernel against its plain PyTorch version on
           the card (main-path shapes and ragged ones, bf16 and f32; every
           version of ``lora_matmul``, ``lora_matmul_grouped``,
           ``flash_attention`` and ``ssd_intra_chunk``: the tensor-core ones
           (bf16 ``wgmma``, f32 ``tf32x3``) and the SIMT one, the f32
           tensor-core ones at every probe shape of the calibrate path;
           ``ssd_intra_chunk`` also at hymba-1.5b's
           width and under steep decay;
           ``flash_decode`` at runs of one piece and of the most pieces,
           linear and ring; every call of the calibrate
           path's probe ladder and kernel benches on its own inputs), then
           timed with CUDA events beside the plain version, one PyTorch
           library call for the same function, and the card's bound; the
           library calls for the calibrate path's f32 kernel benches
  serve    full-width llama32-1b (32 layers, random weights from a seed),
           four non-zero LoRA adapters, ``ServingEngine`` with the fused
           kernels answering 16 requests; launch counts, tokens, logits
           against the port's own plain LoRA path
  prefill  ``make_prefill_step(impl="flash")`` on (4, 1024) tokens against
           ``impl="naive"``
  calibrate  ``launch/calibrate``: the full probe ladder through the Hopper
           kernels (CUDA-event timings), the roofline fit, one latency
           table per architecture, the four kernel benches; then
           ``batched_card`` on the card with analytic and measured tables
           for four full configs x three channel states over a 100-device
           fleet, and the batched decisions held to the scalar float64
           ``card`` on every (round, device) of one state; every
           ``lora_matmul`` and ``flash_attention`` launch of the path is
           ``tf32x3``; a summary line: the fit, the inflations, the moved
           share of CARD's decisions and of Fig. 3's (``--only
           calibrate`` runs this phase alone, no other check: copied into a
           ``git archive`` of an earlier commit, with the version checks
           edited to that commit's kernels, it gives that commit's numbers
           for a before/after comparison on one machine)
  fleet    the fleet engines and tiered CARD at llama32-1b's full config
           (33 cuts, batch 4 x 512), decision grids on the card, no kernel
           (0 launches): Fig. 4 (5 devices x 40 rounds x 3 states x 3
           policies) held to the scalar float64 engine; decisions/s of
           the vectorized engine at 10^3, 10^4, 10^5 devices and, in
           chunks (``FleetMesh``), at 10^6, median of 5 synchronised runs,
           with the peak memory; sharded == unsharded bit for bit; the
           hierarchy sweep (1-8 servers) and hierarchical CARD against its
           scalar oracle; the churn sweep and its zero-fault identity; Fig.
           3 and its decision divergence on the calibrate path's measured
           tables
  train    split LoRA fine-tuning of full-width llama32-1b: split grads
           equal unsplit grads (f32, cuts 0, 16, 32); the kernel routes
           refuse autograd; ``SplitFineTuner`` with CARD in the loop and
           then a static cut 16 (bf16, 4 x 512 tokens, CUDA-event ms per
           stage of each local epoch, peak memory); ``make_train_step``
           lowers the loss on a fixed batch with remat on and off; no
           kernel launches on this path, as in the reference
  families mamba2-370m, hymba-1.5b and granite-moe-3b-a800m at their full
           published configs (bf16, random weights from a seed, four
           non-zero adapters): ``ServingEngine`` with the fused kernels on
           8 requests a config (launch counts by kernel and version,
           tokens, logits against the f32 plain path);
           ``make_prefill_step(impl="flash")`` on (4, 1024) against
           ``impl="chunked"`` (``ssd_intra_chunk`` on its model path, its
           share of the step's device time); split == unsplit grads in f32
           and a falling bf16 train step, no kernel
  registry qwen3-0.6b, qwen3-4b, qwen2-7b, phi3-medium-14b, internvl2-26b
           and musicgen-large at their full published configs (bf16,
           random weights from a seed, four non-zero adapters): the bf16
           kernels against their plain versions at every shape the path
           hands them (head dim 128 and 64, GQA groups 1-7), timing rows at
           qwen2-7b's and internvl2-26b's attention and qwen2-7b's down
           projection; ``ServingEngine`` with the fused kernels on 8
           requests (token configs) or ``generate`` from an embeddings
           prompt (embeds configs); ``make_prefill_step(impl="flash")`` on
           (4, 1024) with the bf16 logits against f32 (full depth, or the
           first 4 layers where an f32 copy does not fit); split == unsplit
           in f32 over 4 layers at full width and one bf16 ``SplitFineTuner``
           epoch at a CARD cut where the full-depth step fits the card (its
           memory predicted from 2 and 4 layers, and traced at full
           depth on ``meta`` by the analysis layer), no kernel
  dryrun   ``launch/dryrun``: every (arch x input shape) combo of the
           reference's dry run traced on ``meta`` at full published width
           (40, kimi-k2-1t-a32b included; FLOPs, HBM bytes, peak bytes,
           roofline terms against the H100), in worker processes, beside
           the card check: the same train / prefill / decode programs of
           qwen3-0.6b, qwen2-7b, mamba2-370m and granite-moe-3b-a800m run
           on the card at full width and depth (the batch cut), their
           FLOP count equal to the meta record's, the meta peak within
           10 % of ``max_memory_allocated``, CUDA-event time beside the
           record's bound; no kernel
  bench    the benchmark twins of ``launch/``: ``serving_bench`` at
           qwen3-0.6b's full published width (28 layers, bf16, eight
           non-zero adapters) on the reference's smoke grid (``--only
           bench``: its full grid), the fused LoRA kernels on, every row
           drained, ``lora_matmul`` and ``lora_matmul_grouped`` launched
           (all ``wgmma``), the warm decode tick's wall and device time per
           slot count, the admission run; ``kernel_bench`` and
           ``cost_model_calibration`` payloads from the calibrate phase's
           payload and the dryrun phase's records, the ``roofline`` table;
           ``ablation_pareto`` on the card held to the same run on the CPU;
           ``check_regression.validate`` on every payload built, the fleet
           twins' smoke payloads included

It imports ``repro_torch`` only (never JAX), needs no network, and prints
one JSON object per line (and, in the bench phase, the serving twin's CSV
table, the fleet twins' lines and the roofline table); the line before the
last holds the card's name and power limit, the last line is ``{"ok":
true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

LORA_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}   # x max|want|
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # absolute
# flash_decode as attention; ssd_intra_chunk (f32 only) at the reference
# tests' 1e-4, absolute on y, the states and the decay vectors
DECODE_TOL = ATTN_TOL
SSD_TOL = 1e-4
# f32 lora_matmul (M, K, N, r) and flash_attention (B, S, Hq, Hkv, D) at the
# calibrate path's probe shapes (measured_cost._FULL_SHAPES; the kernel
# benches' are among them), in the ladder's order
F32_LORA_SHAPES = ((128, 128, 128, 8), (256, 256, 256, 8), (512, 512, 512, 16),
                   (1024, 1024, 1024, 16), (256, 1024, 512, 16))
F32_FLASH_SHAPES = ((1, 128, 4, 2, 32), (1, 256, 4, 2, 32), (1, 512, 4, 2, 32),
                    (1, 512, 8, 4, 64))
KN_SHAPES = ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(calls, reps: int = 10) -> float:
    """Device milliseconds per call, best of ``reps`` replays of a CUDA
    graph (``measured_cost.time_cuda``, the calibrate path's timer).
    ``calls`` is a list of thunks over distinct weight buffers, so that
    weights come from device memory and not from the L2 cache, as they do on
    the main path."""
    from repro_torch.core.measured_cost import time_cuda
    return time_cuda(calls, reps) * 1e3


def host_us(call, n: int = 50) -> float:
    """Host microseconds to enqueue one call (the wrapper's checks, its
    workspace, the launch; no synchronise inside), mean of ``n``."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def randn(rng, shape, dtype, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)
    ).to("cuda").to(dtype)


def n_copies(weight_bytes: int) -> int:
    """Enough distinct weight buffers to exceed the 50 MB L2 twice over."""
    return max(1, min(16, math.ceil(128e6 / max(weight_bytes, 1))))


def misaligned(t):
    """A copy of ``t`` one element past a 16-byte boundary: the wrappers of
    ``lora_matmul``, ``lora_matmul_grouped`` and ``flash_attention`` take
    their SIMT kernel for it (the tensor-core kernels read with 16-byte
    copies)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16
    return out


def run_version(fn, call):
    """``call()`` and the version of ``fn`` (a wrapper with ``by_version``)
    that it launched."""
    before = dict(fn.by_version)
    out = call()
    ran = [v for v, n in fn.by_version.items() if n != before[v]]
    assert len(ran) == 1, (fn.__name__, before, fn.by_version)
    return out, ran[0]


def tensor_core_sass():
    """Per source: the HGMMA (wgmma) and HMMA (mma.sync) instructions in the
    SASS of its built library (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = {}
    for name in _build.SOURCES:
        sass = subprocess.run([tool, "-sass", str(_build._target(name))],
                              capture_output=True, text=True, check=True).stdout
        out[name] = {op: len(re.findall(rf"\b{op}\.", sass))
                     for op in ("HGMMA", "HMMA")}
    return out


# ---------------------------------------------------------------------------
# kernels phase
# ---------------------------------------------------------------------------


def check_lora_matmul(rng, m, k, n, r, dtype, scale=0.5, simt=False):
    """Kernel against plain version; ``simt=True`` hands the kernel a
    misaligned copy of W, so that the SIMT version runs. Returns (err, tol,
    version)."""
    from repro_torch.kernels import lora_matmul as lm
    x = randn(rng, (m, k), dtype)
    w = randn(rng, (k, n), dtype)
    a = randn(rng, (k, r), dtype)
    b = randn(rng, (r, n), dtype)
    w_in = misaligned(w) if simt else w
    got, version = run_version(lm.lora_matmul,
                               lambda: lm.lora_matmul(x, w_in, a, b, scale))
    want_version = "simt" if simt else lm.lora_matmul_version(dtype, k, n, r,
                                                              True)
    assert version == want_version, (version, want_version)
    torch.cuda.synchronize()
    want = lm.lora_matmul_ref(x, w, a, b, scale).float()
    err = (got.float() - want).abs().max().item()
    tol = LORA_TOL[dtype] * want.abs().max().item()
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(
            f"lora_matmul {(m, k, n, r)} {dtype} ({version}): max err {err} "
            f"> tol {tol}")
    return err, tol, version


def check_grouped(rng, g, m, k, n, r, e, dtype, ids=None, scale=0.5,
                  strided=False, simt=None):
    """Kernel against plain version; ``simt="w"`` hands the kernel a
    misaligned copy of W (the SIMT kernel's 2-byte-load variant runs),
    ``simt="x"`` one of x (its 16-byte-load variant, where the shape allows
    it: the tensor-core version's predecessor on the main path). Returns
    (err, tol, version)."""
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
    x_in = misaligned(x) if simt == "x" else x
    w_in = misaligned(w) if simt == "w" else w
    got, version = run_version(
        lm.lora_matmul_grouped,
        lambda: lm.lora_matmul_grouped(x_in, w_in, a, b, ids, scale))
    assert simt is None or version == "simt", (simt, version)
    torch.cuda.synchronize()
    want = lm.lora_matmul_grouped_ref(x, w, a, b, ids, scale).float()
    err = (got.float() - want).abs().max().item()
    tol = LORA_TOL[dtype] * want.abs().max().item()
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(
            f"lora_matmul_grouped {(g, m, k, n, r, e)} strided={strided} "
            f"{dtype} ({version}): max err {err} > tol {tol}")
    return err, tol, version


def check_flash(rng, b, sq, skv, hq, hkv, d, dtype, causal=True, window=0,
                simt=False):
    """Kernel against plain version; ``simt=True`` hands the kernel
    misaligned copies of q, k, v, so that the SIMT version runs. Returns
    (err, tol, version)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    q = randn(rng, (b, sq, hq, d), dtype)
    k = randn(rng, (b, skv, hkv, d), dtype)
    v = randn(rng, (b, skv, hkv, d), dtype)
    if causal:
        qi, ki, vi = (misaligned(t) for t in (q, k, v)) if simt else (q, k, v)
        call = lambda: ops.flash_attention(qi, ki, vi, causal=True,  # noqa: E731
                                           window=window)
    else:           # the (BH, S, D) form of the kernel's own wrapper
        # (the reshape copies, so the misaligned copies are made after it)
        qi, ki, vi = (t.permute(0, 2, 1, 3).reshape(-1, t.shape[1], d)
                      for t in (q, k, v))
        if simt:
            qi, ki, vi = (misaligned(t) for t in (qi, ki, vi))
        call = lambda: fa.flash_attention(  # noqa: E731
            qi, ki, vi, causal=False, window=window
        ).reshape(b, hq, sq, d).permute(0, 2, 1, 3)
    got, version = run_version(fa.flash_attention, call)
    want_version = "simt" if simt else fa.flash_attention_version(dtype, d,
                                                                  True)
    assert version == want_version, (version, want_version)
    torch.cuda.synchronize()
    want = fa.flash_attention_ref(
        q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
        causal=causal, window=window).permute(0, 2, 1, 3).float()
    err = (got.float() - want).abs().max().item()
    tol = ATTN_TOL[dtype]
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(
            f"flash_attention {(b, sq, skv, hq, hkv, d)} window={window} "
            f"causal={causal} {dtype} ({version}): max err {err} > tol {tol}")
    return err, tol, version


def bound(bytes_moved: float, flops: float, dtype):
    """(least ms an H100 could take, "bytes" | "operations")."""
    from repro_torch.launch.calibrate import h100_bound_s
    seconds, by = h100_bound_s(bytes_moved, flops, dtype)
    return seconds * 1e3, by


def time_lora_matmul(rng, m, k, n, r, dtype, scale=2.0):
    from repro_torch.kernels import lora_matmul as lm
    es = torch.finfo(dtype).bits // 8
    copies = n_copies(k * n * es)
    x = randn(rng, (m, k), dtype)
    ws = [randn(rng, (k, n), dtype) for _ in range(copies)]
    a = randn(rng, (k, r), dtype, 0.25)
    b = randn(rng, (r, n), dtype, 0.02)
    err, tol, _ = check_lora_matmul(rng, m, k, n, r, dtype, scale)
    _, timed = run_version(lm.lora_matmul,
                           lambda: lm.lora_matmul(x, ws[0], a, b, scale))
    ms = time_ms([lambda w=w: lm.lora_matmul(x, w, a, b, scale) for w in ws])
    # the same call through the SIMT kernel: W one element off alignment
    offs = [misaligned(w) for w in ws]
    _, simt = run_version(lm.lora_matmul,
                          lambda: lm.lora_matmul(x, offs[0], a, b, scale))
    assert simt == "simt", simt
    simt_ms = time_ms([lambda w=w: lm.lora_matmul(x, w, a, b, scale)
                       for w in offs])
    hosts = {v: host_us(lambda w=w: lm.lora_matmul(x, w, a, b, scale))
             for v, w in ((timed, ws[0]), ("simt", offs[0]))}
    del offs
    plain = time_ms([lambda w=w: lm.lora_matmul_ref(x, w, a, b, scale)
                     for w in ws], reps=5)
    lib = time_ms([lambda w=w: torch.addmm(x @ w, x @ a, b, alpha=scale)
                   for w in ws])
    bytes_moved = es * (m * k + k * n + k * r + r * n + m * n)
    flops = 2.0 * m * k * n + 2.0 * m * k * r + 2.0 * m * r * n
    b_ms, by = bound(bytes_moved, flops, dtype)
    out = {"shape": {"M": m, "K": k, "N": n, "r": r}, "dtype": str(dtype),
           "version": timed, "max_abs_err": err, "tol": tol, "ms": ms,
           "simt_ms": simt_ms, "host_us": hosts[timed],
           "simt_host_us": hosts["simt"], "plain_ms": plain,
           "library_ms": lib, "bound_ms": b_ms, "bound_by": by}
    if timed == "tf32x3":
        out.update(bound_3xtf32(bytes_moved, flops))
    return out


def bound_3xtf32(bytes_moved: float, flops: float):
    """The bound of f32 work done as three tf32 products on the tensor
    cores: max(bytes / 3.35 TB/s, 3 flops / 495 TFLOP/s)."""
    from repro_torch.launch.calibrate import h100_bound_3xtf32_s
    seconds, by = h100_bound_3xtf32_s(bytes_moved, flops)
    return {"bound_3xtf32_ms": seconds * 1e3, "bound_3xtf32_by": by}


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
    err, tol, _ = check_grouped(rng, g, 1, k, n, r, e, dtype, ids=ids_np,
                                scale=scale)
    _, timed = run_version(lm.lora_matmul_grouped,
                           lambda: lm.lora_matmul_grouped(x, ws[0], a, b, ids,
                                                          scale))
    calls = [lambda w=w: lm.lora_matmul_grouped(x, w, a, b, ids, scale)
             for w in ws]
    ms = time_ms(calls)
    # The same work through the SIMT kernel: with x one element off 16-byte
    # alignment its 16-byte-load variant (the main path's kernel before the
    # tensor-core version), with W one element off its first variant.
    xm = misaligned(x)
    _, simt = run_version(lm.lora_matmul_grouped,
                          lambda: lm.lora_matmul_grouped(xm, ws[0], a, b, ids,
                                                         scale))
    assert simt == "simt", simt
    simt_ms = time_ms([lambda w=w: lm.lora_matmul_grouped(xm, w, a, b, ids,
                                                          scale)
                       for w in ws])
    offs = [misaligned(w) for w in ws]
    first_ms = time_ms([lambda w=w: lm.lora_matmul_grouped(x, w, a, b, ids,
                                                           scale)
                        for w in offs])
    del offs
    plain = time_ms([lambda w=w: lm.lora_matmul_grouped_ref(x, w, a, b, ids,
                                                            scale)
                     for w in ws], reps=5)
    lib = time_ms([lambda w=w: torch.baddbmm(
        (x[:, 0] @ w)[:, None], torch.bmm(x, a[idl]), b[idl], alpha=scale)
        for w in ws])
    used = len(set(ids_np.tolist()))
    bytes_moved = es * (g * k + k * n + used * (k * r + r * n) + g * n) + 4 * g
    flops = g * (2.0 * k * n + 2.0 * k * r + 2.0 * r * n)
    b_ms, by = bound(bytes_moved, flops, dtype)
    return {"shape": {"G": g, "M": 1, "K": k, "N": n, "r": r, "E": e},
            "dtype": str(dtype), "version": timed, "max_abs_err": err,
            "tol": tol, "ms": ms, "simt_ms": simt_ms,
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
    err, tol, _ = check_flash(rng, b, s, s, hq, hkv, d, dtype)
    _, timed = run_version(fa.flash_attention,
                           lambda: ops.flash_attention(q, k, v, causal=True))
    ms = time_ms([lambda: ops.flash_attention(q, k, v, causal=True)],
                 reps=10)
    # the same call through the SIMT kernel: q, k, v one element off
    qm, km, vm = (misaligned(t) for t in (q, k, v))
    _, simt = run_version(fa.flash_attention,
                          lambda: ops.flash_attention(qm, km, vm, causal=True))
    assert simt == "simt", simt
    simt_ms = time_ms([lambda: ops.flash_attention(qm, km, vm, causal=True)],
                      reps=10)
    qp, kp, vp = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    plain = time_ms([lambda: fa.flash_attention_ref(qp, kp, vp, causal=True)],
                    reps=5)
    lib = time_ms([lambda: F.scaled_dot_product_attention(
        qp, kp, vp, is_causal=True, enable_gqa=True)], reps=10)
    pairs = s * (s + 1) // 2                      # unmasked (query, key) pairs
    bytes_moved = es * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    flops = 4.0 * d * pairs * b * hq
    b_ms, by = bound(bytes_moved, flops, dtype)
    out = {"shape": {"B": b, "S": s, "Hq": hq, "Hkv": hkv, "D": d,
                     "causal": True, "window": 0},
           "dtype": str(dtype), "version": timed, "max_abs_err": err,
           "tol": tol, "ms": ms, "simt_ms": simt_ms, "plain_ms": plain,
           "library_ms": lib, "bound_ms": b_ms, "bound_by": by}
    if timed == "tf32x3":
        out.update(bound_3xtf32(bytes_moved, flops))
    return out


def check_ssd(rng, b, nc, cl, nh, hp, ns, simt=False, steep=False):
    """Kernel against plain version; ``simt=True`` hands the kernel a
    misaligned copy of xt, so that the SIMT version runs. Returns (err, tol,
    version)."""
    from repro_torch.kernels import ssd_scan as ss
    xt, a, B, C = ssd_inputs(rng, b, nc, cl, nh, hp, ns, steep)
    x_in = misaligned(xt) if simt else xt
    got, version = run_version(ss.ssd_intra_chunk,
                               lambda: ss.ssd_intra_chunk(x_in, a, B, C))
    want_version = "simt" if simt else ss.ssd_intra_chunk_version(cl, hp, ns,
                                                                  True)
    assert version == want_version, (version, want_version)
    torch.cuda.synchronize()
    want = ss.ssd_intra_chunk_ref(xt, a, B, C)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    if not (math.isfinite(err) and err <= SSD_TOL):
        raise AssertionError(f"ssd_intra_chunk {(b, nc, cl, nh, hp, ns)} "
                             f"steep={steep} ({version}): max err {err} > "
                             f"tol {SSD_TOL}")
    return err, SSD_TOL, version


def check_ssd_both(rng, *shape, steep=False):
    """``check_ssd`` through the version the wrapper picks and through the
    SIMT one."""
    return [check_ssd(rng, *shape, simt=simt, steep=steep)
            for simt in (False, True)]


def ssd_inputs(rng, b, nc, cl, nh, hp, ns, steep=False):
    """Scaled normals, a <= 0; ``steep``: a = -|N(0, 1)| * 2, so that cum
    falls to about -400 over a 256-row chunk and exp(cum_i) exp(-cum_j)
    would overflow."""
    f32 = torch.float32
    return (randn(rng, (b, nc, cl, nh, hp), f32, 0.2),
            -randn(rng, (b, nc, cl, nh), f32).abs() * (2.0 if steep else 0.1),
            randn(rng, (b, nc, cl, ns), f32, 0.3),
            randn(rng, (b, nc, cl, ns), f32, 0.3))


def check_ssd_scan(rng, b, length, nh, hp, ns, chunk):
    """The kernel inside ``ops.ssd_scan`` against ``ssd_chunked``, at a
    length that is not a multiple of the chunk."""
    from repro_torch.kernels import ops
    from repro_torch.models.mamba import ssd_chunked
    xt, a, B, C = (x[:, 0] for x in ssd_inputs(rng, b, 1, length, nh, hp, ns))
    y, h = ops.ssd_scan(xt, a, B, C, chunk)
    torch.cuda.synchronize()
    y2, h2 = ssd_chunked(xt, a, B, C, chunk)
    err = max((y - y2).abs().max().item(), (h - h2).abs().max().item())
    if not (math.isfinite(err) and err <= SSD_TOL):
        raise AssertionError(f"ssd_scan {(b, length, nh, hp, ns, chunk)}: "
                             f"max err {err} > tol {SSD_TOL}")
    return err, SSD_TOL, ssd_version(chunk, hp, ns)


def ssd_version(cl, hp, ns):
    from repro_torch.kernels import ssd_scan as ss
    return ss.ssd_intra_chunk_version(cl, hp, ns, True)


def check_decode(rng, b, s, hq, hkv, d, t, dtype, window=0, offset=False):
    """Kernel against plain version; ``offset=True`` hands the wrapper
    caches one element off 16-byte alignment (it copies them before the
    launch: the kernel's copies are 16 bytes)."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    q = randn(rng, (b, 1, hq, d), dtype)
    k = randn(rng, (b, s, hkv, d), dtype)
    v = randn(rng, (b, s, hkv, d), dtype)
    k_in, v_in = (misaligned(k), misaligned(v)) if offset else (k, v)
    got = ops.flash_decode(q, k_in, v_in, t, window=window).float()
    torch.cuda.synchronize()
    want = fd.flash_decode_ref(
        q[:, 0].reshape(b, hkv, hq // hkv, d), k.permute(0, 2, 1, 3),
        v.permute(0, 2, 1, 3), t, window=window).float().reshape(b, 1, hq, d)
    err = (got - want).abs().max().item()
    tol = DECODE_TOL[dtype]
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(
            f"flash_decode {(b, s, hq, hkv, d)} t={t} window={window} "
            f"{dtype}: max err {err} > tol {tol}")
    return err, tol


def time_decode(rng, b, s, hq, hkv, d, t, dtype, window=0):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    es = torch.finfo(dtype).bits // 8
    copies = n_copies(2 * b * s * hkv * d * es)
    q = randn(rng, (b, 1, hq, d), dtype)
    kvs = [(randn(rng, (b, s, hkv, d), dtype), randn(rng, (b, s, hkv, d), dtype))
           for _ in range(copies)]
    err, tol = check_decode(rng, b, s, hq, hkv, d, t, dtype, window)
    ms = time_ms([lambda k=k, v=v: ops.flash_decode(q, k, v, t, window=window)
                  for k, v in kvs])
    qf = q[:, 0].reshape(b, hkv, hq // hkv, d)
    plain = time_ms([lambda k=k, v=v: fd.flash_decode_ref(
        qf, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), t, window=window)
        for k, v in kvs], reps=5)
    valid = fd.valid_slots(t, s, window, "cuda")
    qh = q.permute(0, 2, 1, 3)                       # (B, Hq, 1, D)
    lib = time_ms([lambda k=k, v=v: F.scaled_dot_product_attention(
        qh, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
        attn_mask=valid[None, :], enable_gqa=True) for k, v in kvs])
    n_valid = int(valid.sum().item())                # what this t reads
    bytes_moved = es * (2 * b * hq * d + 2 * b * n_valid * hkv * d)
    flops = 4.0 * d * n_valid * b * hq
    b_ms, by = bound(bytes_moved, flops, dtype)
    return {"shape": {"B": b, "S": s, "Hq": hq, "Hkv": hkv, "D": d, "t": t,
                      "window": window, "valid_slots": n_valid},
            "dtype": str(dtype), "max_abs_err": err, "tol": tol, "ms": ms,
            "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
            "bound_by": by}


def ssd_library(xt, a, B, C):
    """The same function as one composition of PyTorch calls (matmul,
    masked exp, einsum), for the library column: C.B^T once per chunk and
    shared by the heads. Used nowhere in the port."""
    cl = xt.shape[2]
    cum = torch.cumsum(a, dim=2).permute(0, 1, 3, 2)          # (b,c,h,cl)
    causal = torch.ones((cl, cl), dtype=torch.bool, device=xt.device).tril()
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(~causal,
                                                              -math.inf)
    scores = torch.matmul(C, B.transpose(-1, -2))              # (b,c,i,j)
    y = torch.einsum("bchij,bcjhp->bcihp", scores[:, :, None] * seg.exp(), xt)
    dec_end = torch.exp(cum[..., -1:] - cum)                   # (b,c,h,cl)
    st = torch.einsum("bcjn,bchj,bcjhp->bchnp", B, dec_end, xt)
    dec = torch.stack([cum.exp(), cum[..., -1:].exp().expand_as(cum)],
                      dim=-1).permute(0, 1, 3, 2, 4)
    return y, st, dec


def time_ssd(rng, b, nc, cl, nh, hp, ns):
    from repro_torch.kernels import ssd_scan as ss
    f32 = torch.float32
    err, tol, _ = check_ssd(rng, b, nc, cl, nh, hp, ns)
    copies = n_copies(4 * b * nc * cl * nh * hp)
    ins = [ssd_inputs(rng, b, nc, cl, nh, hp, ns) for _ in range(copies)]
    _, timed = run_version(ss.ssd_intra_chunk,
                           lambda: ss.ssd_intra_chunk(*ins[0]))
    ms = time_ms([lambda x=x: ss.ssd_intra_chunk(*x) for x in ins])
    by_kernel = ssd_profile(ins) if timed == "tc" else {}
    # the same call through the SIMT kernel: xt one element off alignment
    offs = [(misaligned(x[0]),) + tuple(x[1:]) for x in ins]
    _, simt = run_version(ss.ssd_intra_chunk,
                          lambda: ss.ssd_intra_chunk(*offs[0]))
    assert simt == "simt", simt
    simt_ms = time_ms([lambda x=x: ss.ssd_intra_chunk(*x) for x in offs])
    del offs
    plain = time_ms([lambda x=x: ss.ssd_intra_chunk_ref(*x) for x in ins],
                    reps=5)
    lib_out = ssd_library(*ins[0])
    lib_err = max((g - w).abs().max().item() for g, w in
                  zip(lib_out, ss.ssd_intra_chunk_ref(*ins[0])))
    assert lib_err <= SSD_TOL, lib_err           # it computes the same function
    lib = time_ms([lambda x=x: ssd_library(*x) for x in ins], reps=5)
    pairs = cl * (cl + 1) // 2                   # causal (i, j) pairs a chunk
    # in: xt, a, B, C; out: y, states, dec; every element read/written once
    elems = (2 * b * nc * cl * nh * hp + b * nc * cl * nh + 2 * b * nc * cl * ns
             + b * nc * nh * ns * hp + 2 * b * nc * cl * nh)
    # C.B^T once per chunk; per head the score scaled by its decay (one
    # multiply a pair), the product with xt, B weighted by the decay to the
    # chunk's end, and the state
    flops = b * nc * (2.0 * pairs * ns
                      + nh * (2.0 * pairs * hp + pairs + cl * ns
                              + 2.0 * cl * ns * hp))
    b_ms, by = bound(4 * elems, flops, f32)
    # at the rate of the units the tensor-core version runs on: three tf32
    # products for each product at the dense TF32 rate, or the bytes
    return {"shape": {"b": b, "nc": nc, "cl": cl, "nh": nh, "hp": hp,
                      "ns": ns}, "dtype": str(f32), "version": timed,
            "max_abs_err": err, "tol": tol, "ms": ms, "simt_ms": simt_ms,
            "plain_ms": plain, "library_ms": lib,
            "library_max_abs_err": lib_err, "bound_ms": b_ms, "bound_by": by,
            **bound_3xtf32(4 * elems, flops), "bytes": 4 * elems,
            "flops": flops,
            "profile_device_us_by_kernel": by_kernel}


def ssd_profile(ins, reps: int = 5):
    """Device µs per call of each CUDA kernel the tensor-core
    ``ssd_intra_chunk`` enqueues (its scores kernel and its heads kernel),
    by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ssd_scan as ss
    ss.ssd_intra_chunk(*ins[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            ss.ssd_intra_chunk(*ins[i % len(ins)])
        torch.cuda.synchronize()
    out = {"ssd_scores_tc_kernel": 0.0, "ssd_intra_chunk_tc_kernel": 0.0}
    for e in prof.key_averages():
        for name in out:
            if name in e.key:
                out[name] += getattr(e, "device_time_total", 0.0) / reps
    return out


def ssd_scan_library(xt, a, B, C, chunk):
    """``ops.ssd_scan`` with its intra-chunk kernel replaced by
    ``ssd_library``: the library column of the calibrate path's
    ``ssd_scan_512`` bench. Used nowhere in the port."""
    b, length, nh, hp = xt.shape
    ns = B.shape[-1]
    nc = length // chunk
    C_c = C.reshape(b, nc, chunk, ns)
    y_diag, states, dec = ssd_library(
        xt.reshape(b, nc, chunk, nh, hp), a.reshape(b, nc, chunk, nh),
        B.reshape(b, nc, chunk, ns), C_c)
    states = states.transpose(3, 4)
    a_tot = dec[:, :, -1, :, 1]
    h = torch.zeros((b, nh, hp, ns), dtype=xt.dtype, device=xt.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * a_tot[:, c, :, None, None] + states[:, c]
    y_off = (torch.einsum("bcin,bchpn->bcihp", C_c, torch.stack(h_prevs, 1))
             * dec[..., 0][..., None])
    return (y_diag + y_off).reshape(b, length, nh, hp), h


def time_benches(rng):
    """The calibrate path's f32 kernel benches at their shapes
    (``calibrate.BENCH_SHAPES``): the kernel as the bench calls it and one
    PyTorch library call for the same function, by graph replay; the
    library's result is held to the kernel's plain version first."""
    import torch.nn.functional as F
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ops
    from repro_torch.launch.calibrate import BENCH_SHAPES
    from repro_torch.models.mamba import ssd_chunked
    f32 = torch.float32
    out = []

    def row(name, shape, kernel, plain, library, tol):
        want, lib = plain(), library()
        if torch.is_tensor(want):
            want, lib = (want,), (lib,)
        err = max((x - y).abs().max().item() for x, y in zip(lib, want))
        assert err <= tol, (name, err, tol)       # the same function
        out.append({"name": name, "shape": shape, "dtype": str(f32),
                    "ms": time_ms([kernel]), "library_ms": time_ms([library]),
                    "library_max_abs_err": err})

    m, k, n, r = BENCH_SHAPES["lora_matmul"]
    x, w, a, b = (randn(rng, sh, f32) for sh in ((m, k), (k, n), (k, r),
                                                 (r, n)))
    want_max = lm.lora_matmul_ref(x, w, a, b, 2.0).abs().max().item()
    row("lora_matmul_512", {"M": m, "K": k, "N": n, "r": r},
        lambda: ops.lora_matmul(x, w, a, b, 2.0),
        lambda: lm.lora_matmul_ref(x, w, a, b, 2.0),
        lambda: torch.addmm(x @ w, x @ a, b, alpha=2.0),
        LORA_TOL[f32] * want_max)
    bsz, s, hq, hkv, d = BENCH_SHAPES["flash_attention"]
    q, kk, v = (randn(rng, (bsz, s, h, d), f32) for h in (hq, hkv, hkv))
    qp, kp, vp = (t.permute(0, 2, 1, 3) for t in (q, kk, v))
    from repro_torch.kernels import flash_attention as fa
    row("flash_attention_512", {"B": bsz, "S": s, "Hq": hq, "Hkv": hkv,
                                "D": d, "causal": True},
        lambda: ops.flash_attention(q, kk, v),
        lambda: fa.flash_attention_ref(qp, kp, vp, causal=True),
        lambda: F.scaled_dot_product_attention(qp, kp, vp, is_causal=True,
                                               enable_gqa=True),
        ATTN_TOL[f32])
    bsz, length, nh, hp, ns, chunk = BENCH_SHAPES["ssd_scan"]
    xt, sa, sb, sc = (t[:, 0] for t in ssd_inputs(rng, bsz, 1, length, nh,
                                                  hp, ns))
    row("ssd_scan_512", {"b": bsz, "L": length, "nh": nh, "hp": hp,
                         "ns": ns, "chunk": chunk},
        lambda: ops.ssd_scan(xt, sa, sb, sc, chunk),
        lambda: ssd_chunked(xt, sa, sb, sc, chunk),
        lambda: ssd_scan_library(xt, sa, sb, sc, chunk), SSD_TOL)
    return out


def check_ladder(rng):
    """The calibrate path's calls against their plain versions, f32: every
    probe of the full ladder on its own inputs (the probe builders draw the
    kernel's and the plain version's inputs from one seed; the kernel
    benches' shapes and inputs are among them), and ``ssd_intra_chunk`` at
    each shape that ``ops.ssd_scan`` hands it there."""
    from repro_torch.core import measured_cost as mc
    from repro_torch.launch.calibrate import BENCH_SHAPES
    dev = torch.device("cuda")
    ladder = [(kernel, args) for kernel, _, args in mc._FULL_SHAPES]
    for kernel in ("lora_matmul", "flash_attention", "ssd_scan"):
        assert (kernel, BENCH_SHAPES[kernel]) in ladder, kernel
    from repro_torch import kernels
    for kernel, args in ladder:
        with torch.no_grad():
            before = kernels.version_counts()
            got = mc._BUILDERS[kernel](*args, "cuda", dev)[0]()
            version = mc.timed_version(mc._WRAPPER[kernel], before)
            want = mc._BUILDERS[kernel](*args, "plain", dev)[0]()
        torch.cuda.synchronize()
        if torch.is_tensor(got):
            got, want = (got,), (want,)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        if kernel == "lora_matmul":
            name = kernel
            tol = LORA_TOL[torch.float32] * want[0].abs().max().item()
        elif kernel == "flash_attention":
            name, tol = kernel, ATTN_TOL[torch.float32]
        else:
            name, tol = "ssd_intra_chunk", SSD_TOL
        if not (math.isfinite(err) and err <= tol):
            raise AssertionError(f"calibrate probe {kernel} {args}: max err "
                                 f"{err} > tol {tol}")
        yield name, (err, tol, version)
        if kernel == "ssd_scan":
            b, length, nh, hp, ns, chunk = args
            for res in check_ssd_both(rng, b, length // chunk, chunk, nh, hp,
                                      ns):
                yield name, res


def phase_kernels(seed: int):
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.calibrate import BENCH_SHAPES
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: full f32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    decode_splits = []
    # the calibrate path's flash_decode bench: (B, S, Hq, Hkv, D), t = S - 1
    decode_bench = BENCH_SHAPES["flash_decode"]
    rng = np.random.default_rng(seed)
    f32, bf16 = torch.float32, torch.bfloat16
    worst = {}

    def note(name, dtype, res):
        """Keep the worst check of each kernel, dtype and version."""
        key = "/".join([name, str(dtype).split('.')[-1], *res[2:]])
        err, tol = res[:2]
        if key not in worst or err / tol > worst[key][0] / worst[key][1]:
            worst[key] = (err, tol)

    for dtype in (f32, bf16):
        # each shape through the version the wrapper picks for it (the
        # tensor-core one where the shape allows: bf16 wgmma, f32 tf32x3)
        # and through the SIMT one
        simts = (False, True)
        # f32: every probe shape of the calibrate path, and ragged M and K
        f32_extra = (F32_LORA_SHAPES + ((70, 260, 196, 12), (130, 64, 68, 4))
                     if dtype == f32 else ())
        for simt in simts:
            for mkn in ((37, 53, 41, 3), (33, 70, 65, 2), (100, 96, 72, 8),
                        (256, 128, 512, 16), (64, 64, 64, 4),
                        (70, 130, 90, 20), (65, 257, 129, 40),
                        (1, 2048, 2048, 16), (37, 136, 72, 8),
                        (200, 520, 264, 64)) + f32_extra:
                note("lora_matmul", dtype,
                     check_lora_matmul(rng, *mkn, dtype, simt=simt))
            for k, n in KN_SHAPES:
                note("lora_matmul", dtype,
                     check_lora_matmul(rng, 64, k, n, 16, dtype, 2.0,
                                       simt=simt))
        # bf16: the version the wrapper picks (tensor cores where K, N, r
        # allow), and the SIMT kernel's two variants (x or W misaligned);
        # f32 has the SIMT kernel only
        g_simts = (None, "x", "w") if dtype == bf16 else (None,)
        for simt in g_simts:
            for gmknre in ((3, 1, 64, 48, 4, 2), (4, 8, 128, 128, 8, 4),
                           (2, 5, 100, 72, 4, 5), (6, 1, 256, 96, 16, 3),
                           (5, 3, 1100, 70, 16, 3), (9, 2, 53, 41, 3, 4),
                           # whole 16-byte vectors: the wide variant's shapes
                           (5, 3, 1100, 72, 16, 3), (9, 2, 530, 40, 8, 4),
                           (3, 1, 300, 96, 32, 2), (4, 2, 130, 64, 64, 3),
                           # K, N, r multiples of 8: the tensor-core shapes,
                           # 2 to 8 rows of x@A a block, 70 rows in 2 tiles
                           (5, 3, 1096, 72, 16, 3), (4, 2, 136, 64, 64, 3),
                           (7, 10, 520, 264, 24, 5), (32, 1, 256, 64, 8, 4)):
                note("lora_matmul_grouped", dtype,
                     check_grouped(rng, *gmknre, dtype, simt=simt))
            note("lora_matmul_grouped", dtype,
                 check_grouped(rng, 8, 1, 2048, 512, 16, 4, dtype,
                               ids=[3, 3, 0, 2, 2, 2, 1, 0], strided=True,
                               simt=simt))
            for k, n in KN_SHAPES:
                note("lora_matmul_grouped", dtype,
                     check_grouped(rng, 8, 1, k, n, 16, 4, dtype,
                                   ids=[0, 1, 2, 3, 0, 1, 2, 3], scale=2.0,
                                   simt=simt))
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
                         ((2, 150, 70, 4, 2, 64), {"causal": False}),
                         ((1, 200, 200, 4, 2, 128), {"window": 64}),
                         ((1, 90, 90, 2, 2, 16), {"window": 20}),
                         ((1, 1024, 1024, 32, 8, 64), {}),
                         *(((b, s, s, hq, hkv, d), {})
                           for b, s, hq, hkv, d in F32_FLASH_SHAPES)):
            for simt in simts:
                note("flash_attention", dtype,
                     check_flash(rng, *args, dtype, simt=simt, **kw))
        # the llama32-1b serving cache, the reference bench's shape, a
        # ragged cache, a window over a linear cache and ring buffers; runs
        # of one piece (one launch) and of the most pieces, linear and ring
        for args in ((8, 512, 32, 8, 64, 0), (8, 512, 32, 8, 64, 200),
                     (8, 512, 32, 8, 64, 511),
                     (*decode_bench, decode_bench[1] - 1),
                     (3, 77, 25, 5, 128, 50), (2, 100, 8, 4, 32, 60, 32),
                     (2, 64, 4, 4, 16, 150, 64),
                     (8, 512, 32, 8, 64, 1500, 512),
                     (2, 512, 8, 4, 64, 1100, 600), (1, 4096, 8, 1, 64, 4095),
                     (1, 4096, 8, 1, 64, 5000, 4096),
                     (1, 300, 16, 2, 128, 299), (2, 200, 6, 2, 16, 130)):
            note("flash_decode", dtype, check_decode(rng, *args[:6], dtype,
                                                     *args[6:]))
            if args == (8, 512, 32, 8, 64, 200):
                note("flash_decode", dtype,
                     check_decode(rng, *args, dtype, offset=True))
            if dtype == bf16:
                b, s, hq, hkv, d, t, *w = args
                decode_splits.append(
                    {"B": b, "S": s, "Hkv": hkv, "G": hq // hkv, "D": d,
                     "t": t, "window": sum(w), "splits": fd.n_splits(
                         b * hkv, fd.valid_run(t, s, sum(w)), sms,
                         fd.block_slots(d, 2, hq // hkv))})
    # mamba2-370m at full width (d_inner 2048 = 32 heads of 64, state 128,
    # chunk 256; batch 4, length 512), hymba-1.5b's (d_inner 3200 = 50 heads
    # of 64, state 16, chunk 128; length 512) and ragged shapes; f32 only;
    # each through the version the wrapper picks (the tensor-core one where
    # the shape allows) and through the SIMT one; mamba's also under steep
    # decay
    for args in ((4, 2, 256, 32, 64, 128), (4, 4, 128, 50, 64, 16),
                 (2, 3, 16, 2, 8, 12), (1, 2, 100, 3, 16, 24),
                 (2, 2, 130, 2, 128, 70), (2, 2, 130, 3, 128, 72),
                 (1, 3, 200, 9, 32, 20)):
        for res in check_ssd_both(rng, *args):
            note("ssd_intra_chunk", f32, res)
    for res in check_ssd_both(rng, 4, 2, 256, 32, 64, 128, steep=True):
        note("ssd_intra_chunk", f32, (*res[:2], res[2] + "_steep"))
    for args in ((4, 300, 32, 64, 128, 256), (2, 100, 3, 16, 24, 32)):
        b, length, nh, hp, ns, chunk = args
        note("ssd_intra_chunk", f32, check_ssd_scan(rng, *args))
        for res in check_ssd_both(rng, b, -(-length // chunk), chunk, nh, hp,
                                  ns):
            note("ssd_intra_chunk", f32, res)
    for name, res in check_ladder(rng):
        note(name, f32, res)
    emit({"phase": "kernels", "checked": {
        k: {"max_abs_err": e, "tol": t} for k, (e, t) in worst.items()},
        "flash_decode_splits": decode_splits})

    # timing at the shapes the main path gives the kernels (bf16)
    rows = {"lora_matmul": [], "lora_matmul_grouped": [], "flash_attention": [],
            "flash_decode": [], "ssd_intra_chunk": []}
    for k, n in KN_SHAPES:
        rows["lora_matmul"].append(time_lora_matmul(rng, 64, k, n, 16, bf16))
        rows["lora_matmul_grouped"].append(
            time_grouped(rng, 8, k, n, 16, 4, bf16))
    # f32 lora_matmul_grouped (SIMT; on no path) at the bf16 rows' first two
    # shapes, after the headline rows
    for k, n in KN_SHAPES[:2]:
        rows["lora_matmul_grouped"].append(
            time_grouped(rng, 8, k, n, 16, 4, f32))
    rows["flash_attention"].append(time_flash(rng, 4, 1024, 32, 8, 64, bf16))
    # the f32 tensor-core versions at the calibrate path's probe shapes
    rows["lora_matmul_tf32x3"] = [time_lora_matmul(rng, *shape, f32)
                                  for shape in F32_LORA_SHAPES]
    rows["flash_attention_tf32x3"] = [time_flash(rng, *shape, f32)
                                      for shape in F32_FLASH_SHAPES]
    # flash_decode at the llama32-1b serving cache (bf16 and f32) and at the
    # reference bench's shape
    for dtype in (bf16, f32):
        for t in (511, 200, 0):
            rows["flash_decode"].append(
                time_decode(rng, 8, 512, 32, 8, 64, t, dtype))
    rows["flash_decode"].append(
        time_decode(rng, *decode_bench, decode_bench[1] - 1, f32))
    # ssd_intra_chunk at the shapes mamba_forward(impl="flash") hands it on
    # (4, 1024) tokens: mamba2-370m's and hymba-1.5b's
    rows["ssd_intra_chunk"].append(time_ssd(rng, 4, 4, 256, 32, 64, 128))
    rows["ssd_intra_chunk"].append(time_ssd(rng, 4, 8, 128, 50, 64, 16))
    emit({"phase": "kernel_times", "by_shape": rows,
          "calibrate_benches": time_benches(rng)})
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
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lora_matmul as lm
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
    runs = kernels.runs_on_card()
    versions = {"lora_matmul": dict(lm.lora_matmul.by_version),
                "lora_matmul_grouped": dict(lm.lora_matmul_grouped.by_version),
                "flash_attention": dict(fa.flash_attention.by_version)}
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
    for name, by in versions.items():      # bf16 main path: tensor cores
        assert by["wgmma"] == counts[name] and by["simt"] == 0, versions
    emit({"phase": "serve", "gpu": gpu_line(), "requests": n_requests,
          "slots": 8, "max_len": 512, "prefill_chunk": 64, "max_new": 32,
          "prompt_lens": [int(n) for n in lens],
          **{k: stats[k] for k in ("completed", "ticks", "prefills", "tokens",
                                   "tokens_per_sec", "requests_per_s",
                                   "mean_ttft_s", "wall_s", "drained")},
          "launches": counts, "launches_by_version": versions})

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
              "logit_abs_max": p32[0][..., :cfg.vocab_size].abs().max().item()}
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
    return counts, runs, versions


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
            # the grouped LoRA kernels' device time in the tick (split and
            # reduce kernels of either version)
            out["tick_grouped_device_us"] = sum(
                getattr(e, "device_time_total", 0.0) for e in rows
                if "lora_matmul_grouped" in e.key)
    emit(out)


def _leaves(tree):
    from repro_torch.models.common import tree_leaves
    return tree_leaves(tree)


# ---------------------------------------------------------------------------
# calibrate phase
# ---------------------------------------------------------------------------

CARD_ARCHS = ("llama32-1b", "qwen3-4b", "granite-moe-3b-a800m", "mamba2-370m")


def phase_calibrate(seed: int):
    """The measured-cost path: probes through the Hopper kernels, the fit,
    the tables, the kernel benches; then CARD on the card with the
    analytic and the measured tables, held to the scalar oracle."""
    from repro_torch import kernels
    from repro_torch.launch import calibrate

    # ---- the main path: counts set to 0 just before, read just after ----
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ssd_scan as ss
    kernels.reset_launch_counts()
    payload = calibrate.run(smoke=False, reps=3)       # device=None: the card
    counts = kernels.launch_counts()
    runs = kernels.runs_on_card()
    versions = {"lora_matmul": dict(lm.lora_matmul.by_version),
                "flash_attention": dict(fa.flash_attention.by_version),
                "ssd_intra_chunk": dict(ss.ssd_intra_chunk.by_version)}
    # ----------------------------------------------------------------------
    gpu = gpu_line()
    fit = payload["roofline_fit"]
    inflation = {r["arch"]: r["inflation"] for r in payload["measured"]["rows"]}
    emit({"phase": "calibrate", "gpu": gpu, "device": payload["device"],
          "seconds": payload["seconds"], "probes": payload["probes"],
          "fit": fit, "kernel_benches": payload["kernels"],
          "inflation": inflation, "launches": counts, "runs_on_card": runs,
          "launches_by_version": versions})
    assert len(payload["probes"]) == 12, payload["probes"]
    # every shape of the calibrate path takes the tensor-core version:
    # ssd_intra_chunk "tc", lora_matmul and flash_attention "tf32x3"
    by = versions["ssd_intra_chunk"]
    assert by["tc"] == counts["ssd_intra_chunk"] and by["simt"] == 0, by
    for name in ("lora_matmul", "flash_attention"):
        assert versions[name]["tf32x3"] == counts[name] > 0, (name, versions)
        assert all(p["version"] == "tf32x3" for p in payload["probes"]
                   if p["kernel"] == name), payload["probes"]
    assert all(p["backend"] == "cuda" and p["seconds"] > 0
               and math.isfinite(p["seconds"]) for p in payload["probes"])
    assert all(math.isfinite(fit[k]) for k in
               ("overhead_s", "inv_compute_s_per_flop",
                "inv_bandwidth_s_per_byte", "rel_residual")), fit
    from repro_torch.configs.base import ARCH_IDS, get_config
    from repro_torch.core.measured_cost import LatencyTable
    tables = {a: LatencyTable.from_dict(t)
              for a, t in payload["latency_tables"].items()}
    assert set(tables) == set(ARCH_IDS)
    for arch, table in tables.items():
        assert table.n_layers == get_config(arch).n_layers
        assert table.source == "measured:cuda"
        assert all(math.isfinite(x) and x > 0
                   for x in (table.embed_s, table.head_s, *table.layer_s))
    for name in ("lora_matmul", "flash_attention", "ssd_intra_chunk",
                 "flash_decode"):
        assert 0 < counts[name] <= runs[name], (name, counts, runs)
    calibrate_result = (counts, runs, versions)

    t0 = time.time()
    div = calibrate.decision_divergence(tables, archs=CARD_ARCHS, seed=seed)
    torch.cuda.synchronize()
    emit({"phase": "card_divergence", "seconds": time.time() - t0, **div})
    for cell in div["cells"]:
        assert 0.0 <= cell["mean_cut_analytic"] <= get_config(
            cell["arch"]).n_layers, cell
        assert math.isfinite(cell["mean_delay_ratio"]), cell

    t0 = time.time()
    agree = [calibrate.scalar_agreement(arch, tables[arch], seed=seed)
             for arch in CARD_ARCHS]
    agree.append(calibrate.scalar_agreement("llama32-1b", None, seed=seed))
    emit({"phase": "card_vs_scalar", "seconds": time.time() - t0,
          "near_tie_rel": calibrate.NEAR_TIE_REL, "cells": agree})
    for cell in agree:
        assert cell["disagree_beyond_near_ties"] == 0, cell
        assert cell["worst_freq_rel_diff"] <= 1e-5, cell

    # Fig. 3's decisions moved by the measured tables, and what the tables
    # rest on, on one line (the before/after comparison reads it)
    from repro_torch.launch import fig3_decisions
    fig3 = fig3_decisions.run_divergence(seed=seed, tables=tables)
    emit({"phase": "calibrate_summary", "gpu": gpu,
          "fit": {k: fit[k] for k in ("compute_flops_per_s",
                                      "bandwidth_bytes_per_s", "overhead_s",
                                      "rel_residual")},
          "probes": {f"{p['kernel']}/{p['shape']}": {
              "us": p["seconds"] * 1e6, "version": p["version"]}
              for p in payload["probes"]},
          "benches_us": {r["name"]: r["kernel_us"] for r in payload["kernels"]},
          "inflation": inflation,
          "card_moved_share": div["frac_decisions_moved_overall"],
          "card_decisions": len(div["cells"]) * div["rounds"]
          * div["n_devices"],
          "fig3_moved_share": fig3["frac_decisions_moved_overall"],
          "fig3_moved": {f"{c['arch']}/{c['channel_state']}":
                         c["frac_decisions_moved"] for c in fig3["cells"]}})
    return calibrate_result, tables, payload


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------
# fleet phase
# ---------------------------------------------------------------------------

FLEET_ROUNDS = 10             # rounds of every decisions/s fleet
FLEET_SIZES = (1_000, 10_000, 100_000)
FLEET_BIG = 1_000_000         # the sharded path
FLEET_BIG_SHARDS = 4          # ~1/4 of the unsharded grid's memory
FLEET_SHARD_CHECK = 4         # shards of the 10^5 identity check
FLEET_REPS = 5                # synchronised repetitions per rate
FIG4_AVG_TOL = 1e-4           # vectorized vs scalar Fig. 4 averages, abs


def cut_flips(cfg, scalar_log, batched_log, devices, seed):
    """(flips at near ties, flips beyond them) between the scalar and the
    batched log of one fleet: a flip is a near tie where the scalar costs
    of the two best cuts differ by at most ``calibrate.NEAR_TIE_REL``."""
    from repro_torch.core.channel import draw_channel_matrix
    from repro_torch.core.cost_model import RoundContext, Workload
    from repro_torch.core.hardware import DEFAULT_SIM, SERVER_RTX4060TI
    from repro_torch.launch.calibrate import is_near_tie
    flips = np.argwhere(scalar_log.cuts != batched_log.cuts)
    if len(flips) == 0:
        return 0, 0
    sim = DEFAULT_SIM
    chans = draw_channel_matrix(
        scalar_log.channel_state, *scalar_log.cuts.shape, seed=seed,
        bandwidth_hz=sim.bandwidth_hz, tx_power_dbm_up=sim.tx_power_dbm_up,
        tx_power_dbm_down=sim.tx_power_dbm_down,
        noise_dbm_per_hz=sim.noise_dbm_per_hz)
    workload = Workload(cfg, sim.mini_batch, sim.seq_len)
    tied = sum(is_near_tie(RoundContext(
        workload=workload, device=devices[m], server=SERVER_RTX4060TI,
        channel=chans.state(r, m), sim=sim), float(scalar_log.freqs[r, m]))
        for r, m in flips)
    return tied, len(flips) - tied


def fleet_fig4(cfg, seed, gpu):
    """The paper's Fig. 4 grid (5 Table-I devices, 40 rounds x 3 states x
    3 policies) through the vectorized engine on the card, held to the
    port's scalar float64 engine."""
    from repro_torch.core.hardware import EDGE_FLEET
    from repro_torch.core.scheduler import compare_policies
    from repro_torch.launch.fig4_comparison import reductions
    states = ("good", "normal", "poor")
    kw = dict(rounds=40, seed=seed, channel_states=states)
    t0 = time.perf_counter()
    grid_v = compare_policies(cfg, **kw)             # device=None: the card
    t_vec = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid_s = compare_policies(cfg, engine="scalar", **kw)
    t_scalar = time.perf_counter() - t0
    red_v, red_s = reductions(grid_v, states), reductions(grid_s, states)
    tied = beyond = 0
    for state in states:
        t, b = cut_flips(cfg, grid_s["card"][state], grid_v["card"][state],
                         EDGE_FLEET, seed)
        tied, beyond = tied + t, beyond + b
    diffs = {k: abs(red_v[k] - red_s[k]) for k in ("avg_delay_reduction",
                                                   "avg_energy_reduction")}
    emit({"phase": "fleet_fig4", "gpu": gpu, "devices": len(EDGE_FLEET),
          "rounds": 40, "states": list(states),
          "per_state": {s: {k: red_v["per_state"][s][k] for k in (
              "delay_reduction_vs_device_only",
              "energy_reduction_vs_server_only")} for s in states},
          "avg_delay_reduction": red_v["avg_delay_reduction"],
          "avg_energy_reduction": red_v["avg_energy_reduction"],
          "scalar_avg_delay_reduction": red_s["avg_delay_reduction"],
          "scalar_avg_energy_reduction": red_s["avg_energy_reduction"],
          "paper_claims": red_v["paper_claims"],
          "avg_abs_diff_vs_scalar": diffs, "tol": FIG4_AVG_TOL,
          "cut_flips_near_tie": tied, "cut_flips_beyond_near_tie": beyond,
          "vectorized_s": t_vec, "scalar_s": t_scalar})
    assert beyond == 0, (tied, beyond)
    assert all(d <= FIG4_AVG_TOL for d in diffs.values()), diffs
    for state in states:
        for policy in ("card", "server_only", "device_only"):
            log = grid_v[policy][state]
            assert np.isfinite(log.delays).all() and (log.delays > 0).all()
            assert log.cuts.shape == (40, len(EDGE_FLEET))


def _same_logs(a, b, fields) -> bool:
    return all(np.array_equal(a[f], b[f]) for f in fields)


def fleet_rates(cfg, seed, gpu):
    """Decisions/s of the vectorized engine: one built context per fleet
    size, then the grid on the card and the one host copy, median of
    ``FLEET_REPS`` synchronised repetitions; 10^6 devices through
    ``FLEET_BIG_SHARDS`` chunks. Sharded against unsharded, bit for bit, at
    10^3 through ``simulate_fleet``, at 10^5 and 10^6 on one context."""
    from repro_torch.core import card as C
    from repro_torch.core import scheduler as S
    from repro_torch.core.hardware import (DEFAULT_SIM, SERVER_RTX4060TI,
                                           make_heterogeneous_fleet)
    from repro_torch.launch.mesh import make_fleet_mesh
    fields = S.LOG_FIELDS
    rows = []
    # the public path: simulate_fleet, sharded == unsharded at 10^3
    fleet = make_heterogeneous_fleet(FLEET_SIZES[0], seed=seed)
    a = S.simulate_fleet(cfg, rounds=FLEET_ROUNDS, devices=fleet, seed=seed)
    b = S.simulate_fleet(cfg, rounds=FLEET_ROUNDS, devices=fleet, seed=seed,
                         mesh=make_fleet_mesh(3))
    same_1k = _same_logs(vars(a), vars(b), fields)
    # the scalar engine at 100 devices, and the vectorized one beside it
    fleet100 = make_heterogeneous_fleet(100, seed=seed)
    t0 = time.perf_counter()
    s100 = S.simulate_fleet(cfg, rounds=5, devices=fleet100, seed=seed,
                            engine="scalar")
    scalar_s = time.perf_counter() - t0
    v100 = S.simulate_fleet(cfg, rounds=5, devices=fleet100, seed=seed)
    flips100 = cut_flips(cfg, s100, v100, fleet100, seed)
    for n in FLEET_SIZES + (FLEET_BIG,):
        t0 = time.perf_counter()
        fleet = make_heterogeneous_fleet(n, seed=seed)
        bctx = S.fleet_context(cfg, channel_state="normal",
                               rounds=FLEET_ROUNDS, devices=fleet,
                               server=SERVER_RTX4060TI, sim=DEFAULT_SIM,
                               seed=seed)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        del fleet
        mesh = make_fleet_mesh(FLEET_BIG_SHARDS) if n == FLEET_BIG else None
        S.fleet_decisions(bctx, mesh=mesh)                  # first use
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(FLEET_REPS):
            t0 = time.perf_counter()
            host = S.fleet_decisions(bctx, mesh=mesh)       # ends in a copy
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        med = float(np.median(times))
        row = {"devices": n, "rounds": FLEET_ROUNDS,
               "decisions": n * FLEET_ROUNDS,
               "n_shards": 1 if mesh is None else mesh.n_shards,
               "build_s": build_s, "decide_s": times, "median_s": med,
               "decisions_per_s": n * FLEET_ROUNDS / med,
               "context_bytes": base, "peak_memory_bytes": peak}
        if mesh is None:
            # CUDA-event span of the grid alone (batched_card, no host
            # copy): device time plus the card's waits for the host's
            # launches
            grid_ms = []
            for _ in range(FLEET_REPS):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                C.batched_card(bctx)
                ev[1].record()
                torch.cuda.synchronize()
                grid_ms.append(ev[0].elapsed_time(ev[1]))
            row["grid_span_ms_median"] = float(np.median(grid_ms))
        if n == FLEET_SIZES[-1]:
            check = make_fleet_mesh(FLEET_SHARD_CHECK)
            row["sharded_equal"] = _same_logs(
                S.fleet_decisions(bctx, mesh=check), host, fields)
            row["sharded_check_shards"] = check.n_shards
            if torch.cuda.device_count() > 1:     # one shard per card
                cards = make_fleet_mesh(0)
                t0 = time.perf_counter()
                row["multi_card_equal"] = _same_logs(
                    S.fleet_decisions(bctx, mesh=cards), host, fields)
                row["multi_card_s"] = time.perf_counter() - t0
                row["multi_card_devices"] = [str(d) for d in cards.devices]
        if n == FLEET_BIG:
            torch.cuda.reset_peak_memory_stats()
            unsharded = S.fleet_decisions(bctx)
            row["unsharded_peak_memory_bytes"] = \
                torch.cuda.max_memory_allocated()
            row["sharded_equal"] = _same_logs(unsharded, host, fields)
            del unsharded
            row["finite"] = bool(np.isfinite(host["delays"]).all())
        rows.append(row)
        del bctx, host
        torch.cuda.empty_cache()
    emit({"phase": "fleet_rates", "gpu": gpu, "rows": rows,
          "simulate_fleet_sharded_equal_1k": same_1k,
          "scalar_100": {"devices": 100, "rounds": 5, "seconds": scalar_s,
                         "decisions_per_s": 500 / scalar_s,
                         "cut_flips_vs_vectorized": flips100}})
    assert same_1k
    assert flips100[1] == 0, flips100
    for row in rows:
        assert row.get("sharded_equal", True), row
        assert row.get("multi_card_equal", True), row
    assert rows[-1]["finite"], rows[-1]
    return rows


def fleet_hierarchy(cfg, seed, gpu):
    """The hierarchy sweep (1, 2, 4, 8 servers x 100, 1000 devices), then
    hierarchical CARD on the card against the scalar float64 oracle at 20
    devices x 3 servers."""
    from repro_torch.core import card as C
    from repro_torch.core.channel import draw_channel_matrix
    from repro_torch.core.cost_model import (RoundContext, TieredRoundContext,
                                             Workload)
    from repro_torch.core.hardware import (DEFAULT_SIM,
                                           make_heterogeneous_fleet,
                                           make_server_tier)
    from repro_torch.launch import hierarchy_bench
    from repro_torch.launch.calibrate import NEAR_TIE_REL, is_near_tie
    sweep = hierarchy_bench.run(seed=seed)           # device=None: the card
    sim = DEFAULT_SIM
    workload = Workload(cfg, sim.mini_batch, sim.seq_len)
    fleet = make_heterogeneous_fleet(20, seed=seed)
    tier = make_server_tier(3, capacity=7, seed=seed)
    chans = draw_channel_matrix("normal", 3, 20, seed=seed,
                                bandwidth_hz=sim.bandwidth_hz,
                                tx_power_dbm_up=sim.tx_power_dbm_up,
                                tx_power_dbm_down=sim.tx_power_dbm_down,
                                noise_dbm_per_hz=sim.noise_dbm_per_hz)
    tctx = TieredRoundContext.build(workload, fleet, tier, chans, sim)
    hb = C.hierarchical_card(tctx, assign="optimal")
    hs = C.hierarchical_card_scalar(workload, fleet, tier, chans, sim,
                                    assign="optimal")
    price = C.tiered_card_grid(tctx).costs.double().mean(dim=1).cpu().numpy()
    moved = np.nonzero(hb.assignment != hs.assignment)[0]
    moved_tied = [int(d) for d in moved if abs(
        price[hb.assignment[d], d] - price[hs.assignment[d], d])
        <= NEAR_TIE_REL * max(abs(price[hb.assignment[d], d]),
                              abs(price[hs.assignment[d], d]))]
    same = hb.assignment == hs.assignment
    flips = np.argwhere((hb.cuts != hs.cuts) & same[None, :])
    flips_tied = sum(is_near_tie(RoundContext(
        workload=workload, device=fleet[m],
        server=tier.servers[hb.assignment[m]], channel=chans.state(r, m),
        sim=sim), float(hs.freqs[r, m])) for r, m in flips)
    freq_rel = float(np.max(np.abs(hb.freqs[:, same] - hs.freqs[:, same])
                            / hs.freqs[:, same]))
    agg_rel = float(np.max(np.abs(hb.aggregation_s - hs.aggregation_s)
                           / hs.aggregation_s.clip(min=1e-30)))
    emit({"phase": "fleet_hierarchy", "gpu": gpu,
          "sweep": [{k: r[k] for k in ("servers", "devices", "wall_s",
                                       "load_imbalance", "mean_round_s",
                                       "mean_delay_s", "mean_energy_j")}
                    for r in sweep["sweep"]],
          "vs_scalar": {"devices": 20, "servers": 3, "rounds": 3,
                        "capacity": 7, "assign": "optimal",
                        "assignment_equal": bool(same.all()),
                        "assignment_moved_near_tie": moved_tied,
                        "cut_flips": len(flips),
                        "cut_flips_near_tie": flips_tied,
                        "worst_freq_rel_diff": freq_rel,
                        "worst_aggregation_rel_diff": agg_rel,
                        "server_load": hb.server_load.tolist()}})
    assert len(moved_tied) == len(moved), (moved, moved_tied)
    assert flips_tied == len(flips), (flips, flips_tied)
    assert freq_rel <= 1e-5 and agg_rel <= 1e-5, (freq_rel, agg_rel)
    assert (hb.server_load <= 7).all() and hb.server_load.sum() == 20
    assert len(sweep["sweep"]) == 8
    for r in sweep["sweep"]:
        assert math.isfinite(r["mean_round_s"]) and r["mean_round_s"] > 0, r


def fleet_churn(cfg, seed, gpu):
    """The churn sweep (1000 devices, 10 rounds, dropout 0-0.4) and the
    zero-fault identity on the card."""
    from repro_torch.core.faults import DeadlinePolicy, FaultModel
    from repro_torch.core.hardware import make_heterogeneous_fleet
    from repro_torch.core.scheduler import LOG_FIELDS, simulate_fleet
    from repro_torch.launch import churn_bench
    sweep = churn_bench.run(seed=seed)               # device=None: the card
    sweep.pop("worst_case_realization")
    fleet = make_heterogeneous_fleet(1000, seed=seed)
    base = simulate_fleet(cfg, rounds=10, devices=fleet, seed=seed)
    degenerate = simulate_fleet(cfg, rounds=10, devices=fleet, seed=seed,
                                fault_model=FaultModel(),
                                deadline=DeadlinePolicy(quantile=1.0))
    identical = (_same_logs(vars(base), vars(degenerate), LOG_FIELDS)
                 and bool(degenerate.participation.all()))
    emit({"phase": "fleet_churn", "gpu": gpu, **sweep,
          "zero_fault_identity": identical})
    assert identical
    rates = [r["dropout_rate"] for r in sweep["sweep"]]
    survivors = [r["survivor_fraction"] for r in sweep["sweep"]]
    assert rates == [0.0, 0.1, 0.2, 0.4], rates
    assert all(b < a for a, b in zip(survivors, survivors[1:])), survivors
    assert all(math.isfinite(r["mean_delay_s"]) for r in sweep["sweep"])


def fleet_fig3(cfg, seed, gpu, tables):
    """Fig. 3 (cuts and frequencies per device over 50 rounds) and its
    decision divergence over the card-calibrated measured tables."""
    from repro_torch.launch import fig3_decisions
    fig3 = fig3_decisions.run(seed=seed)             # device=None: the card
    div = fig3_decisions.run_divergence(seed=seed, tables=tables)
    emit({"phase": "fleet_fig3", "gpu": gpu, "bimodal": fig3["bimodal"],
          "offload_monotone_with_weakness":
              fig3["offload_monotone_with_weakness"],
          "cuts": fig3["cuts"], "divergence": div})
    assert div["table_source"] == "tables" and len(div["cells"]) == 9
    for cell in div["cells"]:
        assert math.isfinite(cell["mean_delay_ratio"]), cell
        assert 0.0 <= cell["frac_decisions_moved"] <= 1.0, cell


def phase_fleet(seed: int, tables):
    """The fleet engines and the tiered CARD stack on the card, at
    llama32-1b's full config (32 layers, 33 cuts), ``DEFAULT_SIM`` (batch
    4 x 512): Fig. 4, decisions/s to 10^6 devices, sharded == unsharded,
    hierarchy, churn, Fig. 3 on ``tables`` (the calibrate path's). No
    kernel is launched: the grids are plain tensor programs, as the
    reference's are plain jnp."""
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    gpu = gpu_line()
    cfg = get_config("llama32-1b")
    t_phase = time.time()
    seconds, peaks = {}, {}
    # ---- the fleet path: counts set to 0 just before, read just after ----
    kernels.reset_launch_counts()
    for name, fn, args in (("fig4", fleet_fig4, ()),
                           ("rates", fleet_rates, ()),
                           ("hierarchy", fleet_hierarchy, ()),
                           ("churn", fleet_churn, ()),
                           ("fig3", fleet_fig3, (tables,))):
        t0 = time.time()
        torch.cuda.reset_peak_memory_stats()
        out = fn(cfg, seed, gpu, *args)
        seconds[name] = time.time() - t0
        # fleet_rates resets the peak per fleet size and reports each
        peaks[name] = max([torch.cuda.max_memory_allocated()]
                          + [r[k] for r in (out or ()) for k in r
                             if k.endswith("peak_memory_bytes")])
    counts = kernels.launch_counts()
    runs = kernels.runs_on_card()
    # ----------------------------------------------------------------------
    emit({"phase": "fleet", "gpu": gpu, "launches": counts,
          "runs_on_card": runs, "seconds_by_part": seconds,
          "peak_memory_bytes_by_part": peaks,
          "peak_memory_bytes": max(peaks.values()),
          "seconds": time.time() - t_phase})
    assert all(n == 0 for n in counts.values()), counts
    assert all(n == 0 for n in runs.values()), runs
    return counts, runs, {}


# ---------------------------------------------------------------------------

SPLIT_TOL = 1e-3         # split vs unsplit grads, f32, x max|leaf|


class StageClock:
    """The ``mark`` of ``split_grads``: a CUDA event as each stage begins,
    read after the run as device ms per stage of each local epoch."""

    STAGES = ("device_forward", "server", "device_backward", "end")

    def __init__(self):
        self.events = []

    def __call__(self, stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((stage, ev))

    def epochs(self):
        torch.cuda.synchronize()
        n = len(self.STAGES)
        out = []
        for i in range(0, len(self.events), n):
            names, evs = zip(*self.events[i:i + n])
            assert names == self.STAGES, names
            out.append({f"{a}_ms": evs[j].elapsed_time(evs[j + 1])
                        for j, a in enumerate(self.STAGES[:-1])})
        return out


def _tree_err(got, want):
    """Worst leaf error relative to that leaf's largest magnitude; inf if
    any leaf of either tree is not finite."""
    worst = 0.0
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        assert a.shape == b.shape, (a.shape, b.shape)
        if b.numel():
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                return math.inf
            scale = b.abs().max().item()
            worst = max(worst, (a - b).abs().max().item() / max(scale, 1e-30))
    return worst


def mm_out_dtype_has_derivative() -> bool:
    """Whether ``torch.mm(..., out_dtype=float32)`` (the f32 logits of a
    bf16 model) has a backward of its own in this PyTorch; the model wraps
    it in an autograd Function either way."""
    x = torch.ones(4, 8, dtype=torch.bfloat16, device="cuda",
                   requires_grad=True)
    w = torch.ones(8, 4, dtype=torch.bfloat16, device="cuda")
    try:
        torch.mm(x, w, out_dtype=torch.float32).sum().backward()
    except RuntimeError:
        return False
    return x.grad is not None


def phase_train(seed: int, profile: bool = False):
    """Split LoRA fine-tuning of full-width llama32-1b on the card:
    (a) split grads equal unsplit grads in f32 at cuts 0, 16, 32; (b) the
    kernel routes refuse autograd; (c) ``SplitFineTuner`` with CARD in the
    loop, then a static mid cut, bf16, per-stage CUDA-event times; (d)
    ``make_train_step`` lowers the loss on a fixed batch, remat on and off.
    The path trains through no kernel, as the reference does: its kernel
    launches are read around the phase and must be 0."""
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    from repro_torch.core import splitting as S
    from repro_torch.core.channel import WirelessChannel
    from repro_torch.core.hardware import (EDGE_FLEET, SERVER_RTX4060TI,
                                           SimParams)
    from repro_torch.core.protocol import SplitFineTuner
    from repro_torch.data import make_fleet_datasets
    from repro_torch.launch.train import make_train_step, value_and_grad
    from repro_torch.models import model as M
    from repro_torch.models.common import batch_to_device, lora_dense
    from repro_torch.optim import adamw, constant_schedule

    dev = torch.device("cuda")
    cfg = get_config("llama32-1b")
    gpu = gpu_line()
    torch.cuda.empty_cache()
    t_phase = time.time()

    # ---- the main path: counts set to 0 just before, read just after ----
    kernels.reset_launch_counts()

    # (a) split == unsplit, f32, channel off, batch 2 x 256
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = M.init_params(seed, cfg32)
    frozen32, lora32 = p32["frozen"], make_adapter(cfg32, seed + 1, dev)
    del p32
    rng = np.random.default_rng(seed + 200)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 256)),
                           device=dev)
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 256)),
                             device=dev)
    ref_loss, ref = value_and_grad(
        lambda lo: M.forward_loss(frozen32, lo,
                                  {"tokens": toks, "labels": labels}, cfg32,
                                  impl="naive", remat=False), lora32)
    split = {"batch": [2, 256], "dtype": "float32", "tol": SPLIT_TOL,
             "loss": ref_loss.item(), "cuts": {}}
    for cut in (0, 16, 32):
        d, s_ = S.split_lora(lora32, cut)
        loss, gd, gs = S.split_grads(frozen32, d, s_, toks, labels, cfg=cfg32,
                                     cut=cut, compress=False)
        split["cuts"][cut] = {
            "loss_rel_err": abs(loss.item() / ref_loss.item() - 1),
            "worst_leaf_rel_err": _tree_err(S.merge_lora(gd, gs), ref)}
    # (b) the kernel routes refuse autograd on the card
    refused = {}
    d, s_ = S.split_lora(lora32, 16)
    try:
        S.split_grads(frozen32, d, s_, toks, labels, cfg=cfg32, cut=16,
                      impl="pallas")
    except RuntimeError as e:
        refused["split_grads_pallas"] = str(e).split(":")[0]
    x = torch.randn(8, cfg.d_model, device=dev, requires_grad=True)
    pair = {k: v[0] for k, v in lora32["layers"]["attn"]["wq"].items()}
    try:
        lora_dense(x, frozen32["layers"]["attn"]["wq"][0], pair,
                   cfg.lora.scale, use_kernel=True)
    except RuntimeError as e:
        refused["lora_dense_kernel"] = str(e).split(":")[0]
    del frozen32, lora32, ref, gd, gs
    torch.cuda.empty_cache()
    emit({"phase": "train_split_equals_unsplit", "gpu": gpu, **split,
          "refused_under_grad": refused,
          "mm_out_dtype_has_derivative": mm_out_dtype_has_derivative()})
    for cut, r in split["cuts"].items():
        assert r["loss_rel_err"] <= SPLIT_TOL, (cut, r)
        assert r["worst_leaf_rel_err"] <= SPLIT_TOL, (cut, r)
    assert refused == {
        "split_grads_pallas": "flash_attention has no backward",
        "lora_dense_kernel": "lora_matmul has no backward"}, refused

    # (c) CARD in the loop, bf16, then a static mid cut
    params = M.init_params(seed, cfg)
    frozen, lora0 = params["frozen"], make_adapter(cfg, seed + 1, dev)
    del params
    sim = SimParams(local_epochs=2)
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    for policy, rounds, static in (("card", 3, None), ("static", 2, 16)):
        ft = SplitFineTuner(
            cfg, frozen, lora0, adamw(constant_schedule(3e-3)),
            devices=list(EDGE_FLEET[:2]), server=SERVER_RTX4060TI,
            channels=[WirelessChannel("normal", seed=i) for i in range(2)],
            datasets=make_fleet_datasets(cfg, 2, seed=1), sim=sim,
            policy=policy, static_cut=static, cost_cfg=cfg)
        clock = StageClock()
        ft.executor.mark = clock
        walls = []
        run_round = ft.run_round

        def timed_round(n, m, run_round=run_round, walls=walls):
            t0 = time.perf_counter()
            log = run_round(n, m)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            return log
        ft.run_round = timed_round
        res = ft.run(rounds)
        epochs = clock.epochs()
        logs = [dataclasses.asdict(l) for l in res.logs]
        for i, log in enumerate(logs):
            log["wall_s_per_epoch"] = walls[i] / sim.local_epochs
            log["epochs_ms"] = epochs[i * sim.local_epochs:
                                      (i + 1) * sim.local_epochs]
        runs[policy] = {"rounds": rounds, "static_cut": static,
                        "committed": res.rounds_committed(), "logs": logs}
        assert res.rounds_committed() == rounds, res.round_summaries
        assert all(l["status"] == "ok" and math.isfinite(l["loss"])
                   for l in logs), logs
    card_peak = torch.cuda.max_memory_allocated()
    cuts = [l["cut"] for r in runs.values() for l in r["logs"]]
    emit({"phase": "train_protocol", "gpu": gpu, "arch": cfg.name,
          "dtype": cfg.dtype, "mini_batch": sim.mini_batch,
          "seq_len": sim.seq_len, "local_epochs": sim.local_epochs,
          "peak_memory_bytes": card_peak, **runs})
    assert any(0 < c < cfg.n_layers for c in cuts), cuts

    # (d) the train step learns on one fixed batch, remat on and off
    batch = batch_to_device(
        make_fleet_datasets(cfg, 1, seed=2)[0].minibatch(4, 512), dev)
    steps = {}
    for remat in (True, False):
        opt = adamw(constant_schedule(3e-3))
        step = make_train_step(cfg, opt, impl="chunked", remat=remat, cut=0)
        lora, st = lora0, opt.init(lora0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses, events = [], []
        for _ in range(8):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            loss, lora, st = step(frozen, lora, st, batch)
            losses.append(loss)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        losses = torch.stack(losses).tolist()
        wall = time.perf_counter() - t0
        step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        steps["remat" if remat else "no_remat"] = {
            "losses": losses, "step_ms": step_ms,
            # steady state: the first step of each run pays first-call costs
            "steps_per_s": 1e3 / float(np.median(step_ms[1:])),
            "wall_steps_per_s": 8 / wall,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    counts = kernels.launch_counts()
    runs_on = kernels.runs_on_card()
    # ----------------------------------------------------------------------
    emit({"phase": "train_step", "gpu": gpu, "batch": [4, 512],
          "optimizer": "adamw, constant 3e-3", "impl": "chunked", **steps,
          "launches": counts, "phase_seconds": time.time() - t_phase})
    if profile:
        emit(train_profile(cfg, frozen, lora0, batch, gpu))
    for name, r in steps.items():
        assert all(math.isfinite(v) for v in r["losses"]), (name, r)
        assert r["losses"][-1] < r["losses"][0], (name, r)
    assert all(n == 0 for n in counts.values()), counts
    return counts, runs_on, {}


def train_profile(cfg, frozen, lora, batch, gpu, cut: int = 16):
    """One local epoch (``split_grads`` at ``cut``, bf16, 4 x 512) under
    ``torch.profiler``: device time by kernel, and the share of the
    epoch's wall in which the card ran no kernel."""
    from torch.profiler import ProfilerActivity, profile as prof
    from repro_torch.core import splitting as S
    d, s_ = S.split_lora(lora, cut)

    def epoch():
        S.split_grads(frozen, d, s_, batch["tokens"], batch["labels"],
                      cfg=cfg, cut=cut)
        torch.cuda.synchronize()
    epoch()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        epoch()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels_ = [e for e in p.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels_)
    rows = sorted(p.key_averages(),
                  key=lambda e: -getattr(e, "self_device_time_total", 0.0))
    return {"phase": "train_profile", "gpu": gpu, "cut": cut,
            "wall_us": wall_us, "device_busy_us": busy_us,
            "device_idle_share": max(0.0, 1 - busy_us / wall_us),
            "device_kernels": len(kernels_),
            "device_us_by_op": [
                {"name": e.key[:60], "calls": e.count,
                 "self_device_us": getattr(e, "self_device_time_total", 0.0)}
                for e in rows[:15]]}


# ---------------------------------------------------------------------------
# families phase
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("mamba2-370m", "hymba-1.5b", "granite-moe-3b-a800m")
FAMILY_REQUESTS = 8        # served per config
FAMILY_CHUNK = 32          # the engine's prefill chunk
LOGIT_TOKENS = 8           # the prompt of the serve logits check
# the bf16 train step's AdamW rate: the train phase's 3e-3, but 3e-4 for
# granite, whose loss on the fixed batch rose at 3e-3 at full width (11.57,
# 11.54, 12.69, 11.83 on the H100); the port's MoE step equals the
# reference's at 3e-3 step by step at the reduced size
# (tests/test_torch_train.py::test_moe_train_step_matches_jax_at_3e_3_on_one_batch)
TRAIN_LR = {"moe": 3e-4}


def lora_projections(cfg) -> int:
    """LoRA projections a layer sends through ``lora_dense`` with the
    caller's kernel route. The attention takes its targets among wq, wk, wv,
    wo (4 of them); the dense MLP among w_gate, w_up, w_down (3). The Mamba
    block's in_proj and out_proj always take the plain product
    (``mamba_decode`` as the reference; in ``mamba_forward`` the route is
    the prefill step's, which has none), and the MoE block's out_adapter two
    plain products. So: mamba2-370m 0, hymba-1.5b 4 + 3 = 7, granite 4."""
    targets = set(cfg.lora.targets)
    n = 0
    if cfg.family != "ssm":
        n += len(targets & {"wq", "wk", "wv", "wo"})
    if cfg.family not in ("ssm", "moe"):
        n += len(targets & {"w_gate", "w_up", "w_down"})
    return n


def family_kernel_checks(seed: int, gpu: str):
    """The kernels of the families path against their plain versions at
    the shapes that path hands them, through the version the wrapper picks
    (``wgmma`` and ``tc``, asserted), at the kernels phase's tolerances
    (``LORA_TOL``, ``ATTN_TOL``, ``SSD_TOL``). hymba-1.5b and granite, bf16:
    every LoRA projection (K, N) of a layer; ``lora_matmul`` at M = 1
    (hymba's scan prefill: a decode step a token) and M = ``FAMILY_CHUNK``
    (granite's parallel chunk); ``lora_matmul_grouped`` at a tick's 8 rows,
    each its own adapter of a strided gathered bank, as the engine hands
    them; the flash prefill's attention on (4, 1024). mamba2-370m and
    hymba, f32: ``ssd_intra_chunk`` at the flash prefill's chunks of
    (4, 1024) tokens. mamba2's LoRA takes the plain product. Launches made
    here precede the families path's counts."""
    from repro_torch.configs.base import get_config
    rng = np.random.default_rng(seed + 300)
    bf16 = torch.bfloat16
    out = []
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        if cfg.has_ssm:
            cl = cfg.ssm_chunk
            shape = (4, 1024 // cl, cl, cfg.ssm_n_heads, cfg.ssm_head_dim,
                     cfg.ssm_state)
            out.append(("ssd_intra_chunk", arch, shape,
                        check_ssd(rng, *shape)))
        if cfg.family == "ssm":
            continue
        r, scale = cfg.lora.rank, cfg.lora.scale
        d, q = cfg.d_model, cfg.n_heads * cfg.head_dim
        kv = cfg.n_kv_heads * cfg.head_dim
        kns = [(d, q), (d, kv), (q, d)]
        if cfg.family == "hybrid":                  # the dense MLP's
            kns += [(d, cfg.d_ff), (cfg.d_ff, d)]
        m = 1 if cfg.has_ssm else FAMILY_CHUNK
        for k, n in dict.fromkeys(kns):
            res = check_lora_matmul(rng, m, k, n, r, bf16, scale)
            out.append(("lora_matmul", arch, (m, k, n, r), res))
            res = check_grouped(rng, 8, 1, k, n, r, 8, bf16,
                                ids=list(range(8)), scale=scale,
                                strided=True)
            out.append(("lora_matmul_grouped", arch, (8, 1, k, n, r), res))
        shape = (4, 1024, 1024, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        res = check_flash(rng, *shape, bf16, causal=True,
                          window=cfg.sliding_window)
        out.append(("flash_attention", arch,
                    (*shape, cfg.sliding_window), res))
    emit({"phase": "families_kernels", "gpu": gpu,
          "checked": [{"name": name, "arch": arch, "shape": list(shape),
                       "max_abs_err": err, "tol": tol, "version": version}
                      for name, arch, shape, (err, tol, version) in out]})
    for name, arch, shape, (err, tol, version) in out:
        assert version == ("tc" if name == "ssd_intra_chunk" else "wgmma"), (
            name, arch, shape, version)


def prefill_ssd_share(fn):
    """One call of ``fn`` under ``torch.profiler``: the device µs of the
    ``ssd_intra_chunk`` kernels (scores and heads) beside all the device
    µs of the call."""
    from torch.profiler import ProfilerActivity, profile as prof
    with prof(activities=[ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    kernels_ = [e for e in p.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.time_range.elapsed_us() for e in kernels_)
    ssd = sum(e.time_range.elapsed_us() for e in kernels_
              if "ssd_" in e.name and "_tc_kernel" in e.name)
    return {"device_us": total, "ssd_intra_chunk_device_us": ssd,
            "ssd_intra_chunk_share": ssd / total if total else 0.0}


def family_serve(cfg, frozen, bank, seed, gpu, chunk=FAMILY_CHUNK,
                 phase="families_serve"):
    """(a) ``ServingEngine`` with the fused kernels on ``FAMILY_REQUESTS``
    requests, prefill chunks of ``chunk`` tokens; its launch counts read
    around the run. Returns (counts, versions)."""
    from repro_torch import kernels
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.serving import Request, ServingEngine
    rng = np.random.default_rng(seed)
    n_requests = FAMILY_REQUESTS
    lens = rng.integers(40, 101, n_requests)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size, int(lens[i]),
                                        dtype=np.int64).astype(np.int32),
                    max_new=16, adapter_id=i % 4) for i in range(n_requests)]
    eng = ServingEngine(cfg, frozen, bank, slots=8, max_len=512,
                        prefill_chunk=chunk, use_lora_kernel=True)
    # ---- the main path: counts set to 0 just before, read just after ----
    kernels.reset_launch_counts()
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    versions = {"lora_matmul": dict(lm.lora_matmul.by_version),
                "lora_matmul_grouped": dict(lm.lora_matmul_grouped.by_version)}
    # ----------------------------------------------------------------------
    per_layer = lora_projections(cfg) * cfg.n_layers
    scan = cfg.has_ssm         # the engine prefills SSM state by decode_scan
    emit({"phase": phase, "gpu": gpu, "arch": cfg.name,
          "requests": n_requests, "slots": 8, "max_len": 512,
          "prefill_chunk": chunk,
          "prefill_mode": "scan" if scan else "parallel",
          "max_new": 16, "prompt_lens": [int(n) for n in lens],
          **{k: stats[k] for k in ("completed", "ticks", "prefills", "tokens",
                                   "tokens_per_sec", "requests_per_s",
                                   "mean_ttft_s", "wall_s", "drained")},
          "launches": counts, "launches_by_version": versions})
    assert stats["drained"] and stats["completed"] == n_requests, stats
    for r in reqs:
        assert len(r.output) == 16, (r.uid, len(r.output))
        assert all(0 <= t < cfg.vocab_size for t in r.output), r.uid
    assert stats["prefills"] == sum(int(n) // chunk for n in lens)
    # a tick: every projection of every layer through the grouped kernel
    # (per-row adapters); a prefill chunk: through lora_matmul (one
    # adapter), once per chunk in parallel mode, once per token of it in
    # scan mode (decode_scan is one decode_step a token)
    assert counts["lora_matmul_grouped"] == per_layer * stats["ticks"], counts
    assert counts["lora_matmul"] == per_layer * stats["prefills"] * (
        chunk if scan else 1), counts
    for name in ("flash_attention", "flash_decode", "ssd_intra_chunk"):
        assert counts[name] == 0, counts
    for name, by in versions.items():      # bf16: tensor cores only
        assert by["wgmma"] == counts[name] and by["simt"] == 0, versions
    return counts, versions


def family_serve_logits(cfg, cfg32, frozen, frozen32, bank, gpu,
                        ids=(0, 1, 2, 3, 0, 1, 2, 3),
                        prompt_tokens=LOGIT_TOKENS,
                        phase="families_serve_logits"):
    """(a) continued: one tick (per-row adapters ``ids``) and one prompt of
    ``prompt_tokens`` tokens through the engine's prefill function (one
    adapter), with the fused kernels and with the plain LoRA path, in bf16
    and in f32, on fresh caches; held as the dense serve_logits phase
    holds them (rows 0 and 1 must differ where their adapters do, a row
    repeating row 0's adapter must not)."""
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_map
    from repro_torch.serving import AdapterBank
    dev = frozen["embed"].device
    rows = len(ids)
    differ = rows > 1 and ids[1] != ids[0]
    repeat = next((j for j in range(1, rows) if ids[j] == ids[0]), None)
    ids = torch.as_tensor(ids, device=dev)
    tok = torch.full((rows, 1), 1234 % cfg.vocab_size, dtype=torch.int32,
                     device=dev)
    ts = torch.zeros((rows,), dtype=torch.int32, device=dev)
    ptoks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, prompt_tokens)), device=dev)
    chunk_fn = M.decode_scan if cfg.has_ssm else M.prefill_chunk
    f32_tol, bf16_tol = 2e-3, 1.0

    def tick_and_prompt(fz, c, act, use_kernel):
        stacked = tree_map(lambda v: v.to(act), bank.stacked)
        lora_b = AdapterBank.gather(stacked, ids)
        one = {"layers": tree_map(lambda v: v[1], stacked["layers"])}
        with torch.no_grad():
            tick, _ = M.decode_step(fz, lora_b,
                                    M.init_cache(c, rows, 64, dev), tok, ts,
                                    c, use_lora_kernel=use_kernel)
            prompt, _ = chunk_fn(fz, one, M.init_cache(c, 1, 64, dev), ptoks,
                                 0, c, use_lora_kernel=use_kernel)
        return tick, prompt

    def err(x, y):
        return (x - y).abs().max().item()

    k32 = tick_and_prompt(frozen32, cfg32, torch.float32, True)
    p32 = tick_and_prompt(frozen32, cfg32, torch.float32, False)
    kbf = tick_and_prompt(frozen, cfg, torch.bfloat16, True)
    pbf = tick_and_prompt(frozen, cfg, torch.bfloat16, False)
    report = {"phase": phase, "gpu": gpu, "arch": cfg.name,
              "ids": ids.tolist(), "prompt_tokens": prompt_tokens,
              "f32_tol": f32_tol, "bf16_tol": bf16_tol,
              "logit_abs_max": p32[0][..., :cfg.vocab_size].abs().max().item()}
    for i, what in enumerate(("tick", "prompt")):
        report[what] = {
            "f32_kernel_vs_plain": err(k32[i], p32[i]),
            "bf16_kernel_vs_plain": err(kbf[i], pbf[i]),
            "bf16_kernel_vs_f32": err(kbf[i], p32[i]),
            "bf16_plain_vs_f32": err(pbf[i], p32[i])}
    if differ:
        report["diff_between_adapters"] = err(kbf[0][0], kbf[0][1])
    if repeat is not None:
        report["diff_same_adapter"] = err(kbf[0][0], kbf[0][repeat])
    emit(report)
    for what in ("tick", "prompt"):
        r = report[what]
        assert all(math.isfinite(v) for v in r.values()), r
        assert r["f32_kernel_vs_plain"] <= f32_tol, r
        assert r["bf16_kernel_vs_plain"] <= bf16_tol, r
        assert (r["bf16_kernel_vs_f32"]
                <= 2.0 * r["bf16_plain_vs_f32"] + 0.05), r
    if differ:
        assert report["diff_between_adapters"] > bf16_tol, report
        if repeat is not None:
            assert (report["diff_same_adapter"]
                    <= 0.1 * report["diff_between_adapters"]), report


class RoutingLog:
    """While open, records the (T, k) experts of every ``moe.route`` call,
    or, given ``replay``, hands those back in order instead of choosing (the
    gates are then the caller's own probabilities at the replayed experts).
    Top-k is discontinuous at a near-tie, so two paths that agree to
    rounding can still route one token differently; replaying one path's
    routing in the other compares what is continuous."""

    def __init__(self, replay=None):
        self.idx = []
        self.replay = None if replay is None else list(replay)

    def __enter__(self):
        from repro_torch.models import moe
        self._orig = moe.route

        def route(probs, k):
            if self.replay is not None:
                idx = self.replay.pop(0)
                return probs.gather(-1, idx), idx
            gates, idx = self._orig(probs, k)
            self.idx.append(idx)
            return gates, idx
        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._orig
        return False


def family_prefill(cfg, cfg32, frozen, frozen32, lora, seed, gpu):
    """(b) ``make_prefill_step(impl="flash")`` on (4, 1024) tokens, its
    launches read around one call, against ``impl="chunked"``; the
    ``ssd_intra_chunk`` share of the step's device time by the profiler.
    Returns (counts, versions)."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch.serve import make_prefill_step
    toks = torch.as_tensor(np.random.default_rng(seed + 100).integers(
        0, cfg.vocab_size, (4, 1024)), device=frozen["embed"].device)
    flash = make_prefill_step(cfg, impl="flash")
    # ---- the main path: counts set to 0 just before, read just after ----
    kernels.reset_launch_counts()
    logits_flash = flash(frozen, lora, toks)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    versions = {"flash_attention": dict(fa.flash_attention.by_version),
                "ssd_intra_chunk": dict(ss.ssd_intra_chunk.by_version)}
    # ----------------------------------------------------------------------
    t0 = time.time()
    flash(frozen, lora, toks)
    torch.cuda.synchronize()
    step_s = time.time() - t0
    share = prefill_ssd_share(lambda: flash(frozen, lora, toks)) \
        if cfg.has_ssm else {}
    chunked_bf = make_prefill_step(cfg, impl="chunked")(frozen, lora, toks)
    with RoutingLog() as flash_route:
        flash32 = make_prefill_step(cfg32, impl="flash")(frozen32, lora, toks)
    with RoutingLog() as chunked_route:
        chunked32 = make_prefill_step(cfg32, impl="chunked")(frozen32, lora,
                                                             toks)
    torch.cuda.synchronize()

    def err(x, y):
        return (x - y).abs().max().item()
    f32_tol, bf16_tol = 2e-3, 1.0
    pre = {"f32_flash_vs_chunked": err(flash32, chunked32),
           "bf16_flash_vs_chunked": err(logits_flash, chunked_bf),
           "bf16_flash_vs_f32": err(logits_flash, chunked32),
           "bf16_chunked_vs_f32": err(chunked_bf, chunked32)}
    if cfg.family == "moe":
        # (token, layer, slot) expert choices the two f32 runs differ in;
        # then the chunked run again on the flash run's routing
        pre["f32_routing_flips"] = sum(
            int((a != b).sum()) for a, b in zip(flash_route.idx,
                                                chunked_route.idx))
        pre["f32_routing_choices"] = sum(a.numel() for a in flash_route.idx)
        with RoutingLog(replay=flash_route.idx):
            pinned = make_prefill_step(cfg32, impl="chunked")(frozen32, lora,
                                                              toks)
        pre["f32_flash_vs_chunked_same_routing"] = err(flash32, pinned)
    f32_key = ("f32_flash_vs_chunked_same_routing" if cfg.family == "moe"
               else "f32_flash_vs_chunked")
    emit({"phase": "families_prefill", "gpu": gpu, "arch": cfg.name,
          "batch": 4, "seq": 1024, "impl": "flash", "step_s": step_s,
          "f32_tol": f32_tol, "bf16_tol": bf16_tol, **pre, **share,
          "launches": counts, "launches_by_version": versions})
    assert logits_flash.shape == (4, cfg.padded_vocab)
    assert torch.isfinite(logits_flash[:, :cfg.vocab_size]).all()
    assert pre[f32_key] <= f32_tol, pre
    assert pre["bf16_flash_vs_chunked"] <= bf16_tol, pre
    assert (pre["bf16_flash_vs_f32"]
            <= 2.0 * pre["bf16_chunked_vs_f32"] + 0.05), pre
    # one scan a Mamba block (the SSM families), one attention a layer
    # (the attention families); the LoRA goes the plain way in a prefill step
    assert counts["ssd_intra_chunk"] == (cfg.n_layers if cfg.has_ssm else 0)
    assert counts["flash_attention"] == (
        cfg.n_layers if cfg.family != "ssm" else 0), counts
    for name in ("lora_matmul", "lora_matmul_grouped", "flash_decode"):
        assert counts[name] == 0, counts
    assert versions["ssd_intra_chunk"] == {
        "tc": counts["ssd_intra_chunk"], "simt": 0}, versions
    assert versions["flash_attention"] == {
        "wgmma": counts["flash_attention"], "tf32x3": 0, "simt": 0}, versions
    if cfg.has_ssm:
        assert share["ssd_intra_chunk_device_us"] > 0, share
    return counts, versions


def family_train(cfg, cfg32, frozen, frozen32, lora, seed, gpu):
    """(c) split == unsplit in f32 (2 x 256, channel off) at cut I/2 and
    cut 0; then ``make_train_step`` in bf16, 4 steps on one 4 x 512 batch;
    0 kernel launches on the path. For the MoE config at cut I/2 the
    unsplit side is ``forward_loss`` less the router aux of layers
    [0, I/2), which the device stage drops as the reference's does."""
    from repro_torch import kernels
    from repro_torch.core import splitting as S
    from repro_torch.data import make_fleet_datasets
    from repro_torch.launch.train import make_train_step, value_and_grad
    from repro_torch.models import model as M
    from repro_torch.models.common import batch_to_device
    from repro_torch.optim import adamw, constant_schedule
    dev = frozen["embed"].device
    # ---- the main path: counts set to 0 just before, read just after ----
    kernels.reset_launch_counts()
    rng = np.random.default_rng(seed + 200)
    toks, labels = (torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 256)),
                                    device=dev) for _ in range(2))
    batch = {"tokens": toks, "labels": labels}
    split = {}
    for cut in (cfg.n_layers // 2, 0):
        def unsplit(lo, cut=cut):
            loss = M.forward_loss(frozen32, lo, batch, cfg32, impl="naive",
                                  remat=False)
            if cut:         # the device stage's aux, which split drops
                loss = loss - M.forward_hidden(
                    frozen32, lo, toks, cfg32, lo=0, hi=cut, impl="naive",
                    remat=False)[1]
            return loss
        ref_loss, ref = value_and_grad(unsplit, lora)
        d, s_ = S.split_lora(lora, cut)
        loss, gd, gs = S.split_grads(frozen32, d, s_, toks, labels, cfg=cfg32,
                                     cut=cut, compress=False)
        split[cut] = {"loss": ref_loss.item(),
                      "loss_rel_err": abs(loss.item() / ref_loss.item() - 1),
                      "worst_leaf_rel_err": _tree_err(S.merge_lora(gd, gs),
                                                      ref)}
        del ref, gd, gs
    lr = TRAIN_LR.get(cfg.family, 3e-3)
    opt = adamw(constant_schedule(lr))
    step = make_train_step(cfg, opt, impl="chunked", remat=True, cut=0)
    tb = batch_to_device(
        make_fleet_datasets(cfg, 1, seed=2)[0].minibatch(4, 512), dev)
    lo, st = lora, opt.init(lora)
    losses = []
    t0 = time.time()
    for _ in range(4):
        loss, lo, st = step(frozen, lo, st, tb)
        losses.append(loss)
    losses = torch.stack(losses).tolist()
    train_s = time.time() - t0
    counts = kernels.launch_counts()
    # ----------------------------------------------------------------------
    emit({"phase": "families_train", "gpu": gpu, "arch": cfg.name,
          "split_batch": [2, 256], "split_dtype": "float32", "tol": SPLIT_TOL,
          "unsplit": ("forward_loss less the aux of layers [0, cut)"
                      if cfg.family == "moe" else "forward_loss"),
          "cuts": split, "train_batch": [4, 512], "train_dtype": cfg.dtype,
          "optimizer": f"adamw, constant {lr}", "losses": losses,
          "train_s": train_s, "launches": counts})
    for cut, r in split.items():
        assert r["loss_rel_err"] <= SPLIT_TOL, (cut, r)
        assert r["worst_leaf_rel_err"] <= SPLIT_TOL, (cut, r)
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0], losses
    assert all(n == 0 for n in counts.values()), counts


def phase_families(seed: int):
    """The ssm, hybrid and moe families at their full published configs,
    bf16, random weights from ``seed``, four adapters with non-zero B:
    (a) serve, (b) the flash prefill step, (c) split training. The family
    path's launches are (a)'s and (b)'s, summed over the three configs."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_map
    from repro_torch.serving import AdapterBank
    dev = torch.device("cuda")
    gpu = gpu_line()
    total = {}
    versions = {}
    t_phase = time.time()
    family_kernel_checks(seed, gpu)
    for i, arch in enumerate(FAMILY_ARCHS):
        t0 = time.time()
        cfg = get_config(arch)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params = M.init_params(seed, cfg)             # device=None: the card
        frozen = params["frozen"]
        del params
        adapters = [make_adapter(cfg, seed + 1 + j, dev) for j in range(4)]
        bank = AdapterBank(adapters)
        frozen32 = tree_map(lambda v: v.float(), frozen)
        torch.cuda.synchronize()
        emit({"phase": "families_init", "arch": arch, "family": cfg.family,
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "param_bytes": sum(x.numel() * x.element_size()
                                 for x in _leaves(frozen)),
              "params": sum(x.numel() for x in _leaves(frozen)),
              "seconds": time.time() - t0})
        counts, by = family_serve(cfg, frozen, bank, seed + i, gpu)
        family_serve_logits(cfg, cfg32, frozen, frozen32, bank, gpu)
        pc, pby = family_prefill(cfg, cfg32, frozen, frozen32, adapters[0],
                                 seed + i, gpu)
        for c in (counts, pc):
            for name, n in c.items():
                total[name] = total.get(name, 0) + n
        for b in (by, pby):
            for name, v in b.items():
                acc = versions.setdefault(name, {})
                for ver, n in v.items():
                    acc[ver] = acc.get(ver, 0) + n
        family_train(cfg, cfg32, frozen, frozen32, adapters[0], seed + i, gpu)
        del frozen, frozen32, adapters, bank
        torch.cuda.empty_cache()
    emit({"phase": "families", "gpu": gpu, "archs": list(FAMILY_ARCHS),
          "launches": total, "launches_by_version": versions,
          "seconds": time.time() - t_phase})
    assert total["ssd_intra_chunk"] > 0 and total["flash_attention"] > 0
    return total, dict(total), versions


# ---------------------------------------------------------------------------
# registry phase
# ---------------------------------------------------------------------------

REGISTRY_ARCHS = ("qwen3-0.6b", "qwen3-4b", "qwen2-7b", "phi3-medium-14b",
                  "internvl2-26b", "musicgen-large")
REGISTRY_CHUNK = 64        # the engine's prefill chunk
REGISTRY_NEW = 16          # new tokens of a generate row
# depth of the bf16-vs-f32 logits check: the whole model where its f32 copy
# fits beside the bf16 one, else its first 4 layers at full width (f32
# copies of phi3-medium-14b and internvl2-26b would take ~59 and ~79 GB)
REGISTRY_F32_DEPTH = {"phi3-medium-14b": 4, "internvl2-26b": 4}
# musicgen-large at full depth (48 layers): the plain bf16 path alone is 2.45
# from the f32 logits (|logit| <= 3.3) and the flash path 2.10 from the
# plain one (the H100, seed 0), so the families phase's 1.0 between the two
# bf16 paths is held over its first 4 layers; at full depth the f32 check
# and the flash-no-further-from-f32 rule are held, and the gap is printed
REGISTRY_BF16_CAP_DEPTH = {"musicgen-large": 4}
SPLIT_LAYERS = 4           # the f32 split == unsplit check at full width
FIT_SHARE = 0.92           # of the card's memory a full-depth step may plan
# timing rows at model-path shapes: bf16 flash_attention (B, S, Hq, Hkv, D)
# of qwen2-7b and internvl2-26b, and lora_matmul (M, K, N, r) at qwen2-7b's
# down projection over a (4, 1024) batch
REGISTRY_FLASH_TIMES = ((4, 1024, 28, 4, 128), (4, 1024, 48, 8, 128))
REGISTRY_LORA_TIMES = ((4096, 18944, 3584, 16),)


def first_layers(cfg, frozen, lora, n: int):
    """The model cut to its first ``n`` layers at full width: (config,
    frozen, lora), the layers as views of the full stacks."""
    from repro_torch.models import model as M
    fz = dict(frozen, layers=M.slice_layers(frozen["layers"], 0, n))
    lo = {"layers": M.slice_layers(lora["layers"], 0, n)}
    return dataclasses.replace(cfg, n_layers=n), fz, lo


def model_inputs(cfg, shape, seed: int):
    """Tokens (B, S) on the card, or for an embeds-mode config (B, S, d)
    f32 embeddings at the data pipeline's scale (0.02)."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        return randn(rng, shape + (cfg.d_model,), torch.float32, 0.02)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, shape),
                           device="cuda")


def lora_shapes(cfg):
    """(K, N) of every LoRA projection of a layer of a dense config."""
    d, q, kv, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    return list(dict.fromkeys(((d, q), (d, kv), (q, d), (d, ff), (ff, d))))


def registry_kernels(seed: int, gpu: str):
    """The bf16 kernels against their plain versions at the shapes the
    registry path hands them, through the version the wrapper picks (all
    ``wgmma``, asserted), at the kernels phase's tolerances: every LoRA
    projection of each config at M = ``REGISTRY_CHUNK`` (a prefill chunk of
    the engine) and at a tick's 8 rows (each its own adapter of a strided
    bank), and the attention of the flash prefill step on (4, 1024); then
    the timing rows at ``REGISTRY_FLASH_TIMES`` and ``REGISTRY_LORA_TIMES``
    beside the bound, the plain version and one PyTorch call. Launches made
    here precede the registry path's counts. Returns the timing rows."""
    from repro_torch.configs.base import get_config
    rng = np.random.default_rng(seed + 400)
    bf16 = torch.bfloat16
    out = []
    for arch in REGISTRY_ARCHS:
        cfg = get_config(arch)
        r, scale = cfg.lora.rank, cfg.lora.scale
        for k, n in lora_shapes(cfg):
            res = check_lora_matmul(rng, REGISTRY_CHUNK, k, n, r, bf16, scale)
            out.append(("lora_matmul", arch, (REGISTRY_CHUNK, k, n, r), res))
            res = check_grouped(rng, 8, 1, k, n, r, 8, bf16,
                                ids=list(range(8)), scale=scale, strided=True)
            out.append(("lora_matmul_grouped", arch, (8, 1, k, n, r), res))
        shape = (4, 1024, 1024, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        out.append(("flash_attention", arch, shape,
                    check_flash(rng, *shape, bf16, causal=True)))
    emit({"phase": "registry_kernels", "gpu": gpu,
          "checked": [{"name": name, "arch": arch, "shape": list(shape),
                       "max_abs_err": err, "tol": tol, "version": version}
                      for name, arch, shape, (err, tol, version) in out]})
    for name, arch, shape, (err, tol, version) in out:
        assert version == "wgmma", (name, arch, shape, version)
    rows = {"flash_attention": [time_flash(rng, *s, bf16)
                                for s in REGISTRY_FLASH_TIMES],
            "lora_matmul": [time_lora_matmul(rng, *s, bf16)
                            for s in REGISTRY_LORA_TIMES]}
    emit({"phase": "registry_kernel_times", "gpu": gpu, "by_shape": rows})
    for name, by_shape in rows.items():
        for row in by_shape:
            assert row["version"] == "wgmma", (name, row)
    return rows


def registry_generate(cfg, frozen, lora, seed, gpu):
    """(a) for an embeds-mode config: ``generate`` from a (2, 16, d)
    embeddings prompt, ``REGISTRY_NEW`` greedy tokens (the engine's chunked
    prefill is for token configs only, as in the reference). TTFT is a
    ``max_new=1`` call. Returns (counts, versions)."""
    from repro_torch import kernels
    from repro_torch.launch.serve import generate
    prompt = model_inputs(cfg, (2, 16), seed)
    t0 = time.time()
    first = generate(cfg, frozen, lora, prompt, 1)
    torch.cuda.synchronize()
    ttft_s = time.time() - t0
    # ---- the main path: counts set to 0 just before, read just after ----
    kernels.reset_launch_counts()
    t0 = time.time()
    toks = generate(cfg, frozen, lora, prompt, REGISTRY_NEW)
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    counts = kernels.launch_counts()
    # ----------------------------------------------------------------------
    emit({"phase": "registry_serve", "gpu": gpu, "arch": cfg.name,
          "mode": "generate", "prompt": [2, 16, cfg.d_model],
          "max_new": REGISTRY_NEW, "tokens": int(toks.numel()),
          "wall_s": wall_s, "tokens_per_sec": toks.numel() / wall_s,
          "ttft_s": ttft_s, "sample": toks[0, :8].tolist(),
          "launches": counts})
    assert toks.shape == (2, REGISTRY_NEW) and toks.dtype == torch.int32
    # the padded vocabulary's columns are masked, so never generated
    assert 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size, toks
    assert torch.equal(toks[:, :1], first), (toks[:, :1], first)
    # generate decodes through the plain LoRA path, as the reference's does
    assert all(n == 0 for n in counts.values()), counts
    return counts, {}


def registry_prefill(cfg, frozen, lora, seed, gpu):
    """(b) ``make_prefill_step(impl="flash")`` on (4, 1024) tokens or
    embeddings, its launches read around one call; then bf16 against f32
    logits at ``REGISTRY_F32_DEPTH``: flash and chunked in both dtypes.
    Returns (counts, versions)."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.models.common import tree_map
    inputs = model_inputs(cfg, (4, 1024), seed + 100)
    flash = make_prefill_step(cfg, impl="flash")
    # ---- the main path: counts set to 0 just before, read just after ----
    kernels.reset_launch_counts()
    logits_flash = flash(frozen, lora, inputs)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    versions = {"flash_attention": dict(fa.flash_attention.by_version)}
    # ----------------------------------------------------------------------
    t0 = time.time()
    flash(frozen, lora, inputs)
    torch.cuda.synchronize()
    step_s = time.time() - t0

    depth = REGISTRY_F32_DEPTH.get(cfg.name, cfg.n_layers)
    if depth < cfg.n_layers:
        c, fz, lo = first_layers(cfg, frozen, lora, depth)
        bf_flash = make_prefill_step(c, impl="flash")(fz, lo, inputs)
    else:
        c, fz, lo, bf_flash = cfg, frozen, lora, logits_flash
    c32 = dataclasses.replace(c, dtype="float32")
    fz32 = tree_map(lambda v: v.float(), fz)
    flash32 = make_prefill_step(c32, impl="flash")(fz32, lo, inputs)
    chunked32 = make_prefill_step(c32, impl="chunked")(fz32, lo, inputs)
    del fz32
    chunked_bf = make_prefill_step(c, impl="chunked")(fz, lo, inputs)
    torch.cuda.synchronize()

    def err(x, y):
        return (x - y).abs().max().item()
    f32_tol, bf16_tol = 2e-3, 1.0
    pre = {"f32_flash_vs_chunked": err(flash32, chunked32),
           "bf16_flash_vs_chunked": err(bf_flash, chunked_bf),
           "bf16_flash_vs_f32": err(bf_flash, chunked32),
           "bf16_chunked_vs_f32": err(chunked_bf, chunked32),
           "logit_abs_max": chunked32[:, :cfg.vocab_size].abs().max().item()}
    cap_depth = REGISTRY_BF16_CAP_DEPTH.get(cfg.name, depth)
    if cap_depth < depth:
        c, fz, lo = first_layers(cfg, frozen, lora, cap_depth)
        pre["bf16_flash_vs_chunked_capped_layers"] = err(
            make_prefill_step(c, impl="flash")(fz, lo, inputs),
            make_prefill_step(c, impl="chunked")(fz, lo, inputs))
    emit({"phase": "registry_prefill", "gpu": gpu, "arch": cfg.name,
          "input": cfg.input_mode, "batch": 4, "seq": 1024, "impl": "flash",
          "step_s": step_s, "logits_check_layers": depth,
          "bf16_cap_layers": cap_depth,
          "logits_check": ("full depth" if depth == cfg.n_layers else
                           f"first {depth} of {cfg.n_layers} layers, full "
                           "width, sliced weights (an f32 copy of the whole "
                           "model does not fit beside the bf16 one)"),
          "f32_tol": f32_tol, "bf16_tol": bf16_tol, **pre,
          "launches": counts, "launches_by_version": versions})
    assert logits_flash.shape == (4, cfg.padded_vocab)
    assert torch.isfinite(logits_flash[:, :cfg.vocab_size]).all()
    assert all(math.isfinite(v) for v in pre.values()), pre
    assert pre["f32_flash_vs_chunked"] <= f32_tol, pre
    assert pre["bf16_flash_vs_chunked" if cap_depth == depth else
               "bf16_flash_vs_chunked_capped_layers"] <= bf16_tol, pre
    assert (pre["bf16_flash_vs_f32"]
            <= 2.0 * pre["bf16_chunked_vs_f32"] + 0.05), pre
    # one attention a layer; the LoRA goes the plain way in a prefill step
    assert counts["flash_attention"] == cfg.n_layers, counts
    for name in ("lora_matmul", "lora_matmul_grouped", "flash_decode",
                 "ssd_intra_chunk"):
        assert counts[name] == 0, counts
    assert versions["flash_attention"] == {
        "wgmma": cfg.n_layers, "tf32x3": 0, "simt": 0}, versions
    return counts, versions


def dryrun_split_peak(cfg, mb, key) -> int:
    """The analysis layer's peak for the ``split_grads`` call that
    ``registry_train`` measures on 2 and 4 layers, at full depth (cut in
    the middle, the batch ``mb``'s shapes and dtypes), traced on ``meta``,
    plus the same 4 x the adapters' bytes (AdamW's two moments, the grads,
    the updates)."""
    from repro_torch.core import splitting as S
    from repro_torch.launch.analysis import analyze_step
    from repro_torch.models import model as M
    params = M.abstract_params(cfg)
    d, s_ = S.split_lora(params["lora"], cfg.n_layers // 2)
    inputs, labels = (torch.empty_like(mb[k], device="meta")
                      for k in (key, "labels"))
    _, _, mem = analyze_step(
        lambda *a: S.split_grads(*a, cfg=cfg, cut=cfg.n_layers // 2),
        params["frozen"], d, s_, inputs, labels)
    lora_bytes = sum(x.numel() * x.element_size()
                     for x in _leaves(params["lora"]))
    return int(mem["peak_bytes"] + 4 * lora_bytes)


def registry_train(cfg, frozen, lora, seed, gpu):
    """(c) split == unsplit in f32 over the first ``SPLIT_LAYERS`` layers at
    full width, cut 2 (2 x 256, channel off); then one bf16 ``SplitFineTuner``
    epoch at a CARD cut on 2 x 512 at full depth, where its step fits the
    card. The fit is predicted from the peak memory of the same
    ``split_grads`` call on the first 2 and first 4 layers (the step keeps
    every layer's activations); a config that does not fit prints the
    predicted bytes and runs no epoch. 0 kernel launches on the path.
    Returns whether the epoch ran."""
    from repro_torch import kernels
    from repro_torch.core import splitting as S
    from repro_torch.core.channel import WirelessChannel
    from repro_torch.core.hardware import (EDGE_FLEET, SERVER_RTX4060TI,
                                           SimParams)
    from repro_torch.core.protocol import SplitFineTuner
    from repro_torch.data import make_fleet_datasets
    from repro_torch.launch.train import value_and_grad
    from repro_torch.models import model as M
    from repro_torch.models.common import batch_to_device, tree_map
    from repro_torch.optim import adamw, constant_schedule
    dev = frozen["embed"].device
    key = "embeds" if cfg.input_mode == "embeds" else "tokens"
    # ---- the main path: counts set to 0 just before, read just after ----
    kernels.reset_launch_counts()
    c, fz, lo = first_layers(cfg, frozen, lora, SPLIT_LAYERS)
    c32 = dataclasses.replace(c, dtype="float32")
    fz32 = tree_map(lambda v: v.float(), fz)
    inputs = model_inputs(cfg, (2, 256), seed + 200)
    labels = torch.as_tensor(np.random.default_rng(seed + 201).integers(
        0, cfg.vocab_size, (2, 256)), device=dev)
    ref_loss, ref = value_and_grad(
        lambda l: M.forward_loss(fz32, l, {key: inputs, "labels": labels},
                                 c32, impl="naive", remat=False), lo)
    cut = SPLIT_LAYERS // 2
    d, s_ = S.split_lora(lo, cut)
    loss, gd, gs = S.split_grads(fz32, d, s_, inputs, labels, cfg=c32,
                                 cut=cut, compress=False)
    split = {"layers": SPLIT_LAYERS, "cut": cut, "batch": [2, 256],
             "dtype": "float32", "tol": SPLIT_TOL, "loss": ref_loss.item(),
             "loss_rel_err": abs(loss.item() / ref_loss.item() - 1),
             "worst_leaf_rel_err": _tree_err(S.merge_lora(gd, gs), ref)}
    del fz32, ref, gd, gs
    torch.cuda.empty_cache()

    # the full-depth step's memory, from its first 2 and first 4 layers
    mb = batch_to_device(make_fleet_datasets(cfg, 1, seed=1)[0].minibatch(
        2, 512), dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    peaks = {}
    for n in (2, 4):
        c, fz, lo = first_layers(cfg, frozen, lora, n)
        d, s_ = S.split_lora(lo, n // 2)
        torch.cuda.reset_peak_memory_stats()
        S.split_grads(fz, d, s_, mb[key], mb["labels"], cfg=c, cut=n // 2)
        torch.cuda.synchronize()
        peaks[n] = torch.cuda.max_memory_allocated() - base
    per_layer = (peaks[4] - peaks[2]) / 2
    lora_bytes = sum(x.numel() * x.element_size() for x in _leaves(lora))
    # + AdamW's two moments, the grads and the updates of the adapters
    predicted = base + peaks[2] + (cfg.n_layers - 2) * per_layer \
        + 4 * lora_bytes
    card = torch.cuda.get_device_properties(0).total_memory
    fit = {"predicted_peak_bytes": int(predicted),
           "dryrun_predicted_peak_bytes": dryrun_split_peak(cfg, mb, key),
           "activation_bytes_per_layer": int(per_layer),
           "card_bytes": card, "fits": predicted <= FIT_SHARE * card}
    epoch = None
    if fit["fits"]:
        sim = SimParams(local_epochs=1, mini_batch=2, seq_len=512)
        ft = SplitFineTuner(
            cfg, frozen, lora, adamw(constant_schedule(3e-3)),
            devices=[EDGE_FLEET[0]], server=SERVER_RTX4060TI,
            channels=[WirelessChannel("normal", seed=seed)],
            datasets=make_fleet_datasets(cfg, 1, seed=1), sim=sim,
            policy="card", cost_cfg=cfg)
        clock = StageClock()
        ft.executor.mark = clock
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = ft.run(1)
        torch.cuda.synchronize()
        log = dataclasses.asdict(res.logs[0])
        epoch = {"wall_s": time.perf_counter() - t0,
                 "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                 "committed": res.rounds_committed(), "log": log,
                 "epochs_ms": clock.epochs()}
        del ft, res
    counts = kernels.launch_counts()
    # ----------------------------------------------------------------------
    emit({"phase": "registry_train", "gpu": gpu, "arch": cfg.name,
          "split": split, "fit": fit, "epoch": epoch,
          "epoch_batch": [2, 512], "epoch_dtype": cfg.dtype,
          "launches": counts})
    assert split["loss_rel_err"] <= SPLIT_TOL, split
    assert split["worst_leaf_rel_err"] <= SPLIT_TOL, split
    if epoch is not None:
        assert epoch["committed"] == 1, epoch
        assert (epoch["log"]["status"] == "ok"
                and math.isfinite(epoch["log"]["loss"])), epoch
    assert all(n == 0 for n in counts.values()), counts
    return fit["fits"]


def phase_registry(seed: int):
    """The rest of the model registry at its full published configs, bf16,
    random weights from ``seed``, four adapters with non-zero B: the kernels
    at the shapes the path hands them and the timing rows, then for each
    config (a) serve (``ServingEngine`` for token configs, ``generate`` for
    embeds configs), (b) the flash prefill step on (4, 1024) with the bf16
    logits against f32, (c) split training. The path's launches are (a)'s
    and (b)'s, summed over the six configs. Returns (counts, runs,
    versions, timing rows)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import AdapterBank
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: full f32
    dev = torch.device("cuda")
    gpu = gpu_line()
    t_phase = time.time()
    rows = registry_kernels(seed, gpu)
    total, versions, fits = {}, {}, {}
    for i, arch in enumerate(REGISTRY_ARCHS):
        t0 = time.time()
        cfg = get_config(arch)
        frozen = M.init_params(seed, cfg)["frozen"]   # device=None: the card
        adapters = [make_adapter(cfg, seed + 1 + j, dev) for j in range(4)]
        torch.cuda.synchronize()
        emit({"phase": "registry_init", "arch": arch, "family": cfg.family,
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.head_dim,
              "vocab": [cfg.vocab_size, cfg.padded_vocab],
              "param_bytes": sum(x.numel() * x.element_size()
                                 for x in _leaves(frozen)),
              "seconds": time.time() - t0})
        if cfg.input_mode == "tokens":
            counts, by = family_serve(cfg, frozen, AdapterBank(adapters),
                                      seed + i, gpu, chunk=REGISTRY_CHUNK,
                                      phase="registry_serve")
        else:
            counts, by = registry_generate(cfg, frozen, adapters[0], seed + i,
                                           gpu)
        lora = adapters[0]
        del adapters
        pc, pby = registry_prefill(cfg, frozen, lora, seed + i, gpu)
        for c in (counts, pc):
            for name, n in c.items():
                total[name] = total.get(name, 0) + n
        for b in (by, pby):
            for name, v in b.items():
                acc = versions.setdefault(name, {})
                for ver, n in v.items():
                    acc[ver] = acc.get(ver, 0) + n
        fits[arch] = registry_train(cfg, frozen, lora, seed + i, gpu)
        del frozen, lora
        torch.cuda.empty_cache()
    emit({"phase": "registry", "gpu": gpu, "archs": list(REGISTRY_ARCHS),
          "epoch_fits": fits, "launches": total,
          "launches_by_version": versions, "seconds": time.time() - t_phase})
    assert total["flash_attention"] > 0 and total["lora_matmul"] > 0
    return total, dict(total), versions, rows

# ---------------------------------------------------------------------------
# The dry run: meta-device records, held against the same steps on the card
# ---------------------------------------------------------------------------

#: the card check: arch -> {shape: the global batch run on one card}. Only
#: the batch is cut: to what one card holds (the matrix's peaks) and, where
#: a call takes seconds (the trains, and the 32k prefills at 15-25 s a row:
#: the chunked path's f32 attention, memory-bound), to one or two rows
DRYRUN_CARD = {
    "qwen3-0.6b": {"train_4k": 2, "prefill_32k": 1, "decode_32k": 8},
    "qwen2-7b": {"train_4k": 2, "prefill_32k": 1, "decode_32k": 16,
                 "long_500k": 1},
    "mamba2-370m": {"train_4k": 2, "prefill_32k": 1, "decode_32k": 128,
                    "long_500k": 1},
    "granite-moe-3b-a800m": {"train_4k": 2, "prefill_32k": 1,
                             "decode_32k": 16},
}
DRYRUN_WORKERS = 6          # processes tracing on meta beside the card check
PEAK_TOL = 0.10             # meta peak vs max_memory_allocated, relative
DRYRUN_REPS = 3             # timed calls after the warm-up, median


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in _leaves(tree)
               if x.is_floating_point())


def dryrun_card_run(arch: str, shape_name: str, batch: int, dev):
    """One dry-run program on the card at its full published width and
    depth, the global batch cut to ``batch``: the warm-up under
    ``FlopCounterMode`` (the card's FLOP count) with the peak memory above
    what was allocated before the arguments were made, then
    ``DRYRUN_REPS`` calls timed with CUDA events. Returns the measurements;
    asserts the output is finite and of its shape."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch.dryrun import build_step, combo_config
    cfg = combo_config(arch, shape_name)
    shape = dataclasses.replace(INPUT_SHAPES[shape_name], global_batch=batch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    step, args = build_step(cfg, shape, device=dev)
    torch.cuda.synchronize()
    arg_bytes = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        out = step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if shape.kind == "train":
        loss, new_lora, _ = out
        assert loss.dim() == 0 and _finite(loss) and _finite(new_lora), arch
    else:
        logits = out[0] if shape.kind == "decode" else out
        assert tuple(logits.shape) == (batch, cfg.padded_vocab), logits.shape
        assert _finite(logits), (arch, shape_name)
    del out
    times = []
    for _ in range(DRYRUN_REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step(*args)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / 1e3)
        del out
    del step, args
    return {"flops": float(fc.get_total_flops()), "peak_bytes": peak,
            "argument_bytes": arg_bytes, "times_s": times,
            "median_s": float(np.median(times))}


def phase_dryrun(seed: int):
    """(a) ``launch/dryrun.lower_combo`` over DRYRUN_ARCHS x INPUT_SHAPES on
    ``meta`` at full published width (40 combos, kimi-k2-1t-a32b included),
    in ``DRYRUN_WORKERS`` processes, beside (b) the card check: the same
    three programs run on the card for the archs of ``DRYRUN_CARD`` at
    full width and depth, the batch cut, each held against its own meta
    record at that batch: the FLOP count equal, the meta peak within
    ``PEAK_TOL`` of the card's. No kernel launches on this path."""
    del seed                        # weights from seed 0, as ``build_step``
    from repro_torch import kernels
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.core.hardware import H100_PEAK_FLOPS
    from repro_torch.launch import dryrun
    torch.backends.cuda.matmul.allow_tf32 = False   # the programs' f32
    dev = torch.device("cuda")
    gpu = gpu_line()
    t_phase = time.time()
    matrix = [(a, s, {}) for a in dryrun.DRYRUN_ARCHS for s in INPUT_SHAPES]
    card_jobs = [(a, s, {"batch": b}) for a, by in DRYRUN_CARD.items()
                 for s, b in by.items()]
    done = []
    pool, result = dryrun.start_matrix(
        matrix + card_jobs, DRYRUN_WORKERS,
        callback=lambda _: done.append(time.time() - t_phase))
    with pool:
        # ---- the main path: counts set to 0 just before, read just after --
        kernels.reset_launch_counts()
        card = {(a, s): dryrun_card_run(a, s, kw["batch"], dev)
                for a, s, kw in card_jobs}
        counts = kernels.launch_counts()
        # ------------------------------------------------------------------
        t_card = time.time() - t_phase
        records = result.get()
    t_matrix = time.time() - t_phase
    failed = []
    for rec in records[:len(matrix)]:
        r = rec.get("roofline", {})
        line = {"phase": "dryrun_combo", "arch": rec["arch"],
                "shape": rec["shape"], "ok": rec["ok"]}
        if rec["ok"]:
            raw = rec["raw_scan_costs"]
            line.update({
                "flops": r["flops"], "hbm_bytes": r["hbm_bytes"],
                "peak_bytes": rec["memory"]["peak_bytes"],
                "argument_bytes": rec["memory"]["argument_bytes"],
                "fits": rec["fits"], "dominant": r["dominant"],
                "compute_s": r["compute_s"], "memory_s": r["memory_s"],
                "bound_s": r["bound_s"],
                "useful_flops_ratio": rec["useful_flops_ratio"],
                "probe_flops_equal": r["flops"] == raw["flops"],
                "probe_hbm_rel_gap": abs(r["hbm_bytes"] / raw["hbm_bytes"]
                                         - 1),
                "trace_s": rec["lower_compile_s"],
                "probe_s": rec.get("probe_s")})
            if not (line["probe_flops_equal"] and r["compute_s"] > 0
                    and r["memory_s"] > 0 and line["peak_bytes"] > 0):
                failed.append(line)
        else:
            line["error"] = rec["error"]
            failed.append(line)
        emit(line)
    checks = []
    for (a, s, kw), rec in zip(card_jobs, records[len(matrix):]):
        got = card[(a, s)]
        line = {"phase": "dryrun_card", "gpu": gpu, "arch": a, "shape": s,
                "batch": kw["batch"], "ok": rec["ok"], **got}
        if rec["ok"]:
            meta_peak = rec["memory"]["peak_bytes"]
            line.update({
                "reduced": rec.get("reduced"), "meta_flops":
                    rec["raw_scan_costs"]["flops"],
                "meta_peak_bytes": meta_peak,
                "meta_argument_bytes": rec["memory"]["argument_bytes"],
                "peak_rel_err": abs(meta_peak / got["peak_bytes"] - 1),
                "bound_s": rec["roofline"]["bound_s"],
                "dominant": rec["roofline"]["dominant"],
                "achieved_flops_per_s": got["flops"] / got["median_s"],
                "share_of_bf16_peak": got["flops"] / got["median_s"]
                / H100_PEAK_FLOPS["bfloat16"]})
            line["flops_equal"] = got["flops"] == line["meta_flops"]
        else:
            line["error"] = rec["error"]
        checks.append(line)
        emit(line)
    # the bf16 logits' product, mm's out_dtype overload, counted on the card
    from torch.utils.flop_counter import FlopCounterMode
    x = torch.ones(64, 128, dtype=torch.bfloat16, device=dev)
    with FlopCounterMode(display=False) as fc:
        torch.mm(x, x.t(), out_dtype=torch.float32)
    mm_out_dtype_flops = fc.get_total_flops()
    emit({"phase": "dryrun", "gpu": gpu, "combos": len(matrix),
          "mm_out_dtype_flops": [mm_out_dtype_flops, 2 * 64 * 128 * 64],
          "combos_ok": sum(r["ok"] for r in records[:len(matrix)]),
          "fit_one_card": sorted(f"{r['arch']} x {r['shape']}"
                                 for r in records[:len(matrix)]
                                 if r.get("fits")),
          "card_runs": len(card_jobs), "launches": counts,
          "workers": DRYRUN_WORKERS, "matrix_s": done[0], "card_s": t_card,
          "seconds": t_matrix})
    assert not failed, failed
    assert mm_out_dtype_flops == 2 * 64 * 128 * 64, mm_out_dtype_flops
    for line in checks:
        assert line["ok"] and line["flops_equal"], line
        assert line["peak_rel_err"] <= PEAK_TOL, line
    assert all(n == 0 for n in counts.values()), counts
    return counts, records[:len(matrix)]


# ---------------------------------------------------------------------------
# bench phase
# ---------------------------------------------------------------------------

ABLATION_TOL = 1e-4         # the ablation's reductions, card vs CPU, abs
BENCH_PREFILL_ROWS = 4      # serving_bench.run's prefill chunk: lora_matmul's M


def bench_kernel_checks(seed: int, gpu: str):
    """The bf16 LoRA kernels against their plain versions at the shapes the
    serving sweep of either grid hands them, through the version the wrapper
    picks (all ``wgmma``, asserted), at the kernels phase's tolerances:
    ``lora_matmul`` at every projection of qwen3-0.6b over a prefill chunk
    of ``BENCH_PREFILL_ROWS`` rows (60 of the 64-row tile masked), and
    ``lora_matmul_grouped`` over ticks of 2, 4 and 8 rows, each row's
    adapter ``i % e`` from a strided bank of e = 1, 2, 4, 8 (the engine
    hands it e = rows, ids ``0..rows-1``, of a gathered bank; repeated ids
    are the sweep's adapter pattern). Then ``lora_matmul`` timed at M = 4
    beside its bound, the plain version and ``addmm``. Launches made here
    precede the bench path's counts. Returns the timing rows."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serving_bench
    rng = np.random.default_rng(seed + 500)
    bf16 = torch.bfloat16
    cfg = get_config(serving_bench.ARCH)
    r, scale = cfg.lora.rank, cfg.lora.scale
    grids = (serving_bench.SMOKE_GRID, serving_bench.FULL_GRID)
    rows = sorted({g for grid in grids for g in grid["slot_counts"]})
    banks = sorted({e for grid in grids for e in grid["adapter_counts"]})
    m = BENCH_PREFILL_ROWS
    out = []
    for k, n in lora_shapes(cfg):
        out.append(("lora_matmul", (m, k, n, r),
                    check_lora_matmul(rng, m, k, n, r, bf16, scale)))
        for g in rows:
            for e in banks:
                res = check_grouped(rng, g, 1, k, n, r, e, bf16,
                                    ids=[i % e for i in range(g)],
                                    scale=scale, strided=e > 1)
                out.append(("lora_matmul_grouped", (g, 1, k, n, r, e), res))
    emit({"phase": "bench_kernels", "gpu": gpu, "arch": cfg.name,
          "checked": [{"name": name, "shape": list(shape),
                       "max_abs_err": err, "tol": tol, "version": version}
                      for name, shape, (err, tol, version) in out]})
    for name, shape, (err, tol, version) in out:
        assert version == "wgmma", (name, shape, version)
    times = [time_lora_matmul(rng, m, k, n, r, bf16)
             for k, n in lora_shapes(cfg)]
    emit({"phase": "bench_kernel_times", "gpu": gpu,
          "lora_matmul": times})
    for row in times:
        assert row["version"] == "wgmma", row
    return {"lora_matmul": times}


def phase_bench(seed: int, full: bool, calibration=None,
                dryrun_records=None):
    """The benchmark twins of ``launch/``: (a) the serving sweep at
    qwen3-0.6b's published width (``serving_bench.SMOKE_GRID``, or the
    reference's full grid ``FULL_GRID``), the fused LoRA kernels on, every
    row drained, both LoRA kernels launched, all ``wgmma``, the warm tick's
    wall and device time per slot count; before it, the LoRA kernels
    against their plain versions at the sweep's shapes
    (``bench_kernel_checks``) and the served weights' logits, kernels
    against the plain path, for one tick per slot count (the gate timer's
    adapter ids) and one prefill chunk (``family_serve_logits``); (b) the
    kernel and card-calibration
    payloads from ``calibration`` (the calibrate phase's payload; without
    it a smoke calibrate) and ``dryrun_records`` (the dryrun phase's
    matrix; without them the payload says ``missing``), the roofline
    summary of the same records; (c) the ablation frontier on the card,
    held to the same run on the CPU; (d) ``check_regression.validate`` on
    every payload built here, the fleet twins' smoke payloads included.
    Returns the main path's counts and ``bench_kernel_checks``' rows."""
    import tempfile
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    from repro_torch.core.measured_cost import RooflineFit
    from repro_torch.launch import (ablation_pareto, calibrate,
                                    check_regression, churn_bench,
                                    cost_model_calibration, fleet_scale_bench,
                                    hierarchy_bench, kernel_bench, roofline,
                                    serving_bench, write_payload)
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_map
    from repro_torch.serving import AdapterBank
    dev = torch.device("cuda")
    gpu = gpu_line()
    t_phase = time.time()
    grid = serving_bench.FULL_GRID if full else serving_bench.SMOKE_GRID
    kernel_rows = bench_kernel_checks(seed, gpu)
    # the weights serving_bench.run makes from the seed, made here so that
    # their logits are checked first
    cfg = get_config(serving_bench.ARCH)
    frozen = M.init_params(seed, cfg, device=dev)["frozen"]
    adapters = [serving_bench.make_adapter(cfg, s, dev) for s in
                serving_bench.ADAPTER_SEEDS[:max(grid["adapter_counts"])]]
    bank = AdapterBank(adapters)
    frozen32 = tree_map(lambda v: v.float(), frozen)
    for slots in grid["slot_counts"]:
        family_serve_logits(
            cfg, dataclasses.replace(cfg, dtype="float32"), frozen, frozen32,
            bank, gpu, ids=[i % bank.n for i in range(slots)],
            prompt_tokens=BENCH_PREFILL_ROWS, phase="bench_serve_logits")
    del frozen32, bank
    torch.cuda.empty_cache()
    t_checks = time.time() - t_phase
    # ---- the main path: counts set to 0 just before, read just after ----
    kernels.reset_launch_counts()
    serving = serving_bench.run(**grid, seed=seed, frozen=frozen,
                                adapters=adapters)   # device=None: the card
    counts = kernels.launch_counts()
    runs = kernels.runs_on_card()
    versions = kernels.version_counts()
    # ----------------------------------------------------------------------
    t_serving = time.time() - t_phase - t_checks
    del frozen, adapters
    serving.update(schema=serving_bench.SCHEMA,
                   mode="full" if full else "smoke")
    serving_bench.print_table(serving)
    emit({"phase": "bench_serving", "gpu": gpu, "grid": grid,
          **{k: serving[k] for k in ("arch", "reduced", "device", "engine",
                                     "sweep", "admission", "gates",
                                     "decode_tick_device_s", "launches",
                                     "launches_by_version")},
          "seconds": t_serving, "checks_seconds": t_checks})
    lora = ("lora_matmul", "lora_matmul_grouped")
    for row in serving["sweep"]:
        assert row["drained"] and row["completed"] == grid["requests"], row
    assert not serving["reduced"], serving["reduced"]
    for name in lora:
        assert counts[name] > 0 and serving["launches"][name] == counts[name]
        assert versions[name]["wgmma"] == counts[name], (name, versions)
    assert all(counts[k] == 0 for k in counts if k not in lora), counts
    for key, wall_s in serving["gates"].items():
        device_s = serving["decode_tick_device_s"][key.rsplit("_", 1)[-1]]
        assert 0 < device_s <= wall_s and math.isfinite(wall_s), (key, wall_s,
                                                                  device_s)

    t0 = time.time()
    if calibration is None:
        calibration = calibrate.run(smoke=True)      # device=None: the card
    kern = kernel_bench.build_payload(calibration)
    payloads = {"kernels": kern, "serving": serving}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dryrun.jsonl")
        with open(path, "w") as f:
            for rec in dryrun_records or ():
                f.write(json.dumps(rec) + "\n")
        payloads["card_calibration"] = cost_model_calibration.build_payload(
            smoke=kern["mode"] == "smoke", path=path,
            fit=RooflineFit.from_dict(kern["roofline_fit"]))
        recs = roofline.load(path)
        roof = roofline.summary(recs)
        for name, mod in (("fleet_scale", fleet_scale_bench),
                          ("churn", churn_bench),
                          ("hierarchy", hierarchy_bench)):
            payloads[name] = mod.main(["--smoke"])
        validated = {}
        for name, payload in payloads.items():
            out = os.path.join(tmp, f"BENCH_torch_{name}.json")
            write_payload(out, payload)
            validated[name] = check_regression.validate(out)
    t_payloads = time.time() - t0
    calib = payloads["card_calibration"]
    emit({"phase": "bench_payloads", "gpu": gpu,
          "kernel_gates": kern["gates"],
          "kernels": kern.get("kernels", []),
          "card_calibration": {k: calib[k] for k in ("dryrun_status",
                                                     "dryrun_rows")},
          "inflation": {r["arch"]: r["inflation"]
                        for r in calib["measured"]["rows"]},
          "roofline_summary": roof, "validate_errors": validated,
          "seconds": t_payloads})
    print(roofline.table(recs), flush=True)
    assert all(not e for e in validated.values()), validated
    assert len(kern["gates"]) == len(calibration["probes"]) > 0, kern["gates"]
    if dryrun_records:
        assert calib["dryrun_status"] == "ok", calib["dryrun_status"]
        assert [r["arch"] for r in calib["dryrun_rows"]] == sorted(
            r["arch"] for r in dryrun_records if r["shape"] == "train_4k")
        assert roof["ok"] == roof["total"] == len(dryrun_records), roof
    else:
        assert calib["dryrun_status"] == "missing", calib["dryrun_status"]

    t0 = time.time()
    ab = ablation_pareto.run(seed=seed)              # device=None: the card
    ab_cpu = ablation_pareto.run(seed=seed, device="cpu")
    diffs = [abs(g[k] - w[k]) for g, w in zip(ab["frontier"],
                                              ab_cpu["frontier"])
             for k in ("delay_reduction", "energy_reduction")]
    emit({"phase": "bench_ablation", "gpu": gpu, "frontier": ab["frontier"],
          "baselines": ab["baselines"], "card_dominates": ab["card_dominates"],
          "cpu_card_dominates": ab_cpu["card_dominates"],
          "paper_point": ab["paper_point"], "max_abs_diff_vs_cpu": max(diffs),
          "tol": ABLATION_TOL, "seconds": time.time() - t0})
    assert len(diffs) == 2 * len(ablation_pareto.WEIGHTS), diffs
    assert max(diffs) <= ABLATION_TOL, diffs
    assert ab["card_dominates"] == ab_cpu["card_dominates"], (ab, ab_cpu)
    emit({"phase": "bench", "gpu": gpu, "full": full, "launches": counts,
          "runs_on_card": runs, "seconds": time.time() - t_phase})
    return counts, runs, versions, kernel_rows

# ---------------------------------------------------------------------------


# the source of the version the main path runs; the redesigned kernels keep
# their SIMT version for f32 and unaligned shapes (SIMT_SOURCES)
SOURCES = {
    "lora_matmul": ("src/repro_torch/csrc/lora_matmul_tc.cu",
                    "src/repro/kernels/lora_matmul.py:73"),
    "lora_matmul_grouped": ("src/repro_torch/csrc/lora_matmul_grouped_tc.cu",
                            "src/repro/kernels/lora_matmul.py:170"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention_tc.cu",
                        "src/repro/kernels/flash_attention.py:107"),
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:109"),
    "ssd_intra_chunk": ("src/repro_torch/csrc/ssd_scan_tc.cu",
                        "src/repro/kernels/ssd_scan.py:80"),
    "lora_matmul_tf32x3": ("src/repro_torch/csrc/lora_matmul_tf32.cu",
                           "src/repro/kernels/lora_matmul.py:73"),
    "flash_attention_tf32x3": ("src/repro_torch/csrc/flash_attention_tf32.cu",
                               "src/repro/kernels/flash_attention.py:107"),
}
SIMT_SOURCES = {"lora_matmul": "src/repro_torch/csrc/lora_matmul.cu",
                "lora_matmul_grouped": "src/repro_torch/csrc/lora_matmul.cu",
                "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
                "ssd_intra_chunk": "src/repro_torch/csrc/ssd_scan.cu",
                "lora_matmul_tf32x3": "src/repro_torch/csrc/lora_matmul.cu",
                "flash_attention_tf32x3":
                    "src/repro_torch/csrc/flash_attention.cu"}
# the wrapper of each entry: the f32 tensor-core versions are a second
# entry of their wrapper, beside its bf16 one
WRAPPER = {"lora_matmul_tf32x3": "lora_matmul",
           "flash_attention_tf32x3": "flash_attention"}
# the shape whose numbers head each kernel's entry (all shapes: "by_shape"):
# the f32 versions' calibrate bench (lora_matmul_512, flash_attention_512)
HEADLINE = {"lora_matmul": 2, "lora_matmul_grouped": 2, "flash_attention": 0,
            "flash_decode": 0, "ssd_intra_chunk": 0, "lora_matmul_tf32x3": 2,
            "flash_attention_tf32x3": 3}
# the path whose launch count each kernel's entry reports: the serving
# slice's kernels from the serve and prefill run, ssd_intra_chunk from the
# model path of the families phase, flash_decode and the f32 versions from
# calibrate (their only caller)
PATH_OF = {"lora_matmul": "serve", "lora_matmul_grouped": "serve",
           "flash_attention": "serve", "flash_decode": "calibrate",
           "ssd_intra_chunk": "families", "lora_matmul_tf32x3": "calibrate",
           "flash_attention_tf32x3": "calibrate"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--only", choices=("kernels", "train", "families",
                                       "fleet", "calibrate", "registry",
                                       "dryrun", "bench"),
                    default=None,
                    help="kernels: stop after the build and kernels phases; "
                         "train: run the train phase alone (it builds and "
                         "launches no kernel); families: build, then run "
                         "the families phase alone; fleet: build, the "
                         "calibrate pipeline's smoke probes for the "
                         "measured tables, then the fleet phase; "
                         "calibrate: the calibrate phase alone (its first "
                         "launch builds the kernels); registry: build, then "
                         "the registry phase alone; dryrun: the dryrun "
                         "phase alone (no kernel is built); bench: build, "
                         "then the bench phase alone with the serving "
                         "twin's full grid")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one decode tick and one local epoch "
                         "of split training with torch.profiler")
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

    if args.only == "train":
        phase_train(args.seed, args.profile)
        emit({"phase": "done", "only": "train",
              "seconds": time.time() - t_start})
        return 0
    if args.only == "calibrate":
        phase_calibrate(args.seed)
        emit({"phase": "done", "only": "calibrate",
              "seconds": time.time() - t_start})
        return 0
    if args.only == "dryrun":
        phase_dryrun(args.seed)
        emit({"phase": "done", "only": "dryrun",
              "seconds": time.time() - t_start})
        return 0

    from repro_torch.kernels import _build
    seconds = _build.build_all(force=True)
    for name in _build.SOURCES:
        _build.load(name)
    # distinct register counts, and any line that reports a spill
    spill = re.compile(r"\b[1-9]\d* bytes spill")
    usage = {name: sorted({ln.split(":", 1)[-1].strip()
                           for ln in log.splitlines()
                           if "registers" in ln or spill.search(ln)})
             for name, log in _build.build_logs.items()}
    sass = tensor_core_sass()
    emit({"phase": "build", "seconds": seconds, "sources": list(_build.SOURCES),
          "ptxas": usage, "sass_tensor_core_instructions": sass})
    for name in ("lora_matmul_tc", "lora_matmul_grouped_tc",
                 "flash_attention_tc"):
        assert sass[name]["HGMMA"] > 0, (name, sass)
    for name in ("ssd_scan_tc", "lora_matmul_tf32", "flash_attention_tf32"):
        assert sass[name]["HMMA"] > 0, (name, sass)  # mma.sync, tf32

    if args.only == "families":
        phase_families(args.seed)
        emit({"phase": "done", "only": "families",
              "seconds": time.time() - t_start})
        return 0
    if args.only == "registry":
        phase_registry(args.seed)
        emit({"phase": "done", "only": "registry",
              "seconds": time.time() - t_start})
        return 0
    if args.only == "bench":
        phase_bench(args.seed, True)
        emit({"phase": "done", "only": "bench",
              "seconds": time.time() - t_start})
        return 0
    if args.only == "fleet":
        from repro_torch.core.measured_cost import LatencyTable
        from repro_torch.launch import calibrate
        payload = calibrate.run(smoke=True)          # device=None: the card
        tables = {a: LatencyTable.from_dict(t)
                  for a, t in payload["latency_tables"].items()}
        emit({"phase": "calibrate_smoke", "seconds": payload["seconds"],
              "fit": payload["roofline_fit"]})
        phase_fleet(args.seed, tables)
        emit({"phase": "done", "only": "fleet",
              "seconds": time.time() - t_start})
        return 0

    rows = phase_kernels(args.seed)
    if args.only == "kernels":
        emit({"phase": "done", "only": "kernels",
              "seconds": time.time() - t_start})
        return 0

    by_path = {"serve": phase_serve_and_prefill(args.seed, args.requests,
                                                args.profile)}
    by_path["calibrate"], tables, calibration = phase_calibrate(args.seed)
    by_path["fleet"] = phase_fleet(args.seed, tables)
    by_path["train"] = phase_train(args.seed, args.profile)
    by_path["families"] = phase_families(args.seed)
    *registry, registry_rows = phase_registry(args.seed)
    by_path["registry"] = tuple(registry)
    _, dryrun_records = phase_dryrun(args.seed)
    *bench, bench_rows = phase_bench(args.seed, False, calibration,
                                     dryrun_records)
    by_path["bench"] = tuple(bench)
    for extra_rows in (registry_rows, bench_rows):  # after the headline rows
        for name, extra in extra_rows.items():
            rows[name] += extra

    kernels_line = []
    for name, by_shape in rows.items():
        head = by_shape[HEADLINE[name]]
        wrapper = WRAPPER.get(name, name)
        counts, runs, versions = by_path[PATH_OF[name]]
        launches = counts[wrapper]
        assert launches > 0, (name, by_path)
        if name in WRAPPER:         # every launch of the path is this version
            assert versions[wrapper][head["version"]] == launches, (
                name, versions)
        kernels_line.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches,
            "path": PATH_OF[name],
            "launches_by_path": {p: c[wrapper]
                                 for p, (c, *_) in by_path.items()},
            # the card's runs: a launch captured into a CUDA graph (the
            # calibrate path's timer) counts once per replay here
            "runs_on_card": runs[wrapper],
            "runs_on_card_by_path": {p: r[wrapper]
                                     for p, (_, r, _) in by_path.items()},
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            **{k: head[k] for k in ("version", "simt_ms", "bound_3xtf32_ms",
                                    "bound_3xtf32_by") if k in head},
            **({"launches_by_version": versions[wrapper]}
               if wrapper in versions else {}),
            **({"simt_source": SIMT_SOURCES[name]}
               if name in SIMT_SOURCES else {}),
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
