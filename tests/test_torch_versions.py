"""The pure-Python choices around the tensor-core kernels of the port, on
the CPU: which version of ``lora_matmul`` / ``flash_attention`` a CUDA call
takes (by dtype, shape and alignment), the split-K plan of the tensor-core
``lora_matmul``, and the build's content hash over every shared header.
"""
import shutil

import pytest
import torch

from repro_torch.kernels import _build, reset_launch_counts
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import lora_matmul as t_lm

BF16, F32 = torch.bfloat16, torch.float32
# (K, N) of the seven LoRA projections of llama32-1b, M = 64 (a prefill chunk)
SERVING_KN = ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048))


@pytest.mark.parametrize("dtype,k,n,r,aligned,want", [
    (BF16, 2048, 2048, 16, True, "wgmma"),
    (BF16, 8192, 2048, 16, True, "wgmma"),
    (BF16, 136, 72, 8, True, "wgmma"),
    (BF16, 520, 264, 64, True, "wgmma"),
    (BF16, 2048, 2048, 16, False, "simt"),   # a pointer off 16 bytes
    (F32, 2048, 2048, 16, True, "tf32x3"),   # f32: three tf32 products
    (F32, 2048, 2048, 16, False, "simt"),    # f32, a pointer off 16 bytes
    (F32, 2048, 2048, 6, True, "simt"),      # f32, r not a multiple of 4
    (BF16, 53, 48, 16, True, "simt"),        # K not whole 16-byte chunks
    (BF16, 64, 41, 16, True, "simt"),        # N ragged
    (BF16, 64, 64, 4, True, "simt"),         # r not a multiple of 8
    (BF16, 64, 64, 20, True, "simt"),
    # ranks 65..256: bf16 (r a multiple of 8) and f32 (r a multiple of 4)
    # on the tensor cores (64-rank panels), other ranks and unaligned
    # pointers on the SIMT kernel
    (BF16, 1024, 2048, 72, True, "wgmma"),
    (BF16, 7168, 7168, 128, True, "wgmma"),
    (BF16, 7168, 896, 256, True, "wgmma"),
    (F32, 1024, 2048, 128, True, "tf32x3"),
    (BF16, 1024, 2048, 100, True, "simt"),
    (BF16, 1024, 2048, 128, False, "simt"),   # a pointer off 16 bytes
    (F32, 1024, 2048, 68, True, "tf32x3"),    # a ragged panel of 4
    (F32, 7168, 896, 100, True, "tf32x3"),
    (F32, 1024, 3072, 200, True, "tf32x3"),
    (F32, 7168, 7168, 256, True, "tf32x3"),
    (F32, 1024, 2048, 130, True, "simt"),     # r not a multiple of 4
    (F32, 1024, 2048, 128, False, "simt"),    # a pointer off 16 bytes
])
def test_lora_matmul_version(dtype, k, n, r, aligned, want):
    # a prefill chunk of the engine (64 rows): below WS_MIN_ROWS
    assert t_lm.lora_matmul_version(dtype, 64, k, n, r, aligned) == want


@pytest.mark.parametrize("dtype,d,aligned,want", [
    (BF16, 16, True, "wgmma"), (BF16, 32, True, "wgmma"),
    (BF16, 64, True, "wgmma_ws"), (BF16, 128, True, "wgmma_ws"),
    (BF16, 64, False, "simt"), (F32, 64, True, "tf32x3"),
    (F32, 128, False, "simt"),
    # the warp-specialised kernel: bf16, head dims 64 and 128, TMA-aligned
    (BF16, 128, False, "simt"), (F32, 128, True, "tf32x3"),
    # head dims 72..128 (multiples of 8) on the D = 128 instantiations
    (BF16, 96, True, "wgmma_ws"), (BF16, 112, True, "wgmma_ws"),
    (F32, 112, True, "tf32x3"), (BF16, 72, True, "wgmma_ws"),
    (BF16, 112, False, "simt"),
    # bf16 head dims 8..56 and 136..256 (multiples of 8) on the D = 64,
    # 192 and 256 instantiations of the warp-specialised kernel; f32 keeps
    # the SIMT kernel there
    (BF16, 256, True, "wgmma_ws"), (F32, 256, True, "simt"),
    (BF16, 40, True, "wgmma_ws"), (F32, 100, True, "simt"),
    (BF16, 8, True, "wgmma_ws"), (BF16, 24, True, "wgmma_ws"),
    (BF16, 48, True, "wgmma_ws"), (BF16, 56, True, "wgmma_ws"),
    (BF16, 136, True, "wgmma_ws"), (BF16, 192, True, "wgmma_ws"),
    (BF16, 200, True, "wgmma_ws"), (F32, 40, True, "simt"),
    (F32, 192, True, "simt"), (F32, 8, True, "simt"),
    # unaligned calls and head dims off the multiples of 8: SIMT
    (BF16, 40, False, "simt"), (BF16, 256, False, "simt"),
    (BF16, 192, False, "simt"), (BF16, 100, True, "simt"),
    (BF16, 36, True, "simt"), (BF16, 252, True, "simt"),
])
def test_flash_attention_version(dtype, d, aligned, want):
    assert t_fa.flash_attention_version(dtype, d, aligned) == want


def test_ws_head_dims_are_the_model_paths():
    """The head dims every model path hands bf16 ``flash_attention`` at
    full width (128: the qwen, phi3 and internvl configs; 112:
    kimi-k2-1t-a32b; 64: llama32-1b, musicgen-large, hymba, granite; 256:
    qwen3-4b regrouped as Gemma-2 and Gemma-3 group their heads) take the
    warp-specialised kernel: every multiple of 8 from 8 to 256 but 16 and
    32, which keep the ``wgmma`` kernel; f32 takes the tensor cores at 16,
    32, 64 and the multiples of 8 from 72 to 128; the SIMT kernel takes
    every head dim up to 256."""
    assert t_fa.BF16_HEAD_DIMS == tuple(range(8, 257, 8))
    assert t_fa.WGMMA_HEAD_DIMS == (16, 32)
    assert t_fa.WS_HEAD_DIMS == tuple(d for d in range(8, 257, 8)
                                      if d not in (16, 32))
    assert t_fa.F32_HEAD_DIMS == (16, 32, 64, 72, 80, 88, 96, 104, 112,
                                  120, 128)
    assert t_fa.MAX_HEAD_DIM == 256
    assert {64, 112, 128, 256} <= set(t_fa.WS_HEAD_DIMS)


@pytest.mark.parametrize("d", range(8, 257, 8))
def test_ws_instance_is_the_narrowest_that_holds_the_head_dim(d):
    """Each head dim runs the narrowest of the kernel's instantiations (64,
    128, 192, 256) that holds it; their K / V tiles are 128 keys up to
    D = 128 and 64 keys above (a block's shared memory), as
    ``csrc/flash_attention_ws.cu``'s ``Cfg`` says."""
    inst = t_fa.ws_instance(d)
    assert inst in t_fa.WS_INSTANCES == (64, 128, 192, 256)
    assert d <= inst and all(w < d for w in t_fa.WS_INSTANCES if w < inst)
    assert t_fa.ws_keys(d) == (128 if inst <= 128 else 64)


def _covered(k, splits, ips):
    """The 64-deep K steps each split block walks (the kernel's ranges)."""
    n_iters = -(-k // t_lm.TC_BK)
    return [list(range(s * ips, min((s + 1) * ips, n_iters)))
            for s in range(splits)]


@pytest.mark.parametrize("m,k,n", [
    (64, 2048, 2048), (64, 2048, 512), (64, 2048, 8192), (64, 8192, 2048),
    (1, 2048, 2048), (37, 136, 72), (200, 520, 264), (64, 64, 64),
    (4096, 2048, 2048), (64, 8, 8), (130, 1000, 4104),
])
@pytest.mark.parametrize("sms", [132, 114, 1])
def test_tc_plan_covers_every_k_step_once(m, k, n, sms):
    bn, splits, ips = t_lm.tc_plan(m, k, n, sms)
    assert bn in (64, 128) and splits >= 1 and ips >= 1
    ranges = _covered(k, splits, ips)
    assert all(ranges), "no split may be empty"
    steps = [i for rg in ranges for i in rg]
    assert steps == list(range(-(-k // t_lm.TC_BK)))
    if n <= 64:
        assert bn == 64


@pytest.mark.parametrize("k,n", SERVING_KN)
@pytest.mark.parametrize("sms", [132, 114])
def test_tc_plan_fills_the_card_at_the_serving_shapes(k, n, sms):
    """At least one block per SM (the H100 SXM has 132, the PCIe part 114)
    at every projection of a llama32-1b prefill chunk."""
    bn, splits, _ = t_lm.tc_plan(64, k, n, sms)
    assert -(-n // bn) * splits >= sms


# (K, N) of qwen3-0.6b's five LoRA projections and of kimi-k2-1t-a32b's
# attention projections (q and o; k and v)
WIDE_RANK_KN = ((1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072),
                (3072, 1024), (7168, 7168), (7168, 896))


@pytest.mark.parametrize("k,n", WIDE_RANK_KN)
@pytest.mark.parametrize("r", [72, 128, 256])
def test_tc_plan_at_ranks_above_64(k, n, r):
    """bf16 ``lora_matmul`` at ranks 72 / 128 / 256 over a bench prefill
    chunk (M = 4) and an engine chunk (M = 64): ``wgmma``; the K split
    covers every step once, none empty; with the x@A panels
    (``ceil(r / 64)`` blocks a row tile and split, after the tiles of W)
    the grid starts at least one block per SM."""
    assert t_lm.lora_matmul_version(BF16, 64, k, n, r, True) == "wgmma"
    panels = -(-r // t_lm.RANK_PANEL)
    for m in (4, 64):
        bn, splits, ips = t_lm.tc_plan(m, k, n, 132)
        n_iters = -(-k // t_lm.TC_BK)
        ranges = [list(range(s * ips, min((s + 1) * ips, n_iters)))
                  for s in range(splits)]
        assert all(ranges), "no split may be empty"
        assert [i for rg in ranges for i in rg] == list(range(n_iters))
        assert (-(-n // bn) + panels) * splits >= 132


def test_by_version_counts_reset_with_the_launch_counts():
    t_lm.lora_matmul.by_version["wgmma"] = 3
    t_fa.flash_attention.by_version["simt"] = 2
    t_fa.flash_attention.by_version["wgmma_ws"] = 4
    reset_launch_counts()
    assert t_lm.lora_matmul.by_version == {"wgmma_ws": 0, "wgmma": 0,
                                           "tf32x3": 0, "simt": 0}
    assert t_fa.flash_attention.by_version == {"wgmma_ws": 0, "wgmma": 0,
                                               "tf32x3": 0, "simt": 0}


def test_cpu_calls_take_the_plain_version_and_count_no_version():
    reset_launch_counts()
    x = torch.randn(64, 128, dtype=BF16)
    t_lm.lora_matmul(x, torch.randn(128, 64, dtype=BF16),
                     torch.randn(128, 16, dtype=BF16),
                     torch.randn(16, 64, dtype=BF16))
    q = torch.randn(1, 2, 70, 64, dtype=BF16)
    t_fa.flash_attention(q, q, q)
    t_fa.flash_attention(torch.randn(1, 4, 70, 128, dtype=BF16),
                         torch.randn(1, 2, 70, 128, dtype=BF16),
                         torch.randn(1, 2, 70, 128, dtype=BF16))
    assert t_lm.lora_matmul.by_version == {"wgmma_ws": 0, "wgmma": 0,
                                           "tf32x3": 0, "simt": 0}
    assert t_fa.flash_attention.by_version == {"wgmma_ws": 0, "wgmma": 0,
                                               "tf32x3": 0, "simt": 0}


@pytest.mark.parametrize("header", ["common.cuh", "hopper.cuh", "tf32x3.cuh"])
def test_editing_any_header_renames_every_library(tmp_path, monkeypatch,
                                                  header):
    """A library is named by a hash of its source and of every header in
    ``csrc/``: editing one header must rebuild every source, including one
    that does not include it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc,
                    ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    before = {name: _build._target(name) for name in _build.SOURCES}
    with open(csrc / header, "a") as fh:
        fh.write("\n// edited\n")
    after = {name: _build._target(name) for name in _build.SOURCES}
    assert all(before[name] != after[name] for name in _build.SOURCES)
    assert all(p.parent == tmp_path / "build" for p in after.values())


def test_a_new_header_renames_every_library(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc,
                    ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = {name: _build._target(name) for name in _build.SOURCES}
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(_build._target(name) != before[name] for name in _build.SOURCES)


@pytest.mark.parametrize("arch,want", [
    ("mamba2-370m", (4, 4, 256, 32, 64, 128)),
    ("hymba-1.5b", (4, 8, 128, 50, 64, 16)),
])
def test_mamba_forward_hands_ssd_intra_chunk_the_tc_shapes(monkeypatch, arch,
                                                           want):
    """``mamba_forward(impl="flash")`` at the full published width on
    (4, 1024) tokens, traced on the meta device (shapes only, no memory):
    each call of ``ssd_intra_chunk`` gets whole f32 tensors (contiguous,
    offset 0, so 16-byte aligned on the card) at the shape that the
    tensor-core version takes."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ssd_scan as t_ssd
    from repro_torch.models import mamba as t_mamba
    cfg = get_config(arch)
    gen = torch.Generator().manual_seed(0)
    params = t_mamba.init_mamba(gen, cfg, BF16, "meta")
    lora = {k: {n: v.to(BF16) for n, v in pair.items()} for k, pair in
            t_mamba.init_mamba_lora(gen, cfg, "meta").items()}
    calls = []

    def record(xt, a, B, C):
        calls.append([(tuple(t.shape), t.dtype, t.is_contiguous(),
                       t.storage_offset()) for t in (xt, a, B, C)])
        b, nc, cl, nh, hp = xt.shape
        return (torch.empty_like(xt),
                xt.new_empty((b, nc, nh, B.shape[-1], hp)),
                xt.new_empty((b, nc, cl, nh, 2)))
    monkeypatch.setattr(t_ssd, "ssd_intra_chunk", record)
    x = torch.empty((4, 1024, cfg.d_model), dtype=BF16, device="meta")
    y = t_mamba.mamba_forward(params, lora, x, cfg, impl="flash")
    assert tuple(y.shape) == tuple(x.shape)
    assert len(calls) == 1
    b, nc, cl, nh, hp, ns = want
    shapes = [(b, nc, cl, nh, hp), (b, nc, cl, nh), (b, nc, cl, ns),
              (b, nc, cl, ns)]
    assert [c[0] for c in calls[0]] == shapes
    assert all(c[1:] == (F32, True, 0) for c in calls[0])
    assert t_ssd.ssd_intra_chunk_version(cl, hp, ns, True) == "tc"
