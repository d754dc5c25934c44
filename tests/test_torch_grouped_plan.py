"""The pure-Python plans around the redesigned grouped LoRA and flash-decode
kernels, on the CPU: which version of ``lora_matmul_grouped`` a CUDA call
takes (by dtype, shape and alignment), the split-K plan of its tensor-core
kernel and how that kernel deals the rows' x@A over its blocks, and how
``flash_decode`` splits the run of valid slots.
"""
import pytest
import torch

from repro_torch.kernels import flash_decode as t_fd
from repro_torch.kernels import lora_matmul as t_lm
from repro_torch.kernels import reset_launch_counts

BF16, F32 = torch.bfloat16, torch.float32
# (K, N) of the seven LoRA projections of llama32-1b; a decode tick of the
# serving engine has 8 slots, one row each
SERVING_KN = ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048))


@pytest.mark.parametrize("dtype,k,n,r,aligned,want", [
    (BF16, 2048, 2048, 16, True, "wgmma"),
    (BF16, 2048, 512, 16, True, "wgmma"),
    (BF16, 2048, 8192, 16, True, "wgmma"),
    (BF16, 8192, 2048, 16, True, "wgmma"),
    (BF16, 1096, 72, 16, True, "wgmma"),     # ragged K, whole 16-byte chunks
    (BF16, 136, 64, 64, True, "wgmma"),      # the largest rank
    (BF16, 2048, 2048, 16, False, "simt"),   # a pointer or stride off 16 B
    (F32, 2048, 2048, 16, True, "tf32x3"),   # f32 on the tensor cores too
    (BF16, 1096, 70, 16, True, "simt"),      # N not whole 16-byte chunks
    (BF16, 1100, 72, 16, True, "simt"),      # K not whole 16-byte chunks
    (BF16, 53, 41, 8, True, "simt"),         # K ragged by an odd count
    (BF16, 256, 96, 4, True, "simt"),        # r not a multiple of 8
    (BF16, 300, 96, 12, True, "simt"),
])
def test_lora_matmul_grouped_version(dtype, k, n, r, aligned, want):
    assert t_lm.lora_matmul_grouped_version(dtype, k, n, r, aligned) == want


def _k_steps(k, splits, ips):
    """The 64-deep K steps each split walks (the kernel's ranges)."""
    n_iters = -(-k // t_lm.TC_BK)
    return [list(range(s * ips, min((s + 1) * ips, n_iters)))
            for s in range(splits)]


@pytest.mark.parametrize("rows,k,n,r", [
    (8, 2048, 2048, 16), (8, 2048, 512, 16), (8, 2048, 8192, 16),
    (8, 8192, 2048, 16), (15, 1100, 72, 16), (32, 128, 128, 8),
    (4, 130, 64, 64), (70, 520, 264, 32), (1, 8, 8, 8), (200, 1000, 96, 24),
])
@pytest.mark.parametrize("sms", [132, 114, 1])
def test_grouped_plan_covers_every_k_step_once(rows, k, n, r, sms):
    bn, splits, ips, nx = t_lm.grouped_plan(rows, k, n, sms, r)
    assert bn in (64, 128) and splits >= 1 and ips >= 1
    ranges = _k_steps(k, splits, ips)
    assert all(ranges), "no split may be empty"
    assert [i for rg in ranges for i in rg] == list(range(-(-k // 64)))
    assert nx >= -(-n // bn)


@pytest.mark.parametrize("k,n", SERVING_KN)
@pytest.mark.parametrize("sms", [132, 114])
def test_grouped_plan_fills_the_card_at_the_serving_shapes(k, n, sms):
    """At least one block per SM (the H100 SXM has 132, the PCIe part 114)
    at every projection of a llama32-1b decode tick, and no block that
    reads more than a quarter of its share of W again in rows of A."""
    bn, splits, _, nx = t_lm.grouped_plan(8, k, n, sms, 16)
    assert nx * splits >= sms
    assert -(-8 // nx) * 16 <= bn // 4


def _dealt_units(rows, nx, r):
    """Per block of each row tile, the x@A units ``grouped_xa_units``
    deals it; and the (row, first rank, ranks) units the tile has."""
    for m0 in range(0, rows, 64):
        here = min(64, rows - m0)
        owned = [t_lm.grouped_xa_units(bx, here, nx, r) for bx in range(nx)]
        want = [(i, c, min(64, r - c)) for i in range(here)
                for c in range(0, r, 64)]
        yield owned, want


@pytest.mark.parametrize("rows,n,r", [
    (8, 2048, 16), (8, 512, 16), (15, 72, 16), (32, 128, 8), (4, 64, 64),
    (64, 64, 64), (70, 264, 32), (200, 96, 24), (130, 4104, 8), (1, 8, 8),
    # ranks past 64: a unit is a 64-rank chunk of a row, one a block
    (8, 896, 128), (8, 896, 256), (8, 2048, 72), (5, 256, 200),
    (64, 64, 256), (70, 264, 136), (1, 8, 256), (130, 4104, 128),
])
def test_grouped_xa_rows_cover_each_row_and_split_once(rows, n, r):
    """In every K split, every (row, 64-rank chunk) unit of x@A is computed
    by exactly one block of its row tile, and no block holds more than
    ``grouped_units_per_block(r)`` of them: 64 // r rows up to r = 64 (what
    fits the kernel's stage of A and its registers), one unit past it."""
    bn, splits, _, nx = t_lm.grouped_plan(rows, 4096, n, 132, r)
    per_block = t_lm.grouped_units_per_block(r)
    assert per_block == (64 // r if r <= 64 else 1)
    for owned, want in _dealt_units(rows, nx, r):
        assert sorted(u for o in owned for u in o) == want
        assert max(len(o) for o in owned) <= per_block
        # a block's units share one width (the kernel's stage layout)
        assert all(len({w for _, _, w in o}) <= 1 for o in owned)


# (K, N) of qwen3-0.6b's five LoRA projections (q; k and v; o; gate and up;
# down): the f32 serve path's decode ticks
QWEN3_KN = ((1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072),
            (3072, 1024))


# kimi-k2-1t-a32b's attention projections: q and o (7168, 7168), k and v
# (7168, 896)
KIMI_KN = ((7168, 7168), (7168, 896))


@pytest.mark.parametrize("k,n", QWEN3_KN + KIMI_KN)
@pytest.mark.parametrize("r", [72, 128, 256])
def test_grouped_plan_deals_ranks_above_64_at_the_model_shapes(k, n, r):
    """bf16 ``lora_matmul_grouped`` at ranks 72 / 128 / 256 over a tick of
    8 rows at qwen3-0.6b's and kimi-k2-1t-a32b's projections: ``wgmma``,
    every K step in one split, none empty, at least one block per SM, and
    every (row, 64-rank chunk) of each split in exactly one block, one
    unit a block."""
    assert t_lm.lora_matmul_grouped_version(BF16, k, n, r, True) == "wgmma"
    bn, splits, ips, nx = t_lm.grouped_plan(8, k, n, 132, r)
    ranges = _k_steps(k, splits, ips)
    assert all(ranges), "no split may be empty"
    assert [i for rg in ranges for i in rg] == list(range(-(-k // 64)))
    assert nx >= max(-(-n // bn), 8 * -(-r // 64))
    assert nx * splits >= 132
    for owned, want in _dealt_units(8, nx, r):
        assert sorted(u for o in owned for u in o) == want
        assert max(len(o) for o in owned) == 1


@pytest.mark.parametrize("rows,k,n,r", [
    (8, 2048, 2048, 16), (8, 2048, 512, 16), (1, 8, 8, 4), (1, 2048, 512, 16),
    (15, 1100, 72, 16), (32, 256, 64, 64), (4, 136, 64, 64),
    (70, 520, 264, 16), (70, 520, 264, 24), (200, 1000, 96, 32),
    (8, 256, 128, 4), *((8, k, n, 16) for k, n in QWEN3_KN)])
@pytest.mark.parametrize("sms", [132, 114, 1])
def test_grouped_tf32_plan_covers_every_k_step_once(rows, k, n, r, sms):
    """The f32 grouped kernel's plan: every 32-deep K step falls in exactly
    one split, none empty; the row tile is the fewest of 8, 16, 32 rows
    that holds the rows (32 past that); x@A blocks follow the W tiles."""
    rt, splits, ips, nx = t_lm.grouped_tf32_plan(rows, k, n, sms, r)
    assert rt == (8 if rows <= 8 else 16 if rows <= 16 else 32)
    n_iters = -(-k // t_lm.TF32_BK)
    ranges = [list(range(s * ips, min((s + 1) * ips, n_iters)))
              for s in range(splits)]
    assert all(ranges), "no split may be empty"
    assert [i for rg in ranges for i in rg] == list(range(n_iters))
    assert nx > -(-n // t_lm.TF32_GROUPED_BN)


@pytest.mark.parametrize("k,n", SERVING_KN[:2] + QWEN3_KN)
def test_grouped_tf32_plan_fills_the_card_at_the_decode_shapes(k, n):
    """At 8 rows (a decode tick of 8 slots), at llama32-1b's (2048, 2048 /
    512) and qwen3-0.6b's five projections: at least 132 blocks (the H100's
    SMs), no split deeper than ``TF32_GROUPED_STEPS`` K steps, and the
    fewest splits (of the counts an even deal of the steps gives) that meet
    both."""
    rt, splits, ips, nx = t_lm.grouped_tf32_plan(8, k, n, 132, 16)
    n_iters = -(-k // t_lm.TF32_BK)
    assert rt == 8
    assert nx * splits >= 132 and ips <= t_lm.TF32_GROUPED_STEPS
    dealt = [s for s in range(1, n_iters + 1)
             if -(-n_iters // -(-n_iters // s)) == s]
    assert splits == min(s for s in dealt if nx * s >= 132
                         and -(-n_iters // s) <= t_lm.TF32_GROUPED_STEPS)


@pytest.mark.parametrize("rows,n,r", [
    (8, 2048, 16), (8, 512, 16), (15, 72, 16), (32, 128, 8), (4, 64, 64),
    (32, 64, 64), (70, 264, 32), (200, 96, 24), (130, 4104, 8), (1, 8, 4),
    (8, 128, 4), (70, 264, 12)])
def test_grouped_tf32_xa_rows_cover_each_row_and_split_once(rows, n, r):
    """In every K split, every row's x@A (one unit a row up to r = 64) is
    computed by exactly one x@A block of its row tile, none by a block of
    W, and no x@A block holds more than ``TF32_XA_COLS // r`` rows (one
    where r is larger): what fits its stage of A and its registers."""
    rt, splits, _, nx = t_lm.grouped_tf32_plan(rows, 4096, n, 132, r)
    assert t_lm.grouped_tf32_units_per_block(r) == max(
        1, t_lm.TF32_XA_COLS // r)
    for owned, want in _dealt_tf32_units(rows, rt, n, nx, r):
        assert sorted(u for o in owned for u in o) == want
        assert max(len(o) for o in owned) <= max(1, t_lm.TF32_XA_COLS // r)


def _dealt_tf32_units(rows, rt, n, nx, r):
    """Per block of each row tile of the f32 grouped kernel, the x@A units
    ``grouped_tf32_xa_units`` deals it (the same in every K split), none to
    a tile of W; and the (row, first rank, ranks) units the tile has."""
    n_tiles = -(-n // t_lm.TF32_GROUPED_BN)
    for m0 in range(0, rows, rt):
        here = min(rt, rows - m0)
        owned = [t_lm.grouped_tf32_xa_units(bx, here, n, nx, r)
                 for bx in range(nx)]
        assert not any(owned[:n_tiles])
        want = [(i, c, min(64, r - c)) for i in range(here)
                for c in range(0, r, 64)]
        yield owned, want


@pytest.mark.parametrize("k,n", QWEN3_KN + KIMI_KN)
@pytest.mark.parametrize("r", [68, 100, 128, 200, 256])
def test_grouped_tf32_plan_deals_ranks_above_64_at_the_model_shapes(k, n, r):
    """f32 ``lora_matmul_grouped`` at ranks 68 to 256 over a tick of 8 rows
    at qwen3-0.6b's and kimi-k2-1t-a32b's projections: ``tf32x3``, every
    32-deep K step in one split, none empty, none deeper than
    ``TF32_GROUPED_STEPS``, at least one block per SM, and every (row,
    64-rank chunk) unit of each split in exactly one x@A block, one unit a
    block, a ragged last chunk where 64 does not divide r."""
    assert t_lm.lora_matmul_grouped_version(F32, k, n, r, True) == "tf32x3"
    rt, splits, ips, nx = t_lm.grouped_tf32_plan(8, k, n, 132, r)
    n_iters = -(-k // t_lm.TF32_BK)
    ranges = [list(range(s * ips, min((s + 1) * ips, n_iters)))
              for s in range(splits)]
    assert all(ranges), "no split may be empty"
    assert [i for rg in ranges for i in rg] == list(range(n_iters))
    assert ips <= t_lm.TF32_GROUPED_STEPS
    assert nx == -(-n // t_lm.TF32_GROUPED_BN) + 8 * -(-r // 64)
    assert nx * splits >= 132
    for owned, want in _dealt_tf32_units(8, rt, n, nx, r):
        assert sorted(u for o in owned for u in o) == want
        assert max(len(o) for o in owned) == 1
        assert sum(w for _, _, w in want) == 8 * r


@pytest.mark.parametrize("t,slots,window,run", [
    (0, 512, 0, 1),          # first token of a linear cache
    (200, 512, 0, 201),
    (511, 512, 0, 512),
    (1500, 512, 0, 512),     # t past the end: the whole cache
    (1100, 256, 1000, 155),  # a window over a linear cache (window > slots)
    (0, 512, 512, 512),      # a ring buffer: its full run, whatever t
    (1500, 512, 512, 512),
    (60, 100, 32, 100),      # window <= slots: a ring
    (5, 64, 100, 6),         # window > slots: a linear cache
])
def test_flash_decode_valid_run(t, slots, window, run):
    assert t_fd.valid_run(t, slots, window) == run


@pytest.mark.parametrize("bh,t,slots,window,sms,piece,want", [
    (64, 0, 512, 0, 132, 64, 1),        # llama32-1b cache, first token: one
    (64, 63, 512, 0, 132, 64, 1),
    (64, 64, 512, 0, 132, 64, 2),
    (64, 200, 512, 0, 132, 64, 4),
    (64, 511, 512, 0, 132, 64, 5),      # two blocks per SM bound it
    (64, 0, 512, 512, 132, 64, 5),      # a ring buffer: its full run
    (64, 511, 512, 0, 132, 128, 4),     # bf16 D=64 G=4: 128-slot blocks
    (64, 200, 512, 0, 132, 128, 2),
    (64, 100, 512, 0, 132, 128, 1),
    (8, 1023, 1024, 0, 132, 64, 8),     # the calibrate bench: 8 at most
    (1, 4095, 4096, 0, 132, 64, 8),
    (1, 5000, 4096, 4096, 114, 64, 8),
    (2, 150, 64, 64, 132, 64, 1),       # a short ring
])
def test_flash_decode_splits_follow_the_valid_run(bh, t, slots, window, sms,
                                                  piece, want):
    run = t_fd.valid_run(t, slots, window)
    got = t_fd.n_splits(bh, run, sms, piece)
    assert got == want
    assert 1 <= got <= max(1, -(-run // 64)) and got <= t_fd.MAX_SPLITS


@pytest.mark.parametrize("d,elem_bytes,g,want", [
    (64, 2, 4, 128),     # llama32-1b in bf16: 32-slot tiles, any D and G
    (16, 2, 1, 128),
    (128, 2, 8, 128),
    (64, 4, 2, 64),      # the calibrate bench, f32: 16 lanes a row
    (128, 4, 8, 16),     # one row a warp load, 4 loads a tile
    (16, 4, 3, 256),
])
def test_flash_decode_block_slots(d, elem_bytes, g, want):
    assert t_fd.block_slots(d, elem_bytes, g) == want


def test_cpu_grouped_calls_count_no_version():
    reset_launch_counts()
    x = torch.randn(8, 1, 128, dtype=BF16)
    y = t_lm.lora_matmul_grouped(x, torch.randn(128, 64, dtype=BF16),
                                 torch.randn(4, 128, 16, dtype=BF16),
                                 torch.randn(4, 16, 64, dtype=BF16),
                                 torch.arange(8, dtype=torch.int32) % 4)
    assert y.shape == (8, 1, 64)
    assert t_lm.lora_matmul_grouped.launches == 0
    assert t_lm.lora_matmul_grouped.by_version == {"wgmma": 0, "tf32x3": 0,
                                                   "simt": 0}


def test_grouped_by_version_resets_with_the_launch_counts():
    t_lm.lora_matmul_grouped.by_version["wgmma"] = 5
    t_lm.lora_matmul_grouped.by_version["tf32x3"] = 3
    reset_launch_counts()
    assert t_lm.lora_matmul_grouped.by_version == {"wgmma": 0, "tf32x3": 0,
                                                   "simt": 0}
