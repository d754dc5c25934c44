"""The f32 tensor-core versions of ``lora_matmul`` and ``flash_attention``
(``"tf32x3"``: ``csrc/lora_matmul_tf32.cu``, ``csrc/flash_attention_tf32.cu``)
on the CPU, where no kernel runs: which version an f32 call takes (by K, N,
r, head dim, alignment and strides), how their grids cover the work
(``tf32_plan``, ``tf32_grid`` / ``tf32_block``), and an emulation of their
arithmetic -- every product as three tf32 products of operands split by
truncation, in the kernels' tiles, splits and order of sums -- which meets
the unchanged f32 tolerances at every probe shape of the calibrate path and
agrees with the plain versions; the plain versions agree with the JAX
package's ``ops.lora_matmul`` and ``ops.flash_attention`` (Pallas in
interpret mode) at those shapes.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import j2n, t2n
from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import lora_matmul as t_lm
from test_torch_grouped_plan import KIMI_KN, QWEN3_KN
from test_torch_ssd_plan import _product, _tf32

torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16
LORA_TOL = 2e-4          # x max|want|, chip_smoke.LORA_TOL[f32]
ATTN_TOL = 2e-5          # absolute, chip_smoke.ATTN_TOL[f32]
# the calibrate path's f32 probe shapes (measured_cost._FULL_SHAPES)
LORA_PROBES = ((128, 128, 128, 8), (256, 256, 256, 8), (512, 512, 512, 16),
               (1024, 1024, 1024, 16), (256, 1024, 512, 16))
FLASH_PROBES = ((1, 128, 4, 2, 32), (1, 256, 4, 2, 32), (1, 512, 4, 2, 32),
                (1, 512, 8, 4, 64))
LORA_BENCH, FLASH_BENCH = (512, 512, 512, 16), (1, 512, 8, 4, 64)


# ---------------------------------------------------------------------------
# versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,n,r,aligned,want", [
    (512, 512, 16, True, "tf32x3"),          # the calibrate bench
    (1024, 1024, 16, True, "tf32x3"),
    (260, 196, 12, True, "tf32x3"),          # K, N, r multiples of 4 only
    (64, 68, 4, True, "tf32x3"),
    (520, 264, 64, True, "tf32x3"),          # the largest rank
    (512, 512, 16, False, "simt"),           # a pointer off 16 bytes
    (257, 128, 8, True, "simt"),             # K not whole 16-byte copies
    (128, 130, 8, True, "simt"),             # N ragged
    (128, 128, 6, True, "simt"),             # r not a multiple of 4
    (53, 41, 3, True, "simt"),
])
def test_lora_matmul_f32_version(k, n, r, aligned, want):
    assert t_lm.lora_matmul_version(F32, 64, k, n, r, aligned) == want


@pytest.mark.parametrize("k,n,r,aligned,want", [
    (512, 512, 16, True, "tf32x3"), (2048, 2048, 16, True, "tf32x3"),
    (136, 72, 8, True, "tf32x3"),
    (2048, 2048, 16, False, "simt"),        # a pointer or stride off 16 B
    (256, 96, 3, True, "simt"),             # r not a multiple of 4
])
def test_lora_matmul_grouped_takes_tf32x3_in_f32(k, n, r, aligned, want):
    """The grouped function's f32 calls take the tensor-core kernel
    (``csrc/lora_matmul_grouped_tf32.cu``) under ``lora_matmul_version``'s
    f32 rule, the f32 decode ticks included; bf16 at the same aligned
    shapes takes wgmma."""
    assert t_lm.lora_matmul_grouped_version(F32, k, n, r, aligned) == want
    if aligned and want == "tf32x3":
        assert t_lm.lora_matmul_grouped_version(BF16, k, n, r,
                                                True) == "wgmma"
    assert set(t_lm.lora_matmul_grouped.by_version) == {"wgmma", "tf32x3",
                                                        "simt"}


@pytest.mark.parametrize("d,aligned,want", [
    (16, True, "tf32x3"), (32, True, "tf32x3"), (64, True, "tf32x3"),
    (128, True, "tf32x3"), (64, False, "simt"), (24, True, "simt"),
])
def test_flash_attention_f32_version(d, aligned, want):
    assert t_fa.flash_attention_version(F32, d, aligned) == want


def test_flash_attention_alignment_is_by_pointer_and_stride():
    """``sixteen_byte_steps``: f32 rows must start on 16 bytes, so every
    stride is a multiple of 4 elements (8 for bf16) and every pointer
    aligned; the model's (B, S, H, D) layout permuted in place qualifies."""
    base = torch.zeros(2, 64, 4, 64)                    # (B, S, H, D)
    assert t_fa.sixteen_byte_steps(base.permute(0, 2, 1, 3))
    assert t_fa.sixteen_byte_steps(base.permute(0, 2, 1, 3).to(BF16))
    wide = torch.zeros(2, 4, 64, 66)[..., :64]          # row stride 66
    assert not t_fa.sixteen_byte_steps(wide)
    assert t_fa.sixteen_byte_steps(torch.zeros(2, 4, 64, 68)[..., :64])
    assert not t_fa.sixteen_byte_steps(
        torch.zeros(2, 4, 64, 68, dtype=BF16)[..., :64])  # 136 bytes
    flat = torch.zeros(2 * 4 * 64 * 64 + 1)
    assert not t_fa.sixteen_byte_steps(flat[1:].view(2, 4, 64, 64))
    assert t_fa.flash_attention_version(
        F32, 64, t_fa.sixteen_byte_steps(wide)) == "simt"


def test_f32_calls_on_the_cpu_take_the_plain_version_and_count_nothing():
    from repro_torch.kernels import reset_launch_counts
    reset_launch_counts()
    x = torch.randn(64, 128)
    t_lm.lora_matmul(x, torch.randn(128, 64), torch.randn(128, 16),
                     torch.randn(16, 64))
    q = torch.randn(1, 2, 70, 64)
    t_fa.flash_attention(q, q, q)
    assert t_lm.lora_matmul.by_version["tf32x3"] == 0
    assert t_fa.flash_attention.by_version["tf32x3"] == 0
    assert t_lm.lora_matmul.launches == t_fa.flash_attention.launches == 0


# ---------------------------------------------------------------------------
# grids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [
    *((m, k, n) for m, k, n, _ in LORA_PROBES), (70, 260, 196), (1, 32, 4),
    (130, 64, 68), (200, 520, 264), (37, 4, 8), (4096, 2048, 2048)])
@pytest.mark.parametrize("sms", [132, 114, 1])
def test_tf32_plan_covers_every_k_step_once(m, k, n, sms):
    splits, ips = t_lm.tf32_plan(m, k, n, sms)
    n_iters = -(-k // t_lm.TF32_BK)
    ranges = [range(s * ips, min((s + 1) * ips, n_iters))
              for s in range(splits)]
    assert all(ranges), "no split may be empty"
    assert [i for rg in ranges for i in rg] == list(range(n_iters))


@pytest.mark.parametrize("mkn", [LORA_BENCH[:3], (1024, 1024, 1024),
                                 (256, 1024, 512)])
def test_tf32_plan_starts_a_block_per_sm_at_the_bench_and_large_probes(mkn):
    """At least 132 blocks (the H100's SMs) at the calibrate bench and the
    probes larger than it; 512^3 alone is 64 output tiles."""
    m, k, n = mkn
    splits, _ = t_lm.tf32_plan(m, k, n, 132)
    assert -(-m // 64) * -(-n // 64) * splits >= 132


@pytest.mark.parametrize("m", [4, 64])
@pytest.mark.parametrize("k,n", QWEN3_KN + KIMI_KN)
@pytest.mark.parametrize("r", [68, 100, 128, 200, 256])
def test_tf32_plan_panels_at_ranks_above_64(m, k, n, r):
    """f32 ``lora_matmul`` at ranks 68 to 256 over a prefill chunk (4 rows,
    the rank phase's; 64, a chunk of the engine's default) at qwen3-0.6b's
    and kimi-k2-1t-a32b's projections: ``tf32x3``; the X@A panel blocks
    cover the ranks once, 64 a panel and a ragged last one; every 32-deep K
    step in one split, none empty; at least two blocks per SM (the
    H100's 132), which the r > 64 kernel's plan asks for."""
    assert t_lm.lora_matmul_version(F32, m, k, n, r, True) == "tf32x3"
    panels = t_lm.tf32_panels(r)
    assert [j for p, w in panels for j in range(p, p + w)] == list(range(r))
    assert all(0 < w <= 64 for _, w in panels) and len(panels) == -(-r // 64)
    splits, ips = t_lm.tf32_plan(m, k, n, 132, r)
    n_iters = -(-k // t_lm.TF32_BK)
    ranges = [range(s * ips, min((s + 1) * ips, n_iters))
              for s in range(splits)]
    assert all(ranges), "no split may be empty"
    assert [i for rg in ranges for i in rg] == list(range(n_iters))
    blocks = -(-m // 64) * (-(-n // 64) + len(panels)) * splits
    assert blocks >= 2 * 132


def test_tf32_plan_is_unchanged_up_to_rank_64():
    """Up to r = 64 X@A rides in the first N tile's blocks: no panel, and
    the plan of r = 16 (the calibrate bench's) at every rank."""
    for r in (4, 16, 32, 64):
        assert t_lm.tf32_panels(r) == []
        for m, k, n, _ in LORA_PROBES:
            assert t_lm.tf32_plan(m, k, n, 132, r) == t_lm.tf32_plan(m, k, n,
                                                                     132)


@pytest.mark.parametrize("b,hq,sq", [(1, 8, 512), (1, 4, 512), (2, 4, 70),
                                     (1, 25, 96), (3, 2, 16), (1, 1, 1)])
def test_flash_tf32_blocks_cover_every_query_once(b, hq, sq):
    gx, gy = t_fa.tf32_grid(b, hq, sq)
    seen = set()
    for bx in range(gx):
        for by in range(gy):
            bi, h, rows = t_fa.tf32_block(bx, by, hq, sq)
            assert len(rows) >= 1
            for i in rows:
                assert (bi, h, i) not in seen
                seen.add((bi, h, i))
    assert seen == {(bi, h, i) for bi in range(b) for h in range(hq)
                    for i in range(sq)}
    # the heaviest causal tiles (the last queries) first
    assert t_fa.tf32_block(0, 0, hq, sq)[2][-1] == sq - 1


def test_flash_tf32_grid_fills_the_card_at_the_bench():
    b, s, hq, _, _ = FLASH_BENCH
    gx, gy = t_fa.tf32_grid(b, hq, s)
    assert gx * gy >= 132


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated
# ---------------------------------------------------------------------------


def _rz(x: torch.Tensor) -> torch.Tensor:
    """f32 truncated to tf32: the 13 low mantissa bits cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _product_rz(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels take it: operands split by truncation (``split_rz``
    of ``csrc/tf32x3.cuh``), lo.hi + hi.lo + hi.hi with f32 sums."""
    ah, bh = _rz(a), _rz(b)
    al, bl = _rz(a - ah), _rz(b - bh)
    return al @ bh + ah @ bl + ah @ bh


@pytest.mark.parametrize("seed", [0, 1])
def test_the_truncating_split_keeps_f32_accuracy(seed):
    """hi + lo recovers x to 2^-21 of |x| after truncation (the kernels'
    split_rz), to 2^-22 after rounding (ssd_scan_tc's split): both far below
    the tolerances, where hi alone is off by up to 2^-10."""
    x, = _normal(seed, (4096,))
    x = x * torch.exp2(torch.randint(-20, 20, (4096,)).float())
    for tf32, bound in ((_rz, 2.0 ** -21), (_tf32, 2.0 ** -22)):
        hi = tf32(x)
        rel = ((hi + tf32(x - hi)) - x).abs() / x.abs()
        assert rel.max().item() <= bound
        assert ((hi - x).abs() / x.abs()).max().item() > 2.0 ** -13


def _prod3(a, b, split):
    return _product_rz(a, b) if split == "rz" else _product(a, b, 3)


def _emulate_lora(x, w, a, b, scale, split="rz", sms=132):
    """``lora_matmul_tf32_split_kernel`` and its epilogue: K in 32-deep
    steps dealt to the splits of ``tf32_plan``, X@W and X@A (in the first N
    tile's blocks, or the panel blocks above r = 64: the same sums) summed
    step by step in each split; the splits added in order, then
    s * (X@A) @ B: in f32 on the CUDA cores up to r = 64, above it as three
    truncated tf32 products (the correction kernel)."""
    m, k = x.shape
    n, r = w.shape[1], a.shape[1]
    splits, ips = t_lm.tf32_plan(m, k, n, sms, r)
    n_iters = -(-k // t_lm.TF32_BK)
    y = torch.zeros(m, n)
    xa = torch.zeros(m, a.shape[1])
    for sp in range(splits):
        py, pa = torch.zeros(m, n), torch.zeros(m, a.shape[1])
        for it in range(sp * ips, min((sp + 1) * ips, n_iters)):
            ks = slice(t_lm.TF32_BK * it, t_lm.TF32_BK * (it + 1))
            py += _prod3(x[:, ks], w[ks], split)
            pa += _prod3(x[:, ks], a[ks], split)
        y, xa = y + py, xa + pa
    if t_lm.tf32_panels(r):
        return y + scale * _product_rz(xa, b)
    return y + scale * (xa @ b)


def _emulate_grouped(x, w, a, b, ids, scale, sms=132):
    """``lora_matmul_grouped_tf32_split_kernel`` and its reduce: K in
    32-deep steps dealt to the splits of ``grouped_tf32_plan``; in each
    split warp ``j`` sums x@W over the k8 block ``j`` of every step (three
    truncated tf32 products), the four warps' sums added in warp order;
    x@A in f32 per row with its own adapter; the reduce adds the splits in
    order, then s * (x@A) @ B[ids]."""
    g, m, k = x.shape
    n, r = w.shape[1], a.shape[2]
    rows = g * m
    xr = x.reshape(rows, k)
    aid = ids.long().repeat_interleave(m)
    _, splits, ips, _ = t_lm.grouped_tf32_plan(rows, k, n, sms, r)
    n_iters = -(-k // t_lm.TF32_BK)
    y, xa = torch.zeros(rows, n), torch.zeros(rows, r)
    for sp in range(splits):
        warps = [torch.zeros(rows, n) for _ in range(4)]
        pa = torch.zeros(rows, r)
        for it in range(sp * ips, min((sp + 1) * ips, n_iters)):
            k0 = t_lm.TF32_BK * it
            for j in range(4):
                ks = slice(k0 + 8 * j, min(k0 + 8 * j + 8, k))
                if ks.start < k:
                    warps[j] += _product_rz(xr[:, ks], w[ks])
            ks = slice(k0, k0 + t_lm.TF32_BK)
            pa += torch.einsum("rk,rkj->rj", xr[:, ks], a[aid][:, ks])
        y = y + (((warps[0] + warps[1]) + warps[2]) + warps[3])
        xa = xa + pa
    corr = torch.einsum("rj,rjn->rn", xa, b[aid])
    return (y + scale * corr).reshape(g, m, n)


def _emulate_flash(q, k, v, *, causal=True, window=0, split="rz",
                   n_products=3):
    """``flash_attention_tf32_kernel`` on (B, H, S, D) tensors: 64 keys a
    step, warp w taking keys [16 w, 16 w + 16) of each with its own online
    softmax in base 2 (masked scores -1e30), the four warps' (m, l, O)
    merged at the end, l clamped at 1e-20. Tiles the kernel skips change
    nothing: a wholly masked group leaves a warp's sums as they were, or is
    dropped at the merge (its weight 2^(-1e30 - m) = 0)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kf = k.repeat_interleave(hq // hkv, dim=1)
    vf = v.repeat_interleave(hq // hkv, dim=1)
    c = 1.4426950408889634 / math.sqrt(d)

    def prod(x, y):
        if n_products == 1:
            return _rz(x) @ _rz(y)
        return _prod3(x, y, split)

    qi = torch.arange(sq)[:, None]
    m = torch.full((4, b, hq, sq), -1e30)
    l = torch.zeros((4, b, hq, sq))
    o = torch.zeros((4, b, hq, sq, d))
    for k0 in range(0, skv, 64):
        for w in range(4):
            keys = torch.arange(k0 + 16 * w, k0 + 16 * w + 16)
            ok = keys < skv
            kk = torch.where(ok[:, None], kf[:, :, keys.clamp(max=skv - 1)],
                             torch.zeros(()))
            vv = torch.where(ok[:, None], vf[:, :, keys.clamp(max=skv - 1)],
                             torch.zeros(()))
            s = prod(q, kk.transpose(-1, -2))
            mask = ok[None, :].expand(sq, -1)
            if causal:
                mask = mask & (keys[None, :] <= qi)
            if window:
                mask = mask & (keys[None, :] > qi - window)
            s = torch.where(mask, s * c, torch.full((), -1e30))
            m_new = torch.maximum(m[w], s.amax(-1))
            alpha = torch.exp2(m[w] - m_new)
            p = torch.exp2(s - m_new[..., None])
            l[w] = l[w] * alpha + p.sum(-1)
            o[w] = o[w] * alpha[..., None] + prod(p, vv)
            m[w] = m_new
    m_all = m.amax(0)
    f = torch.exp2(m - m_all)
    lsum = (l * f).sum(0)
    return (o * f[..., None]).sum(0) / lsum.clamp(min=1e-20)[..., None]


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]


@pytest.mark.parametrize("shape", [*LORA_PROBES, (70, 260, 196, 12),
                                   (200, 520, 264, 64), (70, 264, 136, 100),
                                   (37, 520, 264, 200), (16, 7168, 256, 256)])
@pytest.mark.parametrize("split", ["rz", "rna"])
def test_lora_emulation_meets_the_f32_tolerance(shape, split):
    """Truncation (the kernel's split) and rounding (``ssd_scan_tc``'s) both
    meet 2e-4 max|want| at every probe shape, two ragged ones, and ranks
    above 64 (ragged panels; r = 256 over K = 7168)."""
    m, k, n, r = shape
    x, w, a, b = _normal(0, (m, k), (k, n), (k, r), (r, n))
    want = t_lm.lora_matmul_ref(x, w, a, b, 2.0)
    got = _emulate_lora(x, w, a, b, 2.0, split)
    err = (got - want).abs().max().item()
    assert err <= LORA_TOL * want.abs().max().item(), err


@pytest.mark.parametrize("shape", [
    (8, 1, 2048, 2048, 16, 8), (8, 1, 2048, 512, 16, 4),
    (8, 1, 1024, 3072, 16, 8), (8, 1, 3072, 1024, 16, 8),
    (7, 10, 520, 264, 24, 5), (9, 2, 1100, 92, 12, 4), (3, 1, 64, 48, 4, 2),
    (8, 1, 1024, 3072, 128, 8), (15, 1, 264, 136, 100, 4),
    (8, 1, 7168, 896, 256, 4)])
def test_grouped_emulation_meets_the_f32_tolerance(shape):
    """The f32 grouped kernel's arithmetic at decode ticks of llama32-1b's
    and qwen3-0.6b's projections, M > 1, ragged K and N, and ranks above
    64 (r = 256 over K = 7168): within 2e-4 max|want| of the plain
    version."""
    g, m, k, n, r, e = shape
    x, w, a, b = _normal(6, (g, m, k), (k, n), (e, k, r), (e, r, n))
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, e, g))
    want = t_lm.lora_matmul_grouped_ref(x, w, a, b, ids, 2.0)
    got = _emulate_grouped(x, w, a, b, ids, 2.0)
    err = (got - want).abs().max().item()
    assert err <= LORA_TOL * want.abs().max().item(), err


@pytest.mark.parametrize("shape,kw", [
    *((s, {}) for s in FLASH_PROBES),
    ((2, 130, 4, 4, 16), {"window": 64}), ((1, 150, 2, 1, 128), {}),
    ((2, 96, 25, 5, 16), {"window": 64}),
])
def test_flash_emulation_meets_the_f32_tolerance(shape, kw):
    b, s, hq, hkv, d = shape
    q, k, v = _normal(1, (b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))
    want = t_fa.flash_attention_ref(q, k, v, causal=True, **kw)
    got = _emulate_flash(q, k, v, **kw)
    assert (got - want).abs().max().item() <= ATTN_TOL


def test_flash_emulation_non_causal_sq_other_than_skv():
    q, = _normal(2, (2, 4, 70, 32))
    k, v = _normal(3, (2, 2, 150, 32), (2, 2, 150, 32))
    want = t_fa.flash_attention_ref(q, k, v, causal=False)
    got = _emulate_flash(q, k, v, causal=False)
    assert (got - want).abs().max().item() <= ATTN_TOL


def test_one_tf32_product_misses_the_attention_tolerance():
    """Why three products: one tf32 product of each pair (the operands
    truncated to 10 mantissa bits) misses 2e-5 at the calibrate bench."""
    b, s, hq, hkv, d = FLASH_BENCH
    q, k, v = _normal(1, (b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))
    want = t_fa.flash_attention_ref(q, k, v, causal=True)
    got = _emulate_flash(q, k, v, n_products=1)
    assert (got - want).abs().max().item() > ATTN_TOL


# ---------------------------------------------------------------------------
# the plain versions against the JAX package, f32, at the probe shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", LORA_PROBES)
def test_lora_plain_matches_jax_at_the_probe_shapes(shape):
    m, k, n, r = shape
    arrays = _normal(4, (m, k), (k, n), (k, r), (r, n))
    got = t2n(t_lm.lora_matmul(*arrays, 2.0))
    want = j2n(jops.lora_matmul(*(jnp.asarray(t2n(t)) for t in arrays), 2.0))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LORA_TOL * np.abs(want).max())


@pytest.mark.parametrize("shape", [(8, 1, 256, 128, 4, 8),
                                   (8, 1, 512, 256, 4, 2)])
def test_grouped_plain_matches_jax_at_the_reduced_serve_shapes(shape):
    """f32 ``lora_matmul_grouped`` at decode ticks of the reduced qwen3-0.6b
    (r = 4, eight adapters; its q and down projections), against the JAX
    package's Pallas kernel in interpret mode."""
    g, m, k, n, r, e = shape
    arrays = _normal(7, (g, m, k), (k, n), (e, k, r), (e, r, n))
    ids = np.arange(g, dtype=np.int32) % e
    got = t2n(t_lm.lora_matmul_grouped(*arrays, torch.from_numpy(ids), 2.0))
    want = j2n(jops.lora_matmul_grouped(
        *(jnp.asarray(t2n(t)) for t in arrays), jnp.asarray(ids), 2.0))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LORA_TOL * np.abs(want).max())


@pytest.mark.parametrize("shape", FLASH_PROBES)
def test_flash_plain_matches_jax_at_the_probe_shapes(shape):
    """The probes' (B, S, H, D) layout through both packages' ops."""
    b, s, hq, hkv, d = shape
    q, k, v = _normal(5, (b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))
    from repro_torch.kernels import ops as tops
    got = t2n(tops.flash_attention(q, k, v, causal=True))
    want = j2n(jops.flash_attention(*(jnp.asarray(t2n(t)) for t in (q, k, v)),
                                    causal=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATTN_TOL)
