"""The pure-Python choices around the tensor-core SSD intra-chunk kernel, on
the CPU: which version of ``ssd_intra_chunk`` a CUDA call takes (by shape and
alignment), how the tensor-core kernel's grid covers the work
(``ssd_plan`` / ``ssd_tile``), and why it multiplies in three tf32 products:
an emulation of its arithmetic, tile by tile as its blocks run, agrees with
the JAX Pallas kernel (interpret mode) within the 1e-4 tolerance at one
full-width chunk of mamba2-370m, where a single tf32 product does not.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import j2n
from repro.kernels.ssd_scan import ssd_intra_chunk as j_intra
from repro_torch.kernels import launch_counts
from repro_torch.kernels import ssd_scan as t_ssd

SSD_TOL = 1e-4                 # chip_smoke.SSD_TOL, the reference tests' own
MAMBA = (4, 2, 256, 32, 64, 128)    # b, nc, cl, nh, hp, ns: mamba2-370m
HYMBA = (4, 4, 128, 50, 64, 16)     # hymba-1.5b (d_inner 3200 = 50 x 64)


@pytest.mark.parametrize("cl,hp,ns,aligned,want", [
    (256, 64, 128, True, "tc"),     # mamba2-370m
    (128, 64, 16, True, "tc"),      # hymba-1.5b
    (32, 32, 16, True, "tc"),       # the calibrate ladder: cl 32, 64, 128,
    (64, 32, 16, True, "tc"),       # hp 32 and 64, ns 16 and 64
    (128, 64, 64, True, "tc"),
    (16, 8, 12, True, "tc"),        # ragged tiles, whole 16-byte copies
    (100, 16, 24, True, "tc"),
    (130, 128, 72, True, "tc"),
    (256, 64, 128, False, "simt"),  # xt, B or C off 16 bytes
    (130, 128, 70, True, "simt"),   # ns not whole 16-byte copies
    (64, 6, 16, True, "simt"),      # hp not whole 16-byte copies
    (257, 64, 128, True, "simt"),   # a chunk longer than 256 rows
    (512, 64, 128, True, "simt"),
])
def test_ssd_intra_chunk_version(cl, hp, ns, aligned, want):
    assert t_ssd.ssd_intra_chunk_version(cl, hp, ns, aligned) == want


@pytest.mark.parametrize("shape", [
    MAMBA, HYMBA, (1, 4, 32, 4, 32, 16), (1, 4, 64, 4, 32, 16),
    (1, 4, 128, 4, 64, 64), (2, 3, 16, 2, 8, 12), (1, 2, 100, 3, 16, 24),
    (2, 2, 130, 2, 128, 72), (3, 1, 256, 7, 32, 200), (1, 1, 64, 50, 64, 16),
])
@pytest.mark.parametrize("sms", [132, 114, 1])
def test_ssd_plan_covers_every_tile_once(shape, sms):
    """Every (batch * chunk, head, y row tile) and every (batch * chunk,
    head, state row tile) is computed by exactly one block, the ragged last
    head group included."""
    b, nc, cl, nh, hp, ns = shape
    plan = t_ssd.ssd_plan(*shape, sms)
    assert plan.heads in t_ssd.HEAD_GROUPS and plan.rows == 64
    assert plan.heads <= t_ssd.max_heads(hp)
    assert plan.blocks == (b * nc * plan.groups
                           * (plan.y_tiles + plan.state_tiles))
    seen = {}
    for block in range(plan.blocks):
        bc, group, kind, tile = t_ssd.ssd_tile(plan, block)
        heads = range(group * plan.heads, min(nh, (group + 1) * plan.heads))
        assert len(heads) >= 1
        for h in heads:
            key = (bc, h, kind, tile)
            assert key not in seen, key
            seen[key] = block
    want = {(bc, h, "y", i) for bc in range(b * nc) for h in range(nh)
            for i in range(-(-cl // 64))}
    want |= {(bc, h, "state", n) for bc in range(b * nc) for h in range(nh)
             for n in range(-(-ns // 64))}
    assert set(seen) == want


@pytest.mark.parametrize("shape", [MAMBA, HYMBA])
@pytest.mark.parametrize("sms", [132, 114])
def test_ssd_plan_fills_the_card_at_full_width(shape, sms):
    """Several blocks per SM at both full widths, and C.B^T shared by at
    least two heads per block there (the point of the plan)."""
    plan = t_ssd.ssd_plan(*shape, sms)
    assert plan.blocks >= 132 and plan.blocks >= t_ssd.WAVES * sms
    assert plan.heads >= 2


def test_ssd_plan_head_groups_at_full_width():
    assert t_ssd.ssd_plan(*MAMBA, 132) == (2, 64, 16, 4, 2, 768)
    assert t_ssd.ssd_plan(*HYMBA, 132) == (2, 64, 25, 2, 1, 1200)
    assert t_ssd.ssd_plan(1, 4, 32, 4, 32, 16, 132).heads == 1   # the ladder


def test_cpu_call_counts_no_version():
    b, nc, cl, nh, hp, ns = 1, 1, 16, 2, 8, 12
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((b, nc, cl, nh, hp), (b, nc, cl, nh), (b, nc, cl, ns),
                      (b, nc, cl, ns))]
    before = (launch_counts()["ssd_intra_chunk"],
              dict(t_ssd.ssd_intra_chunk.by_version))
    t_ssd.ssd_intra_chunk(*args)
    assert (launch_counts()["ssd_intra_chunk"],
            t_ssd.ssd_intra_chunk.by_version) == before


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated
# ---------------------------------------------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to tf32 (10 mantissa bits) to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32``: add half of the dropped range, then mask."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(x: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """x @ w as the tensor cores do it with tf32 operands and f32 sums:
    n = 3 is hi.hi + hi.lo + lo.hi, n = 1 hi.hi alone."""
    xh, wh = _tf32(x), _tf32(w)
    if n == 1:
        return xh @ wh
    xl, wl = _tf32(x - xh), _tf32(w - wh)
    return xl @ wh + xh @ wl + xh @ wh


def _emulate(xt, a, B, C, n_products, sms=132):
    """The tensor-core kernel's arithmetic for every block of its plan. A y
    block of row tile i (rows i0..) walks the j tiles up to its diagonal:
    the scores S = C_i B_j^T once for the group's heads; per head, off the
    diagonal and where a <= 0 on the chunk, S times xt_j scaled by
    exp(ref - cum_j), ref = cum[i0 - 1], the sum scaled by exp(cum_i - ref)
    before the diagonal tile; the diagonal tile (and every tile where cum
    rises) in the segment form exp(cum_i - cum_j) where j <= i. A state
    block multiplies B^T by xt scaled by exp(cum_last - cum_j). Each product
    as ``_product``; cum summed in f64 as the kernel does."""
    b, nc, cl, nh, hp = xt.shape
    ns = B.shape[-1]
    plan = t_ssd.ssd_plan(b, nc, cl, nh, hp, ns, sms)
    clp = plan.y_tiles * 64
    pad = clp - cl
    xt_p = torch.nn.functional.pad(xt, (0, 0, 0, 0, 0, pad))
    a_p = torch.nn.functional.pad(a, (0, 0, 0, pad))
    B_p = torch.nn.functional.pad(B, (0, 0, 0, pad))
    C_p = torch.nn.functional.pad(C, (0, 0, 0, pad))
    cum = torch.cumsum(a_p.double(), dim=2)        # rows past cl: cum_last
    mono = (a_p <= 0).all(dim=2)                   # (b, nc, nh)
    y = torch.zeros_like(xt_p)
    st = torch.zeros((b, nc, nh, ns, hp))
    zero = torch.zeros(())
    for block in range(plan.blocks):
        bc, group, kind, tile = t_ssd.ssd_tile(plan, block)
        bi, ci = divmod(bc, nc)
        heads = range(group * plan.heads, min(nh, (group + 1) * plan.heads))
        if kind == "y":
            rows = slice(64 * tile, 64 * tile + 64)
            ii = torch.arange(64 * tile, 64 * tile + 64)[:, None]
            for jt in range(tile + 1):
                cols = slice(64 * jt, 64 * jt + 64)
                jj = torch.arange(64 * jt, 64 * jt + 64)[None, :]
                S = _product(C_p[bi, ci, rows], B_p[bi, ci, cols].T,
                             n_products)
                for h in heads:
                    ch = cum[bi, ci, :, h]
                    x = xt_p[bi, ci, cols, h]
                    acc = y[bi, ci, rows, h]
                    fac = bool(mono[bi, ci, h]) and tile > 0
                    if fac and jt < tile:
                        u = torch.exp(ch[64 * tile - 1] - ch[cols]).float()
                        acc += _product(S, u[:, None] * x, n_products)
                        continue
                    if fac:                     # the diagonal tile
                        v = torch.exp(ch[rows] - ch[64 * tile - 1]).float()
                        acc *= v[:, None]
                    seg = (ch[rows][:, None] - ch[cols][None, :]).float()
                    P = torch.where(jj <= ii, S * torch.exp(seg), zero)
                    acc += _product(P, x, n_products)
        else:
            cols = slice(64 * tile, min(ns, 64 * tile + 64))
            for h in heads:
                ch = cum[bi, ci, :, h]
                w = torch.exp(ch[-1] - ch).float()
                st[bi, ci, h, cols] = _product(
                    B_p[bi, ci, :, cols].T, w[:, None] * xt_p[bi, ci, :, h],
                    n_products)
    cum = cum.float()
    dec = torch.stack([torch.exp(cum), torch.exp(cum[:, :, -1:]).expand_as(cum)],
                      dim=-1)
    return y[:, :, :cl], st, dec[:, :, :cl]


def _inputs(seed, b, nc, cl, nh, hp, ns, steep=False, rising=False):
    """chip_smoke.ssd_inputs: scaled normals, a <= 0 (steeper with
    ``steep``; of either sign with ``rising``), as numpy f32."""
    rng = np.random.default_rng(seed)
    xt = rng.standard_normal((b, nc, cl, nh, hp)) * 0.2
    a = -np.abs(rng.standard_normal((b, nc, cl, nh))) * (2.0 if steep else 0.1)
    if rising:
        a = rng.standard_normal((b, nc, cl, nh)) * 0.05
    B = rng.standard_normal((b, nc, cl, ns)) * 0.3
    C = rng.standard_normal((b, nc, cl, ns)) * 0.3
    return [x.astype(np.float32) for x in (xt, a, B, C)]


@pytest.fixture(scope="module")
def full_width_chunk():
    """One chunk of mamba2-370m at full width (cl 256, 32 heads of 64, ns
    128), and the JAX Pallas kernel's outputs on it (interpret mode)."""
    arrays = _inputs(11, 1, 1, 256, 32, 64, 128)
    want = j_intra(*(jnp.asarray(x) for x in arrays), interpret=True)
    return [torch.from_numpy(x) for x in arrays], [j2n(w) for w in want]


def _max_err(got, want):
    return [float(np.abs(g.numpy() - w).max()) for g, w in zip(got, want)]


def test_three_tf32_products_meet_the_tolerance(full_width_chunk):
    args, want = full_width_chunk
    errs = _max_err(_emulate(*args, n_products=3), want)
    assert max(errs) <= SSD_TOL, errs


def test_one_tf32_product_misses_the_tolerance(full_width_chunk):
    """Why three products: a single tf32 product (one rounding of each
    operand to 10 mantissa bits) misses 1e-4 on y at this chunk."""
    args, want = full_width_chunk
    errs = _max_err(_emulate(*args, n_products=1), want)
    assert errs[0] > SSD_TOL, errs


@pytest.mark.parametrize("shape,kind", [
    ((1, 2, 100, 3, 16, 24), ""),        # ragged cl and ns, one head a group
    ((1, 2, 128, 10, 16, 16), ""),       # hymba-like: a ragged head group
    ((1, 1, 256, 2, 8, 8), "steep"),     # steep decay: exp(cum) underflows
    ((1, 1, 256, 3, 16, 24), "rising"),  # a > 0 somewhere: cum rises
])
def test_emulation_matches_the_plain_version(shape, kind):
    """The emulated kernel, every block of its plan, against the port's
    plain version at ragged shapes, under steep decay and where cum
    rises."""
    args = [torch.from_numpy(x) for x in _inputs(
        12, *shape, steep=kind == "steep", rising=kind == "rising")]
    got = _emulate(*args, n_products=3, sms=1)
    want = t_ssd.ssd_intra_chunk_ref(*args)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= SSD_TOL
