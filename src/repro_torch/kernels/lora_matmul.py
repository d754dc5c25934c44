"""Fused LoRA products: ``Y = X @ W + s * (X @ A) @ B`` for one adapter
(``lora_matmul``) and for a bank of adapters picked per request
(``lora_matmul_grouped``).

Replaces: the Pallas TPU kernels ``lora_matmul`` and ``lora_matmul_grouped``
of ``src/repro/kernels/lora_matmul.py``. CUDA sources (built and bound by
``_build``): ``csrc/lora_matmul_tc.cu`` (``lora_matmul`` on the tensor
cores, bf16), ``csrc/lora_matmul_ws.cu`` (``lora_matmul`` on the tensor
cores, bf16, from ``WS_MIN_ROWS`` rows: warp-specialised, persistent,
clusters of two sharing W), ``csrc/lora_matmul_tf32.cu`` (``lora_matmul``
on the tensor cores, f32 as three tf32 products),
``csrc/lora_matmul_grouped_tc.cu``
(``lora_matmul_grouped`` on the tensor cores, bf16),
``csrc/lora_matmul_grouped_tf32.cu`` (``lora_matmul_grouped`` on the tensor
cores, f32 as three tf32 products) and ``csrc/lora_matmul.cu`` (the SIMT
kernels of both, for the shapes the tensor-core kernels do not take).

Bound on this card: at the serving shapes (64 rows of a prefill chunk, one
row per request in a decode tick) both are bound by bytes, those of ``W``
(and, at ranks above 64 in a tick, of each row's ``A``); over a long
prompt's chunk (hundreds to thousands of rows) ``lora_matmul`` is bound by
operations. The kernels read ``W`` once per tile of rows, keep ``X @ A``
out of the output's path until its one rounding and add the rank-r
correction before the output is rounded; the grouped kernels read each
request's adapter through ``ids`` from the bank where it lies, so no
gathered copy is made for it.
``lora_matmul_version`` / ``lora_matmul_grouped_version`` name the version
a call takes, by dtype, shape and alignment alone (never by failure):
``"wgmma_ws"`` (``lora_matmul``, bf16, M >= ``WS_MIN_ROWS``, at least
``WS_MIN_STEPS`` tile steps, r <= 64; the schedule by ``ws_plan``, dealt
by ``ws_units``: 128 x 256 tiles, whole waves, then the last wave split
along K); ``"wgmma"`` (bf16; K, N, r
multiples of 8, r <= 256; 16-byte aligned pointers and bank strides; fewer
rows or work, and ranks past 64 at any M) splits K over blocks by
``tc_plan`` /
``grouped_plan`` so that every SM streams W, and takes x@A in 64-rank
panels (``RANK_PANEL``: blocks of their own for ``lora_matmul``, units
dealt over the blocks by ``grouped_xa_units`` for the grouped kernel);
``"tf32x3"`` (f32; K, N, r multiples of 4, r <= 256, 16-byte aligned
pointers and bank strides; every product as three tf32 products) splits K
by ``tf32_plan`` for ``lora_matmul`` (the calibrate path's probes, bound by
operations, start at least one block per SM; above r = 64 the split kernel
is a ``wgmma`` one, the product transposed so that both tf32 operands are
K-major, X@A runs in 64-rank panel blocks of their own, ``tf32_panels``,
and the correction on the tensor cores) and by ``grouped_tf32_plan`` for
``lora_matmul_grouped`` (the decode ticks of an f32 config, bound by the
bytes of W and A; x@A in (row, 64-rank chunk) units dealt over blocks of
their own, ``grouped_tf32_xa_units``); otherwise ``"simt"``. The SIMT
grouped kernel itself has two variants (2-byte and 16-byte loads), which
its launcher picks by alignment.

Ranks: the plain versions take any rank, as the reference does; on the card
every kernel takes r <= 256: bf16 ``"wgmma"`` up to ``WGMMA_MAX_RANK``
(256), f32 ``"tf32x3"`` up to ``TF32_MAX_RANK`` (256), and the SIMT kernels
up to ``SIMT_MAX_RANK`` (256: ``lora_matmul`` holds x@A in registers up to
that rank and meets B in chunks of 64 of it, the grouped kernel reduces
x@A over 256 / r thread groups), so ranks off a multiple of 8 (bf16) or 4
(f32) take ``"simt"``; a larger rank raises on the card.

Rounding order (kernel and plain version alike; it follows the reference's
``kernels/ref.py``): ``W``, ``A``, ``B`` are cast to the activation dtype
(once, by the caller, if it wants to avoid the cast per call); every product
accumulates in f32; ``X @ A`` is rounded to the activation dtype before it
meets ``B``; ``X @ W + s * correction`` is rounded once at the end.

The wrappers launch the kernel for a CUDA tensor, or raise; they use the
plain version only for a CPU tensor. ``<wrapper>.launches`` counts launches
(one per call, however many CUDA kernels the call enqueues), and
``<wrapper>.by_version`` splits them by version.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, refuse_autograd

_DTYPES = (torch.float32, torch.bfloat16)
WGMMA_MAX_RANK = 256        # the bf16 tensor-core versions' largest rank
TF32_MAX_RANK = 256         # the f32 tensor-core versions' largest rank
SIMT_MAX_RANK = 256         # the SIMT kernels' largest rank
RANK_PANEL = 64             # ranks of one x@A panel (unit) above r = 64
TC_BK = 64                  # K depth of one step of the tensor-core kernel
TF32_BK = 32                # K depth of one step of the f32 tensor-core kernel
TF32_TILE = 64              # its output tiles: 64 x 64
TF32_GROUPED_BN = 64        # columns of W a block of the f32 grouped kernel
TF32_XA_COLS = 32           # its x@A blocks: units x r of x@A, r <= 32
TF32_GROUPED_STEPS = 8      # its most K steps a split (256 of K)
WS_MIN_ROWS = 128           # M from which bf16 takes "wgmma_ws" (PERF.md)
WS_MIN_STEPS = 1536         # and its tiles x K steps from (PERF.md)
WS_MAX_RANK = 64            # its largest rank (X@A held in registers)
WS_BM = 128                 # its tiles' rows: two consumers of 64
WS_BN = 256                 # its tiles' columns
WS_GM = 8                   # M tiles of one of its dealing groups


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def lora_matmul_ref(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """x: (M, K); w: (K, N); a: (K, r); b: (r, N) -> (M, N) in x.dtype."""
    f32 = torch.float32
    xf = x.to(f32)
    y = xf @ w.to(x.dtype).to(f32)
    xa = (xf @ a.to(x.dtype).to(f32)).to(x.dtype)
    y = y + scale * (xa.to(f32) @ b.to(x.dtype).to(f32))
    return y.to(x.dtype)


def lora_matmul_grouped_ref(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                            b: torch.Tensor, ids: torch.Tensor,
                            scale: float = 1.0) -> torch.Tensor:
    """x: (G, M, K); w: (K, N); a: (E, K, r); b: (E, r, N); ids: (G,)."""
    f32 = torch.float32
    idx = ids.to(torch.long)
    xf = x.to(f32)
    y = xf @ w.to(x.dtype).to(f32)
    ag = a[idx].to(x.dtype).to(f32)                    # (G, K, r)
    bg = b[idx].to(x.dtype).to(f32)                    # (G, r, N)
    xa = (xf @ ag).to(x.dtype)
    y = y + scale * (xa.to(f32) @ bg)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, x on {like.device}")
    if t.dtype != like.dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, x has {like.dtype}")


def _check_rank(r: int) -> None:
    if not 1 <= r <= SIMT_MAX_RANK:
        raise ValueError(f"rank {r}: the kernels take 1..{SIMT_MAX_RANK}")


def _tc_version(dtype: torch.dtype, k: int, n: int, r: int,
                aligned: bool) -> str:
    """The tensor-core version a dtype, K, N, r and alignment allow (any
    M): ``"wgmma"`` (bf16; K, N, r multiples of 8, r <= 256), ``"tf32x3"``
    (f32; multiples of 4, r <= 256), else ``"simt"``."""
    if aligned:
        if (dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0
                and r % 8 == 0 and r <= WGMMA_MAX_RANK):
            return "wgmma"
        if (dtype == torch.float32 and k % 4 == 0 and n % 4 == 0
                and r % 4 == 0 and r <= TF32_MAX_RANK):
            return "tf32x3"
    return "simt"


def lora_matmul_version(dtype: torch.dtype, m: int, k: int, n: int, r: int,
                        aligned: bool) -> str:
    """The kernel a CUDA call of ``lora_matmul`` on ``m`` rows takes, when
    every pointer is 16-byte aligned: for bf16 with K, N and r multiples of
    8, ``"wgmma_ws"`` (``csrc/lora_matmul_ws.cu``, the warp-specialised
    persistent kernel) where ``m >= WS_MIN_ROWS``, the call holds at
    least ``WS_MIN_STEPS`` steps of work (output tiles of 128 x 256 times
    K steps of 64: less, as qwen2-7b's k / v projections over 1024 rows,
    16 tiles x 56 steps, is split along K so finely that the f32 partials
    and the kernel's fixed costs lose to ``"wgmma"``) and r <=
    ``WS_MAX_RANK`` (64: X@A rides beside X@W in the consumers'
    registers), else ``"wgmma"`` (``csrc/lora_matmul_tc.cu``: fewer rows or
    less work, and ranks 72 to ``WGMMA_MAX_RANK`` (256) at any M);
    ``"tf32x3"``
    (``csrc/lora_matmul_tf32.cu``) for f32 with K, N and r multiples of 4
    and r <= ``TF32_MAX_RANK`` (256) (whole 16-byte copies either way);
    otherwise ``"simt"`` (``csrc/lora_matmul.cu``, r up to
    ``SIMT_MAX_RANK``)."""
    version = _tc_version(dtype, k, n, r, aligned)
    steps = -(-m // WS_BM) * -(-n // WS_BN) * -(-k // TC_BK)
    if (version == "wgmma" and m >= WS_MIN_ROWS and steps >= WS_MIN_STEPS
            and r <= WS_MAX_RANK):
        return "wgmma_ws"
    return version


@functools.lru_cache(maxsize=256)
def tc_plan(m: int, k: int, n: int, sms: int) -> Tuple[int, int, int]:
    """Grid of the tensor-core kernel: ``(bn, splits, iters_per_split)``.

    Output tiles are 64 rows by ``bn`` (128, or 64 where 128 would leave
    SMs idle or N is small) columns; K is cut into ``ceil(k / 64)`` steps,
    dealt to ``splits`` blocks per tile, ``iters_per_split`` consecutive
    steps each, the last split taking the rest (none is empty). The splits
    are as few as give at least ``sms`` blocks, where K is deep enough.
    ``lora_matmul``'s kernel adds ``ceil(r / RANK_PANEL)`` blocks of x@A
    panels per row tile and split after the tiles of W."""
    n_iters = -(-k // TC_BK)
    m_tiles = -(-m // 64)
    plan = (64, 1, n_iters)
    for bn in ((128, 64) if n > 64 else (64,)):
        tiles = -(-n // bn) * m_tiles
        want = -(-sms // tiles)
        ips = max(1, n_iters // want)
        splits = -(-n_iters // ips)
        plan = (bn, splits, ips)
        if tiles * splits >= sms:
            break
    return plan


class WsPlan(NamedTuple):
    """The warp-specialised kernel's schedule (``ws_plan``)."""
    cl: int         # CTAs of a cluster: 2 along M, 1 for a single M tile
    dp: int         # group tiles run whole, in waves of ``slots``
    tail: int       # group tiles after them, each split along K
    splits: int     # K ranges of a tail tile (1: no tail)
    ips: int        # K steps of a range (the last takes the rest)
    blocks: int     # the persistent grid: cl x clusters


@functools.lru_cache(maxsize=256)
def ws_plan(m: int, k: int, n: int, sms: int,
            pairs: Optional[int] = None) -> WsPlan:
    """Grid of the warp-specialised kernel for ``sms`` SMs, of which
    ``pairs`` clusters of two CTAs fit at once (``sms // 2`` unless the
    card says less).

    A group tile is ``cl`` M tiles of 128 rows side by side (a cluster:
    ``cl`` = 2 where M has two tiles or more, each CTA loading half of W's
    slab into both) and one N tile of ``WS_BN`` columns; K is cut into
    ``ceil(k / 64)`` steps. ``slots`` clusters run at once (``pairs``, or
    ``sms`` at ``cl`` = 1). The group tiles of whole waves (``dp``) each run
    all of K; the last, partial wave's ``tail`` tiles (all of them, where
    there are fewer than ``slots``) are each split into ``splits`` K ranges
    of ``ips`` steps, as many as keep the tail's units within one wave
    (``slots // tail``), and a reduce kernel sums their f32 partials; where
    that is one range, the tail runs whole too."""
    pairs = sms // 2 if pairs is None else pairs
    kst = -(-k // TC_BK)
    mt = -(-m // WS_BM)
    cl = 2 if mt >= 2 else 1
    slots = pairs if cl == 2 else sms
    tiles = -(-mt // cl) * -(-n // WS_BN)
    dp = tiles // slots * slots
    tail = tiles - dp
    splits, ips = 1, kst
    if tail:
        ips = -(-kst // max(1, slots // tail))
        splits = -(-kst // ips)
    if splits == 1:
        dp, tail, ips = tiles, 0, kst
    return WsPlan(cl, dp, tail, splits, ips,
                  cl * min(dp + tail * splits, slots))


def ws_tile(m: int, n: int, cl: int, t: int) -> Tuple[int, int]:
    """Group tile ``t``: ``(M group, N tile)``. The tiles go in runs of
    ``WS_GM // cl`` M groups (fewer in the last run), M fastest, so that the
    clusters in flight share W's and X's slabs in L2."""
    run = WS_GM // cl
    groups = -(-(-(-m // WS_BM)) // cl)
    g, within = divmod(t, run * -(-n // WS_BN))
    size = min(groups - g * run, run)
    return g * run + within % size, within // size


def ws_units(m: int, k: int, n: int, sms: int, pairs: Optional[int] = None
             ) -> List[List[Tuple[int, int, int, int, int]]]:
    """Each cluster's work units in the order it runs them, as the kernel
    deals them (cluster ``c`` takes units ``c, c + clusters, ...``): ``(M
    group, N tile, first K step, K steps, split)``, split -1 for a unit of
    all of K. CTA ``i`` of a cluster computes M tile ``cl * group + i``."""
    plan = ws_plan(m, k, n, sms, pairs)
    kst = -(-k // TC_BK)
    clusters = plan.blocks // plan.cl
    units = []
    for u in range(plan.dp + plan.tail * plan.splits):
        if u < plan.dp:
            units.append((*ws_tile(m, n, plan.cl, u), 0, kst, -1))
        else:
            split, tt = divmod(u - plan.dp, plan.tail)
            k0 = split * plan.ips
            units.append((*ws_tile(m, n, plan.cl, plan.dp + tt), k0,
                          min(plan.ips, kst - k0), split))
    return [units[c::clusters] for c in range(clusters)]


_ws_pairs = {}      # device index -> clusters of two the kernel fits at once


def launch_ws(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, y: torch.Tensor, scale: float,
              stream: int) -> int:
    """Enqueue ``csrc/lora_matmul_ws.cu`` on ``stream`` for contiguous,
    aligned bf16 CUDA tensors that ``lora_matmul`` has checked; returns the
    launch's error code."""
    m, k = x.shape
    n, r = w.shape[1], a.shape[1]
    lib = _build.load("lora_matmul_ws")
    dev = x.device.index if x.device.index is not None else \
        torch.cuda.current_device()
    if dev not in _ws_pairs:
        _ws_pairs[dev] = lib.lora_matmul_ws_max_pairs()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = ws_plan(m, k, n, sms, _ws_pairs[dev] or None)
    ws_y = ws_xa = 0
    if plan.tail:
        # f32 partials of the tail's tiles: X@W (splits * tail * cl tiles of
        # 128 x 256), then X@A (as many of 128 x r)
        tiles = plan.splits * plan.tail * plan.cl * WS_BM
        ws = torch.empty(tiles * (WS_BN + r), dtype=torch.float32,
                         device=x.device)
        ws_y = ws.data_ptr()
        ws_xa = ws_y + 4 * tiles * WS_BN
    return lib.lora_matmul_ws_launch(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
        ws_y, ws_xa, m, k, n, r, float(scale), plan.cl, plan.dp, plan.tail,
        plan.splits, plan.ips, plan.blocks, stream)


def tf32_panels(r: int) -> List[Tuple[int, int]]:
    """The X@A panels of the f32 tensor-core kernel, ``(first rank,
    ranks)``, each a block per (M tile, split) after the N tiles: none at
    r <= ``RANK_PANEL`` (X@A rides in the first N tile's blocks), else
    ``ceil(r / 64)`` panels of 64 ranks, the last one ragged."""
    if r <= RANK_PANEL:
        return []
    return [(p, min(RANK_PANEL, r - p)) for p in range(0, r, RANK_PANEL)]


@functools.lru_cache(maxsize=256)
def tf32_plan(m: int, k: int, n: int, sms: int,
              r: int = 16) -> Tuple[int, int]:
    """Grid of the f32 tensor-core kernel: ``(splits, iters_per_split)``.

    Output tiles are 64 x 64, and at r > 64 the ``tf32_panels(r)`` blocks
    of X@A join each M tile's row of them; K is cut into ``ceil(k / 32)``
    steps, dealt to ``splits`` blocks per tile, ``iters_per_split``
    consecutive steps each, the last split taking the rest (none is
    empty). The splits are as few as give at least ``sms`` blocks (at
    r > 64, whose wgmma kernel fits four blocks an SM, ``2 * sms``: measured
    faster on the H100, PERF.md), where K is deep enough."""
    n_iters = -(-k // TF32_BK)
    panels = len(tf32_panels(r))
    tiles = -(-m // TF32_TILE) * (-(-n // TF32_TILE) + panels)
    want = -(-(2 * sms if panels else sms) // tiles)
    ips = max(1, n_iters // want)
    return -(-n_iters // ips), ips


def launch_tf32x3(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, y: torch.Tensor, scale: float,
                  stream: int) -> int:
    """Enqueue ``csrc/lora_matmul_tf32.cu`` on ``stream`` for contiguous,
    aligned f32 CUDA tensors that ``lora_matmul`` has checked; returns the
    launch's error code."""
    m, k = x.shape
    n, r = w.shape[1], a.shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, ips = tf32_plan(m, k, n, sms, r)
    # f32 split-K partials: X@W (splits, m, n), then X@A (splits, m, r),
    # then at r > 64 X@A summed over the splits (m, r)
    ws = torch.empty(splits * m * (n + r) + (m * r if tf32_panels(r) else 0),
                     dtype=torch.float32, device=x.device)
    return _build.load("lora_matmul_tf32").lora_matmul_tf32_launch(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
        ws.data_ptr(), ws.data_ptr() + 4 * splits * m * n, m, k, n, r,
        float(scale), splits, ips, stream)


def lora_matmul_grouped_version(dtype: torch.dtype, k: int, n: int, r: int,
                                aligned: bool) -> str:
    """The kernel a CUDA call of ``lora_matmul_grouped`` takes, by the rule
    of ``lora_matmul_version``, where ``aligned`` also covers the bank
    strides (whole 16-byte steps from one adapter to the next): ``"wgmma"``
    (``csrc/lora_matmul_grouped_tc.cu``) for bf16, ``"tf32x3"``
    (``csrc/lora_matmul_grouped_tf32.cu``) for f32, otherwise ``"simt"``
    (``csrc/lora_matmul.cu``)."""
    return _tc_version(dtype, k, n, r, aligned)


@functools.lru_cache(maxsize=256)
def grouped_plan(rows: int, k: int, n: int, sms: int,
                 r: int = 16) -> Tuple[int, int, int, int]:
    """Grid of the tensor-core grouped kernel: ``(bn, splits,
    iters_per_split, nx)``.

    ``bn``, ``splits`` and ``iters_per_split`` are ``tc_plan``'s for the
    ``rows`` rows (the same stream of W, cut the same way); ``nx`` is the
    number of blocks along N: the ``ceil(n / bn)`` tiles of W, and more
    (blocks that compute x@A only) where a row tile's x@A units would give
    a block more than ``grouped_units_per_block(r)`` of them. Each split's
    units are dealt round-robin over the ``nx`` blocks
    (``grouped_xa_units``)."""
    bn, splits, ips = tc_plan(rows, k, n, sms)
    units = min(rows, 64) * -(-r // RANK_PANEL)
    nx = max(-(-n // bn), -(-units // grouped_units_per_block(r)))
    return bn, splits, ips, nx


def grouped_units_per_block(r: int) -> int:
    """x@A units a block of the tensor-core grouped kernel holds: a unit is
    a row's whole rank where r <= ``RANK_PANEL`` (``RANK_PANEL // r`` of
    them share a block's room of A), else one 64-rank chunk of a row (one
    a block)."""
    return 1 if r > RANK_PANEL else RANK_PANEL // r


def grouped_xa_units(bx: int, rows_in_tile: int, nx: int,
                     r: int) -> List[Tuple[int, int, int]]:
    """The x@A units, ``(row, first rank, ranks)``, of a row tile (at most
    64 rows) that block ``bx`` of each K split computes, as the kernel
    deals them: unit ``u`` (row ``u // chunks``, ranks from ``RANK_PANEL *
    (u % chunks)``, ``chunks = ceil(r / RANK_PANEL)``) to block
    ``u % nx``."""
    chunks = -(-r // RANK_PANEL)
    return [(u // chunks, RANK_PANEL * (u % chunks),
             min(RANK_PANEL, r - RANK_PANEL * (u % chunks)))
            for u in range(bx, rows_in_tile * chunks, nx)]


@functools.lru_cache(maxsize=256)
def grouped_tf32_plan(rows: int, k: int, n: int, sms: int,
                      r: int = 16) -> Tuple[int, int, int, int]:
    """Grid of the f32 tensor-core grouped kernel: ``(rt, splits,
    iters_per_split, nx)``.

    Row tiles are ``rt`` rows (8, 16 or 32: the fewest that hold ``rows``,
    up to 32). Along N run ``nx`` blocks: the ``ceil(n / 64)`` tiles of W,
    then the blocks that compute x@A only, each for at most
    ``grouped_tf32_units_per_block(r)`` of a row tile's x@A units (a row,
    or above r = 64 a 64-rank chunk of one), dealt by
    ``grouped_tf32_xa_units``. K is cut into ``ceil(k / 32)`` steps,
    dealt to ``splits`` blocks per (N block, row tile), ``iters_per_split``
    consecutive steps each, the last split taking the rest (none is empty).
    The splits are the fewest that give at least ``sms`` blocks, where K is
    deep enough, and no split more than ``TF32_GROUPED_STEPS`` steps (a
    block's products run step after step, so a long split is a long block:
    measured on the H100, PERF.md), with the steps spread as evenly as that
    count allows."""
    rt = 8 if rows <= 8 else 16 if rows <= 16 else 32
    n_iters = -(-k // TF32_BK)
    units = min(rows, rt) * -(-r // RANK_PANEL)
    nx = (-(-n // TF32_GROUPED_BN)
          + -(-units // grouped_tf32_units_per_block(r)))
    want = -(-sms // (nx * -(-rows // rt)))
    # the deepest split, up to the cap, that still gives ``want`` splits
    ips = next((i for i in range(min(n_iters, TF32_GROUPED_STEPS), 0, -1)
                if -(-n_iters // i) >= want), 1)
    splits = -(-n_iters // ips)
    return rt, splits, -(-n_iters // splits), nx


def grouped_tf32_units_per_block(r: int) -> int:
    """x@A units an x@A block of the f32 grouped kernel holds: ``32 // r``
    rows where r <= 32 (``TF32_XA_COLS``: they share the block's room of
    A), else one unit (a row's whole rank up to 64, one 64-rank chunk of a
    row above it)."""
    return TF32_XA_COLS // r if r <= TF32_XA_COLS else 1


def grouped_tf32_xa_units(bx: int, rows_in_tile: int, n: int, nx: int,
                          r: int) -> List[Tuple[int, int, int]]:
    """The x@A units, ``(row, first rank, ranks)``, of a row tile that
    block ``bx`` of each K split of the f32 grouped kernel computes, as the
    kernel deals them: none for the first ``ceil(n / 64)`` blocks (the
    tiles of W); unit ``u`` (row ``u // chunks``, ranks from ``RANK_PANEL
    * (u % chunks)``, ``chunks = ceil(r / RANK_PANEL)``) to x@A block
    ``u % nxa`` of the ``nxa`` blocks after them."""
    n_tiles = -(-n // TF32_GROUPED_BN)
    if bx < n_tiles:
        return []
    chunks = -(-r // RANK_PANEL)
    return [(u // chunks, RANK_PANEL * (u % chunks),
             min(RANK_PANEL, r - RANK_PANEL * (u % chunks)))
            for u in range(bx - n_tiles, rows_in_tile * chunks, nx - n_tiles)]


def launch_grouped_tf32x3(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                          b: torch.Tensor, ids: torch.Tensor, y: torch.Tensor,
                          a_stride: int, b_stride: int, scale: float,
                          stream: int) -> int:
    """Enqueue ``csrc/lora_matmul_grouped_tf32.cu`` on ``stream`` for the
    aligned f32 CUDA tensors that ``lora_matmul_grouped`` has checked (x
    (G, M, K) and w contiguous, each adapter of the banks contiguous, ids
    int32); returns the launch's error code."""
    g, m, k = x.shape
    n, r = w.shape[1], a.shape[2]
    rows = g * m
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rt, splits, ips, nx = grouped_tf32_plan(rows, k, n, sms, r)
    # f32 split-K partials: x@W (splits, rows, n), x@A (splits, rows, r)
    ws = torch.empty(splits * rows * (n + r), dtype=torch.float32,
                     device=x.device)
    return _build.load(
        "lora_matmul_grouped_tf32").lora_matmul_grouped_tf32_launch(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        ids.data_ptr(), y.data_ptr(), ws.data_ptr(),
        ws.data_ptr() + 4 * splits * rows * n, rows, m, k, n, r, a_stride,
        b_stride, float(scale), rt, splits, ips, nx, stream)


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """x: (M, K); w: (K, N); a: (K, r); b: (r, N) -> (M, N) in x.dtype.

    Any M, K, N (ragged edges are masked in the kernel); any rank on the
    CPU, r <= 256 on the card; float32 or bfloat16. ``w``,
    ``a``, ``b`` of another float dtype are cast to ``x.dtype`` first."""
    refuse_autograd("lora_matmul", x, w, a, b)
    if x.ndim != 2 or w.ndim != 2 or a.ndim != 2 or b.ndim != 2:
        raise ValueError("lora_matmul takes 2-D x, w, a, b")
    m, k = x.shape
    n = w.shape[1]
    r = a.shape[1]
    if w.shape[0] != k or a.shape[0] != k or b.shape != (r, n):
        raise ValueError(
            f"shapes do not agree: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"a {tuple(a.shape)}, b {tuple(b.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"lora_matmul takes float32 or bfloat16, not {x.dtype}")
    w, a, b = w.to(x.dtype), a.to(x.dtype), b.to(x.dtype)
    for name, t in (("w", w), ("a", a), ("b", b)):
        _check(name, t, x)
    if x.device.type == "cpu":
        return lora_matmul_ref(x, w, a, b, scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"lora_matmul has no kernel for device {x.device}")
    _check_rank(r)
    if m == 0:
        return x.new_empty((0, n))
    x, w, a, b = (t.contiguous() for t in (x, w, a, b))
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    version = lora_matmul_version(
        x.dtype, m, k, n, r,
        all(t.data_ptr() % 16 == 0 for t in (x, w, a, b)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if version == "wgmma":
            sms = torch.cuda.get_device_properties(
                x.device).multi_processor_count
            bn, splits, ips = tc_plan(m, k, n, sms)
            # f32 split-K partials: X@W (splits, m, n), then X@A (splits, m,
            # r), then X@A summed and rounded, (m, r) bf16 (used at r > 64)
            ws = torch.empty(splits * m * (n + r) + m * r // 2,
                             dtype=torch.float32, device=x.device)
            code = _build.load("lora_matmul_tc").lora_matmul_tc_launch(
                x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                y.data_ptr(), ws.data_ptr(), ws.data_ptr() + 4 * splits * m * n,
                m, k, n, r, float(scale), bn, splits, ips, stream)
        elif version == "wgmma_ws":
            code = launch_ws(x, w, a, b, y, scale, stream)
        elif version == "tf32x3":
            code = launch_tf32x3(x, w, a, b, y, scale, stream)
        else:
            code = _build.load("lora_matmul").lora_matmul_launch(
                x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                y.data_ptr(), m, k, n, r, float(scale),
                int(x.dtype == torch.bfloat16), stream)
    _build.check(code, f"lora_matmul ({version})")
    lora_matmul.launches += 1
    lora_matmul.by_version[version] += 1
    return y


lora_matmul.launches = 0
lora_matmul.by_version = {"wgmma_ws": 0, "wgmma": 0, "tf32x3": 0,
                          "simt": 0}


def lora_matmul_grouped(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, ids: torch.Tensor,
                        scale: float = 1.0) -> torch.Tensor:
    """``y[g] = x[g] @ W + s * (x[g] @ A[ids[g]]) @ B[ids[g]]``.

    x: (G, M, K) per-request activations; w: (K, N) shared frozen weight;
    a: (E, K, r), b: (E, r, N) the adapter bank; ids: (G,) int32 adapter of
    each request. Returns (G, M, N) in x.dtype. The bank may be strided
    along its first axis (each adapter's own matrix must be contiguous): the
    kernel offsets the bank pointers by ``ids[g]`` times that stride."""
    refuse_autograd("lora_matmul_grouped", x, w, a, b)
    if x.ndim != 3 or w.ndim != 2 or a.ndim != 3 or b.ndim != 3:
        raise ValueError("lora_matmul_grouped takes x (G,M,K), w (K,N), "
                         "a (E,K,r), b (E,r,N)")
    g, m, k = x.shape
    n = w.shape[1]
    e, _, r = a.shape
    if w.shape[0] != k or a.shape[1] != k or b.shape != (e, r, n) \
            or ids.shape != (g,):
        raise ValueError(
            f"shapes do not agree: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"a {tuple(a.shape)}, b {tuple(b.shape)}, ids {tuple(ids.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(
            f"lora_matmul_grouped takes float32 or bfloat16, not {x.dtype}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be an integer tensor, not {ids.dtype}")
    w, a, b = w.to(x.dtype), a.to(x.dtype), b.to(x.dtype)
    for name, t in (("w", w), ("a", a), ("b", b)):
        _check(name, t, x)
    if ids.device != x.device:
        raise ValueError(f"ids is on {ids.device}, x on {x.device}")
    if x.device.type == "cpu":
        return lora_matmul_grouped_ref(x, w, a, b, ids, scale)
    if x.device.type != "cuda":
        raise RuntimeError(
            f"lora_matmul_grouped has no kernel for device {x.device}")
    _check_rank(r)
    if g * m == 0:
        return x.new_empty((g, m, n))
    x, w = x.contiguous(), w.contiguous()
    if not a[0].is_contiguous():
        a = a.contiguous()
    if not b[0].is_contiguous():
        b = b.contiguous()
    ids = ids.to(torch.int32).contiguous()
    a_stride = a.stride(0) if e > 1 else k * r
    b_stride = b.stride(0) if e > 1 else r * n
    rows = g * m
    y = torch.empty((g, m, n), dtype=x.dtype, device=x.device)
    es = x.element_size()
    version = lora_matmul_grouped_version(
        x.dtype, k, n, r,
        all(t.data_ptr() % 16 == 0 for t in (x, w, a, b))
        and a_stride * es % 16 == 0 and b_stride * es % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if version == "wgmma":
            sms = torch.cuda.get_device_properties(
                x.device).multi_processor_count
            bn, splits, ips, nx = grouped_plan(rows, k, n, sms, r)
            # f32 split-K partials: x@W (splits, rows, n), x@A (splits, rows, r)
            ws = torch.empty(splits * rows * (n + r), dtype=torch.float32,
                             device=x.device)
            code = _build.load(
                "lora_matmul_grouped_tc").lora_matmul_grouped_tc_launch(
                x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                ids.data_ptr(), y.data_ptr(), ws.data_ptr(),
                ws.data_ptr() + 4 * splits * rows * n, rows, m, k, n, r,
                a_stride, b_stride, float(scale), bn, splits, ips, nx, stream)
        elif version == "tf32x3":
            code = launch_grouped_tf32x3(x, w, a, b, ids, y, a_stride,
                                         b_stride, scale, stream)
        else:
            code = _build.load("lora_matmul").lora_matmul_grouped_launch(
                x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                ids.data_ptr(), y.data_ptr(), rows, m, k, n, r, a_stride,
                b_stride, float(scale), int(x.dtype == torch.bfloat16),
                stream)
    _build.check(code, f"lora_matmul_grouped ({version})")
    lora_matmul_grouped.launches += 1
    lora_matmul_grouped.by_version[version] += 1
    return y


lora_matmul_grouped.launches = 0
lora_matmul_grouped.by_version = {"wgmma": 0, "tf32x3": 0, "simt": 0}
