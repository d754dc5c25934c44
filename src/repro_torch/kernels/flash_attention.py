"""Flash attention: online softmax over KV tiles, causal and sliding-window
masks, grouped-query heads.

Replaces: the Pallas TPU kernel ``flash_attention`` of
``src/repro/kernels/flash_attention.py``. CUDA sources (built and bound by
``_build``): ``csrc/flash_attention_ws.cu`` (bf16 at head dims in
``WS_HEAD_DIMS``: a warp-specialised persistent kernel, TMA producer and two
ping-pong ``wgmma`` consumers), ``csrc/flash_attention_tc.cu`` (bf16 at head
dims 16 and 32, ``wgmma``), ``csrc/flash_attention_tf32.cu`` (f32 on the
tensor cores, ``mma.sync``, every product as three tf32 products) and
``csrc/flash_attention.cu`` (the SIMT kernel: the other head dims, and the
calls whose pointers or strides do not allow 16-byte copies).
``flash_attention_version`` names the one a call takes, by dtype, head dim
and alignment alone (never by failure).

Head dims, one rule, each dtype's set in one constant: bf16 takes the
tensor cores at ``BF16_HEAD_DIMS`` (every multiple of 8 from 8 to 256:
``"wgmma_ws"``, but ``"wgmma"`` at 16 and 32), f32 at ``F32_HEAD_DIMS``
(16, 32, 64 and every multiple of 8 from 72 to 128: ``"tf32x3"``). A head
dim off an instantiation runs the narrowest one that holds it with the
true head dim at run time (columns past it are zeros on the way in and are
not stored), and does D/d of the products the head dim needs: the
``"wgmma_ws"`` kernel is built for D = 64, 128, 192 and 256
(``ws_instance``), the ``"tf32x3"`` kernel's D = 128 takes 72 to 120. The
SIMT kernel takes every head dim up to ``MAX_HEAD_DIM`` (256), compiled
for padded widths 16, 32, 64, 128 and 256 with the tail columns masked. A
larger head dim raises. The scale is always 1/sqrt of the true head dim.

Bound on this card: a causal prefill on (4, 1024) tokens does ~1000 (head
dim 64) to ~4000 (head dim 256) FLOP per byte it must move, so it is bound
by operations; the (Sq, Skv) score matrix never reaches device memory, K
and V are read through ``kv_head = q_head // group`` instead of a copy
broadcast over the group, and the tensors are addressed through their
strides, so the model's (batch, seq, head, dim) layout is used in place.
The ``"wgmma_ws"`` kernel keeps the tensor cores busy during the softmax:
one warpgroup only copies (TMA, a ring of K/V stages under mbarriers), two
consumer warpgroups take turns at the tensor cores (one's softmax runs
while the other's products do), and one block per SM walks the work items
heaviest first (``ws_qtile_order``, ``ws_items``, ``ws_block_items``;
K/V tiles of ``ws_keys(d)`` keys).

Positions are ``0..S-1`` on both sides, masked scores are ``-1e30``, and the
softmax denominator is clamped at ``1e-20``, as in the TPU kernel.

The wrapper launches the kernel for a CUDA tensor, or raises; it uses the
plain version only for a CPU tensor. ``flash_attention.launches`` counts,
``flash_attention.by_version`` splits the count by version.
"""
from __future__ import annotations

import functools
import math
from typing import List, Tuple

import torch

from repro_torch.kernels import _build, refuse_autograd

_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256          # the SIMT kernel's widest head dim
# head dims of the tensor-core versions (TMA- or 16-byte-aligned calls):
# bf16 "wgmma_ws" and, at WGMMA_HEAD_DIMS, "wgmma"; f32 "tf32x3"
BF16_HEAD_DIMS = tuple(range(8, MAX_HEAD_DIM + 1, 8))
F32_HEAD_DIMS = (16, 32, 64) + tuple(range(72, 129, 8))
WGMMA_HEAD_DIMS = (16, 32)
WS_HEAD_DIMS = tuple(d for d in BF16_HEAD_DIMS if d not in WGMMA_HEAD_DIMS)
NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version. q: (..., Hq, Sq, D); k, v: (..., Hkv, Skv, D) with
    ``Hq`` a multiple of ``Hkv``; positions = arange. Scores, softmax and
    the weighted sum are f32; the result is cast to q.dtype."""
    f32 = torch.float32
    hq, sq, d = q.shape[-3:]
    hkv, skv = k.shape[-3], k.shape[-2]
    group = hq // hkv
    kf = k.to(f32).repeat_interleave(group, dim=-3)
    vf = v.to(f32).repeat_interleave(group, dim=-3)
    s = torch.matmul(q.to(f32), kf.transpose(-1, -2)) / math.sqrt(float(d))
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vf).to(q.dtype)


def flash_attention_version(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """The kernel a CUDA call takes. With every pointer 16-byte aligned and
    every stride a whole number of 16-byte steps (``aligned``): bf16 at
    ``BF16_HEAD_DIMS`` ``"wgmma_ws"`` (``csrc/flash_attention_ws.cu``),
    but ``"wgmma"`` (``csrc/flash_attention_tc.cu``) at
    ``WGMMA_HEAD_DIMS``; f32 at ``F32_HEAD_DIMS`` ``"tf32x3"``
    (``csrc/flash_attention_tf32.cu``). Otherwise ``"simt"``
    (``csrc/flash_attention.cu``, head dims up to ``MAX_HEAD_DIM``)."""
    if aligned:
        if dtype == torch.bfloat16 and d in BF16_HEAD_DIMS:
            return "wgmma" if d in WGMMA_HEAD_DIMS else "wgmma_ws"
        if dtype == torch.float32 and d in F32_HEAD_DIMS:
            return "tf32x3"
    return "simt"


def sixteen_byte_steps(*tensors: torch.Tensor) -> bool:
    """``aligned`` of ``flash_attention_version`` for 4-D (batch, head, seq,
    dim) tensors: every pointer 16-byte aligned and every stride of the
    first three dims a whole number of 16 bytes (the last dim is
    contiguous), so that the tensor-core kernels' 16-byte copies can read
    every row."""
    return all(t.data_ptr() % 16 == 0
               and all(st * t.element_size() % 16 == 0
                       for st in t.stride()[:3]) for t in tensors)


TF32_QUERIES = 16           # queries a block of the f32 tensor-core kernel


def tf32_grid(b: int, hq: int, sq: int) -> Tuple[int, int]:
    """Grid of the f32 tensor-core kernel: ``(b * hq, ceil(sq / 16))``,
    one block per 16 queries of one head (four warps that split the
    keys)."""
    return b * hq, -(-sq // TF32_QUERIES)


def tf32_block(bx: int, by: int, hq: int, sq: int) -> Tuple[int, int, range]:
    """What block ``(bx, by)`` of the f32 tensor-core kernel computes, as the
    kernel decodes it: ``(batch, head, query rows)``; heads vary fastest,
    and the last query tiles (the heaviest under a causal mask) come first."""
    n_tiles = -(-sq // TF32_QUERIES)
    q0 = (n_tiles - 1 - by) * TF32_QUERIES
    return bx // hq, bx % hq, range(q0, min(q0 + TF32_QUERIES, sq))


WS_QUERIES = 128            # queries of a work item of the "wgmma_ws" kernel
WS_INSTANCES = (64, 128, 192, 256)   # the head dims it is built for


def ws_instance(d: int) -> int:
    """The instantiation of the ``"wgmma_ws"`` kernel that head dim ``d``
    runs: the narrowest of ``WS_INSTANCES`` that holds it."""
    return next(w for w in WS_INSTANCES if d <= w)


def ws_keys(d: int) -> int:
    """Keys of the ``"wgmma_ws"`` kernel's K / V tiles at head dim ``d``:
    128 on the D = 64 and 128 instantiations, 64 on D = 192 and 256 (whose
    tiles of 128 keys would not fit a block's shared memory beside Q)."""
    return 128 if ws_instance(d) <= 128 else 64


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def ws_tiles(qt: int, sq: int, skv: int, causal: bool, window: int,
             keys: int) -> range:
    """The KV tiles (of ``keys`` keys: ``ws_keys``) that query tile ``qt``
    (of ``WS_QUERIES`` queries) of the ``"wgmma_ws"`` kernel visits: those
    with at least one key that a query of the tile may see."""
    nkb = -(-skv // keys)
    begin = 0
    if window:
        first = qt * WS_QUERIES - window + 1     # the first query's first key
        begin = nkb if first >= skv else max(0, first) // keys
    last = min((qt + 1) * WS_QUERIES, sq) - 1    # the tile's last query
    end = min(nkb, last // keys + 1) if causal else nkb
    return range(begin, max(begin, end))


def ws_qtile_order(sq: int, skv: int, causal: bool, window: int,
                   keys: int) -> List[int]:
    """The query tiles in the order the ``"wgmma_ws"`` kernel takes them,
    heaviest (most KV tiles of ``keys`` keys) first, as the kernel computes
    it: the weight rises strictly up to a peak tile and never rises after
    it, and the order merges tiles peak, peak-1, ..., 0 with tiles peak+1,
    ..., the first list winning ties."""
    nqt = -(-sq // WS_QUERIES)
    w = [len(ws_tiles(t, sq, skv, causal, window, keys)) for t in range(nqt)]
    peak = 0
    while peak + 1 < nqt and w[peak + 1] > w[peak]:
        peak += 1
    rising, rest = list(range(peak, -1, -1)), list(range(peak + 1, nqt))
    order = []
    a = c = 0
    while a < len(rising) or c < len(rest):
        if a < len(rising) and (c == len(rest) or w[rising[a]] >= w[rest[c]]):
            order.append(rising[a])
            a += 1
        else:
            order.append(rest[c])
            c += 1
    return order


def ws_items(b: int, hq: int, sq: int, skv: int, causal: bool, window: int,
             keys: int) -> List[Tuple[int, int, int]]:
    """The work items ``(batch, head, query tile)`` of the ``"wgmma_ws"``
    kernel in the order it takes them: query tiles by ``ws_qtile_order``,
    then batch, then head (fastest, so the heads of a GQA group, which
    share their K and V tiles, run side by side). ``ws_block_items`` says
    which of them each block of the persistent grid takes."""
    return [(bi, h, qt)
            for qt in ws_qtile_order(sq, skv, causal, window, keys)
            for bi in range(b) for h in range(hq)]


def ws_block_items(n_items: int, blocks: int, block: int) -> List[int]:
    """The indices (into ``ws_items``) of the work items that block
    ``block`` of a persistent grid of ``blocks`` takes, in its order: one
    item a round of ``blocks`` items, counted from the front of the round
    in even rounds and from its back in odd ones, so that a block that took
    one of the heaviest items of a round takes one of the lightest of the
    next."""
    out = []
    for r in range(-(-n_items // blocks)):
        item = r * blocks + (blocks - 1 - block if r % 2 else block)
        if item < n_items:
            out.append(item)
    return out


def ws_blocks(n_items: int, sms: int) -> int:
    """The persistent grid of the ``"wgmma_ws"`` kernel: one block an SM,
    never more blocks than work items."""
    return max(1, min(n_items, sms))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, D) or (BH, Sq, D); k, v: (B, Hkv, Skv, D) or
    (BHkv, Skv, D). Query head ``h`` reads kv head ``h // (Hq // Hkv)``.

    The first three dims may be strided views (e.g. a permuted
    (B, S, H, D) tensor); the last dim must be contiguous. The output has
    q's shape and strides. float32 or bfloat16; any head dim up to
    ``MAX_HEAD_DIM`` (the plain version on the CPU takes any).
    """
    refuse_autograd("flash_attention", q, k, v)
    if q.ndim not in (3, 4) or k.ndim != q.ndim or v.ndim != q.ndim:
        raise ValueError("flash_attention takes 3-D or 4-D q, k, v alike")
    squeeze = q.ndim == 3
    if squeeze:
        q, k, v = q[None], k[None], v[None]
    bsz, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape != (bsz, hkv, skv, d) or v.shape != k.shape or hq % hkv:
        raise ValueError(
            f"shapes do not agree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes q, k, v all float32 or all "
                        f"bfloat16, not {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    window = int(window)
    if window < 0:
        raise ValueError("window must be >= 0")

    if q.device.type == "cpu":
        out = flash_attention_ref(q, k, v, causal=causal, window=window)
        return out[0] if squeeze else out
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention has no kernel for {q.device}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernels take at most "
                         f"{MAX_HEAD_DIM}")
    if 0 in (bsz, hq, sq, skv):
        raise ValueError("flash_attention takes no empty q, k or v")
    # a contiguous last dim, and no stride 0 across a dim of several rows
    # (TMA takes none)
    q, k, v = (t if t.stride(-1) == 1 and all(
        st or n == 1 for st, n in zip(t.stride(), t.shape)) else t.contiguous()
        for t in (q, k, v))
    out = torch.empty_like(q)          # keeps q's strides when q is dense
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    version = flash_attention_version(q.dtype, d,
                                      sixteen_byte_steps(q, k, v, out))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if version == "wgmma_ws":
            blocks = ws_blocks(bsz * hq * -(-sq // WS_QUERIES),
                               sm_count(q.device.index))
            code = _build.load("flash_attention_ws").flash_attention_ws_launch(
                *ptrs, bsz, hq, hkv, sq, skv, d, *strides, int(bool(causal)),
                window, blocks, stream)
        elif version == "wgmma":
            code = _build.load("flash_attention_tc").flash_attention_tc_launch(
                *ptrs, bsz, hq, hkv, sq, skv, d, *strides, int(bool(causal)),
                window, stream)
        elif version == "tf32x3":
            code = _build.load(
                "flash_attention_tf32").flash_attention_tf32_launch(
                *ptrs, bsz, hq, hkv, sq, skv, d, *strides, int(bool(causal)),
                window, stream)
        else:
            code = _build.load("flash_attention").flash_attention_launch(
                *ptrs, bsz, hq, hkv, sq, skv, d, *strides, int(bool(causal)),
                window, int(q.dtype == torch.bfloat16), stream)
    _build.check(code, f"flash_attention ({version})")
    flash_attention.launches += 1
    flash_attention.by_version[version] += 1
    return out[0] if squeeze else out


flash_attention.launches = 0
flash_attention.by_version = {"wgmma_ws": 0, "wgmma": 0, "tf32x3": 0,
                              "simt": 0}
