"""Flash decode: one query token per kv-head group attends over a KV cache,
with online softmax and the cache masked by a scalar position ``t``.

Replaces: the Pallas TPU kernel ``flash_decode`` of
``src/repro/kernels/flash_decode.py``. CUDA source: ``csrc/flash_decode.cu``
(built and bound by ``_build``).

Bound on this card: bytes. Each valid K and V row is read once, with
16-byte asynchronous copies into shared memory, and serves the ``G``
queries of its group; a warp scores a tile of slots before it takes one
softmax update per tile (the products on the tensor cores for bf16, on the
CUDA cores for f32, accumulating in f32 either way). The run of
slots that ``t`` can see (``valid_run``) is split over blocks (one block per
(batch, kv head) would leave half of the SMs idle at the serving cache) by
``n_splits``; the pieces of one (batch, kv head) form a thread-block
cluster and are merged by their log-sum-exp through distributed shared
memory, so every call is one launch with no scratch. Masked slots are not
read, so the bytes follow ``t``.

Shapes, as the TPU kernel takes them, up to head dim ``MAX_HEAD_DIM``
(256; a larger one raises): any head dim (the kernel is compiled for a few
padded widths and masks the tail; a row that is not a whole number of
16-byte chunks is padded with zero columns by the wrapper, a copy of q, k
and v), any number of queries a group (16 in one m16 tile for bf16, more in
chunks along the grid's z axis), and ``t`` as a Python int or a 0-d integer
tensor on q's device (as the reference's ``jnp.asarray(t)``), which the
kernel reads through a pointer; the split is then sized from the cache
length, so nothing is read back. A ``(B,)`` ``t`` (a position per row) is
refused, as the reference refuses it.

Masking is the TPU kernel's: a ring buffer iff ``0 < window <= slots``
(slot ``j`` holds position ``t - ((t - j) mod slots)``, valid iff ``>= 0`` and
``> t - window``), else a linear cache (``j <= t``, and ``j > t - window``
when ``window > 0``); masked scores are ``-1e30`` and the denominator is
clamped at ``1e-20``. A query that sees no valid slot at all (``t`` beyond a
linear cache and its window) is outside the contract: the kernel gives zeros
there, the plain version the mean of ``v``.

The wrapper launches the kernel for a CUDA tensor, or raises; it uses the
plain version only for a CPU tensor. ``flash_decode.launches`` counts.
"""
from __future__ import annotations

import math
from typing import Union

import torch

from repro_torch.kernels import _build, refuse_autograd

_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
NEG_INF = -1e30
MAX_SPLITS = 8              # pieces of one (b, h): a portable cluster
WARPS = 4                   # warps per block of the kernel


def valid_slots(t: int, slots: int, window: int, device) -> torch.Tensor:
    """Bool ``(slots,)``: which cache slots position ``t`` attends to."""
    j = torch.arange(slots, device=device)
    if 0 < window <= slots:                        # ring buffer
        abs_pos = t - torch.remainder(t - j, slots)
        return (abs_pos >= 0) & (abs_pos <= t) & (abs_pos > t - window)
    valid = j <= t                                 # linear cache
    if window:
        valid = valid & (j > t - window)
    return valid


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     t: int, *, window: int = 0) -> torch.Tensor:
    """Plain version. q: (..., G, D); k, v: (..., S, D), the leading dims
    alike; ``t`` the query token's position. Masked softmax over the
    cache in f32; the result is cast to q.dtype."""
    f32 = torch.float32
    d = q.shape[-1]
    s = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) / math.sqrt(d)
    valid = valid_slots(t, k.shape[-2], int(window), q.device)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(f32)).to(q.dtype)


def valid_run(t: int, slots: int, window: int) -> int:
    """Length of the run of slots the kernel walks for position ``t``:
    every slot of a ring buffer (its masked slots are skipped inside the
    run); ``[max(0, t - window + 1), min(t, slots - 1)]`` of a linear
    cache (``0`` for ``lo`` when ``window == 0``)."""
    if 0 < window <= slots:
        return slots
    lo = max(0, t - window + 1) if window else 0
    return max(0, min(t, slots - 1) - lo + 1)


def padded_dim(d: int, elem_bytes: int) -> int:
    """The width of the kernel's instantiation that row length ``d`` runs
    (``dispatch_d``): 16, 32, 64, (bf16) 112, 128 or 256."""
    widths = (16, 32, 64, 112, 128, 256) if elem_bytes == 2 else (
        16, 32, 64, 128, 256)
    return next(w for w in widths if d <= w)


def block_slots(d: int, elem_bytes: int, g: int) -> int:
    """Slots one block of the kernel takes in one round: four warps, each a
    tile of 32 slots (bf16, on the tensor cores) or of ``STEPS`` 16-byte
    copies of ``32 / LPR`` rows, a row being ``LPR`` lanes (f32; at most a
    warp); the kernel's constants."""
    if elem_bytes == 2:
        return WARPS * 32
    lanes_per_row = min(32, padded_dim(d, elem_bytes) // (16 // elem_bytes))
    steps = 8 if g <= 4 else 4
    return WARPS * (32 // lanes_per_row) * steps


def n_splits(bh: int, run: int, sms: int, piece: int = 64) -> int:
    """Pieces of the valid run per (batch, kv head): about two blocks per
    SM of the ``sms`` the card has, no piece shorter than 64 slots or than
    ``piece`` (``block_slots``: a block whose warps all find a full tile),
    and at most ``MAX_SPLITS``; one piece for a short run."""
    want = -(-2 * sms // bh)
    return max(1, min(want, -(-run // max(64, piece)), MAX_SPLITS))


def _rows_aligned(x: torch.Tensor) -> bool:
    """Every row (last dim) of ``x`` starts on a 16-byte boundary."""
    es = x.element_size()
    return x.data_ptr() % 16 == 0 and all(st * es % 16 == 0
                                          for st in x.stride()[:3])


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 t: Union[int, torch.Tensor], *,
                 window: int = 0) -> torch.Tensor:
    """q: (B, Hkv, G, D) or (BH, G, D); k, v: (B, Hkv, S, D) or (BH, S, D);
    ``t`` the query token's position: a Python int or a 0-d int32 / int64
    tensor on q's device (the kernel reads it there). Returns q's shape.

    The first dims may be strided views (e.g. a (B, S, Hkv, D) cache
    permuted); the last dim must be contiguous. float32 or bfloat16; any
    head dim up to ``MAX_HEAD_DIM`` on the card (the plain version on the
    CPU takes any); any number of queries per group.
    """
    refuse_autograd("flash_decode", q, k, v)
    if q.ndim not in (3, 4) or k.ndim != q.ndim or v.ndim != q.ndim:
        raise ValueError("flash_decode takes 3-D or 4-D q, k, v alike")
    squeeze = q.ndim == 3
    if squeeze:
        q, k, v = q[None], k[None], v[None]
    bsz, hkv, g, d = q.shape
    s = k.shape[2]
    if k.shape != (bsz, hkv, s, d) or v.shape != k.shape:
        raise ValueError(
            f"shapes do not agree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_decode takes q, k, v all float32 or all "
                        f"bfloat16, not {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    window = int(window)
    if window < 0:
        raise ValueError("window must be >= 0")
    if isinstance(t, torch.Tensor):
        if t.ndim != 0:
            raise ValueError("t is one position, a Python int or a 0-d "
                             f"tensor, not a tensor of shape {tuple(t.shape)}")
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"t must be an int32 or int64 integer, not "
                            f"{t.dtype}")
        if t.device != q.device:
            raise ValueError(f"t is on {t.device}, q on {q.device}")
    else:
        t = int(t)

    if q.device.type == "cpu":
        out = flash_decode_ref(q, k, v, int(t), window=window)
        return out[0] if squeeze else out
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_decode has no kernel for {q.device}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes at most "
                         f"{MAX_HEAD_DIM}")
    if 0 in (bsz, hkv, g, s):
        raise ValueError("flash_decode takes no empty q, k or v")
    scale = 1.0 / math.sqrt(d)                 # the true head dim's
    step = 16 // q.element_size()
    if d % step:
        # rows of whole 16-byte chunks: zero columns, which add nothing to
        # a score, and the output's are dropped
        q, k, v = (torch.nn.functional.pad(x, (0, step - d % step))
                   for x in (q, k, v))
    q = q if q.stride(-1) == 1 else q.contiguous()
    # the kernel reads rows of K and V with 16-byte loads: a view whose rows
    # do not start on 16-byte boundaries is copied to a fresh tensor first
    k, v = (x if x.stride(-1) == 1 and _rows_aligned(x)
            else torch.empty(x.shape, dtype=x.dtype, device=x.device).copy_(x)
            for x in (k, v))
    dp = q.shape[-1]
    # a tensor t is read by the kernel as it lies; the split is then sized
    # for the longest run
    t_dev = t if isinstance(t, torch.Tensor) else None
    run = s if t_dev is not None else valid_run(t, s, window)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit = n_splits(bsz * hkv, run, sms,
                      block_slots(dp, q.element_size(), g))
    out = torch.empty((bsz, hkv, g, dp), dtype=q.dtype, device=q.device)
    strides = [st for x in (q, k, v) for st in x.stride()[:3]]
    lib = _build.load("flash_decode")
    with torch.cuda.device(q.device):
        code = lib.flash_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bsz, hkv, g, s, dp, *strides, 0 if t_dev is not None else t,
            None if t_dev is None else t_dev.data_ptr(),
            int(t_dev is not None and t_dev.dtype == torch.int64), window,
            nsplit, scale, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "flash_decode")
    flash_decode.launches += 1
    out = out[..., :d] if dp != d else out
    return out[0] if squeeze else out


flash_decode.launches = 0
