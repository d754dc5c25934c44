"""Mamba-2 SSD intra-chunk kernel: per (batch, chunk, head) the quadratic
in-chunk output, the chunk-final state and the decay vectors.

Replaces: the Pallas TPU kernel ``ssd_intra_chunk`` of
``src/repro/kernels/ssd_scan.py``. CUDA sources (built and bound by
``_build``): ``csrc/ssd_scan_tc.cu`` (the tensor-core version) and
``csrc/ssd_scan.cu`` (the SIMT version, for the shapes the first does not
take).

Bound on this card: operations (f32). The TPU kernel holds a whole chunk
(xt, B, C and two chunk x chunk matrices) in one grid cell; on Hopper that
does not fit a block's shared memory at mamba2-370m's width, so a block owns
64 rows of the output or of the state, walks the j tiles up to its diagonal
only, and keeps the decay from overflowing: the segment form
``exp(cum_i - cum_j)`` where j <= i (the tensor-core version factorises it
off the diagonal at a row that keeps both factors <= 1). B and
C are indexed by batch rather than copied over the heads, and xt, y and dec
keep the model's ``(b, nc, cl, nh, .)`` layout. The tensor-core version
is two launches: a scores kernel computes every tile of ``C . B^T`` once,
split into tf32 fragments in a workspace the wrapper allocates, and the
heads kernel shares each tile among a group of heads (``ssd_plan``); every
product runs as three tf32 products (hi.hi + hi.lo + lo.hi), which keeps f32
accuracy. ``ssd_intra_chunk_version`` picks the version by shape and
alignment alone (never by failure).

The wrapper launches a kernel for a CUDA tensor, or raises; it uses the
plain version only for a CPU tensor. ``ssd_intra_chunk.launches`` counts
(one per call, however many CUDA kernels the call enqueues),
``ssd_intra_chunk.by_version`` splits the count by version.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build, refuse_autograd

MAX_HEAD_DIM = 128
TC_MAX_CHUNK = 256          # the tensor-core cum scan: up to 8 rows a lane
TILE = 64                   # rows of a tile: i, j and state rows
HEAD_GROUPS = (4, 2, 1)     # heads per block, most sharing of C.B^T first
WAVES = 5                   # blocks per SM the plan asks for (two resident)


def max_heads(hp: int) -> int:
    """Most heads a block of the tensor-core kernel holds: their outputs
    stay in registers, 4 heads of up to 32 columns, 2 of 64 or 1 of 128."""
    return 4 if hp <= 32 else 2 if hp <= 64 else 1

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def ssd_intra_chunk_ref(xt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                        C: torch.Tensor) -> Triple:
    """Plain version (the reference's ``kernels/ref.py`` oracle), all f32.
    xt: (b, nc, cl, nh, hp); a: (b, nc, cl, nh); B, C: (b, nc, cl, ns).
    Returns y (b, nc, cl, nh, hp), states (b, nc, nh, ns, hp) and
    dec (b, nc, cl, nh, 2) = [exp(cum), exp(cum_last)]."""
    f32 = torch.float32
    cl = xt.shape[2]
    xt, a, Bc, Cc = (x.to(f32) for x in (xt, a, B, C))
    cum = torch.cumsum(a, dim=2)                               # (b,nc,cl,nh)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (b,nc,i,j,nh)
    causal = torch.tril(torch.ones((cl, cl), dtype=torch.bool,
                                   device=xt.device))
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg),
                        torch.zeros((), dtype=f32, device=xt.device))
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * decay, xt)
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)               # (b,nc,cl,nh)
    st = torch.einsum("bcjnh,bcjhp->bchnp",
                      Bc[..., None] * dec_end[:, :, :, None, :], xt)
    dec = torch.stack([torch.exp(cum),
                       torch.exp(cum[:, :, -1:, :]).expand_as(cum)], dim=-1)
    return y, st, dec


def ssd_intra_chunk_version(cl: int, hp: int, ns: int, aligned: bool) -> str:
    """The kernel a CUDA call of ``ssd_intra_chunk`` takes: ``"tc"``
    (``csrc/ssd_scan_tc.cu``) for chunks of at most 256 rows, a head dim
    and a state width that are multiples of 4 (whole 16-byte copies) and
    16-byte aligned xt, B, C; otherwise ``"simt"`` (``csrc/ssd_scan.cu``)."""
    if (aligned and cl <= TC_MAX_CHUNK and hp <= MAX_HEAD_DIM
            and hp % 4 == 0 and ns % 4 == 0):
        return "tc"
    return "simt"


class SsdPlan(NamedTuple):
    """Grid of the tensor-core kernel: ``heads`` per block (a group), 64
    ``rows`` per tile, ``groups`` head groups (the last may be ragged),
    ``y_tiles`` row tiles of y and ``state_tiles`` 64-row tiles of the state
    per (batch, chunk, group), ``blocks`` in all."""
    heads: int
    rows: int
    groups: int
    y_tiles: int
    state_tiles: int
    blocks: int


@functools.lru_cache(maxsize=256)
def ssd_plan(b: int, nc: int, cl: int, nh: int, hp: int, ns: int,
             sms: int) -> SsdPlan:
    """The most heads per block (4, 2 or 1, at most ``max_heads(hp)``;
    each block computes C.B^T once for its heads) that still deals at least
    ``WAVES * sms`` blocks, else one head per block. A block walks its j
    tiles one step after another, so the card needs several blocks per SM
    in turn to hide the steps' latency: on the H100 two heads a block beat
    four at both full widths (PERF.md)."""
    y_tiles, state_tiles = -(-cl // TILE), -(-ns // TILE)
    for heads in (h for h in HEAD_GROUPS if h <= max_heads(hp)):
        groups = -(-nh // heads)
        blocks = b * nc * groups * (y_tiles + state_tiles)
        if blocks >= WAVES * sms:
            break
    return SsdPlan(heads, TILE, groups, y_tiles, state_tiles, blocks)


def ssd_tile(plan: SsdPlan, block: int) -> Tuple[int, int, str, int]:
    """What block ``block`` of the tensor-core kernel computes, as the kernel
    decodes it: ``(batch * nc + chunk, head group, "y" | "state", tile)``.
    The y tiles come first, the longest (the last rows of the chunk) first;
    group ``g`` holds heads ``g * heads`` up to ``min(nh, (g + 1) * heads)``."""
    per_rank = plan.blocks // (plan.y_tiles + plan.state_tiles)
    rank, rem = divmod(block, per_rank)
    bc, group = divmod(rem, plan.groups)
    if rank < plan.y_tiles:
        return bc, group, "y", plan.y_tiles - 1 - rank
    return bc, group, "state", rank - plan.y_tiles


def ssd_intra_chunk(xt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor) -> Triple:
    """xt: (b, nc, cl, nh, hp) pre-multiplied by dt; a: (b, nc, cl, nh);
    B, C: (b, nc, cl, ns); all float32. Returns
    ``(y (b, nc, cl, nh, hp), states (b, nc, nh, ns, hp),
    dec (b, nc, cl, nh, 2))``, float32. Head dim at most 128."""
    refuse_autograd("ssd_intra_chunk", xt, a, B, C)
    if xt.ndim != 5 or a.ndim != 4 or B.ndim != 4 or C.ndim != 4:
        raise ValueError("ssd_intra_chunk takes xt (b,nc,cl,nh,hp), "
                         "a (b,nc,cl,nh), B and C (b,nc,cl,ns)")
    b, nc, cl, nh, hp = xt.shape
    ns = B.shape[-1]
    if (a.shape != (b, nc, cl, nh) or B.shape != (b, nc, cl, ns)
            or C.shape != B.shape):
        raise ValueError(
            f"shapes do not agree: xt {tuple(xt.shape)}, a {tuple(a.shape)}, "
            f"B {tuple(B.shape)}, C {tuple(C.shape)}")
    if any(x.device != xt.device for x in (a, B, C)):
        raise ValueError("xt, a, B, C must lie on one device")

    if xt.device.type == "cpu":
        return ssd_intra_chunk_ref(xt, a, B, C)
    if xt.device.type != "cuda":
        raise RuntimeError(f"ssd_intra_chunk has no kernel for {xt.device}")
    if any(x.dtype != torch.float32 for x in (xt, a, B, C)):
        raise TypeError("the ssd_intra_chunk kernel takes float32 only")
    if hp > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hp} > {MAX_HEAD_DIM}")
    if 0 in (b, nc, cl, nh, hp, ns):
        raise ValueError("ssd_intra_chunk takes no empty tensor")
    xt, a, B, C = (x.contiguous() for x in (xt, a, B, C))
    y = torch.empty_like(xt)
    st = torch.empty((b, nc, nh, ns, hp), dtype=torch.float32,
                     device=xt.device)
    dec = torch.empty((b, nc, cl, nh, 2), dtype=torch.float32,
                      device=xt.device)
    version = ssd_intra_chunk_version(
        cl, hp, ns, all(t.data_ptr() % 16 == 0 for t in (xt, B, C)))
    ptrs = (xt.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), st.data_ptr(), dec.data_ptr())
    with torch.cuda.device(xt.device):
        stream = torch.cuda.current_stream().cuda_stream
        if version == "tc":
            sms = torch.cuda.get_device_properties(
                xt.device).multi_processor_count
            plan = ssd_plan(b, nc, cl, nh, hp, ns, sms)
            # the scores C_i . B_j^T of every (i, j <= i) tile pair, split
            # into tf32 fragments: 2 x 4096 floats a pair
            pairs = plan.y_tiles * (plan.y_tiles + 1) // 2
            ws = torch.empty(b * nc * pairs * 8192, dtype=torch.float32,
                             device=xt.device)
            code = _build.load("ssd_scan_tc").ssd_intra_chunk_tc_launch(
                *ptrs, ws.data_ptr(), b, nc, cl, nh, hp, ns, plan.heads,
                stream)
        else:
            code = _build.load("ssd_scan").ssd_intra_chunk_launch(
                *ptrs, b, nc, cl, nh, hp, ns, stream)
    _build.check(code, f"ssd_intra_chunk ({version})")
    ssd_intra_chunk.launches += 1
    ssd_intra_chunk.by_version[version] += 1
    return y, st, dec


ssd_intra_chunk.launches = 0
ssd_intra_chunk.by_version = {"tc": 0, "simt": 0}
