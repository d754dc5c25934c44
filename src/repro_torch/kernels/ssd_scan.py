"""Mamba-2 SSD intra-chunk kernel: per (batch, chunk, head) the quadratic
in-chunk output, the chunk-final state and the decay vectors.

Replaces: the Pallas TPU kernel ``ssd_intra_chunk`` of
``src/repro/kernels/ssd_scan.py``. CUDA source: ``csrc/ssd_scan.cu`` (built
and bound by ``_build``).

Bound on this card: operations (f32). The TPU kernel holds a whole chunk
(xt, B, C and two chunk x chunk matrices) in one grid cell; on Hopper that
does not fit a block's shared memory at mamba2-370m's width, so each block
owns 64 rows of the output or of the state, walks the j tiles up to its
diagonal only, and keeps the decay in the segment form
``exp(cum_i - cum_j)``. B and C are indexed by batch rather than copied over
the heads, and xt, y and dec keep the model's ``(b, nc, cl, nh, .)`` layout.

The wrapper launches the kernel for a CUDA tensor, or raises; it uses the
plain version only for a CPU tensor. ``ssd_intra_chunk.launches`` counts.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 128

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


def ssd_intra_chunk(xt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor) -> Triple:
    """xt: (b, nc, cl, nh, hp) pre-multiplied by dt; a: (b, nc, cl, nh);
    B, C: (b, nc, cl, ns); all float32. Returns
    ``(y (b, nc, cl, nh, hp), states (b, nc, nh, ns, hp),
    dec (b, nc, cl, nh, 2))``, float32. Head dim at most 128."""
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
    lib = _build.load("ssd_scan")
    with torch.cuda.device(xt.device):
        code = lib.ssd_intra_chunk_launch(
            xt.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), st.data_ptr(), dec.data_ptr(), b, nc, cl, nh, hp,
            ns, torch.cuda.current_stream().cuda_stream)
    _build.check(code, "ssd_intra_chunk")
    ssd_intra_chunk.launches += 1
    return y, st, dec


ssd_intra_chunk.launches = 0
