"""Mamba-2 (SSD, arXiv:2405.21060): the chunked scan.

Only ``ssd_chunked`` is ported so far: the plain oracle that the measured
cost model times on its plain backend and that the tests hold the
``ssd_intra_chunk`` kernel path (``kernels.ops.ssd_scan``) against. The
rest of the block (projections, causal conv, decode recurrence) comes with
the SSM family.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ACC_DTYPE


def ssd_chunked(xt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. xt: (B,L,nh,hp) pre-multiplied by dt; a: (B,L,nh) = A*dt
    (<=0); B,C: (B,L,ns). Returns (y: (B,L,nh,hp), h_final: (B,nh,hp,ns))."""
    b, length, nh, hp = xt.shape
    ns = B.shape[-1]
    pad = (-length) % chunk
    if pad:
        xt = F.pad(xt, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = xt.shape[1] // chunk
    xt = xt.reshape(b, nc, chunk, nh, hp).to(ACC_DTYPE)
    a = a.reshape(b, nc, chunk, nh).to(ACC_DTYPE)
    Bc = B.reshape(b, nc, chunk, ns).to(ACC_DTYPE)
    Cc = C.reshape(b, nc, chunk, ns).to(ACC_DTYPE)

    cum = torch.cumsum(a, dim=2)                         # (b,nc,cl,nh)
    # intra-chunk (quadratic within chunk)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,i,j,nh)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xt.device))
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg),
                        torch.zeros((), dtype=ACC_DTYPE, device=xt.device))
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)     # (b,nc,i,j)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * decay, xt)

    # chunk-final states
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)         # (b,nc,cl,nh)
    states = torch.einsum("bcjnh,bcjhp->bchpn",
                          Bc[..., None] * dec_end[:, :, :, None, :], xt)

    # inter-chunk recurrence
    a_tot = torch.exp(cum[:, :, -1, :])                  # (b,nc,nh)
    h = (torch.zeros((b, nh, hp, ns), dtype=ACC_DTYPE, device=xt.device)
         if h0 is None else h0.to(ACC_DTYPE))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * a_tot[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                 # (b,nc,nh,hp,ns)

    y_off = (torch.einsum("bcin,bchpn->bcihp", Cc, h_prev)
             * torch.exp(cum)[..., None])
    y = (y_diag + y_off).reshape(b, nc * chunk, nh, hp)
    return y[:, :length], h
