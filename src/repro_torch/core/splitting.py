"""Split execution — the SL computation itself (Sec. II-B stages 3-4).

The device stage (embedding + layers [0,c) + its LoRA adapters) and the
server stage (layers [c,I) + final norm + head + loss + its adapters) are
two autograd graphs joined at the cut, where the reference has two
``jax.vjp``s:

  device:  smashed = f_D(lora_D; x)                        (Eq. 2)
  channel: smashed' = Q(smashed)         phi-compression (int8 quantization)
  server:  loss, d(smashed'), grads_S = f_S(lora_S; smashed', y)   (Eq. 3-4)
  channel: g' = Q(d smashed')
  device:  grads_D = vjp_D(g')                              (Eq. 5)

The server graph starts from a detached copy of the smashed data, so the
gradient that crosses back to the device is a tensor of its own and goes
through the channel quantizer like the activations did. Gradients come
from ``torch.autograd.grad`` on fresh leaves made from the adapters, never
from ``.grad``, so nothing carries over from one step to the next.

The compression is a straight-through int8 quantizer: the paper models phi
as a data-size ratio on the link (Eq. 9); here it is also *executed* so the
training dynamics include the quantization error.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.models.common import (Params, batch_to_device,
                                       softmax_cross_entropy, tree_leaves,
                                       tree_map, tree_unflatten)

#: called with a stage name ("device_forward", "server", "device_backward",
#: "end") as each stage of ``split_grads`` begins, for timing on the card
StageMark = Callable[[str], None]


# ---------------------------------------------------------------------------
# Channel compression (phi)
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-last-axis int8 quantization of smashed activations,
    computed in ``x``'s dtype: returns (int8 values shaped like ``x``,
    float32 scales with the last axis kept as size 1)."""
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype
                    ) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def channel_compress(x: torch.Tensor, enabled: bool) -> torch.Tensor:
    """Straight-through int8 round trip emulating the phi-compressed link:
    the value of ``x + (xq - x)`` computed in ``x``'s dtype, as the
    reference writes it (``xq`` itself only where the subtraction is exact),
    and the gradient of the identity."""
    if not enabled:
        return x
    xd = x.detach()
    q, s = quantize_int8(xd)
    return x + (dequantize_int8(q, s, x.dtype) - xd)


# ---------------------------------------------------------------------------
# Stage functions
# ---------------------------------------------------------------------------


def split_lora(lora: Params, cut: int) -> Tuple[Params, Params]:
    """R = {R^D ; R^S} (Eq. 6, inverse): split adapters at the cut (views)."""
    dev = {"layers": model_lib.slice_layers(lora["layers"], 0, cut)}
    n = tree_leaves(lora["layers"])[0].shape[0]
    srv = {"layers": model_lib.slice_layers(lora["layers"], cut, n)}
    return dev, srv


def merge_lora(dev: Params, srv: Params) -> Params:
    """Stage 5, Eq. 6: R = {R^{D,T} ; R^{S,T}}."""
    return {"layers": tree_map(lambda a, b: torch.cat([a, b], dim=0),
                               dev["layers"], srv["layers"])}


def device_forward(frozen: Params, lora_dev: Params, inputs: torch.Tensor,
                   cfg: ModelConfig, cut: int, *, impl: str = "naive",
                   compress: bool = True) -> torch.Tensor:
    """Eq. 2: smashed data at the cut layer (embedding + layers [0,c))."""
    if cut == 0:
        x = model_lib.embed_inputs(frozen, inputs, cfg)
    else:
        x, _ = model_lib.forward_hidden(
            frozen, {"layers": lora_dev["layers"]}, inputs, cfg, lo=0,
            hi=cut, impl=impl, remat=False, lora_sliced=True)
    return channel_compress(x, compress)


def server_loss(frozen: Params, lora_srv: Params, smashed: torch.Tensor,
                labels: torch.Tensor, cfg: ModelConfig, cut: int, *,
                impl: str = "naive") -> torch.Tensor:
    """Eq. 3 + loss: layers [c,I) + final norm + head + CE."""
    if cut == cfg.n_layers:
        x, aux = smashed, 0.0
    else:
        x, aux = model_lib.forward_hidden(
            frozen, {"layers": lora_srv["layers"]}, smashed, cfg, lo=cut,
            hi=cfg.n_layers, impl=impl, remat=False, inputs_embedded=True,
            lora_sliced=True)
    logits = model_lib.logits_from_hidden(frozen, x, cfg)
    return softmax_cross_entropy(logits, labels) + aux


# ---------------------------------------------------------------------------
# One split fine-tuning step (stages 3-4)
# ---------------------------------------------------------------------------


def _trainable(tree: Params) -> Params:
    return tree_map(lambda x: x.detach().requires_grad_(), tree)


def split_grads(frozen: Params, lora_dev: Params, lora_srv: Params,
                inputs: torch.Tensor, labels: torch.Tensor, *,
                cfg: ModelConfig, cut: int, impl: str = "naive",
                compress: bool = True, mark: Optional[StageMark] = None
                ) -> Tuple[torch.Tensor, Params, Params]:
    """Returns (loss, grads_dev, grads_srv) with the smashed-data gradient
    crossing the (compressed) channel boundary — exactly stages 3-4. At the
    edge cuts the empty side's grads are zeros of its ``(0, ...)`` leaves,
    as in the reference. ``mark`` (optional) is called as each stage
    begins."""
    mark = mark or (lambda stage: None)
    dev, srv = _trainable(lora_dev), _trainable(lora_srv)
    dev_leaves, srv_leaves = tree_leaves(dev), tree_leaves(srv)
    with torch.enable_grad():
        # --- device-side FP, graph kept for the later BP ------------------
        mark("device_forward")
        smashed = device_forward(frozen, dev, inputs, cfg, cut, impl=impl,
                                 compress=compress)
        # --- uplink: smashed data + labels (compression already applied) --
        # --- server-side FP + BP ------------------------------------------
        mark("server")
        smashed_in = smashed.detach().requires_grad_(cut > 0)
        loss = server_loss(frozen, srv, smashed_in, labels, cfg, cut,
                           impl=impl)
        wrt = (srv_leaves if cut < cfg.n_layers else []) + (
            [smashed_in] if cut > 0 else [])
        got = list(torch.autograd.grad(loss, wrt)) if wrt else []
        g_srv = (got[:len(srv_leaves)] if cut < cfg.n_layers
                 else [torch.zeros_like(x) for x in srv_leaves])
        # --- downlink: smashed-data gradient, phi-compressed --------------
        # --- device-side BP -----------------------------------------------
        mark("device_backward")
        if cut > 0:
            g = channel_compress(got[-1], compress)
            g_dev = list(torch.autograd.grad(smashed, dev_leaves,
                                             grad_outputs=g))
        else:
            g_dev = [torch.zeros_like(x) for x in dev_leaves]
    mark("end")
    return (loss.detach(), tree_unflatten(lora_dev, g_dev),
            tree_unflatten(lora_srv, g_srv))


class SplitExecutor:
    """One local epoch of split training at a given cut. The reference
    memoizes a compiled program per cut here; the port compiles nothing,
    and keeps the class for ``protocol.SplitFineTuner``. ``mark`` is handed
    to ``split_grads`` (stage timing)."""

    def __init__(self, cfg: ModelConfig, *, impl: str = "naive",
                 compress: bool = True, mark: Optional[StageMark] = None):
        self.cfg = cfg
        self.impl = impl
        self.compress = compress
        self.mark = mark

    def step(self, frozen: Params, lora: Params, batch: Dict[str, Any],
             cut: int) -> Tuple[torch.Tensor, Params]:
        """One local epoch: returns (loss, full-model LoRA grads). ``batch``
        holds numpy arrays or tensors; they go to the parameters' device."""
        batch = batch_to_device(batch, frozen["embed"].device)
        lora_dev, lora_srv = split_lora(lora, cut)
        inputs = (batch["embeds"] if self.cfg.input_mode == "embeds"
                  else batch["tokens"])
        loss, g_dev, g_srv = split_grads(
            frozen, lora_dev, lora_srv, inputs, batch["labels"],
            cfg=self.cfg, cut=cut, impl=self.impl, compress=self.compress,
            mark=self.mark)
        return loss, merge_lora(g_dev, g_srv)
