"""The plain reference of the dense decoder the cells run (Qwen2, Phi-3):
RMSNorm, q / k / v with an optional bias, rotary embeddings on the two
halves of each head (the published models' ``rotate_half``), grouped-query
causal attention with an optional sliding window, SwiGLU, a final norm and
an untied head, and a LoRA pair ``scale * (x @ A) @ B`` beside each of the
seven projections. It follows the published description and nothing of the
port: it imports neither the port nor its kernels.

Everything is computed in float32 with TF32 off, one layer at a time, so
that a model whose float32 weights would not fit the card is still run
whole: each layer's weights are taken from the benchmark's tensors and
widened to float32 when the layer runs. ``rnd`` rounds every operand of
every product (weights once a layer, activations at each product): the
identity for the reference, ``fp8`` for its control, the precision below
the configuration's bfloat16.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

Rounding = Callable[[torch.Tensor], torch.Tensor]
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
#: queries a block of the attention, so that the scores of a long prompt fit
QUERY_BLOCK = 512


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude to e4m3's largest, 448), and back to float32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x.detach())          # the value rounded, the gradient not



def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclasses.dataclass(frozen=True)
class Dims:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int
    vocab: int
    eps: float
    theta: float
    window: int          # 0: full causal attention
    qkv_bias: bool
    lora_scale: float


def dims_of(config: Dict) -> Dims:
    """The reference's reading of a config file."""
    m = config["model"]
    window = m.get("sliding_window") or 0
    if not m.get("use_sliding_window", True):
        window = 0
    lora = config["lora"]
    return Dims(layers=m["num_hidden_layers"], d=m["hidden_size"],
                heads=m["num_attention_heads"],
                kv_heads=m["num_key_value_heads"],
                head_dim=m.get("head_dim") or
                m["hidden_size"] // m["num_attention_heads"],
                ffn=m["intermediate_size"], vocab=m["vocab_size"],
                eps=float(m["rms_norm_eps"]), theta=float(m["rope_theta"]),
                window=int(window),
                qkv_bias=bool(m.get("qkv_bias", m.get("attention_bias",
                                                      False))),
                lora_scale=float(lora["alpha"]) / float(lora["r"]))


# ---------------------------------------------------------------------------
# One layer
# ---------------------------------------------------------------------------


def layer_weights(frozen: Dict, i: int, rnd: Rounding) -> Dict:
    """Layer ``i``'s weights widened to float32 (and rounded by ``rnd``)."""
    L = frozen["layers"]
    w = {p: rnd(L["attn" if p in ("wq", "wk", "wv", "wo") else "mlp"][p][i]
                .float()) for p in PROJECTIONS}
    for b in ("bq", "bk", "bv"):
        if b in L["attn"]:
            w[b] = L["attn"][b][i].float()
    w["norm1"] = L["norm1"][i].float()
    w["norm2"] = L["norm2"][i].float()
    return w


def layer_adapters(lora: Dict, i: int) -> Dict[str, Tuple[torch.Tensor,
                                                          torch.Tensor]]:
    """Layer ``i``'s LoRA pairs ``{projection: (A, B)}`` in float32."""
    out = {}
    for grp in lora["layers"].values():
        for p, pair in grp.items():
            out[p] = (pair["a"][i].float(), pair["b"][i].float())
    return out


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x, positions, theta):
    """x: (B, S, H, D); positions: (S,)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = positions.to(torch.float32)[:, None] * freqs          # (S, D/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def proj(x, w, pair, scale, rnd, bias=None):
    xr = rnd(x)
    y = xr @ w
    if pair is not None:
        a, b = pair
        y = y + scale * (rnd(xr @ rnd(a)) @ rnd(b))
    if bias is not None:
        y = y + bias
    return y


def attention(q, k, v, positions, window, rnd):
    """Causal grouped-query attention. q: (B, S, Hq, D); k, v: (B, S, Hkv,
    D); queries in blocks of ``QUERY_BLOCK``."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = rnd(q).reshape(b, s, hkv, g, d)
    kr, vr = rnd(k), rnd(v)
    outs = []
    for lo in range(0, s, QUERY_BLOCK):
        hi = min(s, lo + QUERY_BLOCK)
        kmax = hi                               # causal: keys up to hi
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qg[:, lo:hi],
                          kr[:, :kmax]) / math.sqrt(d)
        qp = positions[lo:hi][:, None]
        kp = positions[:kmax][None, :]
        mask = kp <= qp
        if window:
            mask = mask & (kp > qp - window)
        sc = sc.masked_fill(~mask, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        outs.append(torch.einsum("bhgqk,bkhd->bqhgd", rnd(p), vr[:, :kmax]))
    return torch.cat(outs, dim=1).reshape(b, s, hq * d)


def layer(x, w, ad, positions, dims: Dims, rnd: Rounding):
    """One layer on ``x`` (B, S, d). Returns (out, k, v): k after RoPE."""
    b, s, _ = x.shape
    sc = dims.lora_scale
    h = rms_norm(x, w["norm1"], dims.eps)
    q = proj(h, w["wq"], ad.get("wq"), sc, rnd, w.get("bq"))
    k = proj(h, w["wk"], ad.get("wk"), sc, rnd, w.get("bk"))
    v = proj(h, w["wv"], ad.get("wv"), sc, rnd, w.get("bv"))
    q = rope(q.reshape(b, s, dims.heads, dims.head_dim), positions, dims.theta)
    k = rope(k.reshape(b, s, dims.kv_heads, dims.head_dim), positions,
             dims.theta)
    v = v.reshape(b, s, dims.kv_heads, dims.head_dim)
    o = attention(q, k, v, positions, dims.window, rnd)
    x = x + proj(o, w["wo"], ad.get("wo"), sc, rnd)
    h = rms_norm(x, w["norm2"], dims.eps)
    gate = proj(h, w["w_gate"], ad.get("w_gate"), sc, rnd)
    up = proj(h, w["w_up"], ad.get("w_up"), sc, rnd)
    x = x + proj(torch.nn.functional.silu(gate) * up, w["w_down"],
                 ad.get("w_down"), sc, rnd)
    return x, k, v


def head_weight(frozen: Dict, rnd: Rounding, vocab: int) -> torch.Tensor:
    """(d, vocab) float32: the head's columns of the real vocabulary."""
    head = frozen["head"] if "head" in frozen else frozen["embed"].T
    return rnd(head[:, :vocab].float())


def logits(x, frozen, dims: Dims, rnd: Rounding, head=None):
    h = rms_norm(x, frozen["final_norm"].float(), dims.eps)
    head = head_weight(frozen, rnd, dims.vocab) if head is None else head
    return rnd(h) @ head


# ---------------------------------------------------------------------------
# Prefill: the first token's logits of each prompt, and its K / V
# ---------------------------------------------------------------------------


def prefill(frozen: Dict, prompts: Sequence[torch.Tensor],
            adapters: Sequence[Dict], dims: Dims, rnd: Rounding = exact,
            on_kv: Optional[Callable] = None, hidden: bool = False
            ) -> List[torch.Tensor]:
    """Each prompt (a (S,) tensor of token ids) through the whole model
    with its adapter; returns each prompt's last-position logits over the
    vocabulary (float32), or with ``hidden`` its last layer's output at
    every position, (S, d). ``on_kv(prompt_index, layer, k, v)`` sees each
    layer's K (after RoPE) and V, (S, Hkv, D) float32."""
    dev = frozen["embed"].device
    xs = [frozen["embed"][p.to(dev)].float()[None] for p in prompts]
    for i in range(dims.layers):
        w = layer_weights(frozen, i, rnd)
        for j, x in enumerate(xs):
            pos = torch.arange(x.shape[1], device=dev)
            xs[j], k, v = layer(x, w, layer_adapters(adapters[j], i), pos,
                                dims, rnd)
            if on_kv is not None:
                on_kv(j, i, k[0], v[0])
        del w
    if hidden:
        return [x[0] for x in xs]
    head = head_weight(frozen, rnd, dims.vocab)
    return [logits(x[0, -1:], frozen, dims, rnd, head)[0] for x in xs]


# ---------------------------------------------------------------------------
# Split fine-tuning: one local epoch's loss and LoRA gradients
# ---------------------------------------------------------------------------


def int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """The channel's symmetric int8 quantisation of each last-axis row and
    back (round half to even), float32."""
    scale = (x.abs().amax(dim=-1, keepdim=True) / 127.0).clamp(min=1e-8)
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def split_step(frozen: Dict, lora: Dict, tokens: torch.Tensor,
               labels: torch.Tensor, cut: int, dims: Dims,
               rnd: Rounding = exact, channel: bool = True
               ) -> Tuple[float, Dict]:
    """One local epoch of split LoRA fine-tuning at ``cut``: the device
    runs the embedding and layers [0, cut), the smashed data crosses the
    int8 channel, the server runs the rest, the head and the mean
    cross-entropy, and the gradient of the smashed data crosses back through
    the channel. Returns (loss, gradients in the layout of ``lora``).

    Each layer keeps only its input; the backward runs it again (layer by
    layer), so the reference's memory is a layer's, whatever the depth."""
    dev = frozen["embed"].device
    tokens, labels = tokens.to(dev), labels.to(dev)
    pos = torch.arange(tokens.shape[1], device=dev)
    q = int8_roundtrip if channel else exact
    x = frozen["embed"][tokens].float()
    inputs = []
    with torch.no_grad():
        for i in range(dims.layers):
            if i == cut:
                x = q(x)
            inputs.append(x)
            x, _, _ = layer(x, layer_weights(frozen, i, rnd),
                            layer_adapters(lora, i), pos, dims, rnd)
        if cut == dims.layers:
            x = q(x)
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        lg = logits(x, frozen, dims, rnd)
        loss = torch.nn.functional.cross_entropy(
            lg.reshape(-1, lg.shape[-1]), labels.reshape(-1).long())
        (g,) = torch.autograd.grad(loss, [x])
    del lg
    if cut == dims.layers:
        g = q(g)
    grads = _zeros_like(lora)
    for i in reversed(range(dims.layers)):
        w = layer_weights(frozen, i, rnd)
        ad = {p: (a.detach().requires_grad_(True),
                  b.detach().requires_grad_(True))
              for p, (a, b) in layer_adapters(lora, i).items()}
        xi = inputs[i].detach().requires_grad_(i > 0)
        with torch.enable_grad():
            y, _, _ = layer(xi, w, ad, pos, dims, rnd)
            wrt = [t for pair in ad.values() for t in pair]
            got = torch.autograd.grad(y, wrt + ([xi] if i > 0 else []), g)
        for n, p in enumerate(ad):
            grads[p]["a"][i] = got[2 * n]
            grads[p]["b"][i] = got[2 * n + 1]
        if i > 0:
            g = got[-1]
            if i == cut:
                g = q(g)
        del w, y
    return float(loss.detach()), _layout(lora, grads)


def _zeros_like(lora: Dict) -> Dict:
    out = {}
    for grp in lora["layers"].values():
        for p, pair in grp.items():
            out[p] = {k: torch.zeros(t.shape, dtype=torch.float32,
                                     device=t.device)
                      for k, t in pair.items()}
    return out


def _layout(lora: Dict, flat: Dict) -> Dict:
    return {"layers": {grp: {p: flat[p] for p in pairs}
                       for grp, pairs in lora["layers"].items()}}


def adamw(params: Dict, grads: Dict, state: Optional[Dict], lr: float,
          b1: float, b2: float, eps: float, weight_decay: float
          ) -> Tuple[Dict, Dict]:
    """One AdamW step in float32 (bias-corrected moments); returns (new
    params, state)."""
    if state is None:
        state = {"m": _map(torch.zeros_like, params),
                 "v": _map(torch.zeros_like, params), "t": 0}
    t = state["t"] + 1
    m = _map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
    v = _map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    new = _map(lambda p, m_, v_: p - lr * ((m_ / bc1)
                                           / (torch.sqrt(v_ / bc2) + eps)
                                           + weight_decay * p),
               params, m, v)
    return new, {"m": m, "v": v, "t": t}


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)
