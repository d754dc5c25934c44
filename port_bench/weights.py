"""Random weights of a dense decoder, made by the benchmark on the device
from the run's seed: one ``normal_`` call for each stacked leaf (all layers
at once), in the type the port serves it in, with a ``torch.Generator`` on
that device. The trees have the layout the port's model functions take
(``models/model.py``: layers stacked along a leading axis, the head a
transposed view of a ``(vocab, d)`` table, f32 norm scales drawn about 1
and adapters).

The same tensors are what the plain reference reads: the benchmark made
them, and the port derives nothing that the reference takes.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from port_bench import spec

#: the seven projections that carry LoRA adapters, with (input, output)
#: widths in terms of (d, q, kv, f)
PROJECTIONS = {"wq": ("attn", "d", "q"), "wk": ("attn", "d", "kv"),
               "wv": ("attn", "d", "kv"), "wo": ("attn", "q", "d"),
               "w_gate": ("mlp", "d", "f"), "w_up": ("mlp", "d", "f"),
               "w_down": ("mlp", "f", "d")}
#: std of a tenant adapter's B: the correction is about a tenth of the
#: projection it corrects (A ~ N(0, 1/K), r = 16, alpha / r = 2)
B_STD = 0.0125
#: std of the q / k / v biases, where the config has them
BIAS_STD = 0.1
#: std of the RMSNorm scales about 1, so that each norm's weight matters
NORM_STD = 0.1


def widths(cfg) -> Dict[str, int]:
    return {"d": cfg.d_model, "q": cfg.q_dim, "kv": cfg.kv_dim,
            "f": cfg.d_ff}


def _normal(gen, shape, std, dtype, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device=device)
    return t.normal_(0.0, std, generator=gen)


def make_frozen(cfg, seed: int, device) -> Dict:
    """The backbone: embedding, layers, final norm and head."""
    gen = torch.Generator(device=device)
    gen.manual_seed(spec.torch_seed(seed, spec.WEIGHTS))
    dt = getattr(torch, cfg.dtype)
    w, n = widths(cfg), cfg.n_layers

    def dense(i, o):
        return _normal(gen, (n, w[i], w[o]), 1.0 / math.sqrt(w[i]), dt, device)

    attn = {p: dense(i, o) for p, (grp, i, o) in PROJECTIONS.items()
            if grp == "attn"}
    if cfg.qkv_bias:
        for p, width in (("bq", "q"), ("bk", "kv"), ("bv", "kv")):
            attn[p] = _normal(gen, (n, w[width]), BIAS_STD, dt, device)
    mlp = {p: dense(i, o) for p, (grp, i, o) in PROJECTIONS.items()
           if grp == "mlp"}
    def scale(*shape):
        return _normal(gen, shape, NORM_STD, torch.float32, device).add_(1.0)

    frozen = {
        "embed": _normal(gen, (cfg.padded_vocab, cfg.d_model), 0.02, dt,
                         device),
        "layers": {"norm1": scale(n, cfg.d_model), "attn": attn,
                   "norm2": scale(n, cfg.d_model), "mlp": mlp},
        "final_norm": scale(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        frozen["head"] = _normal(gen, (cfg.padded_vocab, cfg.d_model), 0.02,
                                 dt, device).T
    return frozen


def make_adapters(cfg, seed: int, device, count: int, purpose: int
                  ) -> Dict:
    """``count`` adapters stacked along a leading axis: leaves
    ``(count, n_layers, K, r)`` (A ~ N(0, 1/K)) and ``(count, n_layers, r,
    N)`` (B ~ N(0, B_STD^2)), in the adapters' type."""
    gen = torch.Generator(device=device)
    gen.manual_seed(spec.torch_seed(seed, purpose))
    dt = getattr(torch, cfg.lora.dtype)
    w, n, r = widths(cfg), cfg.n_layers, cfg.lora.rank
    out: Dict = {"attn": {}, "mlp": {}}
    for p, (grp, i, o) in PROJECTIONS.items():
        if p not in cfg.lora.targets:
            continue
        out[grp][p] = {
            "a": _normal(gen, (count, n, w[i], r), 1.0 / math.sqrt(w[i]), dt,
                         device),
            "b": _normal(gen, (count, n, r, w[o]), B_STD, dt, device)}
    return {"layers": out}


def adapter(stacked: Dict, e: int) -> Dict:
    """Adapter ``e`` of a stack (views)."""
    if isinstance(stacked, dict):
        return {k: adapter(v, e) for k, v in stacked.items()}
    return stacked[e]


def leaves(tree, prefix: Tuple[str, ...] = ()):
    """``(path, tensor)`` of every leaf, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.detach().clone()
