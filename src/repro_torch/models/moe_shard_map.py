"""Expert-parallel MoE with explicit collectives over a live mesh: the
reference's ``shard_map`` layouts, each rank running one shard's block.

The program is SPMD: every rank holds the global activations (as the
reference's ``(B, S, d)`` outside the map), takes its block of the batch
and of the expert weights as ``shard_map``'s ``in_specs`` would hand them,
runs the layout on local tensors, and gathers the output back. The
collectives are ``LiveMesh.psum`` and ``LiveMesh.all_to_all``
(``launch/mesh.py``), whose backward rules are written out there
(``_AllReduce``, ``_AllToAll``), so autograd runs through them as JAX's
transposes run through ``all_to_all``/``psum``; the map's entry and exit
(``LiveMesh.enter``/``leave``) carry shard_map's own transpose rules, so a
loss that every rank computes alike is counted once, not once a rank.

  Layout ('ep_a2a'): expert weights sharded E over the data-parallel axes
  (EP) and FFN width f over 'model' (TP). Per layer:

    source shard --(all_to_all over dp)--> expert owner
      local capacity dispatch -> expert FFN on the f-slice
    expert owner --(all_to_all back)--> source shard
      combine with gates; one psum over 'model' merges the TP-partial
      down-projections (the shared expert folds into the same psum).

  With a batch the data-parallel axes do not divide, the tokens stay
  replicated and each rank serves its expert slice; one psum over (dp +
  model) merges the expert groups and TP (``_local_moe_ep_bcast``).

  Layout ('replicated'): small MoEs (granite-3b: 40 experts, which 16 does
  not divide) replicate the expert weights and dispatch locally per batch
  shard, no collective inside the layer but the ``aux`` mean.

Each rank's expert weights are either the global ones (the rank takes its
block) or already its block (``local_shard`` of ``param_specs``' spec, or
:func:`init_local_moe`, which never holds the whole bank). The expert
weights and the router are frozen: no gradient flows to them through the
map (the adapter, ``out_adapter``, sits outside it and trains).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch import shardctx
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import LiveMesh
from repro_torch.launch.sharding import P, local_shard, shard_shape
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ACC_DTYPE, Params, silu

EXPERT_BYTES_REPLICATED = 6e9   # bf16 experts up to this stay replicated


def _decide(cfg: ModelConfig, dp: int, tp: int) -> Optional[str]:
    if dp > 1 and cfg.n_experts % dp == 0 and cfg.d_ff % tp == 0:
        return "ep_a2a"
    expert_bytes = (cfg.n_experts + cfg.n_shared_experts) * 3 \
        * cfg.d_model * cfg.d_ff * 2
    if expert_bytes <= EXPERT_BYTES_REPLICATED:
        return "replicated"
    return None


def select_strategy(cfg: ModelConfig) -> Optional[str]:
    """The distributed MoE layout for the active mesh (None: no mesh, or
    not an MoE; ``moe_forward`` then runs, as on one card)."""
    if not shardctx.active() or not cfg.is_moe:
        return None
    return _decide(cfg, shardctx.axis_size("dp"), shardctx.axis_size("model"))


def strategy_for_mesh(cfg: ModelConfig, mesh) -> Optional[str]:
    """Same decision from a mesh object (for ``sharding.param_specs``); the
    active context is left as it is."""
    if not cfg.is_moe:
        return None
    dp = math.prod(mesh.shape[a] for a in mesh.axis_names
                   if a in ("pod", "data"))
    return _decide(cfg, dp, mesh.shape.get("model", 1))


def batch_axes(strategy: str, batch: int) -> Optional[Tuple[str, ...]]:
    """The mesh axes the map splits a batch of ``batch`` rows over on the
    active mesh: the data-parallel axes; under 'replicated' also 'model'
    where the batch divides (its otherwise idle TP columns take rows too);
    ``()`` under 'ep_a2a' for a batch dp does not divide (the broadcast
    layout); ``None`` under 'replicated' then (``moe_forward`` runs)."""
    dp, dp_size = shardctx.dp_axes(), shardctx.axis_size("dp")
    if batch % dp_size:
        return () if strategy == "ep_a2a" else None
    tp = shardctx.axis_size("model")
    if strategy == "replicated" and batch % (dp_size * tp) == 0 and tp > 1:
        return dp + ("model",)
    return dp


def _model_axes(mesh) -> Tuple[str, ...]:
    return ("model",) if "model" in mesh.axis_names else ()


def expert_specs(strategy: str, dp: Tuple[str, ...]):
    """One layer's expert and shared-expert specs (shard_map's in_specs)."""
    if strategy == "ep_a2a":
        return ((P(dp, None, "model"), P(dp, None, "model"),
                 P(dp, "model", None)),
                {"w_gate": P(None, "model"), "w_up": P(None, "model"),
                 "w_down": P("model", None)})
    return ((P(None, None, None),) * 3,
            {"w_gate": P(None, None), "w_up": P(None, None),
             "w_down": P(None, None)})


def _expert_shapes(cfg: ModelConfig):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    fs = f * cfg.n_shared_experts
    return (((e, d, f), (e, d, f), (e, f, d)),
            {"w_gate": (d, fs), "w_up": (d, fs), "w_down": (fs, d)})


def _local(w: torch.Tensor, global_shape, spec, mesh) -> torch.Tensor:
    """This rank's block of an expert weight given whole or as its block."""
    if w.requires_grad:
        raise ValueError("moe_forward_dist: the expert weights are frozen; "
                         "the trainable adapter is out_adapter")
    if tuple(w.shape) == tuple(global_shape):
        return local_shard(w, spec, mesh)
    if tuple(w.shape) == shard_shape(global_shape, spec, mesh):
        return w
    raise ValueError(f"expert weight of shape {tuple(w.shape)} is neither "
                     f"{tuple(global_shape)} nor its block under {spec}")


def _expert_ffn(buf, wg, wu, wd, dtype):
    g = torch.bmm(buf, wg.to(dtype))
    u = torch.bmm(buf, wu.to(dtype))
    return torch.bmm(silu(g) * u, wd.to(dtype))


def _shared_ffn(xf, shared, dtype):
    sg = torch.matmul(xf, shared["w_gate"].to(dtype))
    su = torch.matmul(xf, shared["w_up"].to(dtype))
    return torch.matmul(silu(sg) * su, shared["w_down"].to(dtype))


def _route(xf, router, cfg):
    logits = torch.matmul(xf.to(torch.float32), router)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = moe_mod.route(probs, cfg.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch aux loss, local shard contribution
    me = torch.mean(probs, dim=0)
    ce = moe_mod.group_counts(idx[:, 0], cfg.n_experts).to(torch.float32) \
        / xf.shape[0]
    aux = cfg.n_experts * torch.sum(me * ce) * cfg.router_aux_coef
    return gates, idx, aux


def _combine(contrib: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """Each token's k contributions added in order j = 0..k-1."""
    contrib = contrib.reshape(t, k, -1)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out


def _zero(dtype, dev):
    return torch.zeros((), dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# EP + a2a layout
# ---------------------------------------------------------------------------


def _local_moe_ep(x_blk, router, wg, wu, wd, shared, *, cfg: ModelConfig,
                  dp_axes, mesh: LiveMesh):
    ep = mesh.axis_size(dp_axes)
    e, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    eg = e // ep
    b_loc, s, _ = x_blk.shape
    t_loc = b_loc * s
    xf = x_blk.reshape(t_loc, d)
    dtype, dev = x_blk.dtype, x_blk.device

    gates, idx, aux = _route(xf, router, cfg)
    flat_e = idx.reshape(-1)                      # (n,) n = t_loc*k
    n = flat_e.shape[0]

    # ---- send-side packing by destination expert group --------------------
    dest = flat_e // eg
    cs = moe_mod.group_capacity(n, ep, cfg.capacity_factor)
    pos_s = moe_mod.ranks_within_groups(dest, ep)
    keep_s = moe_mod.within_capacity(pos_s, cs)
    ps = torch.where(keep_s, pos_s, torch.zeros_like(pos_s))
    tok = torch.arange(t_loc, device=dev).repeat_interleave(k)
    payload = torch.where(keep_s[:, None], xf[tok], _zero(dtype, dev))
    send_x = torch.zeros((ep, cs, d), dtype=dtype, device=dev).index_put(
        (dest, ps), payload, accumulate=True)
    send_e = torch.zeros((ep, cs), dtype=torch.long, device=dev).index_put(
        (dest, ps), torch.where(keep_s, flat_e + 1, torch.zeros_like(flat_e)),
        accumulate=True)                          # 0 == empty slot

    # ---- the MoE all-to-all ------------------------------------------------
    recv_x = mesh.all_to_all(send_x, dp_axes)
    recv_e = mesh.all_to_all(send_e, dp_axes)

    # ---- receiver: dispatch to local experts ------------------------------
    g_idx = mesh.axis_index(dp_axes)
    rx = recv_x.reshape(ep * cs, d)
    re_ = recv_e.reshape(ep * cs) - 1
    le = re_ - g_idx * eg
    valid = re_ >= 0
    le_sort = torch.where(valid, le, torch.full_like(le, eg))  # empty: trash
    cr = moe_mod.group_capacity(ep * cs, eg, cfg.capacity_factor)
    pos_r = moe_mod.ranks_within_groups(le_sort, eg + 1)
    keep_r = moe_mod.within_capacity(pos_r, cr, valid)
    lec = torch.where(keep_r, le, torch.zeros_like(le))
    pr = torch.where(keep_r, pos_r, torch.zeros_like(pos_r))
    buf = torch.zeros((eg, cr, d), dtype=dtype, device=dev).index_put(
        (lec, pr), torch.where(keep_r[:, None], rx, _zero(dtype, dev)),
        accumulate=True)

    # ---- expert FFN on the local f-slice (TP partial) ----------------------
    y = _expert_ffn(buf, wg, wu, wd, dtype)

    # ---- return trip --------------------------------------------------------
    y_rows = torch.where(keep_r[:, None], y[lec, pr],
                         _zero(dtype, dev)).reshape(ep, cs, d)
    back = mesh.all_to_all(y_rows, dp_axes)

    # ---- combine at the source ----------------------------------------------
    w = (gates.reshape(-1) * keep_s).to(dtype)
    out = _combine(back[dest, ps] * w[:, None], t_loc, k)
    if shared is not None:
        out = out + _shared_ffn(xf, shared, dtype)

    # merge TP-partial contributions (expert down-proj + shared down-proj)
    out = mesh.psum(out, _model_axes(mesh))
    aux = mesh.psum(aux, dp_axes) / ep
    return out.reshape(b_loc, s, d), aux


# ---------------------------------------------------------------------------
# EP with broadcast tokens (a batch too small to shard, e.g. long_500k
# batch=1): tokens replicated; each rank serves only its local expert slice;
# one psum over (dp + model) merges expert groups and TP.
# ---------------------------------------------------------------------------


def _local_moe_ep_bcast(x_blk, router, wg, wu, wd, shared, *,
                        cfg: ModelConfig, dp_axes, mesh: LiveMesh):
    ep = mesh.axis_size(dp_axes)
    e, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    eg = e // ep
    b, s, _ = x_blk.shape
    t = b * s
    xf = x_blk.reshape(t, d)
    dtype, dev = x_blk.dtype, x_blk.device
    gates, idx, aux = _route(xf, router, cfg)
    flat_e = idx.reshape(-1)
    n = flat_e.shape[0]
    g_idx = mesh.axis_index(dp_axes)
    le = flat_e - g_idx * eg
    mine = (le >= 0) & (le < eg)
    cr = moe_mod.group_capacity(n, eg, max(cfg.capacity_factor, float(eg)))
    le_sort = torch.where(mine, le, torch.full_like(le, eg))
    pos = moe_mod.ranks_within_groups(le_sort, eg + 1)
    keep = moe_mod.within_capacity(pos, cr, mine)
    lec = torch.where(keep, le, torch.zeros_like(le))
    pr = torch.where(keep, pos, torch.zeros_like(pos))
    tok = torch.arange(t, device=dev).repeat_interleave(k)
    buf = torch.zeros((eg, cr, d), dtype=dtype, device=dev).index_put(
        (lec, pr), torch.where(keep[:, None], xf[tok], _zero(dtype, dev)),
        accumulate=True)
    y = _expert_ffn(buf, wg, wu, wd, dtype)
    w = (gates.reshape(-1) * keep).to(dtype)
    out = _combine(y[lec, pr] * w[:, None], t, k)
    if shared is not None:
        # every dp shard computes the same f-slice: pre-divide so the joint
        # psum over (dp, model) counts each f-slice exactly once
        out = out + _shared_ffn(xf, shared, dtype) / ep
    out = mesh.psum(out, tuple(dp_axes) + _model_axes(mesh))
    return out.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Replicated-experts layout (small MoEs / indivisible expert counts)
# ---------------------------------------------------------------------------


def _local_moe_replicated(x_blk, router, wg, wu, wd, shared, *,
                          cfg: ModelConfig, dp_axes, mesh: LiveMesh):
    e, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    b_loc, s, _ = x_blk.shape
    t_loc = b_loc * s
    xf = x_blk.reshape(t_loc, d)
    dtype, dev = x_blk.dtype, x_blk.device
    gates, idx, aux = _route(xf, router, cfg)
    flat_e = idx.reshape(-1)
    cap = moe_mod._capacity(t_loc, cfg)
    pos = moe_mod.ranks_within_groups(flat_e, e)
    keep = moe_mod.within_capacity(pos, cap)
    pc = torch.where(keep, pos, torch.zeros_like(pos))
    tok = torch.arange(t_loc, device=dev).repeat_interleave(k)
    buf = torch.zeros((e, cap, d), dtype=dtype, device=dev).index_put(
        (flat_e, pc), torch.where(keep[:, None], xf[tok], _zero(dtype, dev)),
        accumulate=True)
    y = _expert_ffn(buf, wg, wu, wd, dtype)
    w = (gates.reshape(-1) * keep).to(dtype)
    out = _combine(y[flat_e, pc] * w[:, None], t_loc, k)
    if shared is not None:
        out = out + _shared_ffn(xf, shared, dtype)
    if dp_axes:
        aux = mesh.psum(aux, dp_axes) / mesh.axis_size(dp_axes)
    return out.reshape(b_loc, s, d), aux


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


def _live_mesh(name: str) -> LiveMesh:
    mesh = shardctx.mesh()
    if not isinstance(mesh, LiveMesh):
        raise ValueError(f"{name} runs on this rank's LiveMesh "
                         "(spawn_mesh, or a mesh over a live process group); "
                         f"the active mesh is {mesh!r}")
    return mesh


def _layout(params: Params, cfg: ModelConfig, strategy: str, axes, mesh):
    """The local function of ``strategy`` for a batch split over ``axes``,
    the axes its ``aux`` is averaged over, and this rank's blocks of the
    expert and shared-expert weights."""
    dp = shardctx.dp_axes()
    if strategy == "ep_a2a":
        local = _local_moe_ep if axes else _local_moe_ep_bcast
        local_axes = dp
    else:
        local = _local_moe_replicated
        local_axes = axes
    wspecs, shared_specs = expert_specs(strategy, dp)
    wshapes, shared_shapes = _expert_shapes(cfg)
    ws = [_local(params[name], shape, spec, mesh)
          for name, shape, spec in zip(("w_gate", "w_up", "w_down"), wshapes,
                                       wspecs)]
    shared = params.get("shared")
    if shared is not None:
        shared = {name: _local(shared[name], shared_shapes[name],
                               shared_specs[name], mesh)
                  for name in ("w_gate", "w_up", "w_down")}
    return local, local_axes, ws, shared


def _out_adapter(out, lora, x, cfg):
    """The shared-path adapter, outside the map."""
    if lora is not None:
        la = lora["out_adapter"]
        adapt = torch.matmul(torch.matmul(x, la["a"].to(x.dtype)),
                             la["b"].to(x.dtype))
        out = out + cfg.lora.scale * adapt
    return out


def moe_forward_dist(params: Params, lora: Optional[Params], x: torch.Tensor,
                     cfg: ModelConfig, strategy: str
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed MoE layer on the active ``LiveMesh``. ``x``: the global
    ``(B, S, d)``, the same on every rank; returns the global output and
    ``aux``, the same on every rank."""
    mesh = _live_mesh("moe_forward_dist")
    axes = batch_axes(strategy, x.shape[0])
    if axes is None:
        # weights replicated anyway: the one-card path is already correct
        return moe_mod.moe_forward(params, lora, x, cfg)
    local, local_axes, ws, shared = _layout(params, cfg, strategy, axes, mesh)
    out, aux = local(mesh.enter(x, axes), params["router"], *ws, shared,
                     cfg=cfg, dp_axes=local_axes, mesh=mesh)
    out = mesh.leave(out, axes)
    aux = mesh.leave(aux, ())
    return _out_adapter(out, lora, x, cfg), aux.to(ACC_DTYPE)


def moe_forward_tp(params: Params, lora: Optional[Params], x: torch.Tensor,
                   cfg: ModelConfig, strategy: str,
                   batch: Optional[Tuple[str, ...]]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_forward_dist`` inside the tensor-parallel model, which split
    the batch at its input by the same guard: ``x`` is this rank's block of
    the batch over ``batch`` (the data axes, or None: the whole batch),
    replicated over "model", and so is the output; ``aux`` is the same on
    every rank. No ``enter``/``leave``: the model's own carry the
    transposes, and each layout's collectives keep ``LiveMesh``'s rule for
    the cotangents in between. Under ``replicated`` a batch the data and
    model axes both divide is split over "model" too, and gathered back."""
    mesh = _live_mesh("moe_forward_tp")
    shared = params.get("shared")
    # param_specs splits the shared expert by the dense MLP's rule (its
    # "replicated" case comes after that rule and is never reached): under
    # "replicated" it then runs as the dense MLP does, column- and
    # row-parallel on this rank's tokens, beside the routed experts
    tp_shared = (strategy == "replicated" and shared is not None
                 and tuple(shared["w_gate"].shape)
                 != _expert_shapes(cfg)[1]["w_gate"])
    if tp_shared:
        params = {k: v for k, v in params.items() if k != "shared"}
    axes = batch_axes(strategy, x.shape[0] * mesh.axis_size(batch))
    if axes is None:
        out, aux = moe_mod.moe_forward(
            params, None, x,
            dataclasses.replace(cfg, n_shared_experts=0) if tp_shared
            else cfg)
    else:
        local, local_axes, ws, blocks = _layout(params, cfg, strategy, axes,
                                                mesh)
        extra = tuple(a for a in axes if a not in (batch or ()))
        out, aux = local(mesh.split(x, extra, 0), params["router"], *ws,
                         blocks, cfg=cfg, dp_axes=local_axes, mesh=mesh)
        out = mesh.gather(out, extra, 0)
    if tp_shared:
        xf = x.reshape(-1, x.shape[-1])
        out = out + mesh.psum(_shared_ffn(xf, shared, x.dtype),
                              _model_axes(mesh)).reshape(out.shape)
    return _out_adapter(out, lora, x, cfg), aux.to(ACC_DTYPE)


# ---------------------------------------------------------------------------
# Initialisation by expert
# ---------------------------------------------------------------------------


def _expert_generator(seed: int, cfg: ModelConfig, slot: int, device):
    """The generator of one slot of a layer: the router (slot 0), expert
    ``e`` (slot ``e + 1``) or the shared expert (slot ``E + 1``)."""
    gen_dev = "cpu" if torch.device(device).type == "meta" else device
    return torch.Generator(device=gen_dev).manual_seed(
        int(seed) * (cfg.n_experts + 2) + slot)


def init_local_moe(seed: int, cfg: ModelConfig, dtype, mesh=None,
                   device=None) -> Params:
    """One MoE layer's frozen weights, each expert drawn from a generator
    seeded by (``seed``, expert), so that a rank draws its own block only
    and never holds the whole bank: with ``mesh`` (an active layout's
    mesh, ``strategy_for_mesh``), this rank's block of every expert weight
    under ``expert_specs``; without, the whole layer (the same values)."""
    from repro_torch.models.common import resolve_device
    device = resolve_device(device)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    strategy = strategy_for_mesh(cfg, mesh) if mesh is not None else None
    dp = tuple(a for a in mesh.axis_names if a in ("pod", "data")) \
        if mesh is not None else ()
    wspecs, shared_specs = expert_specs(strategy, dp)
    wshapes, _ = _expert_shapes(cfg)

    def normal(gen, shape, scale):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device) * scale

    def block(t, spec):          # spec without the expert dim
        return t if mesh is None else local_shard(t, P(*spec), mesh)

    router = normal(_expert_generator(seed, cfg, 0, device), (d, e),
                    1.0 / math.sqrt(d))
    first, count = 0, e
    if mesh is not None:
        count = shard_shape(wshapes[0], wspecs[0], mesh)[0]
        first = local_shard(torch.arange(e), P(wspecs[0][0]), mesh)[0].item()
    out = [None, None, None]
    for i, ex in enumerate(range(first, first + count)):
        gen = _expert_generator(seed, cfg, ex + 1, device)
        mats = (normal(gen, (d, f), 1.0 / math.sqrt(d)),
                normal(gen, (d, f), 1.0 / math.sqrt(d)),
                normal(gen, (f, d), 1.0 / math.sqrt(f)))
        for j, (m, spec) in enumerate(zip(mats, wspecs)):
            m = block(m, spec[1:]).to(dtype)
            if out[j] is None:
                out[j] = m.new_empty((count,) + tuple(m.shape))
            out[j][i].copy_(m)
    p: Params = {"router": router, "w_gate": out[0], "w_up": out[1],
                 "w_down": out[2]}
    if cfg.n_shared_experts:
        gen = _expert_generator(seed, cfg, e + 1, device)
        fs = f * cfg.n_shared_experts
        mats = {"w_gate": normal(gen, (d, fs), 1.0 / math.sqrt(d)),
                "w_up": normal(gen, (d, fs), 1.0 / math.sqrt(d)),
                "w_down": normal(gen, (fs, d), 1.0 / math.sqrt(fs))}
        p["shared"] = {name: block(m, shared_specs[name]).to(dtype).clone()
                       for name, m in mats.items()}
    return p
