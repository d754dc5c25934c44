"""Sharding rules: parameter tree -> partition-spec tree, per architecture.

The reference's rules, leaf for leaf: Megatron-style tensor parallelism on
the ``model`` axis, batch parallelism on ("pod", "data"), and 2-D (expert x
ffn) sharding of MoE expert weights so that trillion-parameter configs fit
one chip. Every rule is divisibility-guarded: a dim that its axis size does
not divide falls back (next candidate dim, then replication).

A spec is a :class:`P`: one entry per leading dim, each ``None``
(replicated), an axis name, or a tuple of axis names (the dim split over
those axes in their order, as ``NamedSharding`` splits it). In place of the
reference's ``to_named``/``attach`` (which hand specs to XLA), three
functions read a spec here: :func:`shard_shape` (one chip's block),
:func:`local_shard` (this rank's block of a full tensor on a ``LiveMesh``)
and :func:`bytes_per_chip`.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import data_axes

Params = Any


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("data",), None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + (tuple.__repr__(self) if len(self) != 1
                      else f"({self[0]!r})")


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= mesh.shape[a]
        return out
    return mesh.shape[axis]


def shard_dim_if(mesh, shape: Tuple[int, ...], *rules) -> P:
    """rules: (dim_index, axis). Apply each rule whose dim is divisible by
    the axis size; skip otherwise."""
    spec = [None] * len(shape)
    used = set()
    for dim, axis in rules:
        if axis is None:
            continue
        size = _axis_size(mesh, axis)
        names = axis if isinstance(axis, tuple) else (axis,)
        if any(n in used for n in names):
            continue
        if size > 1 and shape[dim] % size == 0 and spec[dim] is None:
            spec[dim] = axis
            used.update(names)
    return P(*spec)


def param_specs(cfg: ModelConfig, params: Params, mesh) -> Params:
    """Spec tree matching ``params`` structure ({"frozen","lora"})."""
    mdl = "model"
    dp = data_axes(mesh)
    moe_strategy = None
    if cfg.is_moe:
        from repro_torch.models.moe_shard_map import strategy_for_mesh
        moe_strategy = strategy_for_mesh(cfg, mesh)

    def frozen_leaf_spec(path: Tuple[str, ...], leaf) -> P:
        name = path[-1]
        shape = tuple(leaf.shape)
        stacked = path[0] == "layers"  # leading n_layers dim
        off = 1 if stacked else 0

        def sd(*rules) -> P:
            shifted = [(d + off, ax) for d, ax in rules]
            if stacked:
                shifted = [(0, None)] + shifted
            return shard_dim_if(mesh, shape, *shifted)

        # --- embeddings / head ------------------------------------------
        if name == "embed":
            return shard_dim_if(mesh, shape, (0, mdl), (1, mdl))
        if name == "head":
            return shard_dim_if(mesh, shape, (1, mdl), (0, mdl))
        # --- attention ----------------------------------------------------
        if name in ("wq", "wk", "wv"):
            return sd((1, mdl))
        if name == "wo":
            return sd((0, mdl))
        if name in ("bq", "bk", "bv"):
            return sd((0, mdl))
        # --- dense MLP ------------------------------------------------------
        if name in ("w_gate", "w_up") and len(shape) == 2 + off:
            return sd((1, mdl))
        if name == "w_down" and len(shape) == 2 + off:
            return sd((0, mdl))
        # --- MoE experts (layout must match moe_shard_map's strategy) -------
        if name in ("w_gate", "w_up") and len(shape) == 3 + off:
            if moe_strategy == "ep_a2a":
                return sd((0, dp), (2, mdl))       # E over EP, f over TP
            if moe_strategy == "replicated":
                return sd()
            return sd((0, mdl), (2, dp))           # the reference's GSPMD case
        if name == "w_down" and len(shape) == 3 + off:
            if moe_strategy == "ep_a2a":
                return sd((0, dp), (1, mdl))
            if moe_strategy == "replicated":
                return sd()
            return sd((0, mdl), (1, dp))
        if name == "router":
            return sd()                            # routing is replicated
        # shared expert (2-D mats named like the dense MLP): TP over f under
        # ep_a2a (moe_shard_map's shared spec); replicated otherwise
        if len(path) >= 2 and path[-2] == "shared" \
                and moe_strategy == "replicated":
            return sd()
        # --- mamba projections, norms, everything else: replicated ----------
        return sd()

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return frozen_leaf_spec(path, tree)

    frozen_specs = walk(params["frozen"])

    # LoRA: mirror the base matrix's output sharding where divisible
    def lora_walk(tree, path=()):
        if isinstance(tree, dict) and set(tree.keys()) == {"a", "b"}:
            base = path[-1]
            out_axis = mdl if base in ("wq", "wk", "wv", "w_gate", "w_up") \
                else None
            stacked_off = 1 if path[0] == "layers" else 0
            a_spec = P(*([None] * (stacked_off + 2)))
            b_shape = tuple(tree["b"].shape)
            rules = [(stacked_off + 1, out_axis)] if out_axis else []
            b_spec = shard_dim_if(mesh, b_shape,
                                  *([(0, None)] if stacked_off else []),
                                  *rules)
            return {"a": a_spec, "b": b_spec}
        if isinstance(tree, dict):
            return {k: lora_walk(v, path + (k,)) for k, v in tree.items()}
        return P(*([None] * tree.dim()))

    lora_specs = lora_walk(params["lora"])
    return {"frozen": frozen_specs, "lora": lora_specs}


def opt_state_specs(lora_specs: Params) -> Params:
    """AdamW m/v mirror the param specs; step is replicated."""
    return {"m": lora_specs, "v": lora_specs, "step": P()}


def batch_specs_for(cfg: ModelConfig, mesh, kind: str,
                    global_batch: int = 0, cut: int = 0) -> Dict[str, P]:
    dp = data_axes(mesh)
    if global_batch and global_batch % _axis_size(mesh, dp) != 0:
        dp = None  # e.g. long_500k: batch=1 cannot shard; TP-only
    if kind == "train" and cut > 0:
        return {"smashed": P(dp, None, None), "labels": P(dp, None)}
    if cfg.input_mode == "embeds":
        inputs = {"embeds": P(dp, None, None)}
    else:
        inputs = {"tokens": P(dp, None)}
    if kind == "train":
        inputs["labels"] = P(dp, None)
    return inputs


def cache_specs(cfg: ModelConfig, cache: Params, mesh, batch: int) -> Params:
    """Decode caches: KV sharded (batch -> data, slots -> model), the
    sequence-sharded KV layout for long-context decode; SSM state sharded
    (batch -> data, heads-or-headdim -> model)."""
    dp = data_axes(mesh)
    dp_or_none = dp if batch % _axis_size(mesh, dp) == 0 else None

    def leaf_spec(path, leaf):
        name = path[-1]
        shape = tuple(leaf.shape)  # leading n_layers dim
        if name in ("k", "v", "k_scale", "v_scale"):
            return shard_dim_if(mesh, shape, (1, dp_or_none), (2, "model"))
        if name == "h":      # (L, B, nh, hp, ns)
            return shard_dim_if(mesh, shape, (1, dp_or_none), (2, "model"),
                                (3, "model"))
        if name == "conv":   # (L, B, W-1, ch)
            return shard_dim_if(mesh, shape, (1, dp_or_none), (3, "model"))
        return P(*([None] * len(shape)))

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return leaf_spec(path, tree)

    return walk(cache)


def slot_range(cfg: ModelConfig, mesh, slots: int, batch: int
               ) -> Tuple[int, int]:
    """This rank's global slot range ``[lo, hi)`` of a decode cache of
    ``slots`` slots and ``batch`` rows on the ``LiveMesh`` ``mesh``, by
    ``cache_specs``: a block over "model" where the axis divides the
    slots, else every slot (the cache replicated over "model")."""
    kv = _Shape((1, batch, slots, cfg.n_kv_heads, cfg.resolved_head_dim))
    spec = cache_specs(cfg, {"kv": {"k": kv}}, mesh, batch)["kv"]["k"]
    n = slots // _axis_size(mesh, spec[2])
    lo = mesh.axis_index(spec[2]) * n if spec[2] is not None else 0
    return lo, lo + n


# ---------------------------------------------------------------------------
# Reading a spec
# ---------------------------------------------------------------------------


def shard_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """One chip's block of a ``shape`` laid out by ``spec`` on ``mesh``."""
    shape = tuple(int(s) for s in shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than {shape} dims")
    out = list(shape)
    for dim, axis in enumerate(spec):
        n = _axis_size(mesh, axis)
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {shape} does not split over "
                             f"{axis} ({n} chips)")
        out[dim] //= n
    return tuple(out)


def local_shard(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` (a view) on a
    ``LiveMesh``: a dim split over a tuple of axes takes the block at the
    rank's row-major coordinate over those axes, in their order."""
    block = shard_shape(t.shape, spec, mesh)
    for dim, axis in enumerate(spec):
        if axis is not None and block[dim] != t.shape[dim]:
            t = t.narrow(dim, mesh.axis_index(axis) * block[dim], block[dim])
    return t


def _leaves_with_specs(tree, specs):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_specs(v, specs[k])
    else:
        yield tree, specs


def bytes_per_chip(tree: Params, specs: Params, mesh) -> int:
    """Bytes of ``tree`` one chip holds when each leaf is laid out by its
    spec (leaves: tensors, ``meta`` ones included)."""
    total = 0
    for leaf, spec in _leaves_with_specs(tree, specs):
        n = 1
        for s in shard_shape(leaf.shape, spec, mesh):
            n *= s
        total += n * leaf.element_size()
    return total


def shard_params(params: Params, specs: Params, mesh) -> Params:
    """Each leaf of ``params`` (the global values) cut to this rank's block
    of its spec on the ``LiveMesh`` ``mesh`` (``param_specs``), a copy that
    owns its storage: the rank holds its blocks and nothing of the rest.
    These are the per-rank parameters the tensor-parallel model code takes
    under ``shardctx.mesh_ctx(mesh)``."""
    return _map_with_specs(
        lambda t, spec: local_shard(t, spec, mesh).clone(), params, specs)


def _map_with_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


class _Shape:
    """A leaf's shape and nothing else (what the spec rules read)."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def dim(self) -> int:
        return len(self.shape)


#: the adapters whose B ``param_specs`` splits with the base's columns, and
#: the config's width of those columns
_COLUMN_OUT = {"wq": "q_dim", "wk": "kv_dim", "wv": "kv_dim", "w_gate": "d_ff",
               "w_up": "d_ff"}


def _per_row(path, leaf) -> bool:
    """A leaf of a per-row adapter bank (serving: one pair a request row,
    ``engine.AdapterBank.gather``): ``(L, B, K, r)`` / ``(L, B, r, N)``."""
    return path[0] == "layers" and len(leaf.shape) == 4


def lora_specs(cfg: ModelConfig, lora: Params, mesh) -> Params:
    """``param_specs``' specs of the adapters, from the adapter tree as
    given (whole, or this rank's blocks: a column-parallel B's whole width
    is the config's), without making a tensor: a step can ask inside a
    traced call. A per-row bank (leaves ``(L, B, ...)``, given with its
    whole batch) takes its pair's spec shifted by one dim, and its batch
    dim goes over the data axes where they divide it (the model's own
    guard on the batch, ``shardctx.guarded_spec``)."""
    def shapes(tree, path=()):
        if isinstance(tree, dict):
            return {k: shapes(v, path + (k,)) for k, v in tree.items()}
        shape = list(tree.shape)
        if _per_row(path, tree):
            del shape[1]
        if path[-1] == "b" and path[-2] in _COLUMN_OUT:
            shape[-1] = getattr(cfg, _COLUMN_OUT[path[-2]])
        return _Shape(shape)
    specs = param_specs(cfg, {"frozen": {}, "lora": shapes(lora)},
                        mesh)["lora"]
    dp = data_axes(mesh)

    def batched(tree, spec, path=()):
        if isinstance(tree, dict):
            return {k: batched(v, spec[k], path + (k,))
                    for k, v in tree.items()}
        if not _per_row(path, tree):
            return spec
        n = _axis_size(mesh, dp)
        axis = dp if n > 1 and tree.shape[1] % n == 0 else None
        return P(spec[0], axis, *spec[1:])
    return batched(lora, specs)


def replicated_axes(spec: P, mesh) -> Tuple[str, ...]:
    """The mesh axes a leaf laid out by ``spec`` is replicated over, in
    mesh order."""
    used = set()
    for axis in spec:
        if axis is not None:
            used.update(axis if isinstance(axis, tuple) else (axis,))
    return tuple(a for a in mesh.axis_names if a not in used)


def reduce_grads(grads: Params, specs: Params, mesh) -> Params:
    """The gradients of this rank's parameter blocks, from each rank's own
    (a partial sum: ``LiveMesh``'s rule for replicated values): each leaf
    summed over the axes its spec replicates it over. The leaves that share
    those axes go in one all-reduce."""
    import torch.distributed as dist
    leaves = list(_leaves_with_specs(grads, specs))
    buckets: Dict[Tuple[str, ...], list] = {}
    for i, (g, spec) in enumerate(leaves):
        axes = replicated_axes(spec, mesh)
        if mesh.axis_size(axes) > 1:
            buckets.setdefault(axes, []).append(i)
    out = [g for g, _ in leaves]
    for axes, idx in buckets.items():
        dtypes = {out[i].dtype for i in idx}
        for dtype in sorted(dtypes, key=str):
            part = [i for i in idx if out[i].dtype == dtype]
            flat = torch.cat([out[i].reshape(-1) for i in part])
            dist.all_reduce(flat, group=mesh.group(axes))
            start = 0
            for i in part:
                n = out[i].numel()
                out[i] = flat[start:start + n].view_as(out[i])
                start += n
    it = iter(out)
    return _map_with_specs(lambda _g, _s: next(it), grads, specs)
