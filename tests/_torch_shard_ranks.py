"""What each rank of ``tests/test_torch_moe_shard_map.py``'s mesh runs.

A module of its own, importing torch and the port only: ``spawn_mesh``'s
ranks import it by name, and would import JAX with the test module.
"""
import dataclasses

import torch

from repro_torch import shardctx
from repro_torch.configs.base import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.models import moe as moe_mod
from repro_torch.models import moe_shard_map as msm

AUX_WEIGHT = 10.0      # the test loss: sum(out * R) + AUX_WEIGHT * aux


def case_config(case):
    """The kimi-reduced variant of the reference's system test."""
    return dataclasses.replace(
        get_config("kimi-k2-1t-a32b").reduced(), n_experts=case["experts"],
        top_k=2, d_ff=32, d_model=64, n_shared_experts=1,
        capacity_factor=case["cf"])


class RanksLog:
    """While open, records each ``ranks_within_groups`` call's
    ``(n_groups, groups, ranks)``: the within-group ranks that every drop
    mask compares with a capacity."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self._orig = moe_mod.ranks_within_groups

        def spy(groups, n_groups):
            ranks = self._orig(groups, n_groups)
            self.calls.append((n_groups, groups.numpy(), ranks.numpy()))
            return ranks
        moe_mod.ranks_within_groups = spy
        return self

    def __exit__(self, *exc):
        moe_mod.ranks_within_groups = self._orig
        return False


def run_cases(mesh, cases, inputs):
    """Every case on this rank: the strategy, the forward's ranks log, and
    the output, ``aux`` and the loss's gradients w.r.t. x and the adapter."""
    out = {}
    for name, case in cases.items():
        cfg = case_config(case)
        data = inputs[name]
        params = from_numpy_tree(data["params"], "cpu")
        x = from_numpy_tree(data["x"], "cpu").requires_grad_()
        r = from_numpy_tree(data["r"], "cpu")
        lora = None
        if "lora" in data:
            lora = {"out_adapter": {
                k: v.requires_grad_() for k, v in from_numpy_tree(
                    data["lora"]["out_adapter"], "cpu").items()}}
        with shardctx.mesh_ctx(mesh):
            strategy = msm.select_strategy(cfg)
            with RanksLog() as log:
                msm.moe_forward_dist(params, lora, x.detach(), cfg, strategy)
            y, aux = msm.moe_forward_dist(params, lora, x, cfg, strategy)
            loss = (y * r).sum() + AUX_WEIGHT * aux
            wrt = [x] + ([lora["out_adapter"]["a"], lora["out_adapter"]["b"]]
                         if lora is not None else [])
            grads = torch.autograd.grad(loss, wrt)
        res = {"strategy": strategy, "coords": mesh.coords,
               "ranks_log": log.calls, "out": y.detach().numpy(),
               "aux": aux.detach().numpy(), "grad_x": grads[0].numpy()}
        if lora is not None:
            res["grad_a"], res["grad_b"] = (g.numpy() for g in grads[1:])
        out[name] = res
    return out


# ---------------------------------------------------------------------------
# Tensor-parallel model steps (tests/test_torch_tensor_parallel.py)
# ---------------------------------------------------------------------------


def _capturing_optimizer(store):
    """An optimizer whose update keeps the gradients it is handed and
    changes nothing: ``make_train_step``'s gradients, reduced as the step
    reduces them."""
    from repro_torch.models.common import tree_map
    from repro_torch.optim import Optimizer

    def update(grads, state, params):
        store.append(grads)
        return tree_map(torch.zeros_like, params), state
    return Optimizer(init=lambda params: {}, update=update)


def tp_step(mesh, cfg, params, batch, impl="chunked"):
    """The prefill step's logits and one train step's loss and gradients on
    this rank (``mesh``: a ``LiveMesh``), from the global ``params``
    (numpy) cut to this rank's blocks; gradients as this rank's blocks."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.common import tree_map
    full = from_numpy_tree(params, "cpu")
    specs = shd.param_specs(cfg, full, mesh)
    local = shd.shard_params(full, specs, mesh)
    grads = []
    step = make_train_step(cfg, _capturing_optimizer(grads), impl=impl)
    prefill = make_prefill_step(cfg, impl=impl, device="cpu")
    tokens = torch.as_tensor(batch["tokens"])
    with shardctx.mesh_ctx(mesh):
        logits = prefill(local["frozen"], local["lora"], tokens)
        loss, _, _ = step(local["frozen"], local["lora"], {}, batch)
    return {"coords": mesh.coords, "logits": logits.numpy(),
            "loss": float(loss),
            "grads": tree_map(lambda g: g.detach().numpy(), grads[0]),
            "lora_specs": shd._map_with_specs(
                lambda _leaf, spec: list(spec), local["lora"],
                shd.lora_specs(cfg, local["lora"], mesh))}


def tp_cases(mesh, jobs):
    """For each (mesh shape, case name, cfg, params, batch) of ``jobs``,
    that mesh over these ranks and ``tp_step`` on it."""
    from repro_torch.launch.mesh import LiveMesh
    out = {}
    for shape, name, cfg, params, batch in jobs:
        m = mesh if tuple(shape) == mesh.sizes else LiveMesh.build(
            shape, ("data", "model"), mesh.device)
        out[(tuple(shape), name)] = tp_step(m, cfg, params, batch)
    return out


def traced_counts(mesh, cfg, shape):
    """``analyze_sharded_step`` of the dry run's step (``build_step``) on
    this rank's real CPU blocks: FLOPs, HBM and peak bytes, collectives."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.analysis import analyze_sharded_step
    step, args = dryrun.build_step(cfg, shape, device="cpu", mesh=mesh)
    roof, coll, mem = analyze_sharded_step(step, *args, mesh=mesh)
    return {"flops": roof.flops, "hbm_bytes": roof.hbm_bytes,
            "counts": coll.counts, "bytes_by_kind": coll.bytes_by_kind,
            "peak_bytes": mem["peak_bytes"]}
