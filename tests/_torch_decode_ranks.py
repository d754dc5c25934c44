"""What each rank of ``tests/test_torch_sharded_decode.py``'s meshes runs.

A module of its own, importing torch and the port only: ``spawn_mesh``'s
ranks import it by name, and would import JAX with the test module.
"""
import torch

from repro_torch import shardctx
from repro_torch.convert import from_numpy_tree
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import LiveMesh
from repro_torch.models import model as M
from repro_torch.models.common import tree_map


def _numpy(tree):
    return tree_map(lambda v: v.detach().numpy(), tree)


def decode_case(mesh, cfg, case):
    """``case``'s decode steps on this rank: the parameters (and the
    per-row adapter banks, if any) cut to its blocks, the cache to its
    block under ``cache_specs``; ``make_serve_step`` (the plain route) and,
    with banks, ``decode_step(use_lora_kernel=True)`` on a copy of the same
    cache. Returns each step's logits, the final cache block and its
    specs."""
    from repro_torch.launch.serve import make_serve_step
    full = from_numpy_tree(case["params"], "cpu")
    local = shd.shard_params(full, shd.param_specs(cfg, full, mesh), mesh)
    lora = local["lora"]
    if case.get("banks") is not None:
        banks = from_numpy_tree(case["banks"], "cpu")
        lora = shd.shard_params(banks, shd.lora_specs(cfg, banks, mesh),
                                mesh)
    whole = from_numpy_tree(case["cache"], "cpu")
    batch = case["steps"][0][0].shape[0]
    cspecs = shd.cache_specs(cfg, whole, mesh, batch)
    routes = ["plain"] + (["kernel"] if case.get("banks") is not None
                          else [])
    out = {"coords": mesh.coords,
           "cache_specs": shd._map_with_specs(lambda _c, s: list(s), whole,
                                              cspecs)}
    for route in routes:
        cache = shd.shard_params(whole, cspecs, mesh)
        step = make_serve_step(cfg, device="cpu", slots=case.get("slots"))
        logits = []
        with shardctx.mesh_ctx(mesh), torch.no_grad():
            for inputs, t in case["steps"]:
                inputs = torch.as_tensor(inputs)
                if route == "plain":
                    y, cache = step(local["frozen"], lora, cache, inputs, t)
                else:
                    y, cache = M.decode_step(local["frozen"], lora, cache,
                                             inputs, t, cfg,
                                             use_lora_kernel=True,
                                             slots=case.get("slots"))
                logits.append(y.numpy())
        out[route] = {"logits": logits, "cache": _numpy(cache)}
    return out


def decode_cases(mesh, jobs):
    """For each (mesh shape, case name, cfg, case) of ``jobs``, that mesh
    over these ranks and ``decode_case`` on it."""
    out = {}
    for shape, name, cfg, case in jobs:
        m = mesh if tuple(shape) == mesh.sizes else LiveMesh.build(
            shape, ("data", "model"), mesh.device)
        out[(tuple(shape), name)] = decode_case(m, cfg, case)
    return out


def row_parallel_bank(mesh, x, w, a, b, scale):
    """``row_parallel_dense`` of a per-row bank on this rank: ``x``'s and
    ``w``'s blocks along ``K`` over "model", the bank whole."""
    from repro_torch.models.common import TensorParallel, row_parallel_dense
    tp = TensorParallel(mesh, None)
    k = w.shape[0] // tp.size
    xs = torch.as_tensor(x).narrow(-1, tp.index * k, k)
    ws = torch.as_tensor(w).narrow(0, tp.index * k, k)
    lora = {"a": torch.as_tensor(a), "b": torch.as_tensor(b)}
    return row_parallel_dense(xs, ws, lora, scale, tp).numpy()
