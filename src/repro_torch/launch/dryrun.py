"""Dry run: trace every (architecture x input shape) step program on the
``meta`` device at full published width — nothing allocated, nothing
computed — and record its FLOPs, HBM bytes, argument / output / peak bytes
and roofline terms against one NVIDIA H100.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each combo onto a forced 512-device host mesh and reads XLA's cost
and memory analyses. Here one card is the mesh (``"mesh": "1"``, the
default): the step's parameters, optimizer state, cache and batch are
``meta`` tensors
(``models.model.abstract_params``, ``data.batch_specs``,
``models.model.init_cache(..., device="meta")``) and ``launch.analysis``
counts the aten ops of one traced call. A record holds the whole global
batch of its ``InputShape`` (the reference's holds one chip's share) and
says whether its peak ``fits`` one H100's 80 GB. The whole matrix of 40
combos runs on the CPU too (``--all``; seconds a combo, no allocation).
``chip_smoke.py --only dryrun`` runs it and holds the records against the
same steps run on the card.

On the production meshes (``mesh="16x16"``, or ``multi_pod=True`` for
``"2x16x16"``; ``--mesh both|multi``) a record holds the per-chip bytes of
the step's arguments under ``launch/sharding.py``'s specs (``param_specs``,
``opt_state_specs``, ``batch_specs_for``, ``cache_specs``), the
counterpart of the argument bytes in XLA's memory analysis, and whether
they ``fit`` one H100. Every step is also traced there (``"traced":
true``): the process joins a ``fake`` process group of 256 or 512 ranks as
rank 0, builds its ``LiveMesh`` on ``meta``, and runs the tensor-parallel
step (``models/model.py``) on that rank's blocks of the parameters and,
for a decode step, of the cache (``cache_specs``: KV slots over "model",
the softmax combined across ranks), so the record has one chip's FLOPs,
HBM bytes, peak bytes and collectives (``analysis.analyze_sharded_step``),
with the depth-1/depth-2 probe pair as on one chip, the layout of the
attention heads (``attention.tp_layout``) and the one-chip FLOPs beside
them. The group is torn down after each record.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses as _dc
import json
import math
import sys
import time
import traceback
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                      ModelConfig, get_config,
                                      long_context_variant)
from repro_torch.core.hardware import H100_HBM_BYTES
from repro_torch.data.pipeline import batch_specs
from repro_torch.launch import sharding as shd
from repro_torch.launch.analysis import (Roofline, analyze_sharded_step,
                                         analyze_step, model_flops)
from repro_torch.launch.mesh import LiveMesh, data_axes, make_abstract_mesh
from repro_torch.launch.serve import make_prefill_step, make_serve_step
from repro_torch.launch.train import make_train_step
from repro_torch.models import model as model_lib
from repro_torch.models.moe_shard_map import strategy_for_mesh
from repro_torch.optim import adamw, constant_schedule

DRYRUN_ARCHS = tuple(a for a in ARCH_IDS if a != "llama32-1b")
META = "meta"
# the reference's production meshes, by the name a record carries
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
TRACED_KINDS = ("train", "prefill", "decode")   # traced on the meshes


def combo_config(arch: str, shape_name: str) -> Optional[ModelConfig]:
    """Config for (arch, shape): ``long_500k`` runs the long-context
    variant (SWA for attention archs, the native config for SSMs)."""
    cfg = get_config(arch)
    if shape_name == "long_500k":
        return long_context_variant(cfg)
    return cfg


def build_step(cfg: ModelConfig, shape: InputShape, *, cut: int = 0,
               microbatches: int = 1, remat: bool = True, device=META,
               mesh=None):
    """One step program of the reference's dry run and its arguments on
    ``device`` (``meta``: shapes only): ``(step, args)``.

      * train: ``make_train_step`` (AdamW at 1e-4) over the LoRA tree's
        optimizer state and ``batch_specs(cfg, shape, cut)``;
      * prefill: ``make_prefill_step`` (chunked attention) on the tokens or
        embeds;
      * decode: ``make_serve_step`` (the naive decode) on one token against
        a cache of ``seq_len`` at ``t = seq_len - 1``. The reference lowers
        ``t`` as an abstract scalar; on ``meta`` only shapes matter.

    None of the three reaches a kernel, as in the reference. For a ``cuda``
    device the parameters are drawn from seed 0 and the inputs are zeros
    (the card check runs these same programs). With ``mesh`` (a
    ``LiveMesh``) the parameters are this rank's blocks
    (``sharding.shard_params``) and the batch the global one; the step runs
    tensor-parallel under ``shardctx.mesh_ctx(mesh)``; a decode step's
    cache is the rank's block under ``sharding.cache_specs``."""
    import torch
    params = model_lib.init_params(0, cfg, device=device)
    if mesh is not None:
        params = shd.shard_params(params, shd.param_specs(cfg, params, mesh),
                                  mesh)
    key = "embeds" if cfg.input_mode == "embeds" else "tokens"
    specs = batch_specs(cfg, shape, cut if shape.kind == "train" else 0)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
             for k, v in specs.items()}
    if shape.kind == "train":
        optimizer = adamw(constant_schedule(1e-4))
        opt_state = optimizer.init(params["lora"])
        step = make_train_step(cfg, optimizer, cut=cut,
                               microbatches=microbatches, remat=remat)
        return step, (params["frozen"], params["lora"], opt_state, batch)
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, device=device)
        return step, (params["frozen"], params["lora"], batch[key])
    cache = model_lib.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device=device)
    slots = None
    if mesh is not None:
        cspecs = shd.cache_specs(cfg, cache, mesh, shape.global_batch)
        if "kv" in cache:
            slots = cache["kv"]["k"].shape[2]
        cache = shd.shard_params(cache, cspecs, mesh)
    step = make_serve_step(cfg, device=device, slots=slots)
    return step, (params["frozen"], params["lora"], cache, batch[key],
                  shape.seq_len - 1)


def _cost_triple(cfg, shape, *, remat, mesh=None) -> Dict:
    step, args = build_step(cfg, shape, remat=remat, mesh=mesh)
    if mesh is None:
        roof, coll, _mem = analyze_step(step, *args)
    else:
        roof, coll, _mem = analyze_sharded_step(step, *args, mesh=mesh)
    return {"flops": roof.flops, "hbm_bytes": roof.hbm_bytes,
            "collective_bytes": float(coll.total_bytes),
            "counts": coll.counts, "bytes_by_kind": coll.bytes_by_kind}


def _probe_pair(cfg, shape, *, remat, mesh=None):
    """The depth-1 and depth-2 costs of the step, and a function that
    extrapolates a key of them to ``L`` layers:
    term(L) = term(1) + (L - 1) * (term(2) - term(1))."""
    p1, p2 = (_cost_triple(_dc.replace(cfg, n_layers=depth), shape,
                           remat=remat, mesh=mesh) for depth in (1, 2))

    def extrap(L, get):
        return get(p1) + (L - 1) * (get(p2) - get(p1))
    return p1, p2, extrap


def sharded_arguments(cfg: ModelConfig, shape: InputShape, mesh, *,
                      cut: int = 0) -> Dict[str, int]:
    """Per-chip bytes of each argument of the step program on ``mesh`` (an
    ``AbstractMesh``), each leaf laid out by its spec; the step's
    arguments are ``build_step``'s, on ``meta``."""
    import torch
    params = model_lib.abstract_params(cfg)
    pspecs = shd.param_specs(cfg, params, mesh)
    key = "embeds" if cfg.input_mode == "embeds" else "tokens"
    batch = batch_specs(cfg, shape, cut if shape.kind == "train" else 0)
    bspecs = shd.batch_specs_for(cfg, mesh, shape.kind, shape.global_batch,
                                 cut if shape.kind == "train" else 0)
    out = {"frozen": shd.bytes_per_chip(params["frozen"], pspecs["frozen"],
                                        mesh),
           "lora": shd.bytes_per_chip(params["lora"], pspecs["lora"], mesh)}
    if shape.kind == "train":
        opt_state = adamw(constant_schedule(1e-4)).init(params["lora"])
        out["opt_state"] = shd.bytes_per_chip(
            opt_state, shd.opt_state_specs(pspecs["lora"]), mesh)
        out["batch"] = shd.bytes_per_chip(batch, bspecs, mesh)
        return out
    out["inputs"] = shd.bytes_per_chip({key: batch[key]},
                                       {key: bspecs[key]}, mesh)
    if shape.kind == "decode":
        cache = model_lib.init_cache(cfg, shape.global_batch, shape.seq_len,
                                     device=META)
        out["cache"] = shd.bytes_per_chip(
            cache, shd.cache_specs(cfg, cache, mesh, shape.global_batch),
            mesh)
        out["t"] = torch.empty((), dtype=torch.int32).element_size()
    return out


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
                mesh: Optional[str] = None,
                cut: int = 0, compile_: bool = True, unroll: bool = False,
                roofline_probe: bool = True, microbatches: int = 1,
                remat: bool = True, capacity_factor: float = 0.0,
                kv_int8: bool = False,
                batch: Optional[int] = None,
                layers: Optional[int] = None) -> Dict:
    """Full-depth trace (peak memory, raw counts) plus a depth-1/depth-2
    probe pair for the roofline terms, as in the reference:

      term(L) = term(1) + (L - 1) * (term(2) - term(1))

    The reference needs the pair because XLA counts a scan body once; the
    port's layer loop is unrolled, so its full-depth counts are exact and
    the extrapolated terms must agree with them for a uniform layer stack
    (``raw_scan_costs`` holds the full-depth ones). ``compile_=False``
    traces the step without counting. ``batch`` replaces the shape's global
    batch and ``layers`` the config's depth (the card check's cuts; the
    record lists them under ``reduced``).

    ``mesh``: ``"1"`` (one H100, the default) or a production mesh,
    ``"16x16"`` or ``"2x16x16"`` (``multi_pod=True``): then the record has
    :func:`sharded_arguments`'s per-chip bytes and, unless
    ``compile_=False``, one rank's trace on a fake process group (module
    docstring)."""
    name = mesh or ("2x16x16" if multi_pod else "1")
    if multi_pod and name != "2x16x16":
        raise ValueError(f"multi_pod=True is the 2x16x16 mesh, not {name!r}")
    if name != "1" and name not in MESHES:
        raise ValueError(f"mesh {name!r}: one of '1', {sorted(MESHES)}")
    cfg = combo_config(arch, shape_name)
    if capacity_factor:
        cfg = _dc.replace(cfg, capacity_factor=capacity_factor)
    if kv_int8:
        cfg = _dc.replace(cfg, kv_cache_dtype="int8")
    shape = INPUT_SHAPES[shape_name]
    reduced = {}
    if batch is not None and batch != shape.global_batch:
        reduced["global_batch"] = [shape.global_batch, batch]
        shape = _dc.replace(shape, global_batch=batch)
    if layers is not None and layers != cfg.n_layers:
        reduced["n_layers"] = [cfg.n_layers, layers]
        cfg = _dc.replace(cfg, n_layers=layers)
    if name != "1":
        return _sharded_record(cfg, shape, name, arch=arch,
                               shape_name=shape_name, cut=cut, unroll=unroll,
                               microbatches=microbatches, remat=remat,
                               capacity_factor=capacity_factor,
                               kv_int8=kv_int8, reduced=reduced,
                               compile_=compile_,
                               roofline_probe=roofline_probe)
    chips = 1
    rec: Dict = {"arch": arch, "shape": shape_name, "unroll": unroll,
                 "mesh": "1", "chips": chips, "device": META,
                 "cut": cut, "microbatches": microbatches, "remat": remat,
                 "capacity_factor": capacity_factor or None,
                 "kv_int8": kv_int8, "ok": False}
    if reduced:
        rec["reduced"] = reduced

    t0 = time.time()
    step, args = build_step(cfg, shape, cut=cut, microbatches=microbatches,
                            remat=remat)
    if not compile_:
        step(*args)
        rec["lower_compile_s"] = round(time.time() - t0, 1)
        rec["ok"] = True
        return rec
    roof_raw, coll_raw, mem = analyze_step(step, *args, chips=chips)
    del step, args
    rec["lower_compile_s"] = round(time.time() - t0, 1)
    rec["memory"] = mem
    rec["fits"] = mem["peak_bytes"] <= H100_HBM_BYTES
    rec["raw_scan_costs"] = {"flops": roof_raw.flops,
                             "hbm_bytes": roof_raw.hbm_bytes,
                             "collective_bytes": float(coll_raw.total_bytes)}

    n_layers_eff = cfg.n_layers - cut
    if roofline_probe and not unroll and n_layers_eff >= 2:
        t1 = time.time()
        # probes run microbatches=1 and cut=0: total FLOPs/bytes per step
        # are mb-invariant (only the peak changes, and that comes from the
        # full-depth trace)
        p1, p2, extrap = _probe_pair(cfg, shape, remat=remat)
        rec["probe_s"] = round(time.time() - t1, 1)
        roof, rec["collectives"] = _extrapolated(p1, p2, extrap,
                                                 n_layers_eff, chips)
    else:
        roof = roof_raw
        rec["collectives"] = {"counts": coll_raw.counts,
                              "bytes_by_kind": coll_raw.bytes_by_kind,
                              "total_bytes": float(coll_raw.total_bytes)}

    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mf = model_flops(cfg, tokens,
                     "train" if shape.kind == "train" else "inference")
    rec.update({
        "ok": True,
        "roofline": {**roof.as_dict(), "bound_s": roof.bound_s},
        "model_flops_global": mf,
        "model_flops_per_chip": mf / chips,
        "useful_flops_ratio": (mf / chips) / roof.flops if roof.flops else None,
        "tokens": tokens,
    })
    return rec


def _extrapolated(p1, p2, extrap, L: int, chips: int):
    """The roofline and the collectives of ``L`` layers from a probe pair."""
    kinds = set(p1["counts"]) | set(p2["counts"])
    coll_b = extrap(L, lambda p: p["collective_bytes"])
    roof = Roofline(flops=extrap(L, lambda p: p["flops"]),
                    hbm_bytes=extrap(L, lambda p: p["hbm_bytes"]),
                    collective_bytes=coll_b, chips=chips)
    coll = {"counts": {k: extrap(L, lambda p: p["counts"].get(k, 0))
                       for k in kinds},
            "bytes_by_kind": {k: extrap(L, lambda p: p["bytes_by_kind"]
                                        .get(k, 0)) for k in kinds},
            "total_bytes": coll_b,
            "per_layer_bytes": p2["collective_bytes"]
            - p1["collective_bytes"]}
    return roof, coll


@contextlib.contextmanager
def fake_mesh(shape, axes):
    """This process as rank 0 of a ``fake`` process group of
    ``prod(shape)`` ranks (collectives are recorded, nothing moves), and
    its ``LiveMesh`` on ``meta``; the group is destroyed on exit."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "traced sharded dry run joins a fake one of its "
                           "own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield LiveMesh.build(shape, axes, torch.device(META))
    finally:
        dist.destroy_process_group()


def _batch_bytes(cfg, shape, mesh, cut) -> Tuple[int, int]:
    """(bytes of the global batch, of this rank's block of it)."""
    kind_cut = cut if shape.kind == "train" else 0
    batch = batch_specs(cfg, shape, kind_cut)
    if shape.kind == "prefill":
        key = "embeds" if cfg.input_mode == "embeds" else "tokens"
        batch = {key: batch[key]}
    specs = shd.batch_specs_for(cfg, mesh, shape.kind, shape.global_batch,
                                kind_cut)
    whole = sum(v.numel() * v.element_size() for v in batch.values())
    return whole, shd.bytes_per_chip(batch, {k: specs[k] for k in batch},
                                     mesh)


def _traced(cfg: ModelConfig, shape: InputShape, name: str, *, cut: int,
            microbatches: int, remat: bool, roofline_probe: bool,
            unroll: bool) -> Dict:
    """One rank's trace of the tensor-parallel step on the mesh ``name``:
    the full-depth peak, the probe pair's roofline and collectives, and
    the one-chip probe pair's FLOPs beside them. Every rank receives the
    global batch and keeps its block; the memory counts the block (the
    peak less the rest of the batch, live from the start to the end)."""
    from repro_torch.models import attention
    out: Dict = {}
    with fake_mesh(*MESHES[name]) as mesh:
        t0 = time.time()
        step, args = build_step(cfg, shape, cut=cut,
                                microbatches=microbatches, remat=remat,
                                mesh=mesh)
        roof_raw, coll_raw, mem = analyze_sharded_step(step, *args, mesh=mesh)
        del step, args
        whole, block = _batch_bytes(cfg, shape, mesh, cut)
        for key in ("argument_bytes", "peak_bytes"):
            mem[key] -= whole - block
        out["trace_s"] = round(time.time() - t0, 1)
        out["memory"] = mem
        out["raw_scan_costs"] = {
            "flops": roof_raw.flops, "hbm_bytes": roof_raw.hbm_bytes,
            "collective_bytes": float(coll_raw.total_bytes),
            "counts": coll_raw.counts, "bytes_by_kind": coll_raw.bytes_by_kind}
        L = cfg.n_layers - cut
        if roofline_probe and not unroll and L >= 2:
            t1 = time.time()
            p1, p2, extrap = _probe_pair(cfg, shape, remat=remat, mesh=mesh)
            roof, out["collectives"] = _extrapolated(p1, p2, extrap, L,
                                                     mesh.size)
            out["probe_s"] = round(time.time() - t1, 1)
        else:
            roof = roof_raw
            out["collectives"] = {
                "counts": coll_raw.counts,
                "bytes_by_kind": coll_raw.bytes_by_kind,
                "total_bytes": float(coll_raw.total_bytes),
                "per_layer_bytes": None}
        out["roofline"] = {**roof.as_dict(), "bound_s": roof.bound_s}
        if not cfg.is_attention_free:
            out["heads"] = attention.tp_layout(cfg, mesh.shape["model"])
        dp = data_axes(mesh)
        out["batch_split"] = (list(dp) if shape.global_batch
                              % mesh.axis_size(dp) == 0 else None)
    if roofline_probe and not unroll and L >= 2:
        _, _, one = _probe_pair(cfg, shape, remat=remat)
        flops_one = one(L, lambda p: p["flops"])
    else:
        flops_one = _cost_triple(cfg, shape, remat=remat)["flops"]
    out["flops_one_chip"] = flops_one
    out["flops_x_chips_over_one_chip"] = (roof.flops * mesh.size / flops_one
                                          if flops_one else None)
    return out


def _sharded_record(cfg: ModelConfig, shape: InputShape, name: str, *,
                    arch: str, shape_name: str, cut: int, reduced,
                    **flags) -> Dict:
    t0 = time.time()
    mesh = make_abstract_mesh(*MESHES[name])
    by_arg = sharded_arguments(cfg, shape, mesh, cut=cut)
    total = sum(by_arg.values())
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": name,
                 "chips": mesh.size, "device": META, "cut": cut, **flags,
                 "capacity_factor": flags["capacity_factor"] or None,
                 "moe_strategy": strategy_for_mesh(cfg, mesh),
                 "memory": {"argument_bytes_per_chip": total,
                            "argument_bytes_per_chip_by_argument": by_arg},
                 "fits": total <= H100_HBM_BYTES,
                 "traced": False, "roofline": None, "tokens": tokens,
                 "model_flops_global": model_flops(
                     cfg, tokens,
                     "train" if shape.kind == "train" else "inference"),
                 "ok": False}
    if reduced:
        rec["reduced"] = reduced
    if shape.kind in TRACED_KINDS and flags.get("compile_", True):
        traced = _traced(cfg, shape, name, cut=cut,
                         microbatches=flags["microbatches"],
                         remat=flags["remat"],
                         roofline_probe=flags.get("roofline_probe", True),
                         unroll=flags["unroll"])
        mem = traced.pop("memory")
        rec["memory"].update(mem)
        rec.update(traced, traced=True, fits=mem["peak_bytes"]
                   <= H100_HBM_BYTES)
        pf = rec["model_flops_global"] / mesh.size
        rec["model_flops_per_chip"] = pf
        rec["useful_flops_ratio"] = pf / rec["roofline"]["flops"] \
            if rec["roofline"]["flops"] else None
    rec.update(ok=True, lower_compile_s=round(time.time() - t0, 1))
    return rec


def lower_record(arch: str, shape_name: str, kwargs: Optional[Dict] = None
                 ) -> Dict:
    """``lower_combo``'s record, or a failed record with the error: the
    boundary that lets a matrix report every combo."""
    kwargs = kwargs or {}
    try:
        return lower_combo(arch, shape_name, **kwargs)
    except Exception as e:  # noqa: BLE001 -- recorded and reported
        mesh = kwargs.get("mesh") or ("2x16x16" if kwargs.get("multi_pod")
                                      else "1")
        return {"arch": arch, "shape": shape_name, "mesh": mesh, "ok": False,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def _lower_star(job):
    return lower_record(*job)


def _one_thread() -> None:
    import torch
    torch.set_num_threads(1)


def start_matrix(jobs, workers: int, callback=None):
    """Run ``lower_record`` over ``jobs`` ((arch, shape, kwargs) triples) in
    ``workers`` spawned processes of one thread each; returns (pool,
    AsyncResult of the records in order). ``callback`` is called with the
    records once all are done. The caller closes the pool."""
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(
        workers, initializer=_one_thread)
    return pool, pool.map_async(_lower_star, list(jobs), chunksize=1,
                                callback=callback)


def summary_line(rec: Dict) -> str:
    label = f"{rec['arch']} x {rec['shape']} x {rec['mesh']}"
    if not rec["ok"]:
        return f"[FAIL] {label}: {rec['error'][:500]}"
    if rec["mesh"] != "1" and not rec.get("traced"):
        return (f"[OK]   {label}: {rec['chips']} chips, arguments "
                f"{rec['memory']['argument_bytes_per_chip']:.4g}B a chip "
                f"fits={rec['fits']} (not traced)")
    if rec["mesh"] != "1":
        r = rec["roofline"]
        return (f"[OK]   {label}: {rec['chips']} chips, traced "
                f"{rec['lower_compile_s']}s dominant={r['dominant']} "
                f"compute={r['compute_s']:.4g}s memory={r['memory_s']:.4g}s "
                f"coll={r['collective_s']:.4g}s "
                f"collective_bytes={r['collective_bytes']:.4g}B "
                f"peak={rec['memory']['peak_bytes']:.4g}B a chip "
                f"fits={rec['fits']}")
    r = rec.get("roofline", {})
    return (f"[OK]   {label}: trace {rec['lower_compile_s']}s "
            f"probes {rec.get('probe_s', '-')}s "
            f"dominant={r.get('dominant', '-')} "
            f"compute={r.get('compute_s', 0):.4g}s "
            f"memory={r.get('memory_s', 0):.4g}s "
            f"coll={r.get('collective_s', 0):.4g}s "
            f"peak={rec.get('memory', {}).get('peak_bytes', 0):.4g}B "
            f"fits={rec.get('fits', '-')}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--mesh", choices=["single", "multi", "both"],
                   default="single",
                   help="single: one H100 (traced); multi: the 2x16x16 "
                        "mesh; both: 16x16 and 2x16x16 (per-chip argument "
                        "bytes; every step traced on one rank of a fake "
                        "process group)")
    p.add_argument("--cut", type=int, default=0)
    p.add_argument("--no-compile", action="store_true",
                   help="trace only, count nothing")
    p.add_argument("--unroll", action="store_true",
                   help="take the full-depth counts, no probe pair (the "
                        "port's layer loop is always unrolled)")
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--capacity-factor", type=float, default=0.0)
    p.add_argument("--kv-int8", action="store_true")
    p.add_argument("--workers", type=int, default=1,
                   help="processes tracing combos at once")
    p.add_argument("--out", default=None, help="append JSONL records here")
    args = p.parse_args(argv)

    archs = list(DRYRUN_ARCHS) if (args.all or args.arch in (None, "all")) \
        else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape in (None, "all")) \
        else [args.shape]
    kw = {"cut": args.cut, "compile_": not args.no_compile,
          "unroll": args.unroll, "microbatches": args.microbatches,
          "remat": not args.no_remat,
          "capacity_factor": args.capacity_factor, "kv_int8": args.kv_int8}
    meshes = {"single": ["1"], "multi": ["2x16x16"],
              "both": ["16x16", "2x16x16"]}[args.mesh]
    jobs = [(a, s, {**kw, "mesh": m}) for a in archs for s in shapes
            for m in meshes]
    if args.workers > 1:
        pool, result = start_matrix(jobs, args.workers)
        with pool:
            records = result.get()
    else:
        records = (lower_record(*job) for job in jobs)
    n_fail = 0
    for rec in records:
        n_fail += not rec["ok"]
        print(summary_line(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
