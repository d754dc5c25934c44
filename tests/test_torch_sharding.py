"""The sharding layer against the JAX package's: the spec trees of
``launch/sharding.py`` leaf for leaf (by key path) on the production
meshes, the MoE layout decision, per-chip bytes, ``shardctx``, and the dry
run's per-chip argument bytes on both meshes. Both sides run on abstract
meshes: no device, no process group."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import shardctx as ref_ctx
from repro.configs.base import ARCH_IDS, INPUT_SHAPES
from repro.configs.base import get_config as ref_config
from repro.launch import sharding as ref_shd
from repro.launch.mesh import make_abstract_mesh as ref_abstract_mesh
from repro.models import model as ref_model
from repro.models.moe_shard_map import strategy_for_mesh as ref_strategy
from repro_torch import shardctx
from repro_torch.configs.base import get_config
from repro_torch.core.hardware import H100_HBM_BYTES
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import (AbstractMesh, data_axes,
                                     make_abstract_mesh, make_debug_mesh,
                                     make_production_mesh, model_axis)
from repro_torch.models import model as M
from repro_torch.models.moe_shard_map import strategy_for_mesh

torch.set_num_threads(1)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MOE_ARCHS = [a for a in ARCH_IDS if get_config(a).is_moe]
MESH_IDS = list(MESHES)


def _meshes(name):
    shape, axes = MESHES[name]
    return make_abstract_mesh(shape, axes), ref_abstract_mesh(shape, axes)


def _entry(e):
    """One spec entry, normalised: None, an axis name, or a tuple of names
    (a 1-tuple reads as its name, as NamedSharding reads it)."""
    if e is None or isinstance(e, str):
        return e
    e = tuple(e)
    return e[0] if len(e) == 1 else e


def _norm(spec, ndim):
    entries = [_entry(e) for e in tuple(spec)]
    return tuple(entries + [None] * (ndim - len(entries)))


def _by_path(tree, leaves, path=()):
    """{key path: (spec or leaf)} of a nested dict whose leaves are specs
    (``leaves`` is None) or of the leaves tree itself."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_by_path(v, leaves[k] if leaves is not None else None,
                                path + (k,)))
        return out
    return {path: (tree, leaves)}


def _spec_map(specs, avals):
    return {p: _norm(s, len(a.shape))
            for p, (s, a) in _by_path(specs, avals).items()}


@pytest.fixture(scope="module")
def abstract():
    """(port meta tree, reference ShapeDtypeStruct tree) per arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = (M.abstract_params(get_config(arch)),
                           ref_model.abstract_params(ref_config(arch)))
        return cache[arch]
    return get


def test_meshes_have_the_reference_shape_and_axes():
    for multi in (False, True):
        got = make_production_mesh(multi_pod=multi)
        shape, axes = MESHES["2x16x16" if multi else "16x16"]
        assert isinstance(got, AbstractMesh)
        assert got.shape == dict(zip(axes, shape))
        assert got.axis_names == axes and got.size == int(np.prod(shape))
        ref = ref_abstract_mesh(shape, axes)
        assert got.shape == dict(ref.shape)
        assert data_axes(got) == tuple(a for a in axes if a != "model")
        assert model_axis(got) == "model"
    debug = make_debug_mesh()
    assert debug.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        make_abstract_mesh((2, 2), ("data", "data"))


@pytest.mark.parametrize("mesh_id", MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(abstract, arch, mesh_id):
    mesh, ref_mesh = _meshes(mesh_id)
    tp, jp = abstract(arch)
    got = _spec_map(shd.param_specs(get_config(arch), tp, mesh), tp)
    want = _spec_map(ref_shd.param_specs(ref_config(arch), jp, ref_mesh), jp)
    assert got.keys() == want.keys()
    assert got == want
    # and opt_state_specs over the LoRA specs, with the AdamW state's leaves
    lora = shd.param_specs(get_config(arch), tp, mesh)["lora"]
    ref_lora = ref_shd.param_specs(ref_config(arch), jp, ref_mesh)["lora"]
    opt = shd.opt_state_specs(lora)
    ref_opt = ref_shd.opt_state_specs(ref_lora)
    assert set(opt) == set(ref_opt) == {"m", "v", "step"}
    for k in ("m", "v"):
        assert _spec_map(opt[k], tp["lora"]) == _spec_map(ref_opt[k],
                                                          jp["lora"])
    assert _norm(opt["step"], 0) == _norm(ref_opt["step"], 0) == ()


@pytest.mark.parametrize("mesh_id", MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_divide_and_local_shapes_tile(abstract, arch, mesh_id):
    """Every spec divides its leaf; ``shard_shape`` times the axis sizes
    gives the leaf back."""
    mesh, _ = _meshes(mesh_id)
    tp, _ = abstract(arch)
    specs = shd.param_specs(get_config(arch), tp, mesh)
    for path, (spec, leaf) in _by_path(specs, tp).items():
        block = shd.shard_shape(leaf.shape, spec, mesh)
        for dim, (b, axis) in enumerate(zip(block, _norm(spec, leaf.dim()))):
            assert b * mesh.axis_size(axis) == leaf.shape[dim], (path, spec)


@pytest.mark.parametrize("mesh_id", MESH_IDS)
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-370m", "hymba-1.5b",
                                  "kimi-k2-1t-a32b", "qwen3-4b-int8"])
@pytest.mark.parametrize("batch", [16, 1])
def test_cache_specs_equal_the_reference(arch, mesh_id, batch):
    from repro.models import model as RM
    int8 = arch.endswith("-int8")
    name = arch[:-len("-int8")] if int8 else arch
    cfg, rcfg = get_config(name), ref_config(name)
    if int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        rcfg = dataclasses.replace(rcfg, kv_cache_dtype="int8")
    mesh, ref_mesh = _meshes(mesh_id)
    seq = 1024
    cache = M.init_cache(cfg, batch, seq, device="meta")
    ref_cache = jax.eval_shape(lambda: RM.init_cache(rcfg, batch, seq))
    got = _spec_map(shd.cache_specs(cfg, cache, mesh, batch), cache)
    want = _spec_map(ref_shd.cache_specs(rcfg, ref_cache, ref_mesh, batch),
                     ref_cache)
    assert got.keys() == want.keys() and got == want
    if int8:
        assert {p[-1] for p in got} >= {"k_scale", "v_scale"}


@pytest.mark.parametrize("mesh_id", MESH_IDS)
@pytest.mark.parametrize("arch", ["qwen3-4b", "internvl2-26b",
                                  "musicgen-large"])
@pytest.mark.parametrize("kind,global_batch,cut", [
    ("train", 256, 0), ("train", 256, 14), ("train", 1, 0),
    ("prefill", 32, 0), ("decode", 1, 0), ("decode", 128, 0),
    ("decode", 0, 0)])
def test_batch_specs_equal_the_reference(arch, mesh_id, kind, global_batch,
                                         cut):
    mesh, ref_mesh = _meshes(mesh_id)
    got = shd.batch_specs_for(get_config(arch), mesh, kind, global_batch, cut)
    want = ref_shd.batch_specs_for(ref_config(arch), ref_mesh, kind,
                                   global_batch, cut)
    assert set(got) == set(want)
    for k in got:
        assert _norm(got[k], 3) == _norm(want[k], 3), k
    if global_batch == 1:       # the small-batch guard: nothing sharded
        assert all(e is None for spec in got.values() for e in spec)
    if cut:
        assert set(got) == {"smashed", "labels"}


@pytest.mark.parametrize("shape,axes", [
    *MESHES.values(), ((4, 2), ("data", "model")), ((8, 1), ("data", "model")),
    ((3, 2), ("data", "model")), ((1, 8), ("data", "model")),
    ((2, 2, 2), ("pod", "data", "model"))])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_strategy_for_mesh_equals_the_reference(arch, shape, axes):
    cfg = get_config(arch)
    mesh = make_abstract_mesh(shape, axes)
    assert strategy_for_mesh(cfg, mesh) == ref_strategy(
        ref_config(arch), ref_abstract_mesh(shape, axes))
    # and the same from the active context, left as it was
    from repro_torch.models.moe_shard_map import select_strategy
    with shardctx.mesh_ctx(mesh):
        assert select_strategy(cfg) == strategy_for_mesh(cfg, mesh)
        assert shardctx.mesh() is mesh


def _ref_bytes_per_chip(avals, specs, mesh):
    """The reference test's arithmetic (``test_big_models_fit_per_chip``):
    sum of size * itemsize / shards over the leaves."""
    from jax.sharding import PartitionSpec as RP
    flat_a, _ = jax.tree_util.tree_flatten(avals)
    flat_s, _ = jax.tree_util.tree_flatten(
        specs, is_leaf=lambda x: isinstance(x, RP))
    total = 0
    for aval, spec in zip(flat_a, flat_s, strict=True):
        shards = 1
        for axis in spec:
            if axis is None:
                continue
            for a in (axis,) if isinstance(axis, str) else axis:
                shards *= mesh.shape[a]
        total += aval.size * aval.dtype.itemsize / shards
    return total


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "kimi-k2-1t-a32b",
                                  "internvl2-26b"])
def test_frozen_bytes_per_chip_equal_the_reference_arithmetic(abstract, arch):
    mesh, ref_mesh = _meshes("2x16x16")
    tp, jp = abstract(arch)
    got = shd.bytes_per_chip(
        tp["frozen"], shd.param_specs(get_config(arch), tp, mesh)["frozen"],
        mesh)
    want = _ref_bytes_per_chip(
        jp["frozen"],
        ref_shd.param_specs(ref_config(arch), jp, ref_mesh)["frozen"],
        ref_mesh)
    assert got == want
    assert got < 12e9                   # the reference's bound
    assert got <= H100_HBM_BYTES        # fits one H100


def test_local_shard_takes_each_ranks_block():
    """On a (2, 2, 2) mesh, a dim split over ("pod", "data") goes to the
    ranks in row-major order of those axes; the blocks tile the tensor."""
    from repro_torch.launch.mesh import LiveMesh
    t = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    spec = shd.P(("pod", "data"), None, "model")
    seen = torch.zeros_like(t)
    for rank in range(8):
        m = LiveMesh(sizes=(2, 2, 2), axis_names=("pod", "data", "model"),
                     rank=rank, groups={})
        c = m.coords
        blk = shd.local_shard(t, spec, m)
        assert blk.shape == shd.shard_shape(t.shape, spec, m) == (2, 6, 2)
        row = (c["pod"] * 2 + c["data"]) * 2
        col = c["model"] * 2
        assert torch.equal(blk, t[row:row + 2, :, col:col + 2])
        seen[row:row + 2, :, col:col + 2] += 1
    assert (seen == 1).all()            # the 8 blocks tile the tensor once
    with pytest.raises(ValueError):
        shd.shard_shape((6, 4), shd.P("data"),
                        make_abstract_mesh((4,), ("data",)))


def test_shardctx_outside_and_inside_a_context():
    x = torch.zeros(4, 6)
    mesh, ref_mesh = _meshes("2x16x16")
    for ctx, m in ((shardctx, mesh), (ref_ctx, ref_mesh)):
        assert not ctx.active() and ctx.mesh() is None
        assert ctx.axis_size("dp") == ctx.axis_size("model") == 1
        assert ctx.dp_axes() == ()
    assert shardctx.constrain(x, "dp", "model") is x
    with shardctx.mesh_ctx(mesh), ref_ctx.mesh_ctx(ref_mesh):
        assert shardctx.active() and shardctx.mesh() is mesh
        for tag in ("dp", "model"):
            assert shardctx.axis_size(tag) == ref_ctx.axis_size(tag)
        assert shardctx.axis_size("dp") == 32
        assert shardctx.dp_axes() == tuple(ref_ctx.dp_axes()) == ("pod",
                                                                  "data")
        assert shardctx.constrain(x, "dp", "model") is x
        with pytest.raises(ValueError):
            shardctx.constrain(x, "dp")
    assert not shardctx.active()


def _expected_arguments(arch, shape_name, mesh_id):
    """Per-chip argument bytes from the reference's specs over the
    reference's avals: the arithmetic a sharded dry-run record must give."""
    from repro.data.pipeline import batch_specs as ref_batch
    from repro.launch.dryrun import combo_config as ref_combo
    from repro.models import model as RM
    from repro.optim import adamw as ref_adamw
    from repro.optim import constant_schedule as ref_const
    _, ref_mesh = _meshes(mesh_id)
    cfg, shape = ref_combo(arch, shape_name), INPUT_SHAPES[shape_name]
    avals = RM.abstract_params(cfg)
    specs = ref_shd.param_specs(cfg, avals, ref_mesh)
    out = {"frozen": _ref_bytes_per_chip(avals["frozen"], specs["frozen"],
                                         ref_mesh),
           "lora": _ref_bytes_per_chip(avals["lora"], specs["lora"],
                                       ref_mesh)}
    bspecs = ref_shd.batch_specs_for(cfg, ref_mesh, shape.kind,
                                     shape.global_batch)
    batch = ref_batch(cfg, shape)
    if shape.kind == "train":
        opt = jax.eval_shape(ref_adamw(ref_const(1e-4)).init, avals["lora"])
        out["opt_state"] = _ref_bytes_per_chip(
            opt, ref_shd.opt_state_specs(specs["lora"]), ref_mesh)
        out["batch"] = _ref_bytes_per_chip(batch, bspecs, ref_mesh)
        return out
    key = "embeds" if cfg.input_mode == "embeds" else "tokens"
    out["inputs"] = _ref_bytes_per_chip({key: batch[key]},
                                        {key: bspecs[key]}, ref_mesh)
    if shape.kind == "decode":
        cache = jax.eval_shape(lambda: RM.init_cache(cfg, shape.global_batch,
                                                     shape.seq_len))
        out["cache"] = _ref_bytes_per_chip(
            cache, ref_shd.cache_specs(cfg, cache, ref_mesh,
                                       shape.global_batch), ref_mesh)
        out["t"] = 4
    return out


@pytest.mark.parametrize("mesh_id", MESH_IDS)
@pytest.mark.parametrize("arch,shape_name", [
    ("qwen3-0.6b", "train_4k"), ("kimi-k2-1t-a32b", "decode_32k"),
    ("granite-moe-3b-a800m", "prefill_32k"), ("mamba2-370m", "long_500k"),
    ("internvl2-26b", "train_4k")])
def test_lower_combo_on_the_production_meshes(arch, shape_name, mesh_id):
    rec = dryrun.lower_combo(arch, shape_name, mesh=mesh_id,
                             multi_pod=mesh_id == "2x16x16")
    want = _expected_arguments(arch, shape_name, mesh_id)
    got = rec["memory"]["argument_bytes_per_chip_by_argument"]
    assert got == want
    assert rec["memory"]["argument_bytes_per_chip"] == sum(want.values())
    if INPUT_SHAPES[shape_name].kind not in dryrun.TRACED_KINDS:
        assert rec["fits"] == (sum(want.values()) <= H100_HBM_BYTES)
    assert rec["chips"] == int(np.prod(MESHES[mesh_id][0]))
    assert rec["ok"]
    # train and prefill are traced on one rank of a fake process group
    # (tests/test_torch_dryrun.py holds those records); decode is not
    if INPUT_SHAPES[shape_name].kind in dryrun.TRACED_KINDS:
        assert rec["traced"] is True and rec["roofline"]["collective_s"] > 0
        assert rec["fits"] == (rec["memory"]["peak_bytes"] <= H100_HBM_BYTES)
    else:
        assert rec["traced"] is False and rec["roofline"] is None
        assert "sequence-sharded" in rec["why"]
    assert dryrun.summary_line(rec).startswith(
        f"[OK]   {arch} x {shape_name} x {mesh_id}:")
