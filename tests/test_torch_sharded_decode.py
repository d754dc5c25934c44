"""The sequence-sharded decode step on ``gloo`` CPU ranks against the JAX
package's on a mesh of 8 forced host devices.

Both take the same numpy parameters (drawn by the port's ``init_params``
from a seed, the adapters' B non-zero), cache and inputs. The
reference's ``make_serve_step`` is jitted on a ``(data, model)`` mesh
with its arguments laid out by its ``param_specs`` and ``cache_specs`` (KV
slots over "model", the SSM state over heads or head dim, the conv window
over channels, the batch over "data" where it divides), in a subprocess.
The port runs the same steps on 8 ranks (``spawn_mesh``, the ranks in
``tests/_torch_decode_ranks.py``, which imports no JAX), each with its
blocks of the parameters and of the cache. Six teacher-forced decode steps
from a seeded non-zero cache, on (2, 4), (4, 2) and (8, 1), f32:

  * ``gqa``: 8 query / 4 kv heads (the global slot count read from the
    block); ``ring``: an 8-slot sliding window that wraps, 2 slots a rank
    on (2, 4); ``t_vector``: a ``(B,)`` position, so the slot's owner
    differs row by row; ``int8``: an int8 KV cache and its scales;
    ``embeds``: internvl2-26b reduced, embeds in; ``mamba2``: ``h`` over
    heads; ``hybrid``: hymba-1.5b at d = 96, 6 SSM heads the model axis 4
    does not divide (``h`` over head dim) beside attention; ``granite``:
    the MoE through ``moe_forward_tp``; ``batch1``: one row (whole over
    "data"); ``odd_slots``: 18 slots, which 4 does not divide (the cache
    whole on every rank of "model", each rank its heads, no combine);
    ``banks``: per-row adapter banks (four adapters over 8 rows) on the
    plain route and on the kernel route (``use_lora_kernel=True``: the
    grouped kernel's plain version on the CPU); ``kv_whole``: one kv head
    of 18, whose columns the model axis 4 does not split (q's gathered
    alone).

Checked on every rank: each step's logits within 1e-5 x max|want| over the
real vocabulary; the final cache block equal to the reference's shard of
its final cache (f32 leaves within 1e-5 x max|want|); the kernel route equal to the plain route. A mesh of
one rank is the path without a mesh, bit for bit. The int8 cache may flip
one quantisation step where a new k or v sits on a rounding boundary (the
two libraries' f32 products differ in the last bit; the port on one device
flips one code of this case's at its third step too), and one step moves
a cached value by max|row| / 127: logits read from such a cache, and the
scales written after it, are held to 1e-3 x max|want|, as
``tests/test_torch_model.py`` holds them, and its codes to one step on at
most 2 % of a block's entries.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import LiveMesh, make_abstract_mesh, spawn_mesh
from repro_torch.models import model as TM
from repro_torch.models.common import lora_dense, tree_map

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_decode_ranks as ranks_mod  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
TOL_INT8_CACHE = 1e-3
STEPS = 6
AXES = ("data", "model")
MESHES = ((2, 4), (4, 2), (8, 1))
GQA = dict(d_model=128, n_heads=8, n_kv_heads=4, head_dim=16, d_ff=256)
# name: (arch, overrides, batch, cache length, first position, options)
CASES = {
    "gqa": ("qwen3-4b", GQA, 8, 16, 5, {}),
    "ring": ("qwen3-4b", dict(GQA, sliding_window=8), 8, 32, 13,
             {"slots": 8}),
    "t_vector": ("qwen3-4b", GQA, 8, 16, 3, {"t_vector": True,
                                             "slots": 16}),
    "int8": ("qwen3-4b", dict(GQA, kv_cache_dtype="int8"), 8, 16, 5,
             {"slots": 16}),
    "embeds": ("internvl2-26b", {}, 8, 16, 5, {"slots": 16}),
    "mamba2": ("mamba2-370m", {}, 8, 16, 5, {}),
    "hybrid": ("hymba-1.5b", dict(d_model=96, d_ff=192), 8, 16, 5,
               {"slots": 16}),
    "granite": ("granite-moe-3b-a800m", {}, 8, 16, 5, {"slots": 16}),
    "batch1": ("qwen3-4b", GQA, 1, 16, 5, {"slots": 16}),
    "odd_slots": ("qwen3-4b", GQA, 8, 18, 5, {"slots": 18}),
    "banks": ("qwen3-4b", GQA, 8, 16, 5, {"banks": True, "slots": 16}),
    "kv_whole": ("qwen3-4b", dict(GQA, n_kv_heads=1, head_dim=18), 8, 16,
                 5, {"slots": 16}),
}
KEYS = [(name, shape) for name in CASES for shape in MESHES]


def _key_id(key):
    name, shape = key
    return f"{name}-{shape[0]}x{shape[1]}"


def _fill(rng, v):
    """A seeded non-zero cache leaf: int8 codes, positive scales, values."""
    if v.dtype == torch.int8:
        return rng.integers(-127, 128, v.shape).astype(np.int8)
    if v.shape[-1] == 1:                        # k_scale / v_scale
        return (rng.random(v.shape) * 0.02 + 1e-3).astype(np.float32)
    return (rng.standard_normal(v.shape) * 0.5).astype(np.float32)


def _nonzero_b(tree, rng):
    """The adapters with B drawn from ``rng`` (std 0.02): ``init_lora_pair``
    sets B = 0, which would hide the adapters."""
    return {k: (_nonzero_b(v, rng) if isinstance(v, dict) else
                (rng.standard_normal(v.shape) * 0.02).astype(np.float32)
                if k == "b" else v.numpy())
            for k, v in tree.items()}


def _params(cfg, seed):
    """The model's parameters as numpy arrays, drawn from ``seed``, the
    adapters' B non-zero: the inputs both packages take."""
    params = TM.init_params(seed, cfg, device="cpu")
    rng = np.random.default_rng(seed + 1000)
    return {"frozen": tree_map(lambda v: v.numpy(), params["frozen"]),
            "lora": _nonzero_b(params["lora"], rng)}


def _banks(cfg, batch, seed):
    """Four adapters with non-zero B over ``batch`` rows (row i takes
    adapter i % 4): leaves (L, B, ...)."""
    adapters = [_params(cfg, seed + i)["lora"] for i in range(4)]
    ids = np.arange(batch) % 4
    return tree_map(lambda *v: np.stack([v[i] for i in ids], 1), *adapters)


def make_case(i, name):
    arch, over, batch, max_len, t0, opt = CASES[name]
    tcfg = dataclasses.replace(get_config(arch).reduced(), **over)
    params = _params(tcfg, i)
    rng = np.random.default_rng(100 + i)
    cache = tree_map(lambda v: _fill(rng, v),
                     TM.init_cache(tcfg, batch, max_len, device="cpu"))
    steps = []
    for s in range(STEPS):
        if tcfg.input_mode == "embeds":
            inputs = rng.standard_normal((batch, 1, tcfg.d_model)).astype(
                np.float32)
        else:
            inputs = rng.integers(0, tcfg.vocab_size, (batch, 1))
        t = t0 + s + (np.arange(batch) % 3 if opt.get("t_vector") else 0)
        steps.append((inputs, np.asarray(t, np.int32)))
    case = {"params": params, "cache": cache, "steps": steps,
            "slots": opt.get("slots"),
            "banks": _banks(tcfg, batch, 50 + i) if opt.get("banks")
            else None}
    return tcfg, case


DECODE_REFERENCE = """
import os, pickle, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from repro import shardctx
from repro.configs.base import get_config
from repro.launch import sharding as shd
from repro.launch.serve import make_serve_step

cases = pickle.load(open(sys.argv[1], "rb"))
out = {}
for key, (arch, overrides, shape, case) in cases.items():
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), ("data", "model"))
    params = jax.tree.map(jnp.asarray, case["params"])
    cache = jax.tree.map(jnp.asarray, case["cache"])
    batch = case["steps"][0][0].shape[0]
    with mesh, shardctx.mesh_ctx(mesh):
        params = jax.device_put(params, shd.to_named(
            shd.param_specs(cfg, params, mesh), mesh))
        lora = params["lora"]
        if case["banks"] is not None:
            lora = jax.device_put(jax.tree.map(jnp.asarray, case["banks"]),
                                  NamedSharding(mesh, PartitionSpec()))
        cache = jax.device_put(cache, shd.to_named(
            shd.cache_specs(cfg, cache, mesh, batch), mesh))
        step = jax.jit(make_serve_step(cfg))
        logits = []
        for inputs, t in case["steps"]:
            y, cache = step(params["frozen"], lora, cache,
                            jnp.asarray(inputs), jnp.asarray(t))
            logits.append(np.asarray(y))
    out[key] = (logits, jax.tree.map(np.asarray, cache))
pickle.dump(out, open(sys.argv[2], "wb"))
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """For every (case, mesh): the reference's step logits and final cache,
    and each rank's (coords, cache specs, plain route, kernel route)."""
    tmp = tmp_path_factory.mktemp("sharded_decode")
    made = {name: make_case(i, name) for i, name in enumerate(CASES)}
    ref_cases, jobs = {}, []
    for name, shape in KEYS:
        tcfg, case = made[name]
        arch, over = CASES[name][:2]
        ref_cases[(name, shape)] = (arch, over, shape, case)
        jobs.append((shape, name, tcfg, case))
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(ref_cases, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("JAX_PLATFORMS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(DECODE_REFERENCE),
         str(tmp / "cases.pkl"), str(tmp / "ref.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        rdv = tmp / "rendezvous"
        rdv.mkdir()
        ranks = spawn_mesh(ranks_mod.decode_cases, MESHES[0], AXES,
                           device="cpu", args=(jobs,), rendezvous=str(rdv),
                           timeout_s=600)
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert "OK" in stdout, stderr[-3000:]
    with open(tmp / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    got = {key: [r[(key[1], key[0])] for r in ranks] for key in KEYS}
    return made, want, got


def _block(want, spec, shape, coords):
    """This rank's block of ``want`` under ``spec`` on a ``shape`` mesh."""
    sizes = dict(zip(AXES, shape))
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        axes = axis if isinstance(axis, (tuple, list)) else (axis,)
        n, idx = 1, 0
        for a in axes:
            n *= sizes[a]
            idx = idx * sizes[a] + coords[a]
        blk = want.shape[dim] // n
        want = np.take(want, range(idx * blk, (idx + 1) * blk), axis=dim)
    return want


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("key", KEYS, ids=_key_id)
def test_decode_logits_equal_the_reference_on_every_rank(runs, key):
    made, want, got = runs
    cfg = made[key[0]][0]
    vocab = cfg.vocab_size
    logits, _ = want[key]
    rel = TOL_INT8_CACHE if cfg.kv_cache_dtype == "int8" else TOL
    for step, w in enumerate(logits):
        w = w[:, :vocab]
        tol = rel * np.abs(w).max()
        for rank, res in enumerate(got[key]):
            g = res["plain"]["logits"][step]
            assert g.shape == (w.shape[0], cfg.padded_vocab), (rank, g.shape)
            err = float(np.abs(g[:, :vocab] - w).max())
            assert err <= tol, (step, rank, err, tol)


@pytest.mark.parametrize("key", KEYS, ids=_key_id)
def test_each_rank_holds_the_reference_shard_of_the_cache(runs, key):
    """The rank's final cache block, leaf by leaf, against its block of the
    reference's final cache; the split the case is there for taken."""
    made, want, got = runs
    name, shape = key
    _, cache = want[key]
    rel = TOL_INT8_CACHE if made[name][0].kv_cache_dtype == "int8" else TOL
    split = set()
    for rank, res in enumerate(got[key]):
        for path, g in _leaves(res["plain"]["cache"]):
            spec = _get(res["cache_specs"], path)
            w_full = _get(cache, path)
            w = _block(w_full, spec, shape, res["coords"])
            assert g.shape == w.shape, (rank, path, g.shape, w.shape)
            if g.dtype == np.int8:
                diff = np.abs(g.astype(np.int32) - w)
                assert diff.max() <= 1, (rank, path, diff.max())
                assert (diff > 0).mean() <= 0.02, (rank, path, diff.mean())
            else:
                err = float(np.abs(g - w).max())
                assert err <= rel * np.abs(w_full).max(), (rank, path, err)
            split.update(path[-1] + f"@{d}" for d, a in enumerate(spec)
                         if a == "model")
    m = shape[1]
    expect = set()
    if m > 1 and name not in ("mamba2", "odd_slots"):
        expect.add("k@2")
    if name == "odd_slots" and m == 2:
        expect.add("k@2")
    if name == "mamba2" and m > 1:
        expect.add("h@2")
    if name == "hybrid" and m == 4:
        expect.add("h@3")       # 6 heads: the head dim
    assert expect <= split, (expect, split)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_the_kernel_route_equals_the_plain_route(runs, shape):
    """Per-row banks: ``decode_step(use_lora_kernel=True)`` (the grouped
    kernel's plain version on the CPU, on the rank's blocks) gives the
    plain route's logits and cache."""
    _, _, got = runs
    for rank, res in enumerate(got[("banks", shape)]):
        for g, w in zip(res["kernel"]["logits"], res["plain"]["logits"]):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-6 * np.abs(w).max())
        for (path, g), (_, w) in zip(_leaves(res["kernel"]["cache"]),
                                     _leaves(res["plain"]["cache"])):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("name", ["gqa", "ring", "mamba2", "hybrid",
                                  "granite"])
def test_a_mesh_of_one_rank_is_the_path_without_a_mesh_bit_for_bit(name):
    """A ``LiveMesh`` of one rank (no process group: no collective runs)
    leaves the decode step and its cache as they are."""
    from repro_torch import shardctx
    from repro_torch.convert import from_numpy_tree
    from repro_torch.launch.serve import make_serve_step
    tcfg, case = make_case(0, name)
    mesh = LiveMesh(sizes=(1, 1), axis_names=AXES, rank=0,
                    device=torch.device("cpu"), backend="gloo", groups={})
    outs = []
    for ctx in (None, mesh):
        params = from_numpy_tree(case["params"], "cpu")
        cache = from_numpy_tree(case["cache"], "cpu")
        step = make_serve_step(tcfg, device="cpu")
        logits = []
        with shardctx.mesh_ctx(ctx) if ctx is not None else torch.no_grad():
            for inputs, t in case["steps"]:
                y, cache = step(params["frozen"], params["lora"], cache,
                                torch.as_tensor(inputs), t)
                logits.append(y)
        outs.append(logits + [leaf for _, leaf in _leaves(cache)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_row_parallel_dense_takes_a_per_row_bank_along_k(tmp_path):
    """A ``(B, K, r)`` bank on a (1, 4) mesh: each rank's rows of ``A``
    along ``K``, not of the batch; every rank gets ``lora_dense``'s whole
    product."""
    rng = np.random.default_rng(7)
    b, k, n, r = 6, 32, 24, 4
    x = rng.standard_normal((b, 1, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    a = rng.standard_normal((b, k, r)).astype(np.float32)
    bb = rng.standard_normal((b, r, n)).astype(np.float32)
    want = lora_dense(*map(torch.as_tensor, (x, w)),
                      {"a": torch.as_tensor(a), "b": torch.as_tensor(bb)},
                      0.5).numpy()
    ranks = spawn_mesh(ranks_mod.row_parallel_bank, (1, 4), AXES,
                       device="cpu", args=(x, w, a, bb, 0.5),
                       rendezvous=str(tmp_path), timeout_s=300)
    for rank, got in enumerate(ranks):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("shape,batch", [((2, 4), 8), ((4, 2), 6)])
def test_lora_specs_of_a_per_row_bank(shape, batch):
    """A per-row bank's spec is its pair's shifted by one dim, with the
    batch over "data" where it divides (the model's guard)."""
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(), **GQA)
    lora = TM.init_params(0, cfg, device="meta")["lora"]
    banks = tree_map(lambda v: v[:, None].expand(v.shape[0], batch,
                                                 *v.shape[1:]), lora)
    mesh = make_abstract_mesh(shape, AXES)
    pair = shd.lora_specs(cfg, lora, mesh)
    rows = shd.lora_specs(cfg, banks, mesh)
    data = ("data",) if batch % shape[0] == 0 else None
    n = 0
    for (path, spec), (_, spec2) in zip(_leaves(pair), _leaves(rows)):
        assert tuple(spec2) == (spec[0], data) + tuple(spec[1:]), path
        n += 1
    assert n == 14
    # a column-parallel B's N over "model", the bank's batch over "data"
    assert tuple(rows["layers"]["attn"]["wq"]["b"]) == (None, data, None,
                                                        "model")


@pytest.mark.parametrize("shape,slots", [((2, 4), 16), ((2, 4), 18),
                                         ((4, 2), 18), ((8, 1), 16)])
def test_slot_range_tiles_the_slots_by_cache_specs(shape, slots):
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(), **GQA)
    m = shape[1]
    blocks = set()
    for rank in range(shape[0] * shape[1]):
        mesh = LiveMesh(sizes=shape, axis_names=AXES, rank=rank,
                        device=torch.device("cpu"), backend="gloo",
                        groups={})
        blocks.add(shd.slot_range(cfg, mesh, slots, 8))
    if m > 1 and slots % m == 0:
        blk = slots // m
        assert blocks == {(i * blk, (i + 1) * blk) for i in range(m)}
    else:
        assert blocks == {(0, slots)}


def test_an_ambiguous_cache_block_asks_for_the_slot_count():
    """A block of 2 slots on a model axis of 4 is a whole 2-slot cache or
    a quarter of an 8-slot one: the step raises unless told."""
    from repro_torch import shardctx
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(), **GQA)
    params = TM.init_params(0, cfg, device="cpu")
    cache = TM.init_cache(cfg, 2, 2, device="cpu")
    mesh = LiveMesh(sizes=(1, 4), axis_names=AXES, rank=0,
                    device=torch.device("cpu"), backend="gloo", groups={})
    with shardctx.mesh_ctx(mesh), pytest.raises(ValueError, match="slots="):
        TM.decode_step(params["frozen"], params["lora"], cache,
                       torch.zeros((2, 1), dtype=torch.long), 0, cfg)
