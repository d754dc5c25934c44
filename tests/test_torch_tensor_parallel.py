"""The tensor-parallel model on ``gloo`` CPU ranks against the JAX package.

Six narrow f32 configs, made by the reference's ``init_params`` (LoRA B
and QKV biases non-zero), each on the meshes (1, 4), (2, 4), (4, 2) and
(1, 8) over ("data", "model"), the port's ranks spawned by ``spawn_mesh``
(``tests/_torch_shard_ranks.py``, which imports no JAX):

  * ``dense``: qwen3-4b narrowed to 16 query / 8 kv heads, every head
    layout split;
  * ``odd_heads``: qwen2-7b narrowed to 6 / 2 heads (QKV bias, vocab 389):
    on 4 and 8 model ranks the query columns split off head boundaries and
    are gathered (``attention.tp_layout``: ``"gathered"``);
  * ``kv_cut``: 8 / 2 heads: each rank its query heads, the kv split cutting
    a head (qwen3-4b's case at model = 16), kv gathered;
  * ``kv_expanded``: 18 / 3 heads, tied embeddings: on 2 model ranks a
    rank's 9 query heads read kv heads in unequal groups (one kv head each);
  * ``granite``: granite-moe-3b-a800m reduced (4 experts, top-2) at
    capacity factor 8 (no path drops): ``ep_a2a`` on (2, 4) and (4, 2),
    ``replicated`` on (1, 4) and (1, 8), and batch 6 on (4, 2), which the
    data axis does not divide (the broadcast layout);
  * ``kimi``: kimi-k2-1t-a32b reduced, with its shared expert, on (1, 4)
    (``replicated``: ``param_specs`` splits the shared expert like a dense
    MLP, so it runs column- and row-parallel) and (2, 4) (``ep_a2a``).

Checked on every rank: the prefill step's logits (``make_prefill_step``,
chunked attention) against the reference's on one device, within 1e-5 x
max|want|; one ``make_train_step``'s loss and LoRA gradients (this rank's
blocks, reduced as the step reduces them) against ``jax.grad`` of the
reference's ``forward_loss``, within 1e-5 x max|want| a leaf. The dense
configs' reference runs on one device. The MoE aux loss is a sum of each
batch shard's Switch loss in the reference's ``moe_forward_dist`` (not the
one-device value), so granite's loss and gradients are held against the
reference's step on the same mesh of forced host devices, in a subprocess.
A mesh of one rank is the path without a mesh, bit for bit.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.launch.serve import make_prefill_step as ref_prefill_step
from repro.models import model as JM
from repro_torch.launch.mesh import LiveMesh, spawn_mesh
from repro_torch.models import attention as port_attention

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_shard_ranks as ranks_mod  # noqa: E402
from _torch_parity import make_pair, to_numpy_tree  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
SEQ = 16
AXES = ("data", "model")
MESHES = ((1, 4), (2, 4), (4, 2), (1, 8))
CONFIGS = {
    "dense": ("qwen3-4b", dict(d_model=128, n_heads=16, n_kv_heads=8,
                               head_dim=16, d_ff=256)),
    "odd_heads": ("qwen2-7b", dict(d_model=96, n_heads=6, n_kv_heads=2,
                                   head_dim=16, d_ff=320, vocab_size=389)),
    "kv_cut": ("qwen3-4b", dict(d_model=128, n_heads=8, n_kv_heads=2,
                                head_dim=16, d_ff=256)),
    "kv_expanded": ("qwen3-0.6b", dict(d_model=144, n_heads=18, n_kv_heads=3,
                                       head_dim=8, d_ff=288)),
    "granite": ("granite-moe-3b-a800m", dict(capacity_factor=8.0)),
    "kimi": ("kimi-k2-1t-a32b", dict(capacity_factor=8.0)),
}
# (config, mesh, batch)
CASES = [(c, m, 8) for c in CONFIGS if c != "kimi" for m in MESHES] \
    + [("granite", (4, 2), 6), ("kimi", (1, 4), 8), ("kimi", (2, 4), 8)]
# the attention layout each case must take (model axis 4, 2, 8)
LAYOUTS = {
    ("dense", 4): ("split", "split"), ("dense", 2): ("split", "split"),
    ("dense", 8): ("split", "split"),
    ("odd_heads", 4): ("gathered", "gathered"),
    ("odd_heads", 2): ("split", "split"),
    ("odd_heads", 8): ("gathered", "gathered"),
    ("kv_cut", 4): ("split", "gathered"), ("kv_cut", 2): ("split", "split"),
    ("kv_cut", 8): ("split", "gathered"),
    ("kv_expanded", 4): ("gathered", "gathered"),
    ("kv_expanded", 2): ("split", "gathered"),
    ("kv_expanded", 8): ("gathered", "gathered"),
    ("granite", 4): ("split", "gathered"), ("granite", 2): ("split", "split"),
    ("granite", 8): ("gathered", "gathered"),
    ("kimi", 4): ("split", "gathered"),
}


def _case_id(case):
    name, mesh, batch = case
    return f"{name}-{mesh[0]}x{mesh[1]}-b{batch}"


def _batch(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (batch, SEQ))
    labels[:, -2:] = -100                   # ignored positions
    return {"tokens": rng.integers(0, cfg.vocab_size, (batch, SEQ)),
            "labels": labels}


def _ref_loss_and_grads(jcfg, jparams, batch):
    def loss(lora):
        return JM.forward_loss(jparams["frozen"], lora,
                               jax.tree.map(jax.numpy.asarray, batch), jcfg,
                               impl="chunked")
    value, grads = jax.jit(jax.value_and_grad(loss))(jparams["lora"])
    return float(value), jax.tree.map(np.asarray, grads)


MESH_REFERENCE = """
import os, pickle, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh
from repro import shardctx
from repro.configs.base import get_config
from repro.models import model as JM

cases = pickle.load(open(sys.argv[1], "rb"))
out = {}
for key, (arch, overrides, shape, params, batch) in cases.items():
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    params = jax.tree.map(jax.numpy.asarray, params)
    batch = jax.tree.map(jax.numpy.asarray, batch)
    n = shape[0] * shape[1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
    with mesh, shardctx.mesh_ctx(mesh):
        def loss(lora):
            return JM.forward_loss(params["frozen"], lora, batch, cfg,
                                   impl="chunked")
        value, grads = jax.jit(jax.value_and_grad(loss))(params["lora"])
    out[key] = (float(value), jax.tree.map(np.asarray, grads))
pickle.dump(out, open(sys.argv[2], "wb"))
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """For every case: the reference's (logits, loss, grads) and each
    rank's (coords, logits, loss, grads, adapter specs)."""
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    pairs = {name: make_pair(arch, seed=i, **over)
             for i, (name, (arch, over)) in enumerate(CONFIGS.items())}
    want, jobs, mesh_ref = {}, {}, {}
    for case in CASES:
        name, shape, b = case
        jcfg, tcfg, jparams, _ = pairs[name]
        batch = _batch(tcfg, b, seed=b)
        if (name, b) not in want:
            logits = ref_prefill_step(jcfg, impl="chunked")(
                jparams["frozen"], jparams["lora"],
                jax.numpy.asarray(batch["tokens"]))
            loss, grads = _ref_loss_and_grads(jcfg, jparams, batch)
            want[(name, b)] = (np.asarray(logits), loss, grads)
        params, _ = to_numpy_tree(jparams)
        world = shape[0] * shape[1]
        jobs.setdefault(world, []).append((shape, f"{name}-b{b}", tcfg,
                                           params, batch))
        if tcfg.is_moe:
            mesh_ref[_case_id(case)] = (CONFIGS[name][0], CONFIGS[name][1],
                                        shape, params, batch)
    with open(tmp / "mesh_cases.pkl", "wb") as f:
        pickle.dump(mesh_ref, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("JAX_PLATFORMS", None)
    ref = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(MESH_REFERENCE),
         str(tmp / "mesh_cases.pkl"), str(tmp / "mesh_ref.pkl")],
        env=env, capture_output=True, text=True, timeout=600)
    assert "OK" in ref.stdout, ref.stderr[-3000:]
    with open(tmp / "mesh_ref.pkl", "rb") as f:
        on_mesh = pickle.load(f)
    got = {}
    for world, world_jobs in jobs.items():
        rdv = tmp / f"rendezvous{world}"
        rdv.mkdir()
        ranks = spawn_mesh(ranks_mod.tp_cases, world_jobs[0][0], AXES,
                           device="cpu", args=(world_jobs,),
                           rendezvous=str(rdv), timeout_s=600)
        for shape, key, *_ in world_jobs:
            got[(tuple(shape), key)] = [r[(tuple(shape), key)] for r in ranks]
    return want, on_mesh, got, pairs


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


def _leaves(tree, specs, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, specs[k], path + (k,))
    else:
        yield path, tree, specs


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_prefill_logits_equal_the_reference_on_every_rank(runs, case):
    want, _, got, pairs = runs
    name, shape, b = case
    cfg = pairs[name][1]
    w = want[(name, b)][0][:, :cfg.vocab_size]
    tol = TOL * np.abs(w).max()
    for rank, res in enumerate(got[(shape, f"{name}-b{b}")]):
        g = res["logits"]
        assert g.shape == (b, cfg.padded_vocab), (rank, g.shape)
        err = float(np.abs(g[:, :cfg.vocab_size] - w).max())
        assert err <= tol, (rank, err, tol)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_train_loss_and_lora_grads_equal_the_reference(runs, case):
    want, on_mesh, got, pairs = runs
    name, shape, b = case
    if pairs[name][1].is_moe:
        loss, grads = on_mesh[_case_id(case)]
    else:
        _, loss, grads = want[(name, b)]
    n_leaves = 0
    ranks = got[(shape, f"{name}-b{b}")]
    for rank, res in enumerate(ranks):
        assert abs(res["loss"] - loss) <= TOL * abs(loss), (rank, res["loss"],
                                                            loss)
        for path, g, spec in _leaves(res["grads"], res["lora_specs"]):
            w_full = _get(grads, path)
            w = _block(w_full, spec, shape, res["coords"])
            assert g.shape == w.shape, (rank, path, g.shape, w.shape)
            err = float(np.abs(g - w).max())
            assert err <= TOL * np.abs(w_full).max(), (rank, path, err)
            n_leaves += 1
    # every rank, and at least the attention adapters' a and b
    assert n_leaves >= len(ranks) * 8


@pytest.mark.parametrize("case", [c for c in CASES if c[2] == 8],
                         ids=_case_id)
def test_heads_take_the_layout_of_the_case(case):
    name, shape, _ = case
    arch, over = CONFIGS[name]
    from repro_torch.configs.base import get_config
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    lay = port_attention.tp_layout(cfg, shape[1])
    assert (lay["q"], lay["kv"]) == LAYOUTS[(name, shape[1])]
    if (name, shape[1]) == ("kv_expanded", 2):
        assert lay["kv_read"] == "expanded"


@pytest.mark.parametrize("hq,hkv,m", [(32, 8, 16), (16, 8, 16), (64, 8, 16),
                                      (48, 8, 16), (18, 3, 2), (24, 8, 4),
                                      (24, 8, 8), (12, 4, 4), (8, 8, 8)])
def test_each_rank_reads_the_kv_heads_of_its_query_heads(hq, hkv, m):
    """``_kv_heads`` against the per-head rule ``h // (Hq // Hkv)``: the
    grouped form repeats each kv head the same number of times, in
    order."""
    cfg = dataclasses.replace(
        __import__("repro_torch.configs.base", fromlist=["x"]).get_config(
            "qwen3-4b"), n_heads=hq, n_kv_heads=hkv)
    group = hq // hkv
    for index in range(m):
        heads = range(index * hq // m, (index + 1) * hq // m)
        need = [h // group for h in heads]
        sel = port_attention._kv_heads(cfg, m, index)
        if isinstance(sel, tuple):
            lo, hi = sel
            per = len(need) // (hi - lo)
            assert need == [lo + i // per for i in range(len(need))]
        else:
            assert sel == need


@pytest.mark.parametrize("name", list(CONFIGS))
def test_a_mesh_of_one_rank_is_the_path_without_a_mesh_bit_for_bit(name):
    """A ``LiveMesh`` of one rank (no process group: no collective runs)
    leaves the prefill step and the train step as they are."""
    from repro_torch import shardctx
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.common import tree_leaves
    arch, over = CONFIGS[name]
    _, cfg, _, params = make_pair(arch, seed=7, **over)
    batch = _batch(cfg, 4, seed=3)
    mesh = LiveMesh(sizes=(1, 1), axis_names=AXES, rank=0,
                    device=torch.device("cpu"), backend="gloo", groups={})
    out = []
    for ctx in (None, mesh):
        grads = []
        step = make_train_step(cfg, ranks_mod._capturing_optimizer(grads))
        prefill = make_prefill_step(cfg, device="cpu")
        with shardctx.mesh_ctx(ctx) if ctx is not None \
                else torch.no_grad():
            logits = prefill(params["frozen"], params["lora"],
                             torch.as_tensor(batch["tokens"]))
        with shardctx.mesh_ctx(ctx) if ctx is not None \
                else torch.enable_grad():
            loss, _, _ = step(params["frozen"], params["lora"], {}, batch)
        out.append([logits, loss] + tree_leaves(grads[0]))
    for a, b in zip(*out):
        assert torch.equal(a, b)
