"""The port's dry run (``repro_torch.launch.dryrun``) and its inputs against
the JAX package's: ``abstract_params``, ``batch_specs``, ``DRYRUN_ARCHS``,
``combo_config``; one combo per family at full published width on
``meta``; the CLI; and the repairs the meta trace needed (MoE counts of a
fixed length, a generator for ``meta``, chunked attention in query blocks).

The reference's own dry run lowers onto a forced 512-device host mesh and
does not run here; its module sets ``XLA_FLAGS`` when imported, so it is
imported only after this process's JAX backend is up, and the variable is
put back.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
from repro.configs.base import asdict as jax_asdict
from repro.configs.base import get_config as jax_get_config
from repro.data.pipeline import batch_specs as jax_batch_specs
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, asdict,
                                      get_config)
from repro_torch.data import batch_specs
from repro_torch.launch import dryrun
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_KEYS = {"arch", "shape", "unroll", "mesh", "cut", "microbatches",
                  "remat", "capacity_factor", "kv_int8", "ok",
                  "lower_compile_s", "memory", "raw_scan_costs", "probe_s",
                  "collectives", "roofline", "model_flops_global",
                  "model_flops_per_chip", "useful_flops_ratio", "tokens"}


@pytest.fixture(scope="module")
def reference_dryrun():
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def _torch_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _torch_leaves(v, path + (k,))
    else:
        yield path, tree


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(p.key for p in path): leaf for path, leaf in flat}


# ---------------------------------------------------------------------------
# Abstract parameters and batch specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_match_the_reference(arch):
    """The full published tree on ``meta``: the reference's leaf paths
    (the port keeps the reference's keys, as ``convert`` maps them),
    shapes and dtypes, and the same total bytes. Neither side allocates."""
    want = _jax_leaves(JM.abstract_params(jax_get_config(arch)))
    got = dict(_torch_leaves(TM.abstract_params(get_config(arch))))
    assert set(got) == set(want)
    for path, t in got.items():
        assert t.is_meta, path
        assert tuple(t.shape) == tuple(want[path].shape), path
        assert str(t.dtype).removeprefix("torch.") == str(
            want[path].dtype), path
    assert sum(t.numel() * t.element_size() for t in got.values()) == sum(
        int(np.prod(x.shape)) * x.dtype.itemsize for x in want.values())


def test_init_params_takes_an_int_seed_on_meta():
    cfg = get_config("granite-moe-3b-a800m")
    p = TM.init_params(0, cfg, device="meta")
    assert all(t.is_meta for _, t in _torch_leaves(p))
    cache = TM.init_cache(cfg, 2, 16, device="meta")
    assert all(t.is_meta for _, t in _torch_leaves(cache))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_the_reference(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        assert JAX_SHAPES[name] == dataclasses.replace(
            JAX_SHAPES[name], **dataclasses.asdict(shape))
        cuts = (0, tcfg.n_layers // 2) if shape.kind == "train" else (0,)
        for cut in cuts:
            want = jax_batch_specs(jcfg, JAX_SHAPES[name], cut)
            got = batch_specs(tcfg, shape, cut)
            assert set(got) == set(want), (name, cut)
            for k, t in got.items():
                assert t.is_meta
                assert tuple(t.shape) == want[k].shape, (name, cut, k)
                assert str(t.dtype).removeprefix("torch.") == str(
                    want[k].dtype), (name, cut, k)


def test_dryrun_archs_and_combo_config_match_the_reference(reference_dryrun):
    assert dryrun.DRYRUN_ARCHS == reference_dryrun.DRYRUN_ARCHS
    assert len(dryrun.DRYRUN_ARCHS) * len(INPUT_SHAPES) == 40
    for arch in dryrun.DRYRUN_ARCHS:
        for shape in INPUT_SHAPES:
            assert asdict(dryrun.combo_config(arch, shape)) == jax_asdict(
                reference_dryrun.combo_config(arch, shape)), (arch, shape)


# ---------------------------------------------------------------------------
# Full width on meta
# ---------------------------------------------------------------------------

#: one combo per family at full published width (the cheapest to trace);
#: the whole 40-combo matrix: ``python -m repro_torch.launch.dryrun --all
#: --workers 6`` (about a minute on 6 CPU cores) or chip_smoke.py's dryrun
FAMILY_COMBOS = (("qwen3-0.6b", "train_4k"),            # dense
                 ("granite-moe-3b-a800m", "decode_32k"),  # moe
                 ("kimi-k2-1t-a32b", "decode_32k"),     # moe, 2 TB
                 ("mamba2-370m", "long_500k"),          # ssm
                 ("hymba-1.5b", "decode_32k"),          # hybrid
                 ("musicgen-large", "long_500k"),       # audio (embeds)
                 ("internvl2-26b", "long_500k"))        # vlm (embeds)


@pytest.mark.parametrize("arch,shape", FAMILY_COMBOS)
def test_full_width_combo_on_meta(arch, shape):
    """A record with the reference's keys; positive terms; the depth-1 /
    depth-2 probe pair's FLOPs equal to the full-depth count (the port's
    layer loop is unrolled, so its full-depth trace is exact), its HBM
    bytes too for inference. A train step's bytes grow by a term
    quadratic in depth (each layer's adapter gradient is scattered into a
    zero tensor of the whole stack), which the linear extrapolation misses:
    held to 1e-4."""
    rec = dryrun.lower_combo(arch, shape)
    assert rec["ok"] and REFERENCE_KEYS <= set(rec)
    assert rec["mesh"] == "1" and rec["chips"] == 1
    assert rec["device"] == "meta"
    r, raw = rec["roofline"], rec["raw_scan_costs"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert r["collective_s"] == 0
    assert r["dominant"] in ("compute", "memory")
    assert r["flops"] == raw["flops"]
    if INPUT_SHAPES[shape].kind == "train":
        assert abs(r["hbm_bytes"] / raw["hbm_bytes"] - 1) < 1e-4
    else:
        assert r["hbm_bytes"] == raw["hbm_bytes"]
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert rec["fits"] == (mem["peak_bytes"] <= 80e9)
    tokens = INPUT_SHAPES[shape].global_batch * (
        1 if INPUT_SHAPES[shape].kind == "decode"
        else INPUT_SHAPES[shape].seq_len)
    assert rec["tokens"] == tokens
    assert rec["useful_flops_ratio"] == pytest.approx(
        rec["model_flops_global"] / r["flops"])


def test_kimi_parameters_are_two_terabytes_and_fit_no_card():
    rec = dryrun.lower_combo("kimi-k2-1t-a32b", "long_500k",
                             roofline_probe=False)
    assert rec["memory"]["argument_bytes"] > 2e12
    assert not rec["fits"]


def test_batch_cut_is_recorded():
    rec = dryrun.lower_combo("mamba2-370m", "decode_32k", batch=4,
                             roofline_probe=False)
    assert rec["reduced"] == {"global_batch": [128, 4]}
    assert rec["tokens"] == 4


def test_depth_cut_is_recorded():
    """The card check's depth cut (the 32k prefills run their first layers
    on the card): the record says so, and counts that depth."""
    full = dryrun.lower_combo("qwen3-0.6b", "decode_32k", batch=2,
                              roofline_probe=False)
    cut = dryrun.lower_combo("qwen3-0.6b", "decode_32k", batch=2, layers=2,
                             roofline_probe=False)
    assert cut["reduced"] == {"global_batch": [128, 2], "n_layers": [28, 2]}
    assert 0 < cut["raw_scan_costs"]["flops"] < full["raw_scan_costs"]["flops"]


def test_multi_pod_raises():
    """``multi_pod=True`` is the 2x16x16 mesh (untraced with
    ``compile_=False``: the per-chip record, ``tests/test_torch_sharding.py``
    holds its bytes); it raises beside another mesh, and for a mesh that
    does not exist."""
    rec = dryrun.lower_combo("qwen3-0.6b", "decode_32k", multi_pod=True,
                             compile_=False)
    assert rec["mesh"] == "2x16x16" and rec["chips"] == 512
    assert rec["traced"] is False and rec["roofline"] is None
    with pytest.raises(ValueError, match="2x16x16"):
        dryrun.lower_combo("qwen3-0.6b", "decode_32k", multi_pod=True,
                           mesh="16x16")
    with pytest.raises(ValueError, match="mesh"):
        dryrun.lower_combo("qwen3-0.6b", "decode_32k", mesh="8x8")


def test_cli_prints_ok_and_writes_one_record(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-0.6b", "--shape", "decode_32k", "--out", str(out)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("[OK]   qwen3-0.6b x decode_32k x 1:")
    lines = out.read_text().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert REFERENCE_KEYS <= set(rec) and rec["ok"]


# ---------------------------------------------------------------------------
# The repairs the meta trace needed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,groups", [(1, 4), (37, 8), (256, 64),
                                      (1000, 3)])
def test_group_counts_equal_bincount(n, groups):
    """Fixed-length counts give ``torch.bincount``'s integers, experts
    that get no item included."""
    rng = np.random.default_rng(n)
    ids = torch.from_numpy(rng.integers(0, max(1, groups // 2), n))
    got = TMoE.group_counts(ids, groups)
    want = torch.bincount(ids, minlength=groups)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert (got[groups // 2:] == 0).all()
    assert TMoE.group_counts(ids, groups).shape == (groups,)


def test_moe_layer_traces_on_meta():
    cfg = get_config("granite-moe-3b-a800m")
    layer = TM.tree_take(TM.abstract_params(cfg)["frozen"]["layers"], 0)
    x = torch.empty(2, 64, cfg.d_model, dtype=torch.bfloat16, device="meta")
    out, aux = TMoE.moe_forward(layer["moe"], None, x, cfg)
    assert out.is_meta and out.shape == x.shape and aux.shape == ()


def _attention_inputs(sq, skv, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, n, h, d)).astype(np.float32)
               for n, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    qpos = np.broadcast_to(np.arange(skv - sq, skv, dtype=np.int32), (2, sq))
    kpos = np.broadcast_to(np.arange(skv, dtype=np.int32), (2, skv))
    return q, k, v, np.ascontiguousarray(qpos), np.ascontiguousarray(kpos)


@pytest.mark.parametrize("sq,skv,window", [(1100, 1100, 0), (600, 600, 128),
                                           (513, 1300, 0), (64, 2048, 0)])
def test_chunked_attention_in_query_blocks(sq, skv, window):
    """Past one block the port's chunked path takes the queries in blocks
    of 512: row for row the naive path's result (same products, same
    softmax), and the reference's online-softmax chunked path to f32
    rounding."""
    q, k, v, qpos, kpos = _attention_inputs(sq, skv, 4, 2, 32)
    tq, tk, tv, tqp, tkp = map(torch.from_numpy, (q, k, v, qpos, kpos))
    kw = dict(causal=True, window=window)
    got = TA.chunked_attention(tq, tk, tv, q_positions=tqp, k_positions=tkp,
                               **kw)
    naive = TA.naive_attention(tq, tk, tv, q_positions=tqp,
                               k_positions=tkp, **kw)
    torch.testing.assert_close(got, naive, rtol=0, atol=1e-6)
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), q_positions=jnp.asarray(qpos),
                                k_positions=jnp.asarray(kpos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_chunked_attention_memory_is_bounded_by_a_query_block():
    """On ``meta``: a 32k prompt's chunked attention holds one query
    block's scores at a time, not the whole (S, S) matrix."""
    from repro_torch.launch.analysis import analyze_step
    s, h, d = 32768, 2, 32
    q, k, v = (torch.empty(1, s, h, d, dtype=torch.bfloat16, device="meta")
               for _ in range(3))
    pos = torch.empty(1, s, dtype=torch.int32, device="meta")
    _, _, mem = analyze_step(
        lambda q, k, v, p: TA.chunked_attention(
            q, k, v, causal=True, window=0, q_positions=p, k_positions=p),
        q, k, v, pos)
    block_scores = TA.BLOCK_Q * s * h * 4
    assert mem["temp_bytes"] < 8 * block_scores < s * s * h * 4


# ---------------------------------------------------------------------------
# The traced sharded records (16x16, 2x16x16)
# ---------------------------------------------------------------------------


@pytest.fixture
def reduced_combos(monkeypatch):
    """``combo_config`` at the reduced size (or the config given)."""
    def use(cfg_of=None):
        orig = dryrun.combo_config
        monkeypatch.setattr(dryrun, "combo_config",
                            cfg_of or (lambda a, s: orig(a, s).reduced()))
    return use


@pytest.mark.parametrize("arch", dryrun.DRYRUN_ARCHS)
@pytest.mark.parametrize("shape,mesh_id", [("train_4k", "16x16"),
                                           ("prefill_32k", "2x16x16")])
def test_traced_sharded_record_at_a_reduced_config(reduced_combos, arch,
                                                   shape, mesh_id):
    """One rank of the mesh traced on ``meta`` over a fake process group:
    a roofline with its collective term, collectives of every layer, a
    per-rank peak that holds the rank's arguments, the heads' layout, and
    per-rank FLOPs x chips no less than one chip's; the group torn down."""
    import torch.distributed as dist
    reduced_combos()
    rec = dryrun.lower_combo(arch, shape, mesh=mesh_id)
    assert rec["ok"] and rec["traced"] is True, rec.get("error")
    assert rec["chips"] == int(np.prod(dryrun.MESHES[mesh_id][0]))
    r, coll = rec["roofline"], rec["collectives"]
    assert r["collective_bytes"] == coll["total_bytes"] > 0
    assert r["collective_s"] > 0 and r["compute_s"] > 0
    assert sum(coll["counts"].values()) > 0
    assert sum(coll["bytes_by_kind"].values()) == coll["total_bytes"]
    assert set(coll["counts"]) <= set(dryrun_analysis().COLLECTIVE_KINDS)
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert rec["fits"] == (mem["peak_bytes"] <= 80e9)
    assert ("heads" in rec) == (arch != "mamba2-370m")
    assert rec["flops_x_chips_over_one_chip"] >= 1 - 1e-9
    assert dryrun.summary_line(rec).startswith(
        f"[OK]   {arch} x {shape} x {mesh_id}: {rec['chips']} chips, traced")
    assert not dist.is_initialized()


def dryrun_analysis():
    from repro_torch.launch import analysis
    return analysis


def test_decode_on_a_mesh_says_why_it_is_not_traced(reduced_combos,
                                                    tmp_path):
    """Decode on a mesh is traced (its cache sequence-sharded by
    ``cache_specs``, the softmax combined across ranks), and no record says
    why it is not. At a narrow config whose heads, kv heads, vocabulary
    and slots the model axis of 16 divides: per-chip FLOPs x chips within
    1.05 of one chip's for decode_32k (the batch over the data axes), and
    of the data axes' size times one chip's for long_500k (its one row
    whole on every data rank); a collective for each layer. Then the
    (2, 4) decode step traced as rank 0 of a fake group of 8 counts what
    rank 0 of 8 live ``gloo`` ranks counts running it on CPU tensors."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_shard_ranks as ranks_mod
    from repro_torch.launch.analysis import analyze_sharded_step
    from repro_torch.launch.mesh import spawn_mesh
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(),
                              **CLOSED_FORM["split"])
    reduced_combos(lambda arch, shape: dryrun.long_context_variant(cfg)
                   if shape == "long_500k" else cfg)
    for mesh_id in ("16x16", "2x16x16"):
        dp = int(np.prod(dryrun.MESHES[mesh_id][0][:-1]))
        for shape, over in (("decode_32k", 1), ("long_500k", dp)):
            rec = dryrun.lower_combo("qwen3-4b", shape, mesh=mesh_id)
            assert rec["ok"] and rec["traced"] is True, rec.get("error")
            assert "why" not in rec and rec["roofline"]["flops"] > 0
            ratio = rec["flops_x_chips_over_one_chip"] / over
            assert 1 - 1e-9 <= ratio <= 1.05, (mesh_id, shape, ratio)
            assert rec["collectives"]["per_layer_bytes"] > 0
            assert rec["batch_split"] == (None if over > 1 else list(
                dryrun.MESHES[mesh_id][1][:-1]))
    shape = dryrun.InputShape("d", 64, 8, "decode")
    with dryrun.fake_mesh((2, 4), ("data", "model")) as mesh:
        step, args = dryrun.build_step(cfg, shape, mesh=mesh)
        roof, coll, mem = analyze_sharded_step(step, *args, mesh=mesh)
    live = spawn_mesh(ranks_mod.traced_counts, (2, 4), ("data", "model"),
                      device="cpu", args=(cfg, shape),
                      rendezvous=str(tmp_path), timeout_s=300)[0]
    assert roof.flops == live["flops"] > 0
    assert coll.counts == live["counts"]
    assert coll.bytes_by_kind == live["bytes_by_kind"]
    assert roof.hbm_bytes == live["hbm_bytes"]
    assert mem["peak_bytes"] == live["peak_bytes"]
    assert set(coll.counts) == {"all-reduce", "all-gather"}


# narrow dense configs whose heads split (every layout "split"), whose kv
# split cuts a head (qwen3-4b at model = 16), and whose query heads do not
# split (qwen2-7b: 28 heads)
CLOSED_FORM = {
    "split": dict(d_model=256, n_heads=32, n_kv_heads=16, head_dim=16,
                  d_ff=512),
    "kv_cut": dict(d_model=256, n_heads=32, n_kv_heads=8, head_dim=16,
                   d_ff=512),
    "q_gathered": dict(d_model=256, n_heads=28, n_kv_heads=4, head_dim=16,
                       d_ff=512),
}


@pytest.mark.parametrize("layout", CLOSED_FORM)
@pytest.mark.parametrize("mesh_id", ["16x16", "2x16x16"])
def test_per_layer_collective_bytes_are_the_closed_form(reduced_combos,
                                                        layout, mesh_id):
    """A dense layer's collectives, per rank: the two row-parallel
    all-reduces (``wo``, ``w_down``) of the rank's ``(B / dp, S, d)``, and
    the all-gather of each projection whose split the heads do not take
    (``tp_layout``), its whole ``(B / dp, S, cols)``. A train step runs
    each of them in the forward, in its recomputation and in the backward
    (a psum's is a psum, a gather's an all-reduce of its result), except
    ``w_down``'s all-reduce in the recomputation: the non-reentrant
    checkpoint stops recomputing after the last op whose saved tensors the
    backward reads. It adds the layer's adapter gradients, summed over the
    axes that replicate them."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.models import attention as TAttn

    def cfg_of(arch, shape):
        return dataclasses.replace(get_config("qwen3-4b").reduced(),
                                   **CLOSED_FORM[layout])
    reduced_combos(cfg_of)
    cfg = cfg_of(None, None)
    mesh = make_abstract_mesh(*dryrun.MESHES[mesh_id])
    dp = mesh.size // mesh.shape["model"]
    lay = TAttn.tp_layout(cfg, 16)
    assert {"split": ("split", "split"), "kv_cut": ("split", "gathered"),
            "q_gathered": ("gathered", "gathered")}[layout] == (lay["q"],
                                                               lay["kv"])
    gathered = (cfg.q_dim if lay["q"] == "gathered" else 0) \
        + (2 * cfg.kv_dim if lay["kv"] == "gathered" else 0)
    for shape_name in ("prefill_32k", "train_4k"):
        shape = INPUT_SHAPES[shape_name]
        tokens = shape.global_batch // dp * shape.seq_len
        per_layer = 4 * tokens * (2 * cfg.d_model + gathered)     # f32
        rec = dryrun.lower_combo("qwen3-4b", shape_name, mesh=mesh_id)
        if shape.kind == "train":
            lora = TM.init_params(0, dataclasses.replace(cfg, n_layers=1),
                                  device="meta")["lora"]
            specs = shd.lora_specs(cfg, lora, mesh)
            per_layer = 4 * tokens * (5 * cfg.d_model + 3 * gathered) \
                + shd.bytes_per_chip(lora, specs, mesh)
        assert rec["collectives"]["per_layer_bytes"] == per_layer, shape_name


FAKE_VS_LIVE = {"prefill": dryrun.InputShape("p", 64, 8, "prefill"),
                "train": dryrun.InputShape("t", 32, 8, "train")}


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-3b-a800m"])
def test_fake_group_trace_equals_a_live_gloo_run(arch, tmp_path):
    """The (2, 4) step traced on ``meta`` as rank 0 of a fake process group
    of 8 counts what rank 0 of 8 live ``gloo`` ranks counts running it on
    real CPU tensors: FLOPs, HBM bytes, peak bytes, collectives by kind."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_shard_ranks as ranks_mod
    from repro_torch.launch.analysis import analyze_sharded_step
    from repro_torch.launch.mesh import spawn_mesh
    cfg = get_config(arch).reduced()
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    for kind, shape in FAKE_VS_LIVE.items():
        with dryrun.fake_mesh((2, 4), ("data", "model")) as mesh:
            step, args = dryrun.build_step(cfg, shape, mesh=mesh)
            roof, coll, mem = analyze_sharded_step(step, *args, mesh=mesh)
        live = spawn_mesh(ranks_mod.traced_counts, (2, 4), ("data", "model"),
                          device="cpu", args=(cfg, shape),
                          rendezvous=str(tmp_path), timeout_s=300)[0]
        assert roof.flops == live["flops"] > 0, kind
        assert roof.hbm_bytes == live["hbm_bytes"], kind
        assert mem["peak_bytes"] == live["peak_bytes"], kind
        assert coll.counts == live["counts"], kind
        assert coll.bytes_by_kind == live["bytes_by_kind"], kind
        assert sum(coll.counts.values()) > 0
