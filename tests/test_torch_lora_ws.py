"""bf16 ``lora_matmul`` at prefill-sized M: the rule that sends a call to the
warp-specialised kernel (``"wgmma_ws"``, ``csrc/lora_matmul_ws.cu``), the
Python mirror of its schedule (``ws_plan``, ``ws_units``), the plain version
against the JAX kernel (Pallas in interpret mode) at shapes that cross the
TPU kernel's blocks, and a narrow qwen2-7b served by the port's engine in
32-token prefill chunks through the kernel route, token for token against
the JAX engine. CPU only: the kernel itself is checked on the card
(``chip_smoke.py``, the ``gpu`` cases of ``tests/test_torch_package.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import j2n, make_adapters, make_pair, t2n
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serving import AdapterBank as JBank
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.configs.base import get_config
from repro_torch.kernels import lora_matmul as t_lm
from repro_torch.kernels import ops as tops
from repro_torch.serving import AdapterBank, Request, ServingEngine

BF16, F32 = torch.bfloat16, torch.float32
SMS, PAIRS = 132, 66           # the H100 SXM's SMs; clusters of two it holds
WS = t_lm.WS_MIN_ROWS
STEPS = t_lm.WS_MIN_STEPS


def _qwen2_kn():
    """(K, N) of qwen2-7b's four LoRA projection shapes: q / o, k / v,
    gate / up, down."""
    cfg = get_config("qwen2-7b")
    d, ff = cfg.d_model, cfg.d_ff
    return ((d, cfg.q_dim), (d, cfg.kv_dim), (d, ff), (ff, d))


# ---------------------------------------------------------------------------
# the version rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,m,k,n,r,aligned,want", [
    (BF16, 64, 3584, 18944, 16, True, "wgmma"),       # an engine chunk
    (BF16, WS - 1, 3584, 18944, 16, True, "wgmma"),   # below the rule
    (BF16, WS, 3584, 18944, 16, True, "wgmma_ws"),    # at it
    (BF16, 1024, 3584, 3584, 16, True, "wgmma_ws"),   # above it
    (BF16, 1024, 3584, 512, 16, True, "wgmma"),       # 16 x 56 steps: too
    (BF16, 2048, 3584, 512, 16, True, "wgmma_ws"),    # little; 32 x 56
    (BF16, 1024, 18944, 512, 16, True, "wgmma_ws"),   # 16 x 296
    (BF16, 128, 64 * STEPS, 256, 16, True, "wgmma_ws"),       # work at the
    (BF16, 128, 64 * (STEPS - 1) + 8, 256, 16, True, "wgmma_ws"),  # floor
    (BF16, 128, 64 * (STEPS - 1), 256, 16, True, "wgmma"),    # below it
    (BF16, 256, 64, 256 * (STEPS // 2), 16, True, "wgmma_ws"),
    (BF16, 256, 64, 256 * (STEPS // 2 - 1), 16, True, "wgmma"),
    (BF16, 4096, 18944, 3584, 16, True, "wgmma_ws"),
    (BF16, 4097, 3592, 520, 8, True, "wgmma_ws"),     # ragged M, N, K
    (BF16, 1024, 3584, 3584, 64, True, "wgmma_ws"),   # the largest rank
    (BF16, 1024, 3584, 3584, 72, True, "wgmma"),      # ranks past 64
    (BF16, 1024, 3584, 3584, 256, True, "wgmma"),
    (BF16, 1024, 3584, 3584, 16, False, "simt"),      # a pointer off 16 B
    (BF16, 1024, 3590, 3584, 16, True, "simt"),       # K not whole 16 B
    (BF16, 1024, 3584, 3584, 20, True, "simt"),       # r not a multiple of 8
    (F32, 1024, 3584, 3584, 16, True, "tf32x3"),      # f32 as before
    (F32, 4096, 18944, 3584, 16, True, "tf32x3"),
    (F32, 4096, 18944, 3584, 16, False, "simt"),
])
def test_lora_matmul_version_by_rows(dtype, m, k, n, r, aligned, want):
    assert t_lm.lora_matmul_version(dtype, m, k, n, r, aligned) == want


def test_grouped_rule_never_takes_the_warp_specialised_kernel():
    """``lora_matmul_grouped`` keeps its rule (no M argument)."""
    for k, n in _qwen2_kn():
        assert t_lm.lora_matmul_grouped_version(BF16, k, n, 16, True) \
            == "wgmma"
        assert t_lm.lora_matmul_grouped_version(F32, k, n, 16, True) \
            == "tf32x3"


def test_rule_at_qwen2_7b_chunk():
    """Over a 1024-token chunk q / o (112 tiles of 128 x 256 x 56 K steps),
    gate / up (592 x 56) and down (112 x 296) take the warp-specialised
    kernel, k / v (16 x 56) stay on ``"wgmma"``: split 8 ways along K to
    fill the card, their f32 partials and the kernel's fixed costs lose to
    it (PERF.md)."""
    (qo, kv, gu, down) = _qwen2_kn()
    for (k, n), want in ((qo, "wgmma_ws"), (kv, "wgmma"), (gu, "wgmma_ws"),
                         (down, "wgmma_ws")):
        assert t_lm.lora_matmul_version(BF16, 1024, k, n, 16, True) == want
    # 896: k / v, slower; 1792: k / v over 2048 rows, faster (PERF.md)
    assert 896 < STEPS <= 1792


def test_rule_keeps_the_small_chunks_of_every_phase_on_wgmma():
    """The serve, registry, bench, rank and shard phases hand
    ``lora_matmul`` at most 64 rows: they keep the kernel they took."""
    assert 64 < WS
    for m in (1, 4, 8, 32, 64):
        for k, n in _qwen2_kn():
            assert t_lm.lora_matmul_version(BF16, m, k, n, 16, True) \
                == "wgmma"


# ---------------------------------------------------------------------------
# the schedule mirror
# ---------------------------------------------------------------------------


def _cta_steps(m, k, n, sms=SMS, pairs=PAIRS):
    """Every (M tile, N tile, K step) the plan's units cover, with
    multiplicity, and the units of each cluster."""
    plan = t_lm.ws_plan(m, k, n, sms, pairs)
    mt = -(-m // t_lm.WS_BM)
    seen = {}
    per_cluster = t_lm.ws_units(m, k, n, sms, pairs)
    for units in per_cluster:
        for g, nt, k0, steps, _ in units:
            for i in range(plan.cl):
                mtile = g * plan.cl + i
                if mtile >= mt:            # the pair's second tile past M
                    continue
                for s in range(k0, k0 + steps):
                    key = (mtile, nt, s)
                    seen[key] = seen.get(key, 0) + 1
    return plan, seen, per_cluster


SHAPES = ([(m, k, n) for m in (1024, 4096) for k, n in _qwen2_kn()]
          + [(129, 3592, 520), (4097, 3592, 520), (300, 600, 136),
             (128, 64, 8), (640, 200, 8), (1000, 3584, 512),
             (2000, 18944, 3584)])


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_ws_plan_deals_every_tile_and_k_step_once(m, k, n):
    plan, seen, per_cluster = _cta_steps(m, k, n)
    mt, nt = -(-m // t_lm.WS_BM), -(-n // t_lm.WS_BN)
    kst = -(-k // t_lm.TC_BK)
    want = {(i, j, s) for i in range(mt) for j in range(nt)
            for s in range(kst)}
    assert set(seen) == want
    assert all(c == 1 for c in seen.values())
    # no empty unit or split; every cluster of the grid has work
    assert all(steps >= 1 for units in per_cluster for *_, steps, _ in units)
    assert plan.blocks == plan.cl * len(per_cluster)
    assert all(per_cluster)
    assert plan.cl == (2 if mt >= 2 else 1)
    if plan.tail:
        assert plan.splits > 1
        assert (plan.splits - 1) * plan.ips < kst <= plan.splits * plan.ips


@pytest.mark.parametrize("m", [1024, 4096])
@pytest.mark.parametrize("k,n", _qwen2_kn())
def test_ws_plan_fills_the_card_at_qwen2_7b_shapes(m, k, n):
    """At qwen2-7b's projections over 1024 and 4096 rows every SM gets work
    where the tiles fill the card (a grid of 132 CTAs), and no cluster runs
    more than one split unit past the others: the busiest cluster's K steps
    stay within one whole tile of the mean."""
    plan, seen, per_cluster = _cta_steps(m, k, n)
    kst = -(-k // t_lm.TC_BK)
    tiles = -(-(-(-m // t_lm.WS_BM)) // 2) * -(-n // t_lm.WS_BN)
    if tiles >= PAIRS:
        assert plan.blocks == SMS
    else:          # fewer group tiles than clusters: each its own cluster,
        # or split along K to fill the card
        assert plan.blocks == 2 * min(PAIRS, tiles * plan.splits)
    load = [sum(u[3] for u in units) for units in per_cluster]
    assert max(load) - min(load) <= kst
    assert max(load) <= -(-sum(load) // len(load)) + kst


def test_ws_plan_splits_only_the_last_wave():
    """qwen2-7b's down projection over 4096 rows: 224 group tiles of
    256 x 256 on 66 clusters are three whole waves (198) and a tail of 26,
    each split into two K ranges of 148 steps (three and a half waves
    instead of four); gate / up over 1024 rows: 264 whole and 32 split in
    two; q / o over 1024 rows: 56 tiles, fewer than the clusters, whole."""
    d = get_config("qwen2-7b").d_model
    ff = get_config("qwen2-7b").d_ff
    assert t_lm.ws_plan(4096, ff, d, SMS, PAIRS) == t_lm.WsPlan(
        cl=2, dp=198, tail=26, splits=2, ips=148, blocks=132)
    assert t_lm.ws_plan(1024, d, ff, SMS, PAIRS) == t_lm.WsPlan(
        cl=2, dp=264, tail=32, splits=2, ips=28, blocks=132)
    assert t_lm.ws_plan(1024, d, d, SMS, PAIRS) == t_lm.WsPlan(
        cl=2, dp=56, tail=0, splits=1, ips=56, blocks=112)
    # k / v: 8 group tiles, each split into 8 ranges of 7 steps
    assert t_lm.ws_plan(1024, d, 512, SMS, PAIRS) == t_lm.WsPlan(
        cl=2, dp=0, tail=8, splits=8, ips=7, blocks=128)
    # one M tile runs unclustered, a CTA a tile
    assert t_lm.ws_plan(128, d, ff, SMS, PAIRS).cl == 1
    # a card that holds fewer clusters: the waves follow it
    assert t_lm.ws_plan(4096, ff, d, SMS, 60).blocks == 120


def test_ws_units_deal_in_runs_of_m_groups():
    """The dealing order the kernel decodes (``tile_of``): group tiles in
    runs of 4 M groups (8 M tiles of 128 rows), M group fastest, then the
    N tile; cluster c takes units c, c + clusters, ..."""
    units = t_lm.ws_units(4096, 18944, 3584, SMS, PAIRS)
    assert len(units) == PAIRS
    first = [u[:2] for u in units[0][:3]]
    assert first == [(0, 0), t_lm.ws_tile(4096, 3584, 2, 66),
                     t_lm.ws_tile(4096, 3584, 2, 132)]
    order = [t_lm.ws_tile(4096, 3584, 2, t) for t in range(12)]
    assert order[:8] == [(0, 0), (1, 0), (2, 0), (3, 0),
                         (0, 1), (1, 1), (2, 1), (3, 1)]
    # the last run of M groups is shorter where the groups do not divide:
    # 1000 rows are 8 M tiles, 4 groups; 1300 rows 11 tiles, 6 groups
    last = [t_lm.ws_tile(1300, 512, 2, t) for t in range(8, 12)]
    assert last == [(4, 0), (5, 0), (4, 1), (5, 1)]
    # every cluster's units in order: the whole ones, then its split one
    for c, mine in enumerate(units):
        splits = [u[4] for u in mine]
        assert splits == sorted(splits, key=lambda s: s >= 0)


# ---------------------------------------------------------------------------
# the plain version against the JAX kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r", [16, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_against_pallas_across_its_blocks(r, dtype):
    """M = 300, K = 600, N = 136 cross the TPU kernel's (256, 256, 512)
    blocks (run as the JAX package's tests run it on the CPU: interpret
    mode); the port's plain version, what a CPU tensor takes, agrees with
    it and with the reference's plain version."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": F32, "bfloat16": BF16}[dtype]
    c = {"float32": 2e-4, "bfloat16": 2e-1}[dtype]
    rng = np.random.default_rng(r)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((300, 600), (600, 136), (600, r), (r, 136))]
    xj, wj, aj, bj = (jnp.asarray(v, jdt) for v in arrays)
    xt, wt, at, bt = (torch.from_numpy(v).to(tdt) for v in arrays)
    got = t2n(tops.lora_matmul(xt, wt, at, bt, 0.5))
    assert got.shape == (300, 136)
    for want in (j2n(jops.lora_matmul(xj, wj, aj, bj, 0.5)),
                 j2n(jref.lora_matmul_ref(xj, wj, aj, bj, 0.5))):
        err = float(np.abs(got - want).max())
        assert err <= c * max(1.0, float(np.abs(want).max())), err


# ---------------------------------------------------------------------------
# a narrow qwen2-7b served in 32-token prefill chunks through the kernel route
# ---------------------------------------------------------------------------


def _requests(cls, cfg, lens, seed=11, max_new=4):
    rng = np.random.default_rng(seed)
    return [cls(uid=i,
                prompt=rng.integers(0, cfg.vocab_size, n,
                                    dtype=np.int64).astype(np.int32),
                max_new=max_new, adapter_id=i % 3)
            for i, n in enumerate(lens)]


def test_engine_long_prompt_chunks_token_identical_to_jax_engine():
    """qwen2-7b's GQA group of 7 and q/k/v biases, narrow (2 layers,
    d_model 256, 2 KV heads, f32), its engine with ``prefill_chunk=32`` and
    the kernel route: prompts of two whole chunks, of two and a ragged
    tail, of one and a tail; the same tokens, ticks and prefills as the JAX
    engine."""
    jcfg, tcfg, jp, tp = make_pair(
        "qwen2-7b", seed=5, reduced=False, n_layers=2, d_model=256,
        d_ff=512, n_kv_heads=2, n_heads=14, vocab_size=389,
        dtype="float32")
    assert tcfg.qkv_bias and tcfg.n_heads // tcfg.n_kv_heads == 7
    jads, tads = make_adapters(jcfg, (0, 7, 13))
    lens = (64, 70, 45, 64)
    jeng = JEngine(jcfg, jp["frozen"], JBank(jads), slots=3, max_len=96,
                   prefill_chunk=32)
    jreqs = _requests(JRequest, jcfg, lens)
    for r in jreqs:
        jeng.submit(r)
    jstats = jeng.run_until_drained()
    assert jstats["completed"] == len(lens) and jstats["drained"]
    eng = ServingEngine(tcfg, tp["frozen"], AdapterBank(tads), slots=3,
                        max_len=96, prefill_chunk=32, use_lora_kernel=True,
                        device="cpu")
    reqs = _requests(Request, tcfg, lens)
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert stats["completed"] == len(lens) and stats["drained"]
    assert stats["prefills"] == sum(n // 32 for n in lens)
    for key in ("ticks", "prefills", "tokens"):
        assert stats[key] == jstats[key], key
    for r, jr in zip(reqs, jreqs):
        assert list(r.output) == list(jr.output), f"uid={r.uid}"


def test_jax_runs_on_the_cpu():
    """The reference side of these tests runs on the CPU."""
    assert jax.default_backend() == "cpu"
