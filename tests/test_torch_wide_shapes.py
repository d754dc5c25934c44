"""Shapes the reference's kernels take and whose CUDA versions the port has
widened: attention at head dim 112 (kimi-k2-1t-a32b's) over a GQA group of
8, decode over groups above 8 with ``t`` a 0-d tensor (the reference's jnp
scalar), LoRA products at ranks above 64, and the serving engine with
rank-128 adapters through its kernel route. On the CPU each wrapper runs
its plain version; the reference's Pallas kernels run in interpret mode.
Inputs are made with numpy from a seed and handed to both sides.

Tolerances are the reference's own kernel tests': attention and decode
2e-5 absolute in f32 and 3e-2 in bf16; the LoRA products
``c * max|want|`` with c = 2e-4 in f32 (summation order) and 2e-1 in bf16;
engine tokens identical (greedy, the two sides' f32 logits agree to ~1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import j2n, make_adapters, nonzero_b, t2n, to_torch_tree
from repro.configs.base import LoRAConfig as JLoRAConfig
from repro.configs.base import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.models.attention import naive_attention as j_naive_attention
from repro.serving import AdapterBank as JBank
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.configs.base import LoRAConfig
from repro_torch.configs.base import get_config as torch_get_config
from repro_torch.kernels import flash_decode as t_fd
from repro_torch.kernels import launch_counts
from repro_torch.kernels import lora_matmul as t_lm
from repro_torch.kernels import ops as tops
from repro_torch.serving import AdapterBank, Request, ServingEngine

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
LORA_C = {"float32": 2e-4, "bfloat16": 2e-1}


def _both(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _close(got, want, c):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=c * np.abs(want).max(), rtol=0)


# ---------------------------------------------------------------------------
# flash_attention at head dim 112, group 8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,window", [(130, 0), (130, 64), (64, 0)])
def test_flash_attention_head_dim_112_group_8(s, window, dtype):
    """kimi-k2-1t-a32b's heads (64 over 8, dim 112) cut to 16 over 2."""
    rng = np.random.default_rng(21)
    b, hq, hkv, d = 2, 16, 2, 112
    (qj, qt), (kj, kt), (vj, vt) = (_both(rng, (b, s, h, d), dtype)
                                    for h in (hq, hkv, hkv))
    got = t2n(tops.flash_attention(qt, kt, vt, causal=True, window=window))
    pos = jnp.broadcast_to(jnp.arange(s), (b, s))
    naive = j2n(j_naive_attention(qj, kj, vj, causal=True, window=window,
                                  q_positions=pos, k_positions=pos))
    pallas = j2n(jops.flash_attention(qj, kj, vj, causal=True, window=window,
                                      block_q=64, block_k=64))
    assert got.shape == (b, s, hq, d)
    np.testing.assert_allclose(got, pallas, atol=ATTN_TOL[dtype], rtol=0)
    np.testing.assert_allclose(got, naive, atol=ATTN_TOL[dtype], rtol=0)


# ---------------------------------------------------------------------------
# flash_decode: groups above 8, t a 0-d tensor, head dims 112 and others
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,hq,hkv,d,t,window", [
    (100, 32, 2, 112, 60, 0),     # group 16, linear cache
    (100, 32, 2, 112, 99, 0),     # group 16, full cache
    (64, 32, 2, 112, 150, 64),    # group 16, ring buffer past its end
    (77, 40, 2, 112, 50, 20),     # group 20, window over a linear cache
    (70, 9, 1, 40, 33, 0),        # group 9, head dim 40
    (50, 12, 1, 256, 49, 0),      # group 12, head dim 256
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_large_group_device_t(s, hq, hkv, d, t, window, dtype):
    rng = np.random.default_rng(22)
    b = 2
    (qj, qt), (kj, kt), (vj, vt) = (_both(rng, shape, dtype) for shape in (
        (b, 1, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    want = j2n(jops.flash_decode(qj, kj, vj, jnp.asarray(t, jnp.int32),
                                 window=window, block_k=32))
    before = launch_counts()["flash_decode"]
    got = tops.flash_decode(qt, kt, vt, torch.tensor(t), window=window)
    assert tuple(got.shape) == (b, 1, hq, d)
    np.testing.assert_allclose(t2n(got), want, atol=ATTN_TOL[dtype], rtol=0)
    # an int t gives the same, and the CPU runs the plain version only
    np.testing.assert_array_equal(
        t2n(tops.flash_decode(qt, kt, vt, t, window=window)), t2n(got))
    assert launch_counts()["flash_decode"] == before


def test_flash_decode_split_rules_at_the_widened_shapes():
    """The kernel's padded widths and the slots a block takes at the head
    dims and groups the widened kernel runs."""
    assert [t_fd.padded_dim(d, 2) for d in (8, 40, 96, 112, 120, 256)] == [
        16, 64, 112, 112, 128, 256]
    assert [t_fd.padded_dim(d, 4) for d in (8, 40, 112, 200)] == [
        16, 64, 128, 256]
    assert t_fd.block_slots(112, 2, 16) == 128
    # f32: a row of 128 or 256 is one warp; 4 steps at groups above 4
    assert t_fd.block_slots(112, 4, 16) == 4 * 1 * 4
    assert t_fd.block_slots(256, 4, 2) == 4 * 1 * 8
    assert t_fd.block_slots(64, 4, 2) == 4 * 2 * 8


# ---------------------------------------------------------------------------
# LoRA products at ranks above 64
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n,r", [(64, 96, 72, 128), (33, 70, 65, 65),
                                     (16, 128, 64, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_matmul_rank_above_64(m, k, n, r, dtype):
    rng = np.random.default_rng(23)
    (xj, xt), (wj, wt) = _both(rng, (m, k), dtype), _both(rng, (k, n), dtype)
    (aj, at), (bj, bt) = _both(rng, (k, r), dtype), _both(rng, (r, n), dtype)
    got = t2n(tops.lora_matmul(xt, wt, at, bt, 0.25))
    _close(got, j2n(jref.lora_matmul_ref(xj, wj, aj, bj, 0.25)), LORA_C[dtype])
    _close(got, j2n(jops.lora_matmul(xj, wj, aj, bj, 0.25,
                                     bm=32, bn=64, bk=32)), LORA_C[dtype])
    # on the card: bf16 with K, N, r multiples of 8 and f32 with K, N, r
    # multiples of 4 on the tensor cores (x@A in 64-rank panels), the rest
    # on the SIMT kernel
    want = ("wgmma" if dtype == "bfloat16" and k % 8 == n % 8 == r % 8 == 0
            else "tf32x3" if dtype == "float32"
            and k % 4 == n % 4 == r % 4 == 0 else "simt")
    assert t_lm.lora_matmul_version(TDT[dtype], m, k, n, r, True) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_matmul_grouped_rank_128(dtype):
    rng = np.random.default_rng(24)
    g, m, k, n, r, e = 4, 2, 96, 80, 128, 3
    (xj, xt), (wj, wt) = _both(rng, (g, m, k), dtype), _both(rng, (k, n),
                                                             dtype)
    (aj, at), (bj, bt) = _both(rng, (e, k, r), dtype), _both(rng, (e, r, n),
                                                             dtype)
    ids = np.array([2, 0, 1, 2], np.int32)
    got = t2n(t_lm.lora_matmul_grouped(xt, wt, at, bt, torch.from_numpy(ids),
                                       0.25))
    want = j2n(jops.lora_matmul_grouped(xj, wj, aj, bj, jnp.asarray(ids),
                                        0.25, bn=16, bk=16))
    assert got.shape == (g, m, n)
    _close(got, want, LORA_C[dtype])
    _close(got, j2n(jref.lora_matmul_grouped_ref(xj, wj, aj, bj,
                                                 jnp.asarray(ids), 0.25)),
           LORA_C[dtype])
    assert t_lm.lora_matmul_grouped_version(TDT[dtype], k, n, r, True) == (
        "wgmma" if dtype == "bfloat16" else "tf32x3")


# ---------------------------------------------------------------------------
# the engine with rank-128 adapters through the kernel route
# ---------------------------------------------------------------------------


def _rank_pair(arch, rank, seed=0):
    """(jax cfg, torch cfg, jax params, torch params) of the reduced config
    with ``LoRAConfig(rank=rank)`` on both sides, adapters with non-zero B."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               lora=JLoRAConfig(rank=rank))
    tcfg = dataclasses.replace(torch_get_config(arch).reduced(),
                               lora=LoRAConfig(rank=rank))
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = {"frozen": jp["frozen"], "lora": nonzero_b(jp["lora"], seed + 1000)}
    return jcfg, tcfg, jp, to_torch_tree(jp)


def _requests(cls, cfg, n, seed=3, max_new=4):
    rng = np.random.default_rng(seed)
    return [cls(uid=i,
                prompt=rng.integers(0, cfg.vocab_size, 4 + (i % 3) * 3,
                                    dtype=np.int64).astype(np.int32),
                max_new=max_new, adapter_id=i % 3) for i in range(n)]


def test_engine_rank_128_token_identical_to_jax_engine():
    jcfg, tcfg, jp, tp = _rank_pair("qwen3-0.6b", 128)
    assert tcfg.lora.rank == 128 <= t_lm.WGMMA_MAX_RANK == t_lm.TF32_MAX_RANK
    for dtype, version in ((torch.bfloat16, "wgmma"),
                           (torch.float32, "tf32x3")):
        assert t_lm.lora_matmul_version(dtype, 4, 1024, 2048, 128,
                                        True) == version
    jads, tads = make_adapters(jcfg, (0, 7, 13))
    assert tads[0]["layers"]["attn"]["wq"]["a"].shape[-1] == 128
    jeng = JEngine(jcfg, jp["frozen"], JBank(jads), slots=3, max_len=32,
                   prefill_chunk=4)
    jreqs = _requests(JRequest, jcfg, 6)
    for r in jreqs:
        jeng.submit(r)
    jstats = jeng.run_until_drained()
    assert jstats["completed"] == 6 and jstats["drained"]
    eng = ServingEngine(tcfg, tp["frozen"], AdapterBank(tads), slots=3,
                        max_len=32, prefill_chunk=4, use_lora_kernel=True,
                        device="cpu")
    reqs = _requests(Request, tcfg, 6)
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert stats["completed"] == 6 and stats["drained"]
    for key in ("ticks", "prefills", "tokens"):
        assert stats[key] == jstats[key], key
    for r, jr in zip(reqs, jreqs):
        assert list(r.output) == list(jr.output), f"uid={r.uid}"
