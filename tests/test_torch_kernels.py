"""Each kernel's plain PyTorch version (what the port's wrappers compute for
a CPU tensor) against the JAX Pallas kernel run in interpret mode through
``repro.kernels.ops`` and against the jnp oracles of ``repro.kernels.ref``,
over the sweeps of ``tests/test_kernels.py`` and the ragged shapes of
``tests/test_kernel_padding.py``. Inputs are made with numpy from a seed and
handed to both sides.

Tolerances are those of the reference's own kernel tests: for the LoRA
products ``atol = c * max|want|`` with c = 2e-4 (f32, summation order) and
2e-1 (bf16; the reference's figure, the measured disagreement is about one
bf16 ulp); for attention 2e-5 absolute in f32 and 3e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import j2n, t2n
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import naive_attention as j_naive_attention
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import lora_matmul as t_lm
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

ATOL = {"float32": 2e-4, "bfloat16": 2e-1}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(rng, shape, dtype):
    """One numpy draw as a JAX array and a tensor of ``dtype`` (both round
    the same f32 values to nearest-even)."""
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _close(got, want, c):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=c * np.abs(want).max(), rtol=0)


# ---------------------------------------------------------------------------
# lora_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n,r", [
    (64, 64, 64, 4), (100, 96, 72, 8), (256, 128, 512, 16),
    (33, 70, 65, 2),     # awkward non-multiples
    (37, 53, 41, 3),     # every dimension prime
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_matmul_plain_vs_pallas_and_ref(m, k, n, r, dtype):
    rng = np.random.default_rng(0)
    (xj, xt), (wj, wt) = _both(rng, (m, k), dtype), _both(rng, (k, n), dtype)
    (aj, at), (bj, bt) = _both(rng, (k, r), dtype), _both(rng, (r, n), dtype)
    got = t2n(tops.lora_matmul(xt, wt, at, bt, 0.5))
    assert got.shape == (m, n)
    _close(got, j2n(jref.lora_matmul_ref(xj, wj, aj, bj, 0.5)), ATOL[dtype])
    _close(got, j2n(jops.lora_matmul(xj, wj, aj, bj, 0.5,
                                     bm=32, bn=64, bk=32)), ATOL[dtype])


def test_lora_matmul_batched_leading_dims():
    rng = np.random.default_rng(1)
    (xj, xt), (wj, wt) = (_both(rng, (2, 17, 64), "float32"),
                          _both(rng, (64, 48), "float32"))
    (aj, at), (bj, bt) = (_both(rng, (64, 4), "float32"),
                          _both(rng, (4, 48), "float32"))
    got = t2n(tops.lora_matmul(xt, wt, at, bt, 1.0))
    want = j2n(jops.lora_matmul(xj, wj, aj, bj, 1.0, bm=16, bn=16, bk=16))
    assert got.shape == (2, 17, 48)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_lora_matmul_casts_f32_adapters_to_activation_dtype():
    """bf16 activations with f32 adapters (the serving case): A and B are
    rounded to bf16 first, as ``kernels/ref.py`` does."""
    rng = np.random.default_rng(2)
    (xj, xt), (wj, wt) = (_both(rng, (9, 64), "bfloat16"),
                          _both(rng, (64, 40), "bfloat16"))
    (aj, at), (bj, bt) = (_both(rng, (64, 4), "float32"),
                          _both(rng, (4, 40), "float32"))
    out = t_lm.lora_matmul(xt, wt, at, bt, 2.0)
    assert out.dtype == torch.bfloat16
    _close(t2n(out), j2n(jref.lora_matmul_ref(xj, wj, aj, bj, 2.0)), 1e-2)


@pytest.mark.parametrize("g,m,k,n,r,e", [
    (3, 1, 64, 48, 4, 2),     # decode shape: one token per request
    (4, 8, 128, 128, 8, 4),
    (2, 5, 100, 72, 4, 5),    # awkward non-multiples
    (6, 1, 256, 96, 16, 3),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_matmul_grouped_plain_vs_pallas_and_ref(g, m, k, n, r, e, dtype):
    rng = np.random.default_rng(2)
    (xj, xt), (wj, wt) = _both(rng, (g, m, k), dtype), _both(rng, (k, n), dtype)
    (aj, at), (bj, bt) = (_both(rng, (e, k, r), dtype),
                          _both(rng, (e, r, n), dtype))
    ids = rng.integers(0, e, g).astype(np.int32)
    got = t2n(tops.lora_matmul_grouped(xt, wt, at, bt, torch.from_numpy(ids),
                                       0.5))
    assert got.shape == (g, m, n)
    _close(got, j2n(jref.lora_matmul_grouped_ref(xj, wj, aj, bj,
                                                 jnp.asarray(ids), 0.5)),
           ATOL[dtype])
    _close(got, j2n(jops.lora_matmul_grouped(xj, wj, aj, bj, jnp.asarray(ids),
                                             0.5, bn=64, bk=32)), ATOL[dtype])


def test_lora_matmul_grouped_matches_single_adapter_loop():
    rng = np.random.default_rng(3)
    g, m, k, n, r, e = 5, 4, 96, 80, 8, 3
    x = torch.from_numpy(rng.standard_normal((g, m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((e, k, r)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((e, r, n)).astype(np.float32))
    ids = torch.from_numpy(np.asarray([2, 0, 1, 1, 2], np.int32))
    got = tops.lora_matmul_grouped(x, w, a, b, ids, 0.7)
    want = torch.stack([tops.lora_matmul(x[gi], w, a[aid], b[aid], 0.7)
                        for gi, aid in enumerate(ids.tolist())])
    np.testing.assert_allclose(t2n(got), t2n(want), atol=2e-4, rtol=0)


def test_lora_matmul_grouped_2d_rows_and_strided_bank():
    """(G, K) input squeezes through; a bank that is a strided view (as
    ``AdapterBank.gather`` leaves it) gives the same result."""
    rng = np.random.default_rng(4)
    g, k, n, r, e = 4, 64, 48, 4, 2
    (xj, xt), (wj, wt) = (_both(rng, (g, k), "float32"),
                          _both(rng, (k, n), "float32"))
    (aj, at), (bj, bt) = (_both(rng, (e, k, r), "float32"),
                          _both(rng, (e, r, n), "float32"))
    ids = np.asarray([0, 1, 1, 0], np.int32)
    want = j2n(jops.lora_matmul_grouped(xj, wj, aj, bj, jnp.asarray(ids), 1.0,
                                        bn=16, bk=16))
    got = tops.lora_matmul_grouped(xt, wt, at, bt, torch.from_numpy(ids), 1.0)
    assert got.shape == (g, n)
    np.testing.assert_allclose(t2n(got), want, atol=2e-4, rtol=0)
    strided = torch.stack([at, at], dim=1)[:, 1]
    assert not strided.is_contiguous()
    got2 = tops.lora_matmul_grouped(xt, wt, strided, bt,
                                    torch.from_numpy(ids), 1.0)
    np.testing.assert_array_equal(t2n(got2), t2n(got))


def test_lora_wrappers_reject_bad_arguments():
    x, w = torch.zeros(4, 8), torch.zeros(8, 6)
    a, b = torch.zeros(8, 2), torch.zeros(2, 6)
    with pytest.raises(ValueError, match="shapes do not agree"):
        t_lm.lora_matmul(x, w, a, torch.zeros(3, 6))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_lm.lora_matmul(x.double(), w, a, b)
    with pytest.raises(ValueError, match="rank"):
        t_lm.lora_matmul(x, w, torch.zeros(8, 65), torch.zeros(65, 6))
    with pytest.raises(ValueError, match="shapes do not agree"):
        t_lm.lora_matmul_grouped(x[:, None], w, a[None], b[None],
                                 torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError, match="integer"):
        t_lm.lora_matmul_grouped(x[:, None], w, a[None], b[None],
                                 torch.zeros(4))


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------


def _attn_case(seed, b, s, hq, hkv, d, dtype="float32"):
    rng = np.random.default_rng(seed)
    q = _both(rng, (b, s, hq, d), dtype)
    k = _both(rng, (b, s, hkv, d), dtype)
    v = _both(rng, (b, s, hkv, d), dtype)
    return q, k, v


def _check_attention(q, k, v, window, atol):
    (qj, qt), (kj, kt), (vj, vt) = q, k, v
    b, s = qj.shape[:2]
    got = tops.flash_attention(qt, kt, vt, causal=True, window=window)
    assert got.shape == qt.shape
    pos = jnp.broadcast_to(jnp.arange(s), (b, s))
    naive = j2n(j_naive_attention(qj, kj, vj, causal=True, window=window,
                                  q_positions=pos, k_positions=pos))
    pallas = j2n(jops.flash_attention(qj, kj, vj, causal=True, window=window,
                                      block_q=64, block_k=64))
    np.testing.assert_allclose(t2n(got), naive, atol=atol, rtol=0)
    np.testing.assert_allclose(t2n(got), pallas, atol=atol, rtol=0)


@pytest.mark.parametrize("s,hq,hkv,d", [
    (128, 4, 4, 32),     # MHA
    (128, 8, 2, 32),     # GQA
    (200, 4, 2, 64),     # non-multiple seq
    (96, 25, 5, 16),     # hymba-style head count
])
@pytest.mark.parametrize("window", [0, 64])
def test_flash_attention_plain_vs_pallas_sweep(s, hq, hkv, d, window):
    _check_attention(*_attn_case(2, 2, s, hq, hkv, d), window, 2e-5)


@pytest.mark.parametrize("s,window", [
    (65, 0),      # one past the block boundary
    (63, 0),      # one short
    (130, 64),    # window crosses the ragged tail
    (127, 32),    # partial final block + window inside it
    (40, 0),      # shorter than one block
])
def test_flash_attention_plain_vs_pallas_ragged(s, window):
    _check_attention(*_attn_case(10, 2, s, 4, 4, 16), window, 2e-5)


def test_flash_attention_gqa_ragged():
    _check_attention(*_attn_case(11, 1, 65, 8, 2, 16), 0, 2e-5)


def test_flash_attention_bf16():
    _check_attention(*_attn_case(3, 1, 128, 4, 4, 32, "bfloat16"), 0, 3e-2)


def test_flash_attention_3d_form_against_ref():
    """The kernel wrapper's own (BH, S, D) form, GQA by index, non-causal
    with Sq != Skv, against ``ref.flash_attention_ref`` on K/V broadcast
    over the group by hand."""
    rng = np.random.default_rng(5)
    (qj, qt) = _both(rng, (6, 20, 16), "float32")
    (kj, kt) = _both(rng, (3, 33, 16), "float32")
    (vj, vt) = _both(rng, (3, 33, 16), "float32")
    for causal, window in ((False, 0), (True, 0), (True, 7)):
        got = t_fa.flash_attention(qt, kt, vt, causal=causal, window=window)
        want = j2n(jref.flash_attention_ref(
            qj, jnp.repeat(kj, 2, axis=0), jnp.repeat(vj, 2, axis=0),
            causal=causal, window=window))
        np.testing.assert_allclose(t2n(got), want, atol=2e-5, rtol=0)


def test_ops_flash_attention_ignores_position_arguments():
    (_, qt), (_, kt), (_, vt) = _attn_case(6, 1, 12, 4, 2, 16)
    pos = torch.arange(100, 112)[None]
    a = tops.flash_attention(qt, kt, vt, causal=True, window=0)
    b = tops.flash_attention(qt, kt, vt, causal=True, window=0,
                             q_positions=pos, k_positions=pos)
    np.testing.assert_array_equal(t2n(a), t2n(b))


def test_flash_wrapper_rejects_bad_arguments():
    q = torch.zeros(2, 4, 8, 16)
    with pytest.raises(ValueError, match="shapes do not agree"):
        t_fa.flash_attention(q, torch.zeros(2, 3, 8, 16),
                             torch.zeros(2, 3, 8, 16))
    with pytest.raises(TypeError, match="float32 or all"):
        t_fa.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="window"):
        t_fa.flash_attention(q, q, q, window=-1)


def test_cpu_tensors_never_count_as_launches():
    """The counters count kernel launches only; on the CPU the wrappers
    take the plain versions and the counts stay where they were."""
    reset_launch_counts()
    x = torch.zeros(3, 8)
    tops.lora_matmul(x, torch.zeros(8, 4), torch.zeros(8, 2),
                     torch.zeros(2, 4))
    tops.lora_matmul_grouped(x, torch.zeros(8, 4), torch.zeros(1, 8, 2),
                             torch.zeros(1, 2, 4),
                             torch.zeros(3, dtype=torch.int32))
    q = torch.zeros(1, 5, 2, 16)
    tops.flash_attention(q, q, q)
    assert launch_counts() == {"lora_matmul": 0, "lora_matmul_grouped": 0,
                               "flash_attention": 0}
