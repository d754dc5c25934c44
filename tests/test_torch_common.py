"""The port's shared blocks, configs, channel and converter against the JAX
reference, on the same numpy-seeded inputs. Tolerances are stated at each
assertion: f32 elementwise code agrees to a few ulps, matmuls to summation
order."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import j2n, t2n, to_numpy_tree
from repro.configs import base as jbase
from repro.core import channel as jchannel
from repro.models import common as jcommon
from repro_torch.configs import base as tbase
from repro_torch.convert import from_numpy_tree
from repro_torch.core import channel as tchannel
from repro_torch.models import common as tcommon

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_config_equal_field_for_field(arch):
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    for reduce in (False, True):
        jc, tc = jbase.get_config(arch), tbase.get_config(arch)
        if reduce:
            jc, tc = jc.reduced(), tc.reduced()
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        for prop in ("padded_vocab", "resolved_head_dim", "q_dim", "kv_dim",
                     "has_ssm", "is_moe", "ssm_d_inner"):
            assert getattr(jc, prop) == getattr(tc, prop), prop
        for fn in ("total_params", "active_params", "lora_params_per_layer",
                   "params_per_layer", "embed_params"):
            assert getattr(jc, fn)() == getattr(tc, fn)(), fn
        assert tc.lora.scale == jc.lora.scale


def test_get_config_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        tbase.get_config("no-such-arch")


def test_long_context_variant_and_shapes_match():
    assert tbase.INPUT_SHAPES == jbase.INPUT_SHAPES or all(
        dataclasses.asdict(tbase.INPUT_SHAPES[k])
        == dataclasses.asdict(jbase.INPUT_SHAPES[k])
        for k in jbase.INPUT_SHAPES)
    for arch in ("llama32-1b", "mamba2-370m", "hymba-1.5b"):
        jv = jbase.long_context_variant(jbase.get_config(arch))
        tv = tbase.long_context_variant(tbase.get_config(arch))
        assert dataclasses.asdict(jv) == dataclasses.asdict(tv)


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 7, 4, 32)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    s = rng.standard_normal(shape[-1:]).astype(np.float32)
    want = j2n(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))
    got = t2n(tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_rms_norm_bf16_keeps_dtype_and_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    s = np.ones((64,), np.float32)
    want = j2n(jcommon.rms_norm(jnp.asarray(x).astype(jnp.bfloat16),
                                jnp.asarray(s)))
    out = tcommon.rms_norm(torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(s))
    assert out.dtype == torch.bfloat16
    # one bf16 ulp at |x| < 4: the two frameworks' rsqrt differ in the last bit
    np.testing.assert_allclose(t2n(out), want, atol=2 ** -6, rtol=0)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope_halves_layout(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 9)).astype(np.int32)
    want = j2n(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = t2n(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                 theta))
    # angles up to 300 rad in f32: sin/cos agree to ~1e-5 between libraries
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    np.testing.assert_allclose(
        t2n(tcommon.rope_frequencies(32, theta)),
        j2n(jcommon.rope_frequencies(32, theta)), rtol=1e-6)


def test_silu():
    x = np.linspace(-8, 8, 257).astype(np.float32)
    want = j2n(jcommon.silu(jnp.asarray(x)))
    got = t2n(tcommon.silu(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _lora_inputs(seed, lead, k, n, r, per_row=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (k,)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    ashape = (lead[0], k, r) if per_row else (k, r)
    bshape = (lead[0], r, n) if per_row else (r, n)
    a = (rng.standard_normal(ashape) / np.sqrt(r)).astype(np.float32)
    b = (rng.standard_normal(bshape) * 0.02).astype(np.float32)
    bias = rng.standard_normal((n,)).astype(np.float32)
    return x, w, a, b, bias


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_lora_dense_both_branches(use_kernel, per_row, with_bias):
    """Plain branch against the reference's jnp branch; kernel branch (on
    the CPU: the kernel's plain version) against the reference's Pallas
    kernels in interpret mode. 2-D adapters and per-row (B, K, r) ones."""
    lead = (3, 1) if per_row else (2, 5)
    x, w, a, b, bias = _lora_inputs(3, lead, 64, 48, 4, per_row)
    bias_j = jnp.asarray(bias) if with_bias else None
    bias_t = torch.from_numpy(bias) if with_bias else None
    want = j2n(jcommon.lora_dense(
        jnp.asarray(x), jnp.asarray(w),
        {"a": jnp.asarray(a), "b": jnp.asarray(b)}, 2.0, bias_j,
        use_kernel=use_kernel))
    got = t2n(tcommon.lora_dense(
        torch.from_numpy(x), torch.from_numpy(w),
        {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}, 2.0, bias_t,
        use_kernel=use_kernel))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)  # f32 sum order


def test_lora_dense_without_adapter_is_plain_product():
    x, w, _, _, bias = _lora_inputs(4, (2, 3), 32, 16, 4)
    want = j2n(jcommon.lora_dense(jnp.asarray(x), jnp.asarray(w), None, 2.0,
                                  jnp.asarray(bias), use_kernel=True))
    got = t2n(tcommon.lora_dense(torch.from_numpy(x), torch.from_numpy(w),
                                 None, 2.0, torch.from_numpy(bias),
                                 use_kernel=True))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_lora_dense_bf16_rounding_order():
    """bf16 activations, f32 adapters: the plain branch rounds x@W, x@A and
    the scaled correction each to bf16, as the reference does. Tolerance:
    one bf16 ulp of the largest output (products of the two libraries can
    differ in the last bit before rounding)."""
    x, w, a, b, _ = _lora_inputs(5, (2, 5), 64, 48, 4)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    want = j2n(jcommon.lora_dense(xj, wj, {"a": jnp.asarray(a),
                                           "b": jnp.asarray(b)}, 1.5))
    out = tcommon.lora_dense(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(w).to(torch.bfloat16),
        {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}, 1.5)
    assert out.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(t2n(out), want, atol=ulp, rtol=0)


def test_maybe_lora_and_dtype_of():
    assert tcommon.maybe_lora(None, "wq") is None
    assert tcommon.maybe_lora({"wq": 1}, "wq") == 1
    assert tcommon.maybe_lora({"wq": 1}, "wk") is None
    assert tcommon.dtype_of("bfloat16") is torch.bfloat16
    assert tcommon.dtype_of("float32") is torch.float32


def test_init_lora_pair_shapes_and_zero_b():
    gen = torch.Generator().manual_seed(0)
    pair = tcommon.init_lora_pair(gen, 64, 48, 4, device="cpu")
    assert pair["a"].shape == (64, 4) and pair["b"].shape == (4, 48)
    assert pair["a"].dtype == torch.float32
    assert float(pair["b"].abs().max()) == 0.0
    # A ~ N(0, 1/r): sample std within 15 % at 256 draws
    assert abs(float(pair["a"].std()) - 0.5) < 0.075


def test_from_numpy_tree_leaf_for_leaf():
    tree = {"a": {"w": jnp.ones((2, 3), jnp.bfloat16) * 1.5,
                  "n": jnp.arange(4, dtype=jnp.float32)},
            "i": jnp.arange(3, dtype=jnp.int32)}
    arrays, names = to_numpy_tree(tree)
    out = from_numpy_tree(arrays, "cpu", names)
    assert out["a"]["w"].dtype == torch.bfloat16
    assert out["a"]["n"].dtype == torch.float32
    assert out["i"].dtype == torch.int32
    np.testing.assert_array_equal(t2n(out["a"]["w"]), np.full((2, 3), 1.5))
    # a raw bfloat16 numpy leaf (ml_dtypes) is taken bit for bit
    raw = from_numpy_tree({"w": np.asarray(tree["a"]["w"])}, "cpu")
    assert raw["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(t2n(raw["w"]), np.full((2, 3), 1.5))
    # one dtype for every floating leaf
    cast = from_numpy_tree(arrays, "cpu", torch.float32)
    assert cast["a"]["w"].dtype == torch.float32
    assert cast["i"].dtype == torch.int32


@pytest.mark.parametrize("state", ["good", "normal", "poor"])
def test_channel_stream_bit_identical(state):
    """Admission decisions depend on the channel draws: the port's stream
    must equal the reference's bit for bit (same numpy generator, same
    order of draws)."""
    jc = jchannel.WirelessChannel(state, seed=7)
    tc = tchannel.WirelessChannel(state, seed=7)
    for _ in range(5):
        a, b = jc.draw(), tc.draw()
        assert (a.snr_up_db, a.snr_down_db, a.rate_up, a.rate_down) == \
               (b.snr_up_db, b.snr_down_db, b.rate_up, b.rate_down)
    ju, jd = jc.draw_rounds(6)
    tu, td = tc.draw_rounds(6)
    np.testing.assert_array_equal(ju, tu)
    np.testing.assert_array_equal(jd, td)
    jm = jchannel.draw_channel_matrix(state, 4, 3, seed=2)
    tm = tchannel.draw_channel_matrix(state, 4, 3, seed=2)
    np.testing.assert_array_equal(jm.rate_up, tm.rate_up)
    np.testing.assert_array_equal(jm.rate_down, tm.rate_down)
    for snr in (-10.0, -6.7, 0.0, 13.2, 30.0):
        assert jchannel.snr_to_efficiency(snr) == tchannel.snr_to_efficiency(snr)
