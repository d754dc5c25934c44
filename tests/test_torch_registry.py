"""The widths that ``ModelConfig.reduced()`` drops, held against the JAX
reference on the CPU, for the six configs of the registry that run at full
width on one H100 (qwen3-0.6b, qwen3-4b, qwen2-7b, phi3-medium-14b,
internvl2-26b, musicgen-large).

``reduced()`` forces head dim 32, at most 4 query and 2 KV heads, so the
parity tests of ``test_torch_model.py`` never see head dim 128, the real
GQA groups (7, 6, 4, 2 and 1), or an odd vocabulary. Each case here is a
*narrow* variant made with ``dataclasses.replace`` of the published config:
it keeps the head dim (128; musicgen-large 64), the q/kv group with at most
2 KV heads, ``qkv_bias``, ``qk_norm``, ``tie_embeddings``, ``rope_theta``
and ``input_mode``, and takes 2 layers, ``d_model`` 256, an FFN of 512, f32
and a vocabulary of 389 (not a multiple of 256, so ``padded_vocab`` masks
123 columns). Same weights on both sides (the reference's ``init_params``
converted leaf for leaf, adapters with a non-zero B, non-zero QKV biases).

Tolerance: ``atol = 2e-4`` on hidden states and logits, as in
``test_torch_model.py`` (f32 matmuls of the two libraries differ by
summation order only); split grads 1e-4 of each leaf's largest magnitude
with the channel off, as in ``test_torch_splitting.py``. Also pure-Python
checks of the kernels' plans and versions at the full-width projection
shapes of the six configs.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_tree_close, j2n, make_pair, t2n
from repro.core import splitting as JS
from repro.launch.serve import generate as jax_generate
from repro.models import model as JM
from repro_torch.configs.base import get_config
from repro_torch.core import splitting as TS
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import lora_matmul as t_lm
from repro_torch.launch.serve import generate, make_prefill_step
from repro_torch.models import model as TM

torch.set_num_threads(1)

ATOL = 2e-4
SPLIT_C = 1e-4
NARROW_VOCAB = 389
# the published q/kv group of each config
GROUP = {"qwen3-0.6b": 2, "qwen3-4b": 4, "qwen2-7b": 7, "phi3-medium-14b": 4,
         "internvl2-26b": 6, "musicgen-large": 1}
REGISTRY = tuple(GROUP)
SMS = 132                      # the H100 SXM's


def narrow(arch):
    """The overrides of the narrow variant of ``arch``."""
    cfg = get_config(arch)
    hkv = min(cfg.n_kv_heads, 2)
    return dict(n_layers=2, d_model=256, d_ff=512, n_kv_heads=hkv,
                n_heads=cfg.n_heads // cfg.n_kv_heads * hkv,
                vocab_size=NARROW_VOCAB, dtype="float32")


@pytest.fixture(scope="module", params=REGISTRY)
def pair(request):
    return make_pair(request.param, seed=0, reduced=False,
                     **narrow(request.param))


def _inputs(cfg, shape, seed):
    """Tokens (B, S), or (B, S, d) embeddings for an embeds-mode config."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        return rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def _cache_close(jcache, tcache):
    """Same keys (by key: JAX sorts them), shapes and contents."""
    assert set(jcache) == set(tcache)
    for key, b in tcache.items():
        if isinstance(b, dict):
            _cache_close(jcache[key], b)
        else:
            np.testing.assert_allclose(t2n(b), j2n(jcache[key]), atol=ATOL,
                                       rtol=0, err_msg=key)


@pytest.mark.parametrize("arch", REGISTRY)
def test_narrow_variant_keeps_what_reduced_drops(arch):
    full = get_config(arch)
    cfg = dataclasses.replace(full, **narrow(arch))
    assert cfg.resolved_head_dim == full.resolved_head_dim in (64, 128)
    assert cfg.n_heads // cfg.n_kv_heads == GROUP[arch]
    assert full.n_heads // full.n_kv_heads == GROUP[arch]
    for name in ("qkv_bias", "qk_norm", "tie_embeddings", "rope_theta",
                 "input_mode", "family", "lora"):
        assert getattr(cfg, name) == getattr(full, name), name
    assert cfg.padded_vocab == 512 != cfg.vocab_size
    # what reduced() would have run instead
    assert full.reduced().resolved_head_dim == 32
    assert dataclasses.replace(cfg, dtype="bfloat16") != full


def test_forward_hidden_and_logits(pair):
    jcfg, tcfg, jp, tp = pair
    x = _inputs(jcfg, (2, 12), 1)
    jh, _ = JM.forward_hidden(jp["frozen"], jp["lora"], jnp.asarray(x), jcfg,
                              impl="naive", remat=False)
    jl = JM.logits_from_hidden(jp["frozen"], jh, jcfg)
    with torch.no_grad():
        th, _ = TM.forward_hidden(tp["frozen"], tp["lora"],
                                  torch.from_numpy(x), tcfg, impl="naive")
        tl = TM.logits_from_hidden(tp["frozen"], th, tcfg)
    assert tuple(tl.shape) == (2, 12, tcfg.padded_vocab)
    assert float(tl[..., NARROW_VOCAB:].max()) == float(np.float32(-1e30))
    np.testing.assert_allclose(t2n(th), j2n(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t2n(tl), j2n(jl), atol=ATOL, rtol=0)


def test_decode_step(pair):
    """Five steps at a scalar position from an empty cache; logits at each
    step and the cache after the last, by key."""
    jcfg, tcfg, jp, tp = pair
    b, steps = 2, 5
    x = _inputs(jcfg, (b, steps), 3)
    jcache = JM.init_cache(jcfg, b, 8)
    tcache = TM.init_cache(tcfg, b, 8, device="cpu")
    for i in range(steps):
        jl, jcache = JM.decode_step(jp["frozen"], jp["lora"], jcache,
                                    jnp.asarray(x[:, i:i + 1]), jnp.int32(i),
                                    jcfg)
        with torch.no_grad():
            tl, tcache = TM.decode_step(tp["frozen"], tp["lora"], tcache,
                                        torch.from_numpy(x[:, i:i + 1]), i,
                                        tcfg)
        np.testing.assert_allclose(t2n(tl), j2n(jl), atol=ATOL, rtol=0,
                                   err_msg=f"step {i}")
    _cache_close(jcache, tcache)


def test_prefill_chunk(pair):
    """Two chunks of four into one cache, through the plain LoRA route and
    the kernel route (on the CPU: the kernels' plain versions)."""
    jcfg, tcfg, jp, tp = pair
    b, half = 2, 4
    x = _inputs(jcfg, (b, 2 * half), 4)
    jcache = JM.init_cache(jcfg, b, 16)
    tcache = TM.init_cache(tcfg, b, 16, device="cpu")
    for use_kernel in (False, True):
        for lo in (0, half):
            jl, jcache = JM.prefill_chunk(jp["frozen"], jp["lora"], jcache,
                                          jnp.asarray(x[:, lo:lo + half]), lo,
                                          jcfg)
            with torch.no_grad():
                tl, tcache = TM.prefill_chunk(
                    tp["frozen"], tp["lora"], tcache,
                    torch.from_numpy(x[:, lo:lo + half]), lo, tcfg,
                    use_lora_kernel=use_kernel)
            np.testing.assert_allclose(t2n(tl), j2n(jl), atol=ATOL, rtol=0)
        _cache_close(jcache, tcache)


def test_prefill_flash_vs_reference_pallas(pair):
    """``make_prefill_step(impl="flash")`` (on the CPU: the kernel's plain
    version) against the reference's ``impl="pallas"`` in interpret mode."""
    jcfg, tcfg, jp, tp = pair
    x = _inputs(jcfg, (2, 20), 6)
    jl, _ = JM.prefill(jp["frozen"], jp["lora"], jnp.asarray(x), jcfg,
                       impl="pallas")
    tl = make_prefill_step(tcfg, impl="flash", device="cpu")(
        tp["frozen"], tp["lora"], x)
    assert tuple(tl.shape) == (2, tcfg.padded_vocab)
    np.testing.assert_allclose(t2n(tl), j2n(jl), atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-26b"])
def test_generate_from_an_embeds_prompt(arch):
    """The port's ``generate`` reads the tokens an embeds-mode decoder
    generates through its embedding table; held against the reference's
    ``decode_step`` driven that way. The reference's own ``generate`` feeds
    the raw tokens back and raises at the first generated token."""
    jcfg, tcfg, jp, tp = make_pair(arch, seed=2, reduced=False,
                                   **narrow(arch))
    b, s0, new = 2, 5, 4
    prompt = _inputs(jcfg, (b, s0), 7) * 0.02
    with pytest.raises(ValueError):
        jax_generate(jcfg, jp["frozen"], jp["lora"], jnp.asarray(prompt), 1)
    cache = JM.init_cache(jcfg, b, s0 + new)
    for t in range(s0):
        logits, cache = JM.decode_step(jp["frozen"], jp["lora"], cache,
                                       jnp.asarray(prompt[:, t:t + 1]),
                                       jnp.int32(t), jcfg)
    want = []
    for i in range(new):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
        emb = jnp.take(jp["frozen"]["embed"], tok, axis=0)[:, None]
        logits, cache = JM.decode_step(jp["frozen"], jp["lora"], cache, emb,
                                       jnp.int32(s0 + i), jcfg)
    got = generate(tcfg, tp["frozen"], tp["lora"], torch.from_numpy(prompt),
                   new, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, new)
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))


def test_split_grads_embeds_device_stage():
    """musicgen-large's narrow variant at cut 1, channel off: the device
    stage starts from (B, S, d) embeddings, not a token lookup."""
    arch = "musicgen-large"
    jcfg, tcfg, jp, tp = make_pair(arch, seed=0, reduced=False, **narrow(arch))
    rng = np.random.default_rng(5)
    embeds = (rng.standard_normal((2, 16, jcfg.d_model)) * 0.02
              ).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jd, js = JS.split_lora(jp["lora"], 1)
    jloss, jgd, jgs = JS.split_grads(jp["frozen"], jd, js, jnp.asarray(embeds),
                                     jnp.asarray(labels), cfg=jcfg, cut=1,
                                     compress=False)
    td, ts = TS.split_lora(tp["lora"], 1)
    tloss, tgd, tgs = TS.split_grads(tp["frozen"], td, ts,
                                     torch.from_numpy(embeds),
                                     torch.from_numpy(labels), cfg=tcfg, cut=1,
                                     compress=False)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    assert_tree_close(jgd, tgd, SPLIT_C)
    assert_tree_close(jgs, tgs, SPLIT_C)
    assert any(t2n(x).any() for x in TS.tree_leaves(tgd))


# ---------------------------------------------------------------------------
# the kernels' plans and versions at the full-width shapes (no GPU needed)
# ---------------------------------------------------------------------------


def _projections(cfg):
    """(K, N) of every LoRA projection of a layer at the published width."""
    d, q, kv, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    return sorted({(d, q), (d, kv), (q, d), (d, ff), (ff, d)})


def _k_steps(k, splits, ips):
    n_iters = -(-k // t_lm.TC_BK)
    return [list(range(s * ips, min((s + 1) * ips, n_iters)))
            for s in range(splits)]


@pytest.mark.parametrize("arch", REGISTRY)
def test_tc_plan_deals_every_k_step_once_at_full_width(arch):
    """``lora_matmul`` at every projection, M = 8 (a tick's rows), 64 (a
    prefill chunk of the engine) and 4096 (a (4, 1024) batch); every K step
    of 64 dealt to exactly one split, none empty (qwen2-7b's down
    projection: K = 18944, 296 steps), bf16 ``wgmma``."""
    cfg = get_config(arch)
    for k, n in _projections(cfg):
        assert t_lm.lora_matmul_version(torch.bfloat16, k, n, cfg.lora.rank,
                                        True) == "wgmma", (k, n)
        for m in (8, 64, 4096):
            bn, splits, ips = t_lm.tc_plan(m, k, n, SMS)
            ranges = _k_steps(k, splits, ips)
            assert all(ranges), (m, k, n, "an empty split")
            assert ([i for rg in ranges for i in rg]
                    == list(range(-(-k // t_lm.TC_BK)))), (m, k, n)
            assert bn in (64, 128)


@pytest.mark.parametrize("arch", REGISTRY)
def test_grouped_plan_deals_every_k_step_once_at_full_width(arch):
    """``lora_matmul_grouped`` at every projection of a tick of 8 slots:
    every K step once, none empty, each row's x@A in one block, bf16
    ``wgmma``."""
    cfg = get_config(arch)
    r = cfg.lora.rank
    for k, n in _projections(cfg):
        assert t_lm.lora_matmul_grouped_version(torch.bfloat16, k, n, r,
                                                True) == "wgmma", (k, n)
        bn, splits, ips, nx = t_lm.grouped_plan(8, k, n, SMS, r)
        ranges = _k_steps(k, splits, ips)
        assert all(ranges), (k, n, "an empty split")
        assert ([i for rg in ranges for i in rg]
                == list(range(-(-k // 64)))), (k, n)
        assert nx >= -(-n // bn)
        owned = [list(t_lm.grouped_xa_rows(bx, 8, nx)) for bx in range(nx)]
        assert sorted(i for o in owned for i in o) == list(range(8))


@pytest.mark.parametrize("arch", REGISTRY)
def test_flash_attention_version_at_the_model_head_dim(arch):
    cfg = get_config(arch)
    assert cfg.resolved_head_dim in t_fa.HEAD_DIMS
    assert t_fa.flash_attention_version(torch.bfloat16, cfg.resolved_head_dim,
                                        True) == "wgmma"
    assert t_fa.flash_attention_version(torch.float32, cfg.resolved_head_dim,
                                        True) == "tf32x3"
