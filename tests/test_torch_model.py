"""The port's model against the JAX reference on the same weights (made by
the reference's ``init_params``, converted leaf for leaf, adapters with a
non-zero B) and the same numpy-seeded tokens, at the reduced size (2 layers,
d_model 256, f32).

Tolerance: logits ``atol = 2e-4`` — f32 matmuls of the two libraries differ
by summation order only; cache leaves the same; the int8 cache may flip one
quantisation step where a value sits on a rounding boundary (the two
libraries' f32 products differ in the last bit), so its integer leaves are
allowed one step on a few entries, and logits computed from such a cache get
``atol = 2e-3``: one step moves a cached value by ``max|row| / 127``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import j2n, make_pair, t2n
from repro.configs.base import get_config as jax_get_config
from repro.models import model as JM
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import make_prefill_step, make_serve_step
from repro_torch.models import attention as t_attn
from repro_torch.models import model as TM
from repro_torch.models.common import tree_leaves

torch.set_num_threads(1)

ATOL = 2e-4
ATOL_INT8_CACHE = 2e-3


def _atol(cfg):
    return ATOL_INT8_CACHE if cfg.kv_cache_dtype == "int8" else ATOL


VARIANTS = {
    "llama32-1b": ("llama32-1b", {}),
    "qwen2-7b-bias": ("qwen2-7b", {}),
    "qwen3-0.6b-qknorm": ("qwen3-0.6b", {}),
    "llama32-1b-ring8": ("llama32-1b", {"sliding_window": 8}),
    "llama32-1b-int8kv": ("llama32-1b", {"kv_cache_dtype": "int8"}),
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    arch, overrides = VARIANTS[request.param]
    return make_pair(arch, seed=0, **overrides)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _cache_leaves_close(jcache, tcache):
    """Same keys, same shapes, same contents, leaf by leaf."""
    assert set(jcache) == set(tcache)
    for key, b in tcache.items():
        a = jcache[key]
        if isinstance(b, dict):
            _cache_leaves_close(a, b)
            continue
        assert tuple(a.shape) == tuple(b.shape), key
        if b.dtype == torch.int8:
            diff = np.abs(np.asarray(a, np.int32) - b.numpy().astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, key
        else:
            np.testing.assert_allclose(t2n(b), j2n(a), atol=ATOL, rtol=0,
                                       err_msg=key)


def test_forward_hidden_and_logits(pair):
    jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, (2, 12), 1)
    jh, _ = JM.forward_hidden(jp["frozen"], jp["lora"], jnp.asarray(toks),
                              jcfg, impl="naive", remat=False)
    jl = JM.logits_from_hidden(jp["frozen"], jh, jcfg)
    with torch.no_grad():
        th, aux = TM.forward_hidden(tp["frozen"], tp["lora"],
                                    torch.from_numpy(toks), tcfg, impl="naive")
        tl = TM.logits_from_hidden(tp["frozen"], th, tcfg)
    assert float(aux) == 0.0
    assert tl.dtype == torch.float32
    assert tuple(tl.shape) == (2, 12, tcfg.padded_vocab)
    np.testing.assert_allclose(t2n(th), j2n(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t2n(tl), j2n(jl), atol=ATOL, rtol=0)


def test_forward_hidden_layer_range_and_sliced_lora(pair):
    """Layers [1, 2) on hidden states, with the adapters already sliced."""
    jcfg, tcfg, jp, tp = pair
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    jl = {"layers": JM.slice_layers(jp["lora"]["layers"], 1, 2)}
    tl = {"layers": TM.slice_layers(tp["lora"]["layers"], 1, 2)}
    jh, _ = JM.forward_hidden(jp["frozen"], jl, jnp.asarray(h), jcfg, lo=1,
                              hi=2, impl="naive", remat=False,
                              lora_sliced=True)
    with torch.no_grad():
        th, _ = TM.forward_hidden(tp["frozen"], tl, torch.from_numpy(h), tcfg,
                                  lo=1, hi=2, impl="naive", lora_sliced=True)
    np.testing.assert_allclose(t2n(th), j2n(jh), atol=ATOL, rtol=0)


@pytest.mark.parametrize("vector_t", [False, True])
def test_decode_step_scalar_and_vector_t(pair, vector_t):
    """Twelve steps past the 8-slot ring; scalar ``t`` for the whole batch,
    or a (B,) vector with each row at its own position."""
    jcfg, tcfg, jp, tp = pair
    b, steps, max_len = 3, 12, 16
    toks = _tokens(jcfg, (b, steps), 3)
    offs = np.asarray([0, 0, 0] if not vector_t else [0, 2, 5], np.int32)
    jcache = JM.init_cache(jcfg, b, max_len)
    tcache = TM.init_cache(tcfg, b, max_len, device="cpu")
    step = make_serve_step(tcfg, device="cpu")
    jstep = jax.jit(lambda c, x, t: JM.decode_step(
        jp["frozen"], jp["lora"], c, x, t, jcfg))
    if vector_t:        # rows start at different positions: feed a prefix
        for t in range(int(offs.max())):
            live = (t < offs)
            tt = np.where(live, t, 0).astype(np.int32)
            xx = np.where(live[:, None], toks[:, :1], 0).astype(np.int32)
            _, jcache = jstep(jcache, jnp.asarray(xx), jnp.asarray(tt))
            _, tcache = step(tp["frozen"], tp["lora"], tcache, xx,
                             torch.from_numpy(tt))
    for i in range(steps - int(offs.max())):
        t = (offs + i) if vector_t else np.int32(i)
        jl, jcache = jstep(jcache, jnp.asarray(toks[:, i:i + 1]),
                           jnp.asarray(t))
        tl, tcache = step(tp["frozen"], tp["lora"], tcache,
                          toks[:, i:i + 1],
                          torch.from_numpy(t) if vector_t else int(t))
        np.testing.assert_allclose(t2n(tl), j2n(jl), atol=_atol(tcfg),
                                   rtol=0, err_msg=f"step {i}")
    assert tuple(tl.shape) == (b, tcfg.padded_vocab)
    _cache_leaves_close(jcache, tcache)


def test_prefill_chunk_two_chunks_and_cache(pair):
    jcfg, tcfg, jp, tp = pair
    b, max_len, half = 2, 16, 4
    toks = _tokens(jcfg, (b, 2 * half), 4)
    jcache = JM.init_cache(jcfg, b, max_len)
    tcache = TM.init_cache(tcfg, b, max_len, device="cpu")
    for use_kernel in (False, True):
        # the kernel route on the CPU is the kernels' plain versions; it
        # restarts from position 0 and overwrites the same cache lanes
        for lo in (0, half):
            jl, jcache = JM.prefill_chunk(
                jp["frozen"], jp["lora"], jcache,
                jnp.asarray(toks[:, lo:lo + half]), lo, jcfg)
            with torch.no_grad():
                tl, tcache = TM.prefill_chunk(
                    tp["frozen"], tp["lora"], tcache,
                    torch.from_numpy(toks[:, lo:lo + half]), lo, tcfg,
                    use_lora_kernel=use_kernel)
            np.testing.assert_allclose(t2n(tl), j2n(jl), atol=_atol(tcfg),
                                       rtol=0)
        _cache_leaves_close(jcache, tcache)


def test_prefill_chunk_matches_decode_loop(pair):
    """Within the port: chunked prefill reproduces the token-by-token
    decode loop's logits and cache (atol 2e-4: parallel re-association)."""
    _, tcfg, _, tp = pair
    b, s = 2, 8
    toks = torch.from_numpy(_tokens(tcfg, (b, s), 5))
    c1 = TM.init_cache(tcfg, b, 16, device="cpu")
    c2 = TM.init_cache(tcfg, b, 16, device="cpu")
    with torch.no_grad():
        want, c1 = TM.decode_scan(tp["frozen"], tp["lora"], c1, toks, 0, tcfg)
        _, c2 = TM.prefill_chunk(tp["frozen"], tp["lora"], c2, toks[:, :4], 0,
                                 tcfg)
        got, c2 = TM.prefill_chunk(tp["frozen"], tp["lora"], c2, toks[:, 4:],
                                   4, tcfg)
    np.testing.assert_allclose(t2n(got), t2n(want), atol=_atol(tcfg), rtol=0)
    for x, y in zip(tree_leaves(c1), tree_leaves(c2)):
        if x.dtype == torch.int8:
            assert (x.int() - y.int()).abs().max() <= 1
        else:
            np.testing.assert_allclose(t2n(x), t2n(y), atol=2e-3, rtol=0)


def test_prefill_flash_vs_reference_pallas(pair):
    """``impl="flash"`` (on the CPU: the kernel's plain version) against the
    reference's ``impl="pallas"`` (interpret mode) and ``impl="naive"``."""
    jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, (2, 20), 6)
    jl_pallas, _ = JM.prefill(jp["frozen"], jp["lora"], jnp.asarray(toks),
                              jcfg, impl="pallas")
    jl_naive, jh = JM.prefill(jp["frozen"], jp["lora"], jnp.asarray(toks),
                              jcfg, impl="naive")
    tl = make_prefill_step(tcfg, impl="flash", device="cpu")(
        tp["frozen"], tp["lora"], toks)
    with torch.no_grad():
        tl_chunked, th = TM.prefill(tp["frozen"], tp["lora"],
                                    torch.from_numpy(toks), tcfg,
                                    impl="chunked")
    assert tuple(tl.shape) == (2, tcfg.padded_vocab)
    np.testing.assert_allclose(t2n(tl), j2n(jl_pallas), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t2n(tl), j2n(jl_naive), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t2n(tl_chunked), j2n(jl_naive), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(t2n(th), j2n(jh), atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-26b"])
def test_embeds_input_families(arch):
    """The audio and vlm families are dense decoders over precomputed
    embeddings: forward and one cached decode step against the reference."""
    jcfg, tcfg, jp, tp = make_pair(arch, seed=3)
    assert tcfg.input_mode == "embeds"
    x = np.random.default_rng(9).standard_normal(
        (2, 6, jcfg.d_model)).astype(np.float32)
    jh, _ = JM.forward_hidden(jp["frozen"], jp["lora"], jnp.asarray(x), jcfg,
                              impl="naive", remat=False)
    with torch.no_grad():
        th, _ = TM.forward_hidden(tp["frozen"], tp["lora"],
                                  torch.from_numpy(x), tcfg, impl="naive")
    np.testing.assert_allclose(t2n(th), j2n(jh), atol=ATOL, rtol=0)
    jl, _ = JM.decode_step(jp["frozen"], jp["lora"], JM.init_cache(jcfg, 2, 8),
                           jnp.asarray(x[:, :1]), jnp.int32(0), jcfg)
    tl, _ = make_serve_step(tcfg, device="cpu")(
        tp["frozen"], tp["lora"], TM.init_cache(tcfg, 2, 8, device="cpu"),
        x[:, :1], 0)
    np.testing.assert_allclose(t2n(tl), j2n(jl), atol=ATOL, rtol=0)


def test_padded_vocab_columns_are_masked():
    jcfg, tcfg, jp, tp = make_pair("llama32-1b", seed=1, vocab_size=300)
    assert tcfg.padded_vocab == 512 and tcfg.vocab_size == 300
    toks = _tokens(jcfg, (1, 5), 7)
    jl, _ = JM.prefill(jp["frozen"], jp["lora"], jnp.asarray(toks), jcfg,
                       impl="naive")
    tl = make_prefill_step(tcfg, impl="naive", device="cpu")(
        tp["frozen"], tp["lora"], toks)
    assert float(tl[:, 300:].max()) == float(np.float32(-1e30))
    np.testing.assert_allclose(t2n(tl[:, :300]), j2n(jl[:, :300]), atol=ATOL,
                               rtol=0)


def test_cache_abs_positions_and_quant_match_reference():
    from repro.models import attention as j_attn
    for t in (np.int32(3), np.int32(21), np.asarray([0, 9, 30], np.int32)):
        for slots, window in ((8, 8), (16, 0), (16, 32)):
            want = np.asarray(j_attn._cache_abs_positions(
                jnp.asarray(t), slots, window, 3))
            got = t_attn._cache_abs_positions(
                torch.as_tensor(t), slots, window, 3).numpy()
            np.testing.assert_array_equal(got, want)
    x = np.random.default_rng(8).standard_normal((2, 3, 4, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0                                   # exercises the clamp
    jq, js = j_attn._quant_kv(jnp.asarray(x))
    tq, ts = t_attn._quant_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)


def test_init_params_structure_matches_reference():
    """Same leaves, shapes and dtypes as the reference's tree, for a dense
    config and one of each family the port runs besides (ssm, hybrid,
    moe); seeded, and with the standard B = 0."""
    def walk(tree, prefix=""):
        for k, v in tree.items():
            path = f"{prefix}['{k}']"
            if isinstance(v, dict):
                yield from walk(v, path)
            else:
                yield path, v

    for arch in ("qwen2-7b",) + FAMILIES:
        tcfg = get_config(arch).reduced()
        tp = TM.init_params(0, tcfg, device="cpu")
        jshapes = jax.tree_util.tree_map(
            lambda x: (tuple(x.shape), str(x.dtype)),
            JM.abstract_params(jax_get_config(arch).reduced()))
        flat_j = {jax.tree_util.keystr(k): v for k, v in
                  jax.tree_util.tree_flatten_with_path(
                      jshapes, is_leaf=lambda x: isinstance(x, tuple))[0]}
        assert {path: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for path, v in walk(tp)} == flat_j, arch
        # same seed, same weights; another seed, other weights
        tp2 = TM.init_params(0, tcfg, device="cpu")
        tp3 = TM.init_params(1, tcfg, device="cpu")
        assert torch.equal(tp["frozen"]["embed"], tp2["frozen"]["embed"])
        assert not torch.equal(tp["frozen"]["embed"], tp3["frozen"]["embed"])
        for path, leaf in walk(tp["lora"]):
            if path.endswith("['b']"):
                assert float(leaf.abs().max()) == 0.0, (arch, path)


# ---------------------------------------------------------------------------
# The ssm, hybrid and moe families: the dense cases above on their configs
# (each case's tolerance as stated there), and what is theirs alone
# ---------------------------------------------------------------------------

FAMILIES = ("mamba2-370m", "hymba-1.5b", "granite-moe-3b-a800m")


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return make_pair(request.param, seed=0)


def test_family_forward_hidden_logits_and_aux(family):
    """The MoE aux loss is summed over the layers as the reference does.
    The kernel routes (``impl="flash"``) are held against the reference in
    ``test_family_prefill_flash_vs_reference_pallas``."""
    jcfg, tcfg, jp, tp = family
    toks = _tokens(jcfg, (2, 40), 1)
    jh, jaux = JM.forward_hidden(jp["frozen"], jp["lora"], jnp.asarray(toks),
                                 jcfg, impl="naive", remat=False)
    jl = JM.logits_from_hidden(jp["frozen"], jh, jcfg)
    with torch.no_grad():
        th, taux = TM.forward_hidden(tp["frozen"], tp["lora"],
                                     torch.from_numpy(toks), tcfg,
                                     impl="naive")
        tl = TM.logits_from_hidden(tp["frozen"], th, tcfg)
    np.testing.assert_allclose(t2n(th), j2n(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t2n(tl), j2n(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL, rtol=0)
    assert (float(taux) > 0) == (tcfg.family == "moe")


def test_family_decode_scan_matches_jax_and_the_step_loop(family):
    """``decode_scan`` over a 6-token chunk from position 3 against the
    reference's, logits and cache by key; within the port equal to six
    ``decode_step`` calls, and the cache updated in place."""
    jcfg, tcfg, jp, tp = family
    b, max_len = 2, 16
    toks = _tokens(jcfg, (b, 9), 7)
    jcache = JM.init_cache(jcfg, b, max_len)
    tcache = TM.init_cache(tcfg, b, max_len, device="cpu")
    loop = TM.init_cache(tcfg, b, max_len, device="cpu")
    leaves = tree_leaves(tcache)
    jl, jcache = JM.decode_scan(jp["frozen"], jp["lora"], jcache,
                                jnp.asarray(toks[:, :3]), 0, jcfg)
    jl, jcache = JM.decode_scan(jp["frozen"], jp["lora"], jcache,
                                jnp.asarray(toks[:, 3:]), 3, jcfg)
    with torch.no_grad():
        _, got = TM.decode_scan(tp["frozen"], tp["lora"], tcache,
                                torch.from_numpy(toks[:, :3]), 0, tcfg)
        tl, got = TM.decode_scan(tp["frozen"], tp["lora"], tcache,
                                 torch.from_numpy(toks[:, 3:]), 3, tcfg)
        for i in range(9):
            want, loop = TM.decode_step(tp["frozen"], tp["lora"], loop,
                                        torch.from_numpy(toks[:, i:i + 1]),
                                        i, tcfg)
    assert got is tcache and all(x is y for x, y in
                                 zip(tree_leaves(got), leaves))
    np.testing.assert_allclose(t2n(tl), j2n(jl), atol=ATOL, rtol=0)
    _cache_leaves_close(jcache, tcache)
    assert torch.equal(tl, want)
    for x, y in zip(tree_leaves(tcache), tree_leaves(loop)):
        assert torch.equal(x, y)


def test_family_prefill_chunk(family):
    """The SSM families' cumulative state has no parallel chunk:
    ``prefill_chunk`` raises and names ``decode_scan``. The MoE family's
    parallel prefill runs the MoE block over the chunk (dropless at the
    reduced size, cf = E/k): two chunks and the cache as the dense cases,
    and equal to the decode loop."""
    jcfg, tcfg, jp, tp = family
    if tcfg.has_ssm:
        cache = TM.init_cache(tcfg, 1, 16, device="cpu")
        with pytest.raises(ValueError, match="decode_scan"):
            TM.prefill_chunk(tp["frozen"], tp["lora"], cache,
                             torch.zeros((1, 4), dtype=torch.int32), 0, tcfg)
    else:
        test_prefill_chunk_two_chunks_and_cache(family)
        test_prefill_chunk_matches_decode_loop(family)


def test_family_prefill_flash_vs_reference_pallas(family):
    test_prefill_flash_vs_reference_pallas(family)
