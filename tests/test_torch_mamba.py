"""The port's Mamba-2 block against the JAX reference's, on the same weights
(made by the reference's ``init_params`` at the reduced size, converted leaf
for leaf, adapters with a non-zero B) and the same numpy-seeded inputs, for
mamba2-370m (the ssm family) and hymba-1.5b (the hybrid family's SSM
branch).

Tolerances: hidden states ``atol = 2e-4`` (f32, the two libraries'
summation orders), as ``test_torch_model.py``; the causal conv 1e-6 (a few
f32 products and adds in one order on both sides); the decode cache leaves
2e-4; the port's step-by-step decode against its own teacher-forced
forward 2e-4 (the chunked scan re-associates the recurrence).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import j2n, make_pair, t2n
from repro.models import mamba as j_mamba
from repro_torch.kernels import launch_counts
from repro_torch.models import mamba as t_mamba
from repro_torch.models.common import tree_take

torch.set_num_threads(1)

ATOL = 2e-4
CONV_ATOL = 1e-6
ULP2 = 2.0 ** -22          # two f32 ulps, relative: log and exp of libm


@pytest.fixture(scope="module", params=["mamba2-370m", "hymba-1.5b"])
def block(request):
    """(jax cfg, torch cfg, jax block params, jax block lora, torch block
    params, torch block lora): layer 1's Mamba block."""
    jcfg, tcfg, jp, tp = make_pair(request.param, seed=4)

    def take(tree):
        return jax.tree_util.tree_map(lambda v: v[1], tree)
    return (jcfg, tcfg, take(jp["frozen"]["layers"]["mamba"]),
            take(jp["lora"]["layers"]["mamba"]),
            tree_take(tp["frozen"]["layers"]["mamba"], 1),
            tree_take(tp["lora"]["layers"]["mamba"], 1))


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


@pytest.mark.parametrize("with_prefix", [False, True])
def test_causal_conv_matches_jax(with_prefix):
    rng = np.random.default_rng(0)
    xbc = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    prefix = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_prefix else None
    want = j_mamba._causal_conv(
        jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b),
        None if prefix is None else jnp.asarray(prefix))
    got = t_mamba._causal_conv(
        torch.from_numpy(xbc), torch.from_numpy(w), torch.from_numpy(b),
        None if prefix is None else torch.from_numpy(prefix))
    np.testing.assert_allclose(t2n(got), j2n(want), atol=CONV_ATOL, rtol=0)


def test_softplus_matches_jax():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)`` everywhere (``F.softplus``
    switches to x above 20); the two libraries' logaddexp agree to within
    two f32 ulps (``ULP2``)."""
    x = np.linspace(-40.0, 40.0, 161).astype(np.float32)
    got = t_mamba._softplus(torch.from_numpy(x))
    np.testing.assert_allclose(t2n(got), j2n(jax.nn.softplus(x)), rtol=ULP2,
                               atol=0)


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_mamba_forward_matches_jax(block, impl):
    """``impl="flash"`` runs ``ops.ssd_scan``, on the CPU the plain
    ``ssd_intra_chunk``; 40 tokens over chunks of 32 (a ragged tail)."""
    jcfg, tcfg, jp, jl, tp, tl = block
    x = _x(jcfg, (2, 40), 1)
    want = jax.jit(j_mamba.mamba_forward, static_argnums=3)(
        jp, jl, jnp.asarray(x), jcfg)
    before = launch_counts()["ssd_intra_chunk"]
    with torch.no_grad():
        got = t_mamba.mamba_forward(tp, tl, torch.from_numpy(x), tcfg,
                                    impl=impl)
    assert launch_counts()["ssd_intra_chunk"] == before    # CPU: plain only
    assert tuple(got.shape) == (2, 40, tcfg.d_model)
    np.testing.assert_allclose(t2n(got), j2n(want), atol=ATOL, rtol=0)


def test_mamba_decode_matches_jax_and_teacher_forced_forward(block):
    """Eight decode steps from a zeroed cache against the reference's, the
    cache leaves compared by key after each; the outputs against the port's
    own full-sequence forward on the same eight tokens."""
    jcfg, tcfg, jp, jl, tp, tl = block
    x = _x(jcfg, (3, 8), 2)
    jcache = j_mamba.init_ssm_cache(jcfg, 3, jnp.float32)
    tcache = t_mamba.init_ssm_cache(tcfg, 3, torch.float32)
    leaves = {k: v for k, v in tcache.items()}
    outs = []
    jdecode = jax.jit(j_mamba.mamba_decode, static_argnums=4)
    for i in range(8):
        jy, jcache = jdecode(jp, jl, jnp.asarray(x[:, i:i + 1]), jcache, jcfg)
        with torch.no_grad():
            ty, got_cache = t_mamba.mamba_decode(
                tp, tl, torch.from_numpy(x[:, i:i + 1]), tcache, tcfg)
        assert got_cache is tcache                       # in place
        assert all(tcache[k] is leaves[k] for k in leaves)
        assert set(tcache) == set(jcache)
        for k in tcache:
            np.testing.assert_allclose(t2n(tcache[k]), j2n(jcache[k]),
                                       atol=ATOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(t2n(ty), j2n(jy), atol=ATOL, rtol=0)
        outs.append(ty)
    with torch.no_grad():
        full = t_mamba.mamba_forward(tp, tl, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(t2n(torch.cat(outs, dim=1)), t2n(full),
                               atol=ATOL, rtol=0)


def test_init_mamba_leaves_match_reference(block):
    jcfg, tcfg, jp, jl, _, _ = block
    gen = torch.Generator().manual_seed(0)
    tp = t_mamba.init_mamba(gen, tcfg, torch.float32)
    tl = t_mamba.init_mamba_lora(gen, tcfg)
    fresh = j_mamba.init_mamba(jax.random.PRNGKey(0), jcfg, jnp.float32)
    for want, got in ((fresh, tp), (jl, tl)):
        assert set(got) == set(want)
        for k in got:
            w = jax.tree_util.tree_leaves(want[k])
            g = [v for v in (got[k].values() if isinstance(got[k], dict)
                             else [got[k]])]
            assert [tuple(v.shape) for v in g] == [tuple(v.shape) for v in w]
            assert [str(v.dtype).split(".")[-1] for v in g] == \
                [str(v.dtype) for v in w], k
    # the deterministic leaves (a_log = log(1..nh) to two ulps); dt_bias is
    # f32 with dt in [0.001, 0.1], i.e. softplus(dt_bias) in that range
    for k in ("a_log", "d_skip", "gate_norm", "conv_b"):
        np.testing.assert_allclose(t2n(tp[k]), j2n(fresh[k]), rtol=ULP2,
                                   atol=0)
    assert tp["dt_bias"].dtype == torch.float32
    dt = t_mamba._softplus(tp["dt_bias"])
    assert float(dt.min()) >= 0.001 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    assert float(tl["in_proj"]["b"].abs().max()) == 0.0


def test_ssd_chunked_gradient_is_finite_where_the_references_is_not():
    """Under steep decay exp(cum_i - cum_j) of a future j overflows; the
    reference masks after the exp, so its gradient with respect to ``a``
    (so to dt, so to the in_proj adapter) is nan there (0 * inf). The port
    masks before it: the same forward (1e-4, the scan's tolerance), and
    finite gradients."""
    rng = np.random.default_rng(3)
    xt = (rng.standard_normal((1, 64, 2, 8)) * 0.2).astype(np.float32)
    a = (-np.abs(rng.standard_normal((1, 64, 2))) * 8.0).astype(np.float32)
    B = (rng.standard_normal((1, 64, 6)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((1, 64, 6)) * 0.3).astype(np.float32)

    def jloss(a):
        y, h = j_mamba.ssd_chunked(jnp.asarray(xt), a, jnp.asarray(B),
                                   jnp.asarray(C), 32)
        return jnp.sum(y) + jnp.sum(h)
    assert not np.isfinite(np.asarray(
        jax.jit(jax.grad(jloss))(jnp.asarray(a)))).all()
    ta = torch.from_numpy(a).requires_grad_()
    y, h = t_mamba.ssd_chunked(torch.from_numpy(xt), ta, torch.from_numpy(B),
                               torch.from_numpy(C), 32)
    (g,) = torch.autograd.grad(y.sum() + h.sum(), ta)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    wy, wh = j_mamba.ssd_chunked(jnp.asarray(xt), jnp.asarray(a),
                                 jnp.asarray(B), jnp.asarray(C), 32)
    np.testing.assert_allclose(t2n(y), j2n(wy), atol=1e-4, rtol=0)
    np.testing.assert_allclose(t2n(h), j2n(wh), atol=1e-4, rtol=0)
