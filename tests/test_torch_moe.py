"""The port's mixture-of-experts block against the JAX reference's, on the
same weights (the reference's ``init_params`` at the reduced size, converted
leaf for leaf, adapters with a non-zero B) and the same numpy-seeded inputs:
granite-moe-3b-a800m and kimi-k2-1t-a32b (shared experts).

The routing must be EQUAL: top-k indices (the lower expert index first on
ties, as ``jax.lax.top_k``), within-expert ranks and the keep mask. Outputs
and the aux loss to ``atol = 2e-4`` (f32, summation order), as
``test_torch_model.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _torch_parity import j2n, make_pair, t2n
from repro.configs.base import get_config as jax_get_config
from repro.models import moe as j_moe
from repro_torch.configs.base import get_config
from repro_torch.models import moe as t_moe
from repro_torch.models.common import tree_take

torch.set_num_threads(1)

ATOL = 2e-4


@settings(max_examples=6, deadline=None)
@given(n=st.integers(1, 300), g=st.integers(1, 16), seed=st.integers(0, 99))
def test_ranks_within_groups_properties_and_jax(n, g, seed):
    """``tests/test_moe.py``'s properties, and equal to the reference."""
    groups = np.random.default_rng(seed).integers(0, g, n).astype(np.int32)
    ranks = t_moe.ranks_within_groups(torch.from_numpy(groups), g).numpy()
    want = np.asarray(j_moe.ranks_within_groups(jnp.asarray(groups), g))
    np.testing.assert_array_equal(ranks, want)
    for gid in range(g):
        r = ranks[groups == gid]
        assert sorted(r.tolist()) == list(range(len(r)))
        assert (np.diff(r) > 0).all() if len(r) > 1 else True


@pytest.mark.parametrize("tokens", [1, 7, 32, 100, 4096])
def test_capacity_equals_reference(tokens):
    for arch in ("granite-moe-3b-a800m", "kimi-k2-1t-a32b"):
        assert t_moe._capacity(tokens, get_config(arch)) == \
            j_moe._capacity(tokens, jax_get_config(arch))
    assert t_moe.group_capacity(tokens, 16, 1.25) == \
        j_moe.group_capacity(tokens, 16, 1.25)


def test_route_breaks_ties_by_the_lower_index_as_jax_top_k():
    probs = np.asarray([[0.25, 0.25, 0.25, 0.25],
                        [0.1, 0.4, 0.1, 0.4],
                        [0.3, 0.2, 0.3, 0.2],
                        [0.0, 0.5, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3):
        gates, idx = t_moe.route(torch.from_numpy(probs), k)
        jg, ji = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(gates.numpy(), np.asarray(jg))


def _routing_jax(p, x, cfg):
    """(idx, pos, keep) of the reference's dispatch, recomputed."""
    t = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(
        jnp.matmul(x.reshape(t, -1).astype(jnp.float32), p["router"]), -1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    pos = j_moe.ranks_within_groups(idx.reshape(-1), cfg.n_experts)
    return (np.asarray(idx), np.asarray(pos),
            np.asarray(pos < j_moe._capacity(t, cfg)))


def _routing_torch(p, x, cfg):
    t = x.shape[0] * x.shape[1]
    probs = torch.softmax(torch.matmul(x.reshape(t, -1), p["router"]), -1)
    _, idx = t_moe.route(probs, cfg.top_k)
    pos = t_moe.ranks_within_groups(idx.reshape(-1), cfg.n_experts)
    return (idx.numpy(), pos.numpy(),
            (pos < t_moe._capacity(t, cfg)).numpy())


@pytest.fixture(scope="module", params=["granite-moe-3b-a800m",
                                        "kimi-k2-1t-a32b"])
def moe_pair(request):
    """(jax cfg, torch cfg, jax block, jax adapter, torch block, torch
    adapter): layer 0's MoE block; kimi's has a shared expert."""
    jcfg, tcfg, jp, tp = make_pair(request.param, seed=5)

    def take(tree):
        return jax.tree_util.tree_map(lambda v: v[0], tree)
    return (jcfg, tcfg, take(jp["frozen"]["layers"]["moe"]),
            take(jp["lora"]["layers"]["moe"]),
            tree_take(tp["frozen"]["layers"]["moe"], 0),
            tree_take(tp["lora"]["layers"]["moe"], 0))


# drops=True: a capacity factor far below E/k, so that the capacity (16
# slots for the 72 tokens x 2 choices) is smaller than an expert's load and
# the drop path runs; the reduced configs are dropless otherwise (cf = E/k)
@pytest.mark.parametrize("drops", [False, True])
def test_moe_forward_matches_jax(moe_pair, drops):
    jcfg, tcfg, jmoe, jl, tmoe, tl = moe_pair
    if drops:
        jcfg = dataclasses.replace(jcfg, capacity_factor=0.25)
        tcfg = dataclasses.replace(tcfg, capacity_factor=0.25)
    assert ("shared" in tmoe) == (tcfg.n_shared_experts > 0)
    x = np.random.default_rng(6).standard_normal(
        (3, 24, jcfg.d_model)).astype(np.float32)

    want_route = _routing_jax(jmoe, jnp.asarray(x), jcfg)
    got_route = _routing_torch(tmoe, torch.from_numpy(x), tcfg)
    for w, g, name in zip(want_route, got_route, ("idx", "pos", "keep")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got_route[2].all() != drops

    jout, jaux = j_moe.moe_forward(jmoe, jl, jnp.asarray(x), jcfg)
    with torch.no_grad():
        tout, taux = t_moe.moe_forward(tmoe, tl, torch.from_numpy(x), tcfg)
    assert taux.dtype == torch.float32 and tout.shape == x.shape
    np.testing.assert_allclose(t2n(tout), j2n(jout), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL, rtol=0)
    # the adapter is live: without it the output moves
    with torch.no_grad():
        bare, _ = t_moe.moe_forward(tmoe, None, torch.from_numpy(x), tcfg)
    assert float((bare - tout).abs().max()) > 1e-3


def test_moe_forward_has_gradients_through_gates_and_adapter(moe_pair):
    """Under autograd the adapter and the input get gradients (the gates
    carry the router's path, the aux loss too), as ``jax.grad`` gives."""
    jcfg, tcfg, jmoe, jl, tmoe, tl = moe_pair
    x = np.random.default_rng(8).standard_normal(
        (2, 8, jcfg.d_model)).astype(np.float32)

    def jloss(lora, x):
        out, aux = j_moe.moe_forward(jmoe, lora, x, jcfg)
        return jnp.sum(out * out) * 1e-3 + aux
    jg_l, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jl,
                                                          jnp.asarray(x))
    ta = {k: v.detach().clone().requires_grad_()
          for k, v in tl["out_adapter"].items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = t_moe.moe_forward(tmoe, {"out_adapter": ta}, tx, tcfg)
    loss = torch.sum(out * out) * 1e-3 + aux
    ga, gb, gx = torch.autograd.grad(loss, [ta["a"], ta["b"], tx])
    for got, want in ((ga, jg_l["out_adapter"]["a"]),
                      (gb, jg_l["out_adapter"]["b"]), (gx, jg_x)):
        scale = float(np.abs(j2n(want)).max())
        np.testing.assert_allclose(t2n(got), j2n(want), atol=ATOL * scale,
                                   rtol=0)


def test_init_moe_leaves_match_reference():
    for arch in ("granite-moe-3b-a800m", "kimi-k2-1t-a32b"):
        cfg = get_config(arch).reduced()
        jcfg = jax_get_config(arch).reduced()
        gen = torch.Generator().manual_seed(0)
        tp = t_moe.init_moe(gen, cfg, torch.bfloat16)
        tl = t_moe.init_moe_lora(gen, cfg)
        jp = j_moe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
        jl = j_moe.init_moe_lora(jax.random.PRNGKey(1), jcfg)
        for want, got in ((jp, tp), (jl, tl)):
            flat = jax.tree_util.tree_flatten_with_path(want)[0]
            flat_w = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
                      for k, v in flat}

            def walk(tree, prefix=""):
                for k, v in tree.items():
                    if isinstance(v, dict):
                        yield from walk(v, f"{prefix}['{k}']")
                    else:
                        yield (f"{prefix}['{k}']",
                               (tuple(v.shape),
                                str(v.dtype).replace("torch.", "")))
            assert dict(walk(got)) == flat_w, arch
        assert tp["router"].dtype == torch.float32
        assert float(tl["out_adapter"]["b"].abs().max()) == 0.0
