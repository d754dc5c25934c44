"""``moe_forward_dist`` on 8 ``gloo`` ranks of a (4, 2) ``("data", "model")``
mesh against the JAX package's on 8 forced host devices, the mesh of the
reference's own system test, with its kimi-reduced variant (8 experts,
top-2, d = 64, f = 32, one shared expert), f32:

  * ``ep_a2a`` at capacity factor 4.0 (no drops) and 1.0 (drops);
  * ``ep_a2a``'s broadcast layout (batch 2 on dp 4);
  * ``replicated`` (6 experts, which dp 4 does not divide);
  * without the shared-path adapter.

Each case holds the output, ``aux`` and the gradients of one loss (the
same on every rank) w.r.t. x and the adapter against ``jax.grad`` of the
reference, to 1e-5, on every rank: a loss counted once per rank would show
as a gradient a whole multiple too large. The drop masks are compared through the
within-group ranks every mask reads (both sides logged at each
``ranks_within_groups`` call) and the capacities.

One subprocess runs the reference (the forced device count must be set
before JAX starts) and one ``spawn_mesh`` runs the port, each once per
module, on weights made by ``repro.models.moe.init_moe``.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.models import moe as ref_moe
from repro_torch.launch.mesh import spawn_mesh
from repro_torch.models import moe as port_moe

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_shard_ranks as ranks_mod  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 16
TOL = 1e-5
CASES = {
    "ep_a2a": {"experts": 8, "cf": 4.0, "batch": 8, "lora": True,
               "strategy": "ep_a2a"},
    "ep_a2a_drops": {"experts": 8, "cf": 1.0, "batch": 8, "lora": True,
                     "strategy": "ep_a2a"},
    "ep_a2a_broadcast": {"experts": 8, "cf": 4.0, "batch": 2, "lora": True,
                         "strategy": "ep_a2a"},
    "replicated": {"experts": 6, "cf": 4.0, "batch": 8, "lora": True,
                   "strategy": "replicated"},
    "no_adapter": {"experts": 8, "cf": 4.0, "batch": 8, "lora": False,
                   "strategy": "ep_a2a"},
}


def _ref_cfg(case):
    import dataclasses
    return dataclasses.replace(
        ref_config("kimi-k2-1t-a32b").reduced(), n_experts=case["experts"],
        top_k=2, d_ff=32, d_model=64, n_shared_experts=1,
        capacity_factor=case["cf"])


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


def _inputs():
    out = {}
    for i, (name, case) in enumerate(CASES.items()):
        cfg = _ref_cfg(case)
        rng = np.random.default_rng(100 + i)
        d = {"params": _np_tree(ref_moe.init_moe(jax.random.PRNGKey(i), cfg,
                                                 np.float32)),
             "x": (rng.standard_normal((case["batch"], SEQ, cfg.d_model))
                   * 0.5).astype(np.float32),
             "r": rng.standard_normal((case["batch"], SEQ, cfg.d_model)
                                      ).astype(np.float32)}
        if case["lora"]:
            lora = _np_tree(ref_moe.init_moe_lora(jax.random.PRNGKey(50 + i),
                                                  cfg))
            lora["out_adapter"]["b"] = (rng.standard_normal(
                lora["out_adapter"]["b"].shape) * 0.1).astype(np.float32)
            d["lora"] = lora
        out[name] = d
    return out


REFERENCE = """
import os, pickle, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro import shardctx
from repro.configs.base import get_config
from repro.models import moe_shard_map as msm

AUX_WEIGHT = {aux_weight}
cases, inputs = pickle.load(open(sys.argv[1], "rb"))
mesh = jax.make_mesh((4, 2), ("data", "model"))
orig = msm.ranks_within_groups
log = []


def spy(groups, n_groups):
    ranks = orig(groups, n_groups)

    def record(g, r, d, m):
        log.append((n_groups, int(d), int(m), np.asarray(g), np.asarray(r)))
    jax.debug.callback(record, groups, ranks, jax.lax.axis_index("data"),
                       jax.lax.axis_index("model"))
    return ranks


out = {{}}
for name, case in cases.items():
    cfg = dataclasses.replace(
        get_config("kimi-k2-1t-a32b").reduced(), n_experts=case["experts"],
        top_k=2, d_ff=32, d_model=64, n_shared_experts=1,
        capacity_factor=case["cf"])
    d = inputs[name]
    params = jax.tree.map(jnp.asarray, d["params"])
    x, r = jnp.asarray(d["x"]), jnp.asarray(d["r"])
    lora = jax.tree.map(jnp.asarray, d["lora"]) if "lora" in d else None
    with mesh, shardctx.mesh_ctx(mesh):
        strategy = msm.select_strategy(cfg)
        msm.ranks_within_groups = spy
        log.clear()
        jax.block_until_ready(jax.jit(lambda p, l, v: msm.moe_forward_dist(
            p, l, v, cfg, strategy))(params, lora, x))
        jax.effects_barrier()
        msm.ranks_within_groups = orig
        calls = list(log)

        def loss(v, l):
            y, aux = msm.moe_forward_dist(params, l, v, cfg, strategy)
            return jnp.sum(y * r) + AUX_WEIGHT * aux, (y, aux)

        argnums = (0, 1) if lora is not None else (0,)
        (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
            loss, argnums=argnums, has_aux=True))(x, lora)
    res = {{"strategy": strategy, "ranks_log": calls, "out": np.asarray(y),
           "aux": np.asarray(aux), "grad_x": np.asarray(grads[0])}}
    if lora is not None:
        res["grad_a"] = np.asarray(grads[1]["out_adapter"]["a"])
        res["grad_b"] = np.asarray(grads[1]["out_adapter"]["b"])
    out[name] = res
pickle.dump(out, open(sys.argv[2], "wb"))
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, per-rank port results) for every case."""
    tmp = tmp_path_factory.mktemp("moe_shard_map")
    inputs = _inputs()
    cases = {n: {k: c[k] for k in ("experts", "cf")} for n, c in CASES.items()}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump((cases, inputs), f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("JAX_PLATFORMS", None)
    ref = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE.format(
            aux_weight=ranks_mod.AUX_WEIGHT)),
         str(tmp / "inputs.pkl"), str(tmp / "reference.pkl")],
        env=env, capture_output=True, text=True, timeout=600)
    assert "OK" in ref.stdout, ref.stderr[-3000:]
    with open(tmp / "reference.pkl", "rb") as f:
        want = pickle.load(f)
    rdv = tmp / "rendezvous"
    rdv.mkdir()
    got = spawn_mesh(ranks_mod.run_cases, (4, 2), ("data", "model"),
                     device="cpu", args=(cases, inputs), rendezvous=str(rdv),
                     timeout_s=300)
    return want, got


QUANTITIES = [(case, q) for case in CASES
              for q in ("out", "aux", "grad_x", "grad_a", "grad_b")
              if CASES[case]["lora"] or q not in ("grad_a", "grad_b")]


@pytest.mark.parametrize("case,quantity", QUANTITIES)
def test_every_rank_equals_the_reference(runs, case, quantity):
    want, got = runs
    w = want[case][quantity]
    scale = max(1.0, float(np.abs(w).max()))
    for rank, res in enumerate(got):
        g = res[case][quantity]
        assert g.shape == w.shape, (rank, g.shape, w.shape)
        err = float(np.abs(g - w).max())
        assert err <= TOL * scale, (rank, err)


@pytest.mark.parametrize("case", CASES)
def test_strategy_equals_the_reference(runs, case):
    want, got = runs
    assert want[case]["strategy"] == CASES[case]["strategy"]
    assert {res[case]["strategy"] for res in got} == {CASES[case]["strategy"]}


def _capacities(case, n_groups, n, cap_fns):
    """The capacity each logged ``ranks_within_groups`` call's ranks are
    held to, and whether slot ``i`` is a real item, for the layout of
    ``case`` (``cap_fns``: one package's group_capacity, _capacity)."""
    group_capacity, capacity = cap_fns
    c = CASES[case]
    e, k, cf, ep = c["experts"], 2, c["cf"], 4
    eg = e // ep
    if c["strategy"] == "replicated":               # E groups, t_loc tokens
        assert n_groups == e
        return capacity(n // k, _ref_cfg(c)), None
    if c["batch"] % ep:                             # broadcast: eg + 1
        assert n_groups == eg + 1
        return group_capacity(n, eg, max(cf, float(eg))), eg
    if n_groups == ep:                              # send side
        return group_capacity(n, ep, cf), None
    assert n_groups == eg + 1                       # receive side
    return group_capacity(n, eg, cf), eg


def _masks(case, log, cap_fns):
    """{(n_groups, data, model): (groups, ranks, valid, keep)}."""
    out = {}
    for n_groups, d, m, groups, ranks in log:
        groups, ranks = np.asarray(groups), np.asarray(ranks)
        cap, trash = _capacities(case, n_groups, len(groups), cap_fns)
        valid = groups < trash if trash is not None \
            else np.ones(len(groups), bool)
        out[(n_groups, d, m)] = (groups, ranks, valid, valid & (ranks < cap))
    return out


@pytest.mark.parametrize("case", CASES)
def test_drop_masks_equal_the_reference(runs, case):
    want, got = runs
    ref = _masks(case, want[case]["ranks_log"],
                 (ref_moe.group_capacity, ref_moe._capacity))
    port = {}
    for res in got:
        r = res[case]
        d, m = r["coords"]["data"], r["coords"]["model"]
        port.update(_masks(case, [(n, d, m, g, k)
                                  for n, g, k in r["ranks_log"]],
                           (port_moe.group_capacity, port_moe._capacity)))
    assert port.keys() == ref.keys() and len(port) >= 8
    dropped = 0
    for key, (g, k, valid, keep) in ref.items():
        pg, pk, _, pkeep = port[key]
        assert np.array_equal(pg, g) and np.array_equal(pk, k), key
        assert np.array_equal(pkeep, keep), key
        dropped += int((valid & ~keep).sum())
    assert (dropped > 0) == (case == "ep_a2a_drops"), dropped
