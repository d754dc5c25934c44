"""The port's optimizers against the JAX package's ``optim/optimizer.py``:
the schedules at steps 0-30 and ``sgd`` / ``adamw`` state after five steps
on the same numpy-seeded gradients, all to rel 1e-6 (both compute in f32).
The port's functions are pure: nothing is updated in place, which is what
``SplitFineTuner``'s rollback relies on."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizer as JO
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import optimizer as TO

torch.set_num_threads(1)

SCHEDULES = {
    "constant": lambda o: o.constant_schedule(3e-3),
    "cosine": lambda o: o.cosine_schedule(1e-2, 25, 0.05),
    "warmup_cosine": lambda o: o.warmup_cosine(5e-3, 6, 30),
    "warmup_cosine_no_warmup": lambda o: o.warmup_cosine(5e-3, 0, 20, 0.2),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    js, ts = SCHEDULES[name](JO), SCHEDULES[name](TO)
    for step in range(31):
        want = js(jnp.asarray(step, jnp.int32))
        got = ts(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _tree(rng, shapes):
    return {k: ({n: rng.standard_normal(s).astype(np.float32)
                 for n, s in v.items()} if isinstance(v, dict)
                else rng.standard_normal(v).astype(np.float32))
            for k, v in shapes.items()}


SHAPES = {"wq": {"a": (2, 16, 4), "b": (2, 4, 8)}, "w_down": (2, 4, 16)}
OPTIMIZERS = {
    "sgd": lambda o: o.sgd(o.warmup_cosine(1e-2, 2, 10), momentum=0.8),
    "adamw": lambda o: o.adamw(o.constant_schedule(3e-3)),
    "adamw_decay": lambda o: o.adamw(o.cosine_schedule(1e-2, 8), b1=0.8,
                                     b2=0.99, eps=1e-6, weight_decay=0.01),
}


def _close(jtree, ttree):
    if isinstance(ttree, dict):
        assert set(jtree) == set(ttree)
        for k in ttree:
            _close(jtree[k], ttree[k])
        return
    np.testing.assert_allclose(ttree.numpy(), np.asarray(jtree), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_state_matches_jax_after_five_steps(name):
    rng = np.random.default_rng(0)
    params = _tree(rng, SHAPES)
    grads = [_tree(rng, SHAPES) for _ in range(5)]
    jopt, topt = OPTIMIZERS[name](JO), OPTIMIZERS[name](TO)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = JO.apply_updates(jp, ju)
        tu, ts = topt.update(tree_map(torch.from_numpy, g), ts, tp)
        tp = TO.apply_updates(tp, tu)
    _close(jp, tp)
    assert set(ts) == set(js)
    for key in ts:
        if key == "step":
            assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 5
            assert int(js["step"]) == 5
        else:
            _close(js[key], ts[key])
            assert all(x.dtype == torch.float32 for x in tree_leaves(ts[key]))


def test_updates_take_the_parameter_dtype_and_moments_stay_f32():
    params = {"a": torch.ones(4, 3, dtype=torch.bfloat16),
              "b": torch.ones(3, 2)}
    opt = TO.adamw(TO.constant_schedule(1e-2))
    state = opt.init(params)
    grads = {"a": torch.full((4, 3), 0.5, dtype=torch.bfloat16),
             "b": torch.full((3, 2), 0.5)}
    upd, state = opt.update(grads, state, params)
    assert upd["a"].dtype == torch.bfloat16 and upd["b"].dtype == torch.float32
    assert state["m"]["a"].dtype == torch.float32
    new = TO.apply_updates(params, upd)
    assert new["a"].dtype == torch.bfloat16
    assert float(new["b"][0, 0]) == pytest.approx(1 - 1e-2, rel=1e-5)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_update_and_apply_leave_their_inputs_unchanged(name):
    """A rollback keeps references to the old (lora, opt_state): neither
    ``update`` nor ``apply_updates`` may write into them, and the new
    leaves carry no autograd history."""
    rng = np.random.default_rng(1)
    params = tree_map(torch.from_numpy, _tree(rng, SHAPES))
    grads = tree_map(lambda x: torch.from_numpy(x).requires_grad_(),
                     _tree(rng, SHAPES))
    opt = OPTIMIZERS[name](TO)
    state = opt.init(params)
    state = opt.update(grads, state, params)[1]
    before = [x.clone() for x in tree_leaves(params) + tree_leaves(state)]
    upd, new_state = opt.update(grads, state, params)
    new = TO.apply_updates(params, upd)
    after = tree_leaves(params) + tree_leaves(state)
    for a, b in zip(before, after, strict=True):
        assert torch.equal(a, b)
    for x in tree_leaves(new) + tree_leaves(new_state) + tree_leaves(upd):
        assert not x.requires_grad and x.grad_fn is None
    assert int(new_state["step"]) == int(state["step"]) + 1
