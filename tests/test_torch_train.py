"""The port's train step, trainer and checkpoints against the JAX
package's ``launch/train.py``, ``launch/trainer.py`` and
``checkpoint/checkpoint.py``, on the same weights (the reference's
``init_params`` converted leaf for leaf, adapters with a non-zero B) and
the same numpy-seeded batches, at the reduced size (2 layers, f32).

Tolerances: loss and every leaf of the new LoRA after three steps within
1e-4 relative (1e-4 of the JAX leaf's largest magnitude); the checkpoint
format exact, in both directions."""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_tree_close, make_pair
from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.launch.train import make_train_step as j_make_train_step
from repro.optim import adamw as j_adamw
from repro.optim import constant_schedule as j_const
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.data import make_fleet_datasets
from repro_torch.launch.train import make_train_step, run_training
from repro_torch.launch.trainer import Trainer, TrainerConfig, TrainingDiverged
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw, constant_schedule

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return make_pair("llama32-1b", seed=0)


def _batches(cfg, cut, n=3, b=4, s=16, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {"labels": rng.integers(0, cfg.vocab_size, (b, s)
                                        ).astype(np.int32)}
        if cut == 0:
            batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)
                                           ).astype(np.int32)
        else:
            batch["smashed"] = rng.standard_normal((b, s, cfg.d_model)
                                                   ).astype(np.float32)
        out.append(batch)
    return out


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("cut", [0, 1])
def test_train_step_matches_jax(pair, cut, microbatches):
    jcfg, tcfg, jp, tp = pair
    jstep = jax.jit(j_make_train_step(jcfg, j_adamw(j_const(3e-3)), cut=cut,
                                      microbatches=microbatches))
    topt = adamw(constant_schedule(3e-3))
    tstep = make_train_step(tcfg, topt, cut=cut, microbatches=microbatches)
    jl, jst = jp["lora"], j_adamw(j_const(3e-3)).init(jp["lora"])
    tl, tst = tp["lora"], topt.init(tp["lora"])
    for batch in _batches(jcfg, cut):
        jloss, jl, jst = jstep(jp["frozen"], jl, jst,
                               {k: jnp.asarray(v) for k, v in batch.items()})
        tloss, tl, tst = tstep(tp["frozen"], tl, tst, batch)
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-4)
    assert_tree_close(jl, tl, 1e-4)
    assert_tree_close(jst["m"], tst["m"], 1e-4)
    assert int(tst["step"]) == 3
    if cut:     # layers below the cut get no gradient, as in the reference
        assert not any(x[:cut].any() for x in tree_leaves(tst["m"]))


@pytest.mark.parametrize("cut", [0, 1])
def test_remat_on_equals_off(pair, cut):
    _, cfg, _, tp = pair
    opt = adamw(constant_schedule(3e-3))
    batch = _batches(cfg, cut, n=1)[0]
    outs = []
    for remat in (True, False):
        step = make_train_step(cfg, opt, cut=cut, remat=remat)
        outs.append(step(tp["frozen"], tp["lora"], opt.init(tp["lora"]),
                         batch))
    assert float(outs[0][0]) == float(outs[1][0])
    for a, b in zip(tree_leaves(outs[0][1]), tree_leaves(outs[1][1]),
                    strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_train_step_leaves_its_inputs_unchanged(pair):
    _, cfg, _, tp = pair
    opt = adamw(constant_schedule(3e-3))
    st = opt.init(tp["lora"])
    before = [x.clone() for x in tree_leaves(tp["lora"])]
    _, new, _ = make_train_step(cfg, opt)(tp["frozen"], tp["lora"], st,
                                          _batches(cfg, 0, n=1)[0])
    for a, b, c in zip(before, tree_leaves(tp["lora"]), tree_leaves(new),
                       strict=True):
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert not b.requires_grad and not c.requires_grad
    assert all(not x.requires_grad for x in tree_leaves(tp["frozen"]))


# ---------------------------------------------------------------------------
# Trainer and checkpoints
# ---------------------------------------------------------------------------


def _ds(cfg):
    return make_fleet_datasets(cfg, 1, vocab=cfg.vocab_size, seed=0)[0]


def test_trainer_runs_and_logs(pair, tmp_path):
    _, cfg, _, tp = pair
    ds = _ds(cfg)
    tcfg = TrainerConfig(steps=12, batch=4, seq_len=16, eval_every=6,
                         checkpoint_every=6, checkpoint_dir=str(tmp_path),
                         log_path=str(tmp_path / "log.jsonl"))
    tr = Trainer(cfg, tp["frozen"], tp["lora"], tcfg)
    out = tr.train(lambda: ds.minibatch(4, 16),
                   eval_batches=[ds.minibatch(4, 16)])
    assert math.isfinite(out["final_loss"])
    assert {m["kind"] for m in out["metrics"]} == {"train", "eval"}
    assert os.path.exists(tmp_path / "trainer.npz")
    assert os.path.exists(tmp_path / "log.jsonl")


def test_trainer_restore_resumes(pair, tmp_path):
    _, cfg, _, tp = pair
    ds = _ds(cfg)
    tcfg = TrainerConfig(steps=6, batch=4, seq_len=16, eval_every=0,
                         checkpoint_every=3, checkpoint_dir=str(tmp_path))
    tr1 = Trainer(cfg, tp["frozen"], tp["lora"], tcfg)
    tr1.train(lambda: ds.minibatch(4, 16))
    tr2 = Trainer(cfg, tp["frozen"], tp["lora"], tcfg)
    assert tr2.restore() and tr2.step == 6
    for a, b in zip(tree_leaves({"l": tr1.lora, "o": tr1.opt_state}),
                    tree_leaves({"l": tr2.lora, "o": tr2.opt_state}),
                    strict=True):
        assert torch.equal(a, b) and a.dtype == b.dtype
    tr2.tcfg.steps = 9
    tr2.train(lambda: ds.minibatch(4, 16))
    assert tr2.step == 9


def test_reference_checkpoint_loads_into_the_port(pair, tmp_path):
    """The JAX package writes (dict keys sorted), the port's Trainer
    resumes from it (keys in insertion order): leaves found by key."""
    jcfg, tcfg, jp, tp = pair
    jopt = j_adamw(j_const(3e-3))
    jst = jopt.init(jp["lora"])
    step = jax.jit(j_make_train_step(jcfg, jopt))
    batch = {k: jnp.asarray(v) for k, v in _batches(jcfg, 0, n=1)[0].items()}
    _, jl, jst = step(jp["frozen"], jp["lora"], jst, batch)
    j_save(str(tmp_path / "trainer.npz"), {"lora": jl, "opt_state": jst},
           step=7)
    tr = Trainer(tcfg, tp["frozen"], tp["lora"],
                 TrainerConfig(checkpoint_dir=str(tmp_path)))
    assert tr.restore() and tr.step == 7
    assert_tree_close(jl, tr.lora, 0.0)
    assert_tree_close(jst["m"], tr.opt_state["m"], 0.0)
    assert_tree_close(jst["v"], tr.opt_state["v"], 0.0)
    assert tr.opt_state["step"].dtype == torch.int32
    assert int(tr.opt_state["step"]) == 1


def test_port_checkpoint_loads_into_the_reference(pair, tmp_path):
    jcfg, tcfg, jp, tp = pair
    ds = _ds(tcfg)
    tr = Trainer(tcfg, tp["frozen"], tp["lora"],
                 TrainerConfig(steps=2, eval_every=0, checkpoint_every=0,
                               checkpoint_dir=str(tmp_path)))
    tr.train(lambda: ds.minibatch(4, 16))
    like = {"lora": jp["lora"], "opt_state": j_adamw(j_const(1.0)).init(
        jp["lora"])}
    tree, step = j_load(str(tmp_path / "trainer.npz"), like)
    assert step == 2
    assert_tree_close(tree["lora"], tr.lora, 0.0)
    assert_tree_close(tree["opt_state"]["v"], tr.opt_state["v"], 0.0)
    assert int(tree["opt_state"]["step"]) == 2
    assert tree["opt_state"]["step"].dtype == jnp.int32


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bfloat16_leaves_cross_both_ways(tmp_path, writer):
    """bf16 travels as raw uint16 bits under the tag "bfloat16"."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((5, 3)).astype(np.float32)
    path = str(tmp_path / "x.npz")
    jtree = {"w": jnp.asarray(w, jnp.bfloat16),
             "n": [jnp.arange(4, dtype=jnp.int32), jnp.ones((2,))]}
    ttree = {"w": torch.from_numpy(w).to(torch.bfloat16),
             "n": [torch.arange(4, dtype=torch.int32), torch.ones(2)]}
    if writer == "port":
        save_checkpoint(path, ttree, step=3, extra={"k": 1})
        got, step = j_load(path, jtree)
        assert got["w"].dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            np.asarray(got["w"]).view(np.uint16),
            ttree["w"].view(torch.int16).numpy().view(np.uint16))
        np.testing.assert_array_equal(np.asarray(got["n"][0]), np.arange(4))
    else:
        j_save(path, jtree, step=3, extra={"k": 1})
        got, step = load_checkpoint(path, ttree)
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"], ttree["w"])
        assert torch.equal(got["n"][0], ttree["n"][0])
        assert got["n"][0].dtype == torch.int32
    assert step == 3


def test_load_refuses_a_missing_leaf_or_a_shape_mismatch(tmp_path):
    path = str(tmp_path / "x.npz")
    save_checkpoint(path, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaf 'b'"):
        load_checkpoint(path, {"a": torch.zeros(3), "b": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch at a"):
        load_checkpoint(path, {"a": torch.zeros(4)})


def test_training_diverged_after_max_nonfinite(pair):
    _, cfg, _, tp = pair
    frozen = dict(tp["frozen"], final_norm=torch.full_like(
        tp["frozen"]["final_norm"], float("nan")))
    ds = _ds(cfg)
    tr = Trainer(cfg, frozen, tp["lora"],
                 TrainerConfig(steps=40, eval_every=0, checkpoint_every=0,
                               max_nonfinite=3))
    with pytest.raises(TrainingDiverged, match="3 consecutive"):
        tr.train(lambda: ds.minibatch(2, 8))
    assert tr.step == 20      # log points at steps 1, 10, 20
    warn = [m for m in tr.metrics if m.get("event") == "nonfinite_loss"]
    assert [m["streak"] for m in warn] == [1, 2, 3]


def test_run_training_on_the_cpu():
    out = run_training(steps=4, batch=2, seq_len=8, pretrain_steps=2,
                       log_every=0, device="cpu")
    assert len(out["losses"]) == 4
    assert all(math.isfinite(v) for v in out["losses"])
    assert math.isfinite(out["pretrain_loss"])
    assert out["cfg"].n_layers == 2
    assert all(x.device.type == "cpu" for x in tree_leaves(out["lora"]))


def test_moe_train_step_matches_jax_at_3e_3_on_one_batch():
    """granite-moe-3b-a800m: four AdamW steps at 3e-3 on one fixed batch,
    as ``chip_smoke.py``'s families phase takes them. Each loss within 1e-4
    relative of the reference's, falling or not, and the LoRA leaves and
    Adam's first moment after the last step within the tolerance above:
    the port's MoE step (routing, dispatch, aux loss, AdamW) is the
    reference's, step by step."""
    jcfg, tcfg, jp, tp = make_pair("granite-moe-3b-a800m", seed=3)
    jstep = jax.jit(j_make_train_step(jcfg, j_adamw(j_const(3e-3))))
    topt = adamw(constant_schedule(3e-3))
    tstep = make_train_step(tcfg, topt)
    rng = np.random.default_rng(11)
    batch = {k: rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jst = jp["lora"], j_adamw(j_const(3e-3)).init(jp["lora"])
    tl, tst = tp["lora"], topt.init(tp["lora"])
    jlosses, tlosses = [], []
    for _ in range(4):
        jloss, jl, jst = jstep(jp["frozen"], jl, jst, jb)
        tloss, tl, tst = tstep(tp["frozen"], tl, tst, batch)
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert_tree_close(jl, tl, 1e-4)
    assert_tree_close(jst["m"], tst["m"], 1e-4)
