"""bf16 at full depth, the port beside the JAX package on the same weights:
whether a drift seen on the card is bf16 rounding (the reference drifts as
far) or the port's own.

  * musicgen-large, all 48 layers, narrowed to d = 256 (4 heads of 64): the
    prefill step's bf16 logits against f32 logits of the same weights
    (upcast), in each package. On the card the port's full-width gap is
    2.45 (|logit| <= 3.3); here the port's gap must stay within 1.5x the
    reference's, and the two f32 runs must agree.
  * granite-moe-3b-a800m, all 32 layers, 40 experts top-8 at the published
    capacity factor, narrowed to d = 128, bf16: four AdamW steps at 3e-3 on
    one fixed batch in each package. The losses must agree step by step.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.launch.serve import make_prefill_step as ref_prefill_step
from repro.launch.train import make_train_step as ref_train_step
from repro.optim import adamw as ref_adamw
from repro.optim import constant_schedule as ref_constant
from repro_torch.launch.serve import make_prefill_step
from repro_torch.launch.train import make_train_step
from repro_torch.models.common import tree_map
from repro_torch.optim import adamw, constant_schedule

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_parity import j2n, make_pair, t2n  # noqa: E402

torch.set_num_threads(1)

GAP_RATIO = 1.5          # the port's bf16-vs-f32 gap over the reference's
F32_TOL = 1e-4           # the two f32 runs, x max|logit|
LOSS_RTOL = 3e-3         # bf16 losses, port vs reference, relative


def _upcast(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def test_musicgen_bf16_drift_at_full_depth_is_the_references():
    jcfg, tcfg, jp, tp = make_pair("musicgen-large", seed=0, reduced=False,
                                   d_model=256, n_heads=4, n_kv_heads=4,
                                   head_dim=64, d_ff=512)
    assert jcfg.n_layers == 48 and jcfg.dtype == "bfloat16"
    x = np.random.default_rng(0).standard_normal((2, 16, 256)
                                                 ).astype(np.float32)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    tcfg32 = dataclasses.replace(tcfg, dtype="float32")
    ref_bf = j2n(ref_prefill_step(jcfg)(jp["frozen"], jp["lora"],
                                        jnp.asarray(x, jnp.bfloat16)))
    ref_32 = j2n(ref_prefill_step(jcfg32)(_upcast(jp["frozen"]),
                                          _upcast(jp["lora"]),
                                          jnp.asarray(x)))
    port_bf = t2n(make_prefill_step(tcfg, device="cpu")(
        tp["frozen"], tp["lora"], torch.as_tensor(x).to(torch.bfloat16)))
    port_32 = t2n(make_prefill_step(tcfg32, device="cpu")(
        tree_map(lambda v: v.float(), tp["frozen"]),
        tree_map(lambda v: v.float(), tp["lora"]), torch.as_tensor(x)))
    scale = np.abs(ref_32).max()
    assert np.abs(port_32 - ref_32).max() <= F32_TOL * scale
    ref_gap = np.abs(ref_bf - ref_32).max()
    port_gap = np.abs(port_bf - port_32).max()
    assert 0 < port_gap <= GAP_RATIO * ref_gap, (port_gap, ref_gap)


def test_granite_bf16_train_steps_at_3e_3_are_the_references():
    jcfg, tcfg, jp, tp = make_pair("granite-moe-3b-a800m", seed=3,
                                   reduced=False, d_model=128, n_heads=4,
                                   n_kv_heads=2, head_dim=32, d_ff=64,
                                   vocab_size=4096)
    assert (jcfg.n_layers, jcfg.n_experts, jcfg.top_k, jcfg.dtype) == (
        32, 40, 8, "bfloat16")
    rng = np.random.default_rng(11)
    batch = {k: rng.integers(0, jcfg.vocab_size, (4, 64)).astype(np.int32)
             for k in ("tokens", "labels")}
    jstep = jax.jit(ref_train_step(jcfg, ref_adamw(ref_constant(3e-3))))
    topt = adamw(constant_schedule(3e-3))
    tstep = make_train_step(tcfg, topt)
    jl, jst = jp["lora"], ref_adamw(ref_constant(3e-3)).init(jp["lora"])
    tl, tst = tp["lora"], topt.init(tp["lora"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlosses, tlosses = [], []
    for _ in range(4):
        jloss, jl, jst = jstep(jp["frozen"], jl, jst, jb)
        tloss, tl, tst = tstep(tp["frozen"], tl, tst, batch)
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    # and the direction the four steps take is the reference's
    assert (tlosses[-1] < tlosses[0]) == (jlosses[-1] < jlosses[0])
