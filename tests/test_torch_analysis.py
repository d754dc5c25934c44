"""The port's step analysis (``repro_torch.launch.analysis``) against the JAX
package's ``launch/analysis.py`` and against the reference's step programs.

The reference counts FLOPs with XLA's ``cost_analysis`` on a compiled
program; that needs the 512-device lowering, which does not run here. What
does run on one CPU device is ``jax.make_jaxpr`` of the reference's steps:
the port's ``FlopCounterMode`` count of its own step, traced on ``meta``, is
held against 2·M·N·K summed over every ``dot_general`` of that jaxpr
(sub-jaxprs walked, a scan body times its length), at reduced configs.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.extend import core as jcore

from repro.configs.base import get_config as jax_get_config
from repro.data.pipeline import batch_specs as jax_batch_specs
from repro.launch import analysis as jax_analysis
from repro.launch.serve import make_prefill_step as jax_prefill_step
from repro.launch.serve import make_serve_step as jax_serve_step
from repro.launch.train import make_train_step as jax_train_step
from repro.models import model as JM
from repro.optim import adamw as jax_adamw
from repro.optim import constant_schedule as jax_constant_schedule
from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.core.hardware import (H100_HBM_BYTES_PER_S,
                                       H100_NVLINK_BYTES_PER_S,
                                       H100_NVLINK_LINKS, H100_PEAK_FLOPS)
from repro_torch.launch import analysis
from repro_torch.launch.dryrun import build_step

torch.set_num_threads(1)

KIND_SHAPE = {"train": "train_4k", "prefill": "prefill_32k",
              "decode": "decode_32k"}
B, S = 2, 64        # the parity tests' batch and sequence


# ---------------------------------------------------------------------------
# Roofline, model_flops, collectives
# ---------------------------------------------------------------------------


def test_roofline_terms_math_on_the_h100():
    """The reference's ``test_roofline_terms_math`` with the H100's
    constants: each term is one second at its own peak; the compute term
    uses the bf16 peak; the largest term dominates and bounds."""
    link = H100_NVLINK_BYTES_PER_S * H100_NVLINK_LINKS
    r = analysis.Roofline(flops=989e12, hbm_bytes=3.35e12,
                          collective_bytes=link, chips=1)
    assert H100_PEAK_FLOPS["bfloat16"] == 989e12
    assert H100_HBM_BYTES_PER_S == 3.35e12
    assert link == 450e9                     # 900 GB/s both ways
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(1.0)
    r2 = analysis.Roofline(flops=1e12, hbm_bytes=3.35e12 * 5,
                           collective_bytes=0, chips=1)
    assert r2.dominant == "memory"
    assert r2.bound_s == pytest.approx(5.0)
    r3 = analysis.Roofline(flops=989e12 * 2, hbm_bytes=1.0,
                           collective_bytes=0, chips=1)
    assert r3.dominant == "compute" and r3.bound_s == pytest.approx(2.0)
    d = r3.as_dict()
    want = jax_analysis.Roofline(flops=1.0, hbm_bytes=1.0,
                                 collective_bytes=0.0, chips=1).as_dict()
    assert set(d) == set(want)
    assert d["compute_s"] == r3.compute_s and d["dominant"] == "compute"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_matches_reference(arch):
    for kind in ("train", "inference"):
        for tokens in (1, 4096, 32 * 32768):
            assert analysis.model_flops(get_config(arch), tokens, kind) == \
                jax_analysis.model_flops(jax_get_config(arch), tokens, kind)


def test_collective_stats_are_empty_on_one_card():
    roof, coll, mem = analysis.analyze_step(
        lambda x: x @ x, torch.ones(4, 4, device="meta"))
    assert coll.counts == {} and coll.total_bytes == 0
    assert coll.summary() == jax_analysis.CollectiveStats().summary()
    assert roof.collective_bytes == 0 and roof.chips == 1
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "generated_code_bytes", "peak_bytes"}
    assert mem["generated_code_bytes"] is None


# ---------------------------------------------------------------------------
# The counters
# ---------------------------------------------------------------------------


def test_hbm_bytes_count_kernels_not_views_or_allocations():
    """A view moves nothing, an ``empty`` moves nothing, an op reads its
    inputs and writes its outputs, an in-place op reads and writes its
    target."""
    x = torch.empty(256, 128, device="meta")          # 131072 bytes

    def fn(x):
        t = x.t()                                     # view: 0
        y = t + 1.0                                   # read x, write y
        z = torch.empty(128, 256, device="meta")      # allocation: 0
        z.copy_(y)                                    # z, y in; z out
        return z.sum()                                # z in; 4 bytes out

    roof, _, mem = analysis.analyze_step(fn, x)
    n = 256 * 128 * 4
    assert roof.hbm_bytes == 2 * n + 3 * n + n + 4
    assert roof.flops == 0
    assert mem["argument_bytes"] == n and mem["output_bytes"] == 4
    # x, y and z live at once, and the sum's output beside them
    assert mem["peak_bytes"] == 3 * n + 4 and mem["temp_bytes"] == 2 * n + 4


def test_peak_is_the_most_live_at_once_not_the_sum():
    def fn(x):
        for _ in range(5):
            y = x * 2.0           # each y freed when the next is made
        return y.sum()

    x = torch.empty(1000, device="meta")
    _, _, mem = analysis.analyze_step(fn, x)
    # x, the live y, and the next y being made
    assert mem["peak_bytes"] == 3 * 4000


def test_saved_for_backward_counts_while_autograd_holds_it():
    w = torch.empty(512, 512, device="meta")

    def fn(w, keep):
        w = w.detach().requires_grad_()
        h = (w @ w).sin()        # mm output saved by sin's backward
        loss = (h * h).sum()
        if not keep:
            return loss.detach()
        return torch.autograd.grad(loss, w)[0]

    _, _, no_grad = analysis.analyze_step(lambda w: fn(w, False), w)
    _, _, with_grad = analysis.analyze_step(lambda w: fn(w, True), w)
    assert with_grad["peak_bytes"] > no_grad["peak_bytes"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_peak_on_real_cpu_tensors_equals_meta(kind):
    """One reduced f32 step traced twice: on real CPU tensors and on
    ``meta``. The same program makes the same storages, so the tracker
    gives the same peak, arguments and bytes."""
    cfg = get_config("qwen3-0.6b").reduced()
    assert cfg.dtype == "float32"
    shape = dataclasses.replace(INPUT_SHAPES[KIND_SHAPE[kind]], seq_len=S,
                                global_batch=B)
    out = {}
    for device in ("cpu", "meta"):
        step, args = build_step(cfg, shape, device=device)
        out[device] = analysis.analyze_step(step, *args)
    (rc, _, mc), (rm, _, mm) = out["cpu"], out["meta"]
    assert mc == mm
    assert rc.flops == rm.flops and rc.hbm_bytes == rm.hbm_bytes


def test_logits_count_the_cards_bf16_operands_on_meta():
    """A bf16 model's f32 logits: on ``meta`` the trace takes the card's
    ``mm(..., out_dtype=float32)``, which reads bf16 operands, not the CPU
    branch's f32 casts."""
    from repro_torch.models.model import _matmul_f32_out
    x = torch.empty(8, 64, dtype=torch.bfloat16, device="meta")
    w = torch.empty(64, 128, dtype=torch.bfloat16, device="meta")
    roof, _, _ = analysis.analyze_step(_matmul_f32_out, x, w)
    assert roof.flops == 2 * 8 * 64 * 128
    assert roof.hbm_bytes == (8 * 64 + 64 * 128) * 2 + 8 * 128 * 4


# ---------------------------------------------------------------------------
# FLOP parity with the reference's jaxprs
# ---------------------------------------------------------------------------


def _sub_jaxprs(eqn):
    for v in eqn.params.values():
        for x in (v if isinstance(v, (tuple, list)) else [v]):
            if isinstance(x, jcore.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jcore.Jaxpr):
                yield x


def dot_flops(jaxpr):
    """(2·M·N·K summed over every dot_general, the part of it from
    dot_generals with no contracting dimension): sub-jaxprs walked, a scan
    body counted ``length`` times. The steps are traced with
    ``unroll=True``, so no while loop or branch is left to guess."""
    total = outer = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        assert name not in ("while", "cond", "conv_general_dilated"), name
        if name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            f = 2 * math.prod(eqn.outvars[0].aval.shape) * math.prod(
                lhs[i] for i in lc)
            total += f
            outer += 0 if lc else f
        mult = eqn.params["length"] if name == "scan" else 1
        for sub in _sub_jaxprs(eqn):
            t, o = dot_flops(sub)
            total += mult * t
            outer += mult * o
    return total, outer


def reference_flops(arch, kind):
    cfg = jax_get_config(arch).reduced()
    shape = dataclasses.replace(INPUT_SHAPES[KIND_SHAPE[kind]], seq_len=S,
                                global_batch=B)
    params = JM.abstract_params(cfg)
    key = "embeds" if cfg.input_mode == "embeds" else "tokens"
    if kind == "prefill":
        fn = jax_prefill_step(cfg, unroll=True)
        args = (params["frozen"], params["lora"],
                jax_batch_specs(cfg, shape)[key])
    elif kind == "decode":
        fn = jax_serve_step(cfg, unroll=True)
        cache = jax.eval_shape(lambda: JM.init_cache(cfg, B, S))
        args = (params["frozen"], params["lora"], cache,
                jax_batch_specs(cfg, shape)[key],
                jax.ShapeDtypeStruct((), jnp.int32))
    else:
        opt = jax_adamw(jax_constant_schedule(1e-4))
        fn = jax_train_step(cfg, opt, unroll=True)
        args = (params["frozen"], params["lora"],
                jax.eval_shape(opt.init, params["lora"]),
                jax_batch_specs(cfg, shape))
    return dot_flops(jax.make_jaxpr(fn)(*args).jaxpr)


def port_flops(arch, kind):
    cfg = get_config(arch).reduced()
    shape = dataclasses.replace(INPUT_SHAPES[KIND_SHAPE[kind]], seq_len=S,
                                global_batch=B)
    step, args = build_step(cfg, shape)
    return analysis.analyze_step(step, *args)[0].flops


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_inference_flops_equal_the_reference_dot_generals(arch, kind):
    """Dense, embeds (audio, vlm) and MoE: exactly the reference's count.
    SSM and hybrid: the reference's count less its dot_generals with no
    contracting dimension — the SSD scan's elementwise and outer products
    (decay x scores, x_t ⊗ B_t in the decode update), which XLA writes as
    dot_generals and the port as broadcast multiplies, which FlopCounterMode
    does not count. The gap is named and held exactly."""
    total, outer = reference_flops(arch, kind)
    got = port_flops(arch, kind)
    family = get_config(arch).family
    if family in ("ssm", "hybrid"):
        assert outer > 0
        assert got == total - outer, (got, total, outer)
    else:
        assert outer == 0
        assert got == total, (got, total)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_flops_against_the_reference_dot_generals(arch):
    """The train step (remat on, as the dry run runs it) counts at least
    the reference's products and at most 12 % more. The reason:
    ``torch.utils.checkpoint`` recomputes each layer's whole forward in the
    backward, where JAX's remat recomputes only what the backward reads
    (its dead-code elimination drops, for instance, the recomputed output
    projection of a dense MLP, whose result no gradient needs). For the
    dense and embeds families the excess is exactly that: one down
    projection a layer. MoE without a shared expert: no excess."""
    total, outer = reference_flops(arch, "train")
    got = port_flops(arch, "train")
    cfg = get_config(arch).reduced()
    want = total - outer
    assert want <= got <= 1.12 * want, (got, want)
    if cfg.family in ("dense", "audio", "vlm"):
        assert got - want == cfg.n_layers * 2 * B * S * cfg.d_ff * cfg.d_model
    if cfg.family == "moe" and not cfg.n_shared_experts:
        assert got == want
