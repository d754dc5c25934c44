"""Split execution in the port against the JAX package's
``core/splitting.py`` (mirrors ``tests/test_splitting.py``): the same
weights (the reference's ``init_params`` converted leaf for leaf, adapters
with a non-zero B, or ``dA`` would be zero and prove nothing) and the same
numpy-seeded tokens, at the reduced size (2 layers, f32).

Tolerances: int8 codes equal except one step at a rounding tie, scales rel
1e-6; loss rel 1e-5; every gradient leaf within 1e-4 of the JAX leaf's
largest magnitude with the channel quantizer off (the worst is 3e-6), 3e-3
with it on. With it on, the two libraries' f32 activations and gradients
differ in the last bit, so a value that close to a rounding boundary takes
a code one step apart (at cut 1: 2 of the 32768 smashed values, 1 of the
32768 gradient values); the one gradient code moves that value by
max|row| / 127 and the device's leaves by up to 2.4e-3 of their largest
magnitude. The quantizer itself is exact against the reference on equal
inputs (the int8 test), and given the reference's own compressed gradient
the device backward agrees to 1e-4 (the stage-by-stage test). Also here: each of the five kernel wrappers refuses autograd
on the CPU, as on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_tree_close, j2n, make_pair, t2n
from repro.core import splitting as JS
from repro_torch.core import splitting as TS
from repro_torch.launch.train import value_and_grad
from repro_torch.models import attention as t_attn
from repro_torch.models import model as TM
from repro_torch.models.common import lora_dense, tree_leaves, tree_map

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg, jp, tp = make_pair("llama32-1b", seed=0)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    return jcfg, tcfg, jp, tp, tokens, labels


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# channel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,scale,dtype", [
    ((8, 64), 3.0, "float32"), ((4, 32, 256), 0.05, "float32"),
    ((4, 32, 256), 2.0, "bfloat16")])
def test_int8_codes_and_scales_match_jax(shape, scale, dtype):
    x = (np.random.default_rng(0).standard_normal(shape) * scale
         ).astype(np.float32)
    jq, js = JS.quantize_int8(jnp.asarray(x, dtype))
    tq, ts = TS.quantize_int8(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == shape[:-1] + (1,)
    np.testing.assert_allclose(t2n(ts), j2n(js), rtol=1e-6)
    diff = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq, np.int32))
    assert diff.max() <= 1
    if dtype == "float32":
        assert diff.sum() == 0
    else:   # a step apart only at rounding ties of the bf16 quotient
        assert (diff > 0).mean() < 0.01


def test_int8_channel_roundtrip():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 64))
                         .astype(np.float32) * 3.0)
    q, s = TS.quantize_int8(x)
    err = (TS.dequantize_int8(q, s, x.dtype) - x).abs()
    assert (err <= s * 0.5 + 1e-6).all()


def test_channel_compress_straight_through_gradient():
    x = torch.randn(16, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(TS.channel_compress(x, True) * 3.0),
                               x)
    np.testing.assert_allclose(g.numpy(), 3.0, rtol=1e-6)


def test_channel_compress_keeps_the_activation_dtype_arithmetic():
    """The value is ``x + (xq - x)`` rounded in x's dtype, op by op, as the
    reference writes it (not ``xq``, which it equals wherever the
    subtraction is exact)."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((64, 256))
                         .astype(np.float32)).to(torch.bfloat16)
    q, s = TS.quantize_int8(x)
    xq = TS.dequantize_int8(q, s, x.dtype)
    got = TS.channel_compress(x, True)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, x + (xq - x))
    assert not torch.equal(got, x)
    assert TS.channel_compress(x, False) is x


# ---------------------------------------------------------------------------
# split_grads against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("cut", [0, 1, 2])
def test_split_grads_match_jax(setup, cut, compress):
    jcfg, tcfg, jp, tp, tokens, labels = setup
    jd, js = JS.split_lora(jp["lora"], cut)
    jloss, jgd, jgs = JS.split_grads(jp["frozen"], jd, js, jnp.asarray(tokens),
                                     jnp.asarray(labels), cfg=jcfg, cut=cut,
                                     compress=compress)
    td, ts = TS.split_lora(tp["lora"], cut)
    tloss, tgd, tgs = TS.split_grads(tp["frozen"], td, ts, _t(tokens),
                                     _t(labels), cfg=tcfg, cut=cut,
                                     compress=compress)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    c = 3e-3 if compress else 1e-4
    assert_tree_close(jgd, tgd, c)
    assert_tree_close(jgs, tgs, c)
    # the adapters that train reach the loss: no side is all zeros
    if 0 < cut:
        assert any(t2n(x).any() for x in tree_leaves(tgd))
    if cut < tcfg.n_layers:
        assert any(t2n(x).any() for x in tree_leaves(tgs))


@pytest.mark.parametrize("cut", [1, 2])
def test_device_backward_matches_jax_on_the_same_channel_gradient(setup, cut):
    """The stage-by-stage view of the channel-on case: given the reference's
    own int8-compressed smashed-data gradient, the port's device backward
    gives the reference's device grads to 1e-4, so what the end-to-end
    comparison allows beyond that is the quantizer's tie, nothing else."""
    jcfg, tcfg, jp, tp, tokens, labels = setup
    jd, js = JS.split_lora(jp["lora"], cut)

    @jax.jit
    def reference(jd, js):
        def dev_fn(ld):
            return JS.device_forward(jp["frozen"], ld, jnp.asarray(tokens),
                                     jcfg, cut, compress=True)
        jsm, dev_vjp = jax.vjp(dev_fn, jd)
        g = jax.grad(lambda sm: JS.server_loss(
            jp["frozen"], js, sm, jnp.asarray(labels), jcfg, cut))(jsm)
        g = JS.channel_compress(g, True)
        return g, dev_vjp(g)[0]
    jg, want = reference(jd, js)

    td = tree_map(lambda x: x.detach().requires_grad_(),
                  TS.split_lora(tp["lora"], cut)[0])
    tsm = TS.device_forward(tp["frozen"], td, _t(tokens), tcfg, cut,
                            compress=True)
    got = torch.autograd.grad(tsm, tree_leaves(td),
                              grad_outputs=torch.from_numpy(np.array(jg)))
    it = iter(got)
    assert_tree_close(want, tree_map(lambda _: next(it), td), 1e-4)


@pytest.mark.parametrize("cut", [0, 1, 2])
def test_split_grads_equal_unsplit_in_the_port(setup, cut):
    """Split BP through the channel == end-to-end LoRA grads (phi off)."""
    _, cfg, _, tp, tokens, labels = setup
    batch = {"tokens": _t(tokens), "labels": _t(labels)}
    ref_loss, ref = value_and_grad(
        lambda lo: TM.forward_loss(tp["frozen"], lo, batch, cfg, impl="naive",
                                   remat=False), tp["lora"])
    d, s = TS.split_lora(tp["lora"], cut)
    loss, gd, gs = TS.split_grads(tp["frozen"], d, s, batch["tokens"],
                                  batch["labels"], cfg=cfg, cut=cut,
                                  compress=False)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-6)
    for a, b in zip(tree_leaves(TS.merge_lora(gd, gs)), tree_leaves(ref),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * b.abs().max().item())


@pytest.mark.parametrize("cut", [0, 1, 2])
def test_split_merge_roundtrip(setup, cut):
    *_, tp, _, _ = setup
    d, s = TS.split_lora(tp["lora"], cut)
    for a, b in zip(tree_leaves(TS.merge_lora(d, s)), tree_leaves(tp["lora"]),
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cut", [0, 2])
def test_edge_cuts_give_zero_length_grads(setup, cut):
    """At cut 0 the device holds no layer, at cut n_layers the server none:
    that side's grads are zeros of its (0, ...) leaves, and merge works."""
    jcfg, tcfg, jp, tp, tokens, labels = setup
    d, s = TS.split_lora(tp["lora"], cut)
    _, gd, gs = TS.split_grads(tp["frozen"], d, s, _t(tokens), _t(labels),
                               cfg=tcfg, cut=cut, compress=True)
    empty, full = (gd, gs) if cut == 0 else (gs, gd)
    assert all(x.shape[0] == 0 for x in tree_leaves(empty))
    assert all(x.shape[0] == tcfg.n_layers for x in tree_leaves(full))
    merged = TS.merge_lora(gd, gs)
    for a, b in zip(tree_leaves(merged), tree_leaves(tp["lora"]), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_compression_changes_forward_but_not_much(setup):
    _, cfg, _, tp, tokens, labels = setup
    d, s = TS.split_lora(tp["lora"], 1)
    lc, *_ = TS.split_grads(tp["frozen"], d, s, _t(tokens), _t(labels),
                            cfg=cfg, cut=1, compress=True)
    ln, *_ = TS.split_grads(tp["frozen"], d, s, _t(tokens), _t(labels),
                            cfg=cfg, cut=1, compress=False)
    assert float(lc) != float(ln)
    assert abs(float(lc) - float(ln)) < 0.1


@pytest.mark.parametrize("cut", [0, 1, 2])
def test_smashed_data_matches_jax(setup, cut):
    """Eq. 2: smashed data is (B, S, d) at every cut, equal to the
    reference's (compress off)."""
    jcfg, tcfg, jp, tp, tokens, _ = setup
    want = JS.device_forward(jp["frozen"], JS.split_lora(jp["lora"], cut)[0],
                             jnp.asarray(tokens), jcfg, cut, compress=False)
    with torch.no_grad():
        got = TS.device_forward(tp["frozen"], TS.split_lora(tp["lora"], cut)[0],
                                _t(tokens), tcfg, cut, compress=False)
    assert tuple(got.shape) == (4, 32, tcfg.d_model)
    np.testing.assert_allclose(t2n(got), j2n(want), rtol=0, atol=2e-4)


def test_executor_step_takes_numpy_and_marks_the_stages(setup):
    _, cfg, _, tp, tokens, labels = setup
    stages = []
    ex = TS.SplitExecutor(cfg, compress=True, mark=stages.append)
    batch = {"tokens": tokens, "labels": labels}
    l1, g1 = ex.step(tp["frozen"], tp["lora"], batch, 1)
    l2, g2 = ex.step(tp["frozen"], tp["lora"], batch, 1)
    assert float(l1) == float(l2)
    assert stages == ["device_forward", "server", "device_backward",
                      "end"] * 2
    for a, b, p in zip(tree_leaves(g1), tree_leaves(g2),
                       tree_leaves(tp["lora"]), strict=True):
        assert torch.equal(a, b) and a.shape == p.shape
        assert not a.requires_grad
    assert all(not x.requires_grad for x in tree_leaves(tp["lora"]))


# ---------------------------------------------------------------------------
# the kernels refuse autograd (the reference cannot differentiate them)
# ---------------------------------------------------------------------------


def _kernel_calls():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ssd_scan as ss
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)
    return {
        "lora_matmul": (lm.lora_matmul,
                        lambda: (r(8, 16), r(16, 12), r(16, 4), r(4, 12))),
        "lora_matmul_grouped": (
            lambda x, w, a, b: lm.lora_matmul_grouped(
                x, w, a, b, torch.tensor([0, 1, 0], dtype=torch.int32)),
            lambda: (r(3, 1, 16), r(16, 12), r(2, 16, 4), r(2, 4, 12))),
        "flash_attention": (fa.flash_attention,
                            lambda: (r(1, 4, 8, 16), r(1, 2, 8, 16),
                                     r(1, 2, 8, 16))),
        "flash_decode": (lambda q, k, v: fd.flash_decode(q, k, v, 5),
                         lambda: (r(1, 2, 2, 16), r(1, 2, 8, 16),
                                  r(1, 2, 8, 16))),
        "ssd_intra_chunk": (ss.ssd_intra_chunk,
                            lambda: (r(1, 2, 8, 2, 4), -r(1, 2, 8, 2).abs(),
                                     r(1, 2, 8, 4), r(1, 2, 8, 4))),
    }


@pytest.mark.parametrize("name", ["lora_matmul", "lora_matmul_grouped",
                                  "flash_attention", "flash_decode",
                                  "ssd_intra_chunk"])
def test_kernel_wrappers_refuse_autograd(name):
    fn, make = _kernel_calls()[name]
    args = make()
    args[0].requires_grad_()
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        fn(*args)
    with torch.no_grad():       # what serving and calibration do
        out = fn(*args)
    assert all(not o.requires_grad for o in
               (out if isinstance(out, tuple) else (out,)))
    fn(*(a.detach() for a in args))    # inputs that need no gradient


def test_kernel_routes_refuse_to_train(setup):
    """``split_grads(impl="pallas")`` and ``lora_dense(use_kernel=True)``
    raise under grad, as the reference's ``jax.grad`` through its Pallas
    kernels fails; no path returns a kernel result without its gradient."""
    _, cfg, _, tp, tokens, labels = setup
    d, s = TS.split_lora(tp["lora"], 1)
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        TS.split_grads(tp["frozen"], d, s, _t(tokens), _t(labels), cfg=cfg,
                       cut=1, impl="pallas")
    x = torch.randn(4, 16, requires_grad=True)
    pair = {"a": torch.randn(16, 4), "b": torch.randn(4, 8)}
    with pytest.raises(RuntimeError, match="lora_matmul has no backward"):
        lora_dense(x, torch.randn(16, 8), pair, 2.0, use_kernel=True)


def test_attention_takes_the_reference_name_of_the_kernel_route():
    """``impl="pallas"`` (the reference's name) is the ``"flash"`` route:
    the same result, and the kernel's refusal under grad."""
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, 8, h, 16, generator=g) for h in (4, 2, 2))
    pos = torch.arange(8)[None].expand(2, 8)
    kw = dict(causal=True, window=0, q_positions=pos, k_positions=pos)
    with torch.no_grad():
        got = t_attn.attention_scores(q, k, v, impl="pallas", **kw)
        want = t_attn.attention_scores(q, k, v, impl="flash", **kw)
        naive = t_attn.attention_scores(q, k, v, impl="naive", **kw)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, naive, rtol=0, atol=2e-5)
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        t_attn.attention_scores(q.requires_grad_(), k, v, impl="pallas", **kw)


# ---------------------------------------------------------------------------
# The ssm, hybrid and moe families
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b",
                                  "granite-moe-3b-a800m"])
def test_family_split_grads_match_jax(arch):
    """At the middle cut, channel off, tolerances as above (loss rel 1e-5,
    leaves 1e-4 of the JAX leaf's largest magnitude)."""
    jcfg, tcfg, jp, tp = make_pair(arch, seed=1)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jd, js = JS.split_lora(jp["lora"], 1)
    jloss, jgd, jgs = JS.split_grads(jp["frozen"], jd, js, jnp.asarray(tokens),
                                     jnp.asarray(labels), cfg=jcfg, cut=1,
                                     compress=False)
    td, ts = TS.split_lora(tp["lora"], 1)
    tloss, tgd, tgs = TS.split_grads(tp["frozen"], td, ts, _t(tokens),
                                     _t(labels), cfg=tcfg, cut=1,
                                     compress=False)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    assert_tree_close(jgd, tgd, 1e-4)
    assert_tree_close(jgs, tgs, 1e-4)
    assert any(t2n(x).any() for x in tree_leaves(tgd))
    assert any(t2n(x).any() for x in tree_leaves(tgs))


def test_moe_split_grads_drop_the_device_stage_aux_as_the_reference():
    """The reference's ``device_forward`` discards the router aux loss of
    layers [0, c), and the port keeps that: at cut 1 the split grads equal
    the grads of ``forward_loss`` less layer 0's aux (to 1e-6, the same
    arithmetic), and differ from those of ``forward_loss`` itself."""
    _, cfg, _, tp = make_pair("granite-moe-3b-a800m", seed=2)
    rng = np.random.default_rng(7)
    batch = {k: _t(rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32))
             for k in ("tokens", "labels")}

    def unsplit(lora, less_device_aux):
        loss = TM.forward_loss(tp["frozen"], lora, batch, cfg, impl="naive",
                               remat=False)
        if less_device_aux:
            loss = loss - TM.forward_hidden(tp["frozen"], lora,
                                            batch["tokens"], cfg, lo=0, hi=1,
                                            impl="naive", remat=False)[1]
        return loss
    d, s = TS.split_lora(tp["lora"], 1)
    loss, gd, gs = TS.split_grads(tp["frozen"], d, s, batch["tokens"],
                                  batch["labels"], cfg=cfg, cut=1,
                                  compress=False)
    got = tree_leaves(TS.merge_lora(gd, gs))
    want_loss, want = value_and_grad(lambda lo: unsplit(lo, True), tp["lora"])
    full_loss, full = value_and_grad(lambda lo: unsplit(lo, False),
                                     tp["lora"])
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
    assert float(full_loss) - float(loss) > 1e-4       # layer 0's aux
    for a, b in zip(got, tree_leaves(want), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * b.abs().max().item())
    assert max(float((a - b).abs().max())
               for a, b in zip(got, tree_leaves(full))) > 1e-6
