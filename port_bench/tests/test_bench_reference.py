"""The plain reference against the port at a tiny size on the CPU, both in
float32: the prefill's first-token logits and K / V through the port's
cache path, and a split step's loss and LoRA gradients. The reference
imports nothing of the port."""
import ast

import pytest
import torch

from port_bench import spec, weights
from port_bench.reference import model as ref
from port_bench.tests import tiny

TOL = 2e-4          # x the largest magnitude: float32 in a different order


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def test_reference_imports_nothing_of_the_port():
    for path in (spec.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module]
        assert not [n for n in names if n.split(".")[0] in
                    ("repro_torch", "repro", "jax", "jaxlib")], path


def test_prefill_against_the_port():
    from repro_torch.models import model as M
    r = tiny.run("prefill_pool.qwen2-7b", dtype="float32")
    cfg = r.cfg
    frozen = weights.make_frozen(cfg, 3, "cpu")
    stack = weights.make_adapters(cfg, 3, "cpu", 2, spec.ADAPTERS)
    lora = weights.adapter(stack, 1)
    chunk, n = 8, 3
    toks = torch.randint(0, cfg.vocab_size, (1, chunk * n),
                         generator=torch.Generator().manual_seed(0))
    cache = M.init_cache(cfg, 1, 40, device="cpu")
    with torch.no_grad():
        for i in range(n):
            got, cache = M.prefill_chunk(frozen, lora, cache,
                                         toks[:, i * chunk:(i + 1) * chunk],
                                         i * chunk, cfg)
        kv = {}
        want = ref.prefill(frozen, [toks[0]], [lora], r.dims, ref.exact,
                           lambda j, i, k, v: kv.__setitem__(i, (k, v)))
    assert _rel(got[0, :cfg.vocab_size], want[0]) < TOL
    for i, (k, v) in kv.items():
        assert _rel(cache["kv"]["k"][i, 0, :chunk * n], k) < TOL
        assert _rel(cache["kv"]["v"][i, 0, :chunk * n], v) < TOL


@pytest.mark.parametrize("cut", [0, 1, 2])
@pytest.mark.parametrize("channel", [False, True])
def test_split_step_against_the_port(cut, channel):
    from repro_torch.core import splitting as S
    r = tiny.run("split_finetune.qwen2-7b", dtype="float32")
    cfg = r.cfg
    frozen = weights.make_frozen(cfg, 4, "cpu")
    lora = weights.adapter(weights.make_adapters(cfg, 4, "cpu", 1,
                                                 spec.ADAPTERS), 0)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=g)
    d, s = S.split_lora(lora, cut)
    loss, gd, gs = S.split_grads(frozen, d, s, toks[:, :-1], toks[:, 1:],
                                 cfg=cfg, cut=cut, compress=channel)
    grads = S.merge_lora(gd, gs)
    want_loss, want = ref.split_step(frozen, lora, toks[:, :-1], toks[:, 1:],
                                     cut, r.dims, ref.exact, channel)
    assert abs(loss.item() - want_loss) < TOL * abs(want_loss)
    for (_, a), (_, b) in zip(weights.leaves(grads), weights.leaves(want)):
        # the int8 channel rounds the two sides' f32 values: a step of its
        # grid where they fall either side of a rounding edge
        assert _rel(a, b) < (2e-2 if channel else TOL)


def test_adamw_against_the_port():
    from repro_torch.optim import adamw, apply_updates, constant_schedule
    p = {"w": torch.randn(5, 3, generator=torch.Generator().manual_seed(2))}
    opt = adamw(constant_schedule(1e-3))
    st = opt.init(p)
    mine, state = p, None
    for k in range(3):
        g = {"w": torch.randn(5, 3,
                              generator=torch.Generator().manual_seed(10 + k))}
        u, st = opt.update(g, st, p)
        p = apply_updates(p, u)
        mine, state = ref.adamw(mine, g, state, 1e-3, 0.9, 0.999, 1e-8, 0.0)
    assert _rel(p["w"], mine["w"]) < 1e-6
