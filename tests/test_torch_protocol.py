"""The port's live SL protocol against the JAX package's
``core/protocol.py``, ``core/faults.py`` and ``data/pipeline.py``.

Faults and data are numpy streams, so they are bit-identical. A
``SplitFineTuner`` run gives the reference's ``RoundLog`` stream on the
same seeds and weights (the reference's ``init_params`` converted, non-zero
B): cut, frequency, status, attempts and backoff exactly; delay and energy
to rel 1e-12 (the same float64 cost model); loss to rel 1e-4. The CARD run
keeps the int8 channel on; the churn run, whose random cuts fall inside the
stack, turns it off: there a gradient code one step apart at a rounding
tie (the two libraries' f32 gradients differ in the last bit; see
``test_torch_splitting.py``) moves the loss 1.8e-4 after four Adam steps,
which says nothing about the protocol. The reference's protocol fault
tests (``tests/test_faults.py``) are mirrored at the end.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from _torch_parity import make_pair
from repro.configs.base import get_config as j_get_config
from repro.core import faults as JF
from repro.core.channel import WirelessChannel as JChannel
from repro.core.hardware import EDGE_FLEET as J_FLEET
from repro.core.hardware import SERVER_RTX4060TI as J_SERVER
from repro.core.hardware import SimParams as JSim
from repro.core.protocol import SplitFineTuner as JTuner
from repro.data import make_fleet_datasets as j_datasets
from repro.data import synthetic_lm_task as j_synthetic_lm_task
from repro.optim import adamw as j_adamw
from repro.optim import constant_schedule as j_const
from repro_torch.configs.base import get_config
from repro_torch.core import faults as TF
from repro_torch.core.channel import WirelessChannel
from repro_torch.core.hardware import EDGE_FLEET, SERVER_RTX4060TI, SimParams
from repro_torch.core.protocol import SplitFineTuner
from repro_torch.data import make_fleet_datasets, synthetic_lm_task
from repro_torch.models import model as TM
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw, constant_schedule

torch.set_num_threads(1)

FAULT_MODELS = {
    "none": {},
    "churn": dict(dropout_prob=0.2, straggler_prob=0.3, outage_prob=0.25,
                  leave_prob=0.1, rejoin_prob=0.6, initial_absent_prob=0.1),
    "stragglers": dict(straggler_prob=0.9, slowdown_min=1.1,
                       slowdown_max=6.0, outage_stall_s=0.3),
}


@pytest.mark.parametrize("name", list(FAULT_MODELS))
def test_fault_realizations_bit_identical(name):
    kw = FAULT_MODELS[name]
    want = JF.FaultModel(**kw).realize(9, 5, seed=11)
    got = TF.FaultModel(**kw).realize(9, 5, seed=11)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert want.to_jsonable() == got.to_jsonable()


def test_retry_and_breaker_behave_as_the_reference():
    def run(mod):
        calls = iter([mod.LinkTimeout("a"), mod.LinkTimeout("b"), 42])

        def fn():
            v = next(calls)
            if isinstance(v, Exception):
                raise v
            return v
        res = mod.retry_call(fn, mod.RetryPolicy(max_attempts=3,
                                                 base_backoff_s=0.1))
        br = mod.CircuitBreaker(failure_threshold=2, cooldown_rounds=3)
        trace = []
        for r in range(8):
            trace.append(br.allow(0, r))
            if trace[-1] and r < 4:
                br.record_failure(0, r)
        with pytest.raises(mod.ExchangeFailed) as e:
            mod.retry_call(lambda: (_ for _ in ()).throw(OSError("x")),
                           mod.RetryPolicy(max_attempts=4, timeout_s=0.2))
        return res, trace, e.value.attempts, e.value.backoff_s
    assert run(TF) == run(JF)


@pytest.mark.parametrize("arch", ["llama32-1b", "musicgen-large"])
def test_data_batches_bit_identical(arch):
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    np.testing.assert_array_equal(synthetic_lm_task(64, seed=4),
                                  j_synthetic_lm_task(64, seed=4))
    jd = j_datasets(jcfg, 2, vocab=jcfg.vocab_size, seed=1)
    td = make_fleet_datasets(tcfg, 2, vocab=tcfg.vocab_size, seed=1)
    for j, t in zip(jd, td, strict=True):
        assert (j.size, j.seed, j.noise) == (t.size, t.seed, t.noise)
        for _ in range(3):
            a, b = j.minibatch(3, 12), t.minibatch(3, 12)
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# SplitFineTuner against the reference
# ---------------------------------------------------------------------------


def _tuners(policy, fault_kw, n_dev=2, rounds=3, **kw):
    jcfg, tcfg, jp, tp = make_pair("llama32-1b", seed=0)
    sim = dict(local_epochs=2, mini_batch=4, seq_len=16)
    common = dict(policy=policy, quorum=0.5, **kw)
    jinj = tinj = None
    if fault_kw is not None:
        jinj = JF.FaultInjector(JF.FaultModel(**fault_kw).realize(
            rounds, n_dev, seed=3))
        tinj = TF.FaultInjector(TF.FaultModel(**fault_kw).realize(
            rounds, n_dev, seed=3))
    jt = JTuner(jcfg, jp["frozen"], jp["lora"], j_adamw(j_const(3e-3)),
                devices=list(J_FLEET[:n_dev]), server=J_SERVER,
                channels=[JChannel("normal", seed=i) for i in range(n_dev)],
                datasets=j_datasets(jcfg, n_dev, vocab=jcfg.vocab_size,
                                    seed=1),
                sim=JSim(**sim), cost_cfg=j_get_config("llama32-1b"),
                fault_injector=jinj,
                retry_policy=JF.RetryPolicy(max_attempts=2,
                                            base_backoff_s=0.01), **common)
    tt = SplitFineTuner(
        tcfg, tp["frozen"], tp["lora"], adamw(constant_schedule(3e-3)),
        devices=list(EDGE_FLEET[:n_dev]), server=SERVER_RTX4060TI,
        channels=[WirelessChannel("normal", seed=i) for i in range(n_dev)],
        datasets=make_fleet_datasets(tcfg, n_dev, vocab=tcfg.vocab_size,
                                     seed=1),
        sim=SimParams(**sim), cost_cfg=get_config("llama32-1b"),
        fault_injector=tinj,
        retry_policy=TF.RetryPolicy(max_attempts=2, base_backoff_s=0.01),
        **common)
    return jt, tt


def _same(a, b, rel):
    if math.isnan(a):
        return math.isnan(b)
    return b == pytest.approx(a, rel=rel, abs=0)


@pytest.mark.parametrize("policy,faults,compress", [("card", None, True),
                                                    ("random", "churn", False)])
def test_round_log_stream_matches_jax(policy, faults, compress):
    jt, tt = _tuners(policy, None if faults is None
                     else FAULT_MODELS[faults], compress=compress)
    want, got = jt.run(3), tt.run(3)
    assert len(want.logs) == len(got.logs) == 6
    for a, b in zip(want.logs, got.logs, strict=True):
        assert (a.round_idx, a.device, a.cut, a.status, a.attempts) == \
            (b.round_idx, b.device, b.cut, b.status, b.attempts)
        assert a.backoff_s == b.backoff_s
        assert a.frequency == b.frequency or (math.isnan(a.frequency)
                                              and math.isnan(b.frequency))
        for f in ("delay", "server_energy", "cost"):
            assert _same(getattr(a, f), getattr(b, f), 1e-12), f
        assert _same(a.loss, b.loss, 1e-4)
    assert [dataclasses.astuple(s) for s in want.round_summaries] == \
        [dataclasses.astuple(s) for s in got.round_summaries]
    assert any(l.status == "ok" for l in got.logs)
    if faults is None:
        assert all(math.isfinite(l.loss) for l in got.logs)


# ---------------------------------------------------------------------------
# The reference's protocol fault tests (tests/test_faults.py), mirrored
# ---------------------------------------------------------------------------


def _make_tuner(n_devices, n_rounds, fm, *, quorum=0.5, seed=0,
                retry=None, breaker=None):
    cfg = get_config("qwen3-0.6b").reduced()
    params = TM.init_params(0, cfg, device="cpu")
    datasets = make_fleet_datasets(cfg, n_devices, vocab=cfg.vocab_size,
                                   seed=1)
    sim = SimParams(local_epochs=1, mini_batch=4, seq_len=32)
    inj = TF.FaultInjector(fm.realize(n_rounds, n_devices, seed=seed))
    return SplitFineTuner(
        cfg, params["frozen"], params["lora"],
        adamw(constant_schedule(3e-3)),
        devices=list(EDGE_FLEET[:n_devices]), server=SERVER_RTX4060TI,
        channels=[WirelessChannel("normal", seed=i)
                  for i in range(n_devices)],
        datasets=datasets, sim=sim, policy="card", fault_injector=inj,
        retry_policy=retry or TF.RetryPolicy(max_attempts=2,
                                             base_backoff_s=0.01),
        breaker=breaker or TF.CircuitBreaker(), quorum=quorum)


def test_protocol_outages_retried_transparently():
    ft = _make_tuner(2, 3, TF.FaultModel(outage_prob=1.0))
    res = ft.run(3)
    ok = [l for l in res.logs if l.status == "ok"]
    assert len(ok) == 6
    assert all(l.attempts == 2 for l in ok)
    assert all(l.backoff_s > 0 for l in ok)
    assert res.rounds_committed() == 3


def test_protocol_dropout_breaker_evicts_repeat_offender():
    fm = TF.FaultModel()
    real = fm.realize(6, 2, seed=0)
    real.dropout[:, 1] = True
    ft = _make_tuner(2, 6, fm, quorum=0.4,
                     breaker=TF.CircuitBreaker(failure_threshold=2,
                                               cooldown_rounds=10))
    ft.fault_injector = TF.FaultInjector(real)
    res = ft.run(6)
    by_status = {}
    for l in res.logs:
        if l.device == ft.devices[1].name:
            by_status[l.status] = by_status.get(l.status, 0) + 1
    assert by_status.get("dropped") == 2
    assert by_status.get("evicted") == 4
    assert res.rounds_committed() == 6


def test_protocol_below_quorum_rolls_back_to_the_exact_tensors():
    fm = TF.FaultModel(dropout_prob=1.0)
    ft = _make_tuner(2, 2, fm, quorum=0.5,
                     breaker=TF.CircuitBreaker(failure_threshold=99,
                                               cooldown_rounds=1))
    before = [x.clone() for x in tree_leaves(ft.lora)]
    state_before = ft.opt_state
    res = ft.run(2)
    assert res.rounds_committed() == 0
    assert all(not s.committed for s in res.round_summaries)
    for a, b in zip(before, tree_leaves(res.lora), strict=True):
        assert torch.equal(a, b)
    assert ft.opt_state is state_before
    assert math.isnan(res.mean_delay())
    assert res.losses() == []


def test_protocol_rollback_undoes_a_trained_round():
    """A member that trains and then sees its round fall below quorum is
    rolled back too: the adapters return to the very tensors of the round's
    start (the optimizer never wrote into them)."""
    fm = TF.FaultModel()
    real = fm.realize(1, 3, seed=0)
    real.dropout[0, 1:] = True          # 1 of 3 survives, quorum 0.5 needs 2
    ft = _make_tuner(3, 1, fm, quorum=0.5)
    ft.fault_injector = TF.FaultInjector(real)
    start = ft.lora
    before = [x.clone() for x in tree_leaves(start)]
    res = ft.run(1)
    assert [l.status for l in res.logs] == ["rolled_back", "dropped",
                                            "dropped"]
    assert res.lora is start
    for a, b in zip(before, tree_leaves(res.lora), strict=True):
        assert torch.equal(a, b)


def test_protocol_absent_members_are_skipped_not_failed():
    fm = TF.FaultModel(initial_absent_prob=1.0, rejoin_prob=0.0)
    ft = _make_tuner(2, 2, fm)
    res = ft.run(2)
    assert all(l.status == "absent" for l in res.logs)
    assert all(s.attempted == 0 for s in res.round_summaries)
    assert not any(s.committed for s in res.round_summaries)
