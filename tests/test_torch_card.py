"""The port's decision stack (``core/hardware``, ``core/cost_model``,
``core/card``) against the JAX package's.

The fleet and channel streams are numpy and must be bit-identical; the
scalar cost model and CARD run the same float64 Python arithmetic and must
give identical decisions; the batched engine runs float32 tensors on the CPU
here and is held to the JAX batched engine with the tolerances of
``tests/test_fleet_engine.py`` (cuts equal, frequencies rtol 1e-5, delays
and energies rtol 1e-4)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core import card as JC
from repro.core import channel as j_channel
from repro.core import cost_model as j_cm
from repro.core import hardware as j_hw
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.core import card as TC
from repro_torch.core import channel as t_channel
from repro_torch.core import cost_model as t_cm
from repro_torch.core import hardware as t_hw

torch.set_num_threads(1)

ARCHS = ("llama32-1b", "qwen3-4b", "granite-moe-3b-a800m")
STATES = ("good", "normal", "poor")
BATCH, SEQ = 4, 512


def _fields(profile):
    return dataclasses.asdict(profile)


def test_fleets_and_server_tier_bit_identical():
    for n, seed in ((1, 0), (7, 3), (100, 0)):
        jf = j_hw.make_heterogeneous_fleet(n, seed=seed)
        tf = t_hw.make_heterogeneous_fleet(n, seed=seed)
        assert [_fields(d) for d in jf] == [_fields(d) for d in tf]
    assert _fields(j_hw.SERVER_RTX4060TI) == _fields(t_hw.SERVER_RTX4060TI)
    assert ([_fields(d) for d in j_hw.EDGE_FLEET]
            == [_fields(d) for d in t_hw.EDGE_FLEET])
    assert (dataclasses.asdict(j_hw.DEFAULT_SIM)
            == dataclasses.asdict(t_hw.DEFAULT_SIM))
    jt, tt = j_hw.make_server_tier(3, seed=2), t_hw.make_server_tier(3, seed=2)
    assert [_fields(s) for s in jt.servers] == [_fields(s) for s in tt.servers]
    assert jt.backhaul_bits_per_s == tt.backhaul_bits_per_s
    for key, arr in j_hw.tier_arrays(jt).items():
        np.testing.assert_array_equal(arr, t_hw.tier_arrays(tt)[key])
    fleet = t_hw.make_heterogeneous_fleet(9, seed=4)
    for key, arr in j_hw.fleet_arrays(
            j_hw.make_heterogeneous_fleet(9, seed=4)).items():
        np.testing.assert_array_equal(arr, t_hw.fleet_arrays(fleet)[key])
    assert (_fields(j_hw.profile_from_throughput("h", 1.5e13))
            == _fields(t_hw.profile_from_throughput("h", 1.5e13)))


@pytest.mark.parametrize("state", STATES)
def test_channel_matrix_bit_identical(state):
    jb = j_channel.draw_channel_matrix(state, 20, 100, seed=0)
    tb = t_channel.draw_channel_matrix(state, 20, 100, seed=0)
    for key in ("snr_up_db", "snr_down_db", "rate_up", "rate_down"):
        np.testing.assert_array_equal(getattr(jb, key), getattr(tb, key))


@pytest.mark.parametrize("arch", ARCHS + ("mamba2-370m", "kimi-k2-1t-a32b"))
def test_workload_flops_and_per_cut_tables(arch):
    jw = j_cm.Workload(j_get_config(arch), BATCH, SEQ)
    tw = t_cm.Workload(t_get_config(arch), BATCH, SEQ)
    assert tw.total_flops() == pytest.approx(jw.total_flops(), rel=1e-12)
    for c in range(tw.cfg.n_layers + 1):
        for name in ("device_flops", "server_flops"):
            assert getattr(tw, name)(c) == pytest.approx(
                getattr(jw, name)(c), rel=1e-12)
    sim = j_hw.DEFAULT_SIM
    jt = j_cm._per_cut_tables(jw, sim, j_cm.AnalyticCompute(jw))
    tt = t_cm._per_cut_tables(tw, t_hw.DEFAULT_SIM, t_cm.AnalyticCompute(tw))
    assert set(jt) == set(tt)
    for key in jt:
        np.testing.assert_allclose(tt[key], jt[key], rtol=1e-12, atol=0)
    mem = j_hw.fleet_arrays(j_hw.make_heterogeneous_fleet(30, seed=1))
    np.testing.assert_array_equal(
        t_cm._max_cut_per_device(tt["weight_bytes"], mem["mem_bytes"]),
        j_cm._max_cut_per_device(jt["weight_bytes"], mem["mem_bytes"]))


def _contexts(arch, state, n_dev=4, rounds=2, seed=3):
    """Matching (JAX, port) RoundContexts for every (round, device)."""
    jw = j_cm.Workload(j_get_config(arch), BATCH, SEQ)
    tw = t_cm.Workload(t_get_config(arch), BATCH, SEQ)
    jf = j_hw.make_heterogeneous_fleet(n_dev, seed=seed)
    tf = t_hw.make_heterogeneous_fleet(n_dev, seed=seed)
    jb = j_channel.draw_channel_matrix(state, rounds, n_dev, seed=seed)
    tb = t_channel.draw_channel_matrix(state, rounds, n_dev, seed=seed)
    for r in range(rounds):
        for d in range(n_dev):
            yield (j_cm.RoundContext(workload=jw, device=jf[d],
                                     server=j_hw.SERVER_RTX4060TI,
                                     channel=jb.state(r, d),
                                     sim=j_hw.DEFAULT_SIM),
                   t_cm.RoundContext(workload=tw, device=tf[d],
                                     server=t_hw.SERVER_RTX4060TI,
                                     channel=tb.state(r, d),
                                     sim=t_hw.DEFAULT_SIM))


def _same(jd, td):
    assert dataclasses.astuple(jd) == dataclasses.astuple(td)


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("arch", ARCHS)
def test_scalar_decisions_identical(arch, state):
    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    for jctx, tctx in _contexts(arch, state):
        assert tctx.corners() == jctx.corners()
        assert tctx.f_min() == jctx.f_min()
        assert tctx.max_feasible_cut() == jctx.max_feasible_cut()
        assert TC.optimal_frequency(tctx) == JC.optimal_frequency(jctx)
        _same(JC.card(jctx), TC.card(tctx))
        _same(JC.card(jctx, respect_memory=False),
              TC.card(tctx, respect_memory=False))
        _same(JC.server_only(jctx), TC.server_only(tctx))
        _same(JC.device_only(jctx), TC.device_only(tctx))
        _same(JC.static_cut(jctx, 3), TC.static_cut(tctx, 3))
        _same(JC.random_cut(jctx, rng_j), TC.random_cut(tctx, rng_t))
        # with a deadline that the nominal decision misses: the penalty
        # and the f_max rescue candidate come into play
        nominal = JC.card(jctx).delay
        for factor in (0.8, 1.5):
            kw = dict(deadline_s=factor * nominal, p_dropout=0.05,
                      p_straggler=0.2, slowdown=2.0, penalty=1.0)
            _same(JC.card(jctx, deadline=JC.DeadlineSpec(**kw)),
                  TC.card(tctx, deadline=TC.DeadlineSpec(**kw)))


@pytest.mark.parametrize("arch", ARCHS)
def test_joint_bruteforce_identical(arch):
    for jctx, tctx in _contexts(arch, "normal", n_dev=2, rounds=1):
        _same(JC.card_joint_bruteforce(jctx, n_freq=25),
              TC.card_joint_bruteforce(tctx, n_freq=25))


def _batched_pair(arch, state, n_dev=12, rounds=3, seed=7, **kw):
    sim = j_hw.DEFAULT_SIM
    jw = j_cm.Workload(j_get_config(arch), BATCH, SEQ)
    tw = t_cm.Workload(t_get_config(arch), BATCH, SEQ)
    jb = j_channel.draw_channel_matrix(state, rounds, n_dev, seed=seed)
    tb = t_channel.draw_channel_matrix(state, rounds, n_dev, seed=seed)
    jctx = j_cm.BatchedRoundContext.build(
        jw, j_hw.make_heterogeneous_fleet(n_dev, seed=seed),
        j_hw.SERVER_RTX4060TI, jb, sim, **kw)
    tctx = t_cm.BatchedRoundContext.build(
        tw, t_hw.make_heterogeneous_fleet(n_dev, seed=seed),
        t_hw.SERVER_RTX4060TI, tb, t_hw.DEFAULT_SIM, device="cpu", **kw)
    return jctx, tctx


def _assert_decisions_match(jd, td):
    assert td.cuts.dtype == torch.int32
    np.testing.assert_array_equal(td.cuts.numpy(), np.asarray(jd.cuts))
    np.testing.assert_allclose(td.freqs.numpy(), np.asarray(jd.freqs),
                               rtol=1e-5)
    np.testing.assert_allclose(td.delays.numpy(), np.asarray(jd.delays),
                               rtol=1e-4)
    np.testing.assert_allclose(td.energies.numpy(), np.asarray(jd.energies),
                               rtol=1e-4, atol=1e-6)
    for k in ("costs", "d_device", "d_uplink", "d_server", "d_downlink"):
        np.testing.assert_allclose(getattr(td, k).numpy(),
                                   np.asarray(getattr(jd, k)),
                                   rtol=1e-4, atol=1e-9)


def test_batched_context_tables_equal_the_reference():
    jctx, tctx = _batched_pair("qwen3-4b", "normal")
    for key in ("dev_flops", "srv_flops", "up_bits", "down_bits",
                "adapter_bits", "peak_flops", "max_cut", "rate_up",
                "rate_down"):
        got = getattr(tctx, key)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jctx, key)))
    assert tctx.dev_flops.dtype == torch.float32
    assert tctx.shape == tuple(jctx.shape) and tctx.n_cuts == jctx.n_cuts
    for key in ("local_epochs", "server_tp_per_hz", "server_f_max",
                "server_f_min"):
        assert getattr(tctx, key) == getattr(jctx, key)
    jc, tc = jctx.corners(), tctx.corners()
    for a, b in zip(jc, tc):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batched_card_vs_jax(arch, state):
    jctx, tctx = _batched_pair(arch, state)
    _assert_decisions_match(JC.batched_card(jctx), TC.batched_card(tctx))
    _assert_decisions_match(JC.batched_card(jctx, respect_memory=False),
                            TC.batched_card(tctx, respect_memory=False))


def test_batched_baselines_and_deadline_vs_jax():
    jctx, tctx = _batched_pair("llama32-1b", "normal")
    _assert_decisions_match(JC.batched_server_only(jctx),
                            TC.batched_server_only(tctx))
    _assert_decisions_match(JC.batched_device_only(jctx),
                            TC.batched_device_only(tctx))
    _assert_decisions_match(JC.batched_static_cut(jctx, 9),
                            TC.batched_static_cut(tctx, 9))
    cuts = np.random.default_rng(2).integers(0, tctx.n_cuts, tctx.shape)
    _assert_decisions_match(JC.batched_static_cut(jctx, cuts),
                            TC.batched_static_cut(tctx, torch.as_tensor(cuts)))
    nominal = float(np.median(np.asarray(JC.batched_card(jctx).delays)))
    kw = dict(deadline_s=nominal, p_dropout=0.05, p_straggler=0.2,
              slowdown=2.0, penalty=1.0)
    _assert_decisions_match(
        JC.batched_card(jctx, deadline=JC.DeadlineSpec(**kw)),
        TC.batched_card(tctx, deadline=TC.DeadlineSpec(**kw)))


def test_batched_joint_bruteforce_vs_jax_and_card():
    jctx, tctx = _batched_pair("qwen3-4b", "normal", n_dev=5, rounds=2)
    tg = TC.batched_card_joint_bruteforce(tctx, n_freq=40)
    _assert_decisions_match(JC.batched_card_joint_bruteforce(jctx, n_freq=40),
                            tg)
    # closed-form f* + cut argmin never loses to the (f, c) grid
    ta = TC.batched_card(tctx)
    assert torch.all(ta.costs <= tg.costs + 1e-5)
    assert torch.equal(ta.cuts, tg.cuts)


def test_batched_card_matches_scalar_card():
    """The port's batched engine (float32) against the port's scalar oracle
    (float64), decision for decision."""
    arch, n_dev, rounds, seed = "llama32-1b", 8, 3, 11
    tw = t_cm.Workload(t_get_config(arch), BATCH, SEQ)
    fleet = t_hw.make_heterogeneous_fleet(n_dev, seed=seed)
    chans = t_channel.draw_channel_matrix("normal", rounds, n_dev, seed=seed)
    bctx = t_cm.BatchedRoundContext.build(tw, fleet, t_hw.SERVER_RTX4060TI,
                                          chans, t_hw.DEFAULT_SIM,
                                          device="cpu")
    dec = TC.batched_card(bctx)
    for r in range(rounds):
        for d in range(n_dev):
            ctx = t_cm.RoundContext(workload=tw, device=fleet[d],
                                    server=t_hw.SERVER_RTX4060TI,
                                    channel=chans.state(r, d),
                                    sim=t_hw.DEFAULT_SIM)
            want = TC.card(ctx)
            assert int(dec.cuts[r, d]) == want.cut
            assert float(dec.freqs[r, d]) == pytest.approx(want.frequency,
                                                           rel=1e-5)


def test_memory_mask_for_a_1t_model():
    """Kimi-1T fits no Jetson: every decision, batched and scalar, is c=0."""
    kimi = t_get_config("kimi-k2-1t-a32b")
    sim = t_hw.SimParams(mini_batch=1, seq_len=128)
    w = t_cm.Workload(kimi, 1, 128)
    chans = t_channel.draw_channel_matrix("normal", 2, len(t_hw.EDGE_FLEET),
                                          seed=0)
    bctx = t_cm.BatchedRoundContext.build(w, t_hw.EDGE_FLEET,
                                          t_hw.SERVER_RTX4060TI, chans, sim,
                                          device="cpu")
    for m, dev in enumerate(t_hw.EDGE_FLEET):
        ctx = t_cm.RoundContext(workload=w, device=dev,
                                server=t_hw.SERVER_RTX4060TI,
                                channel=chans.state(0, m), sim=sim)
        assert int(bctx.max_cut[m]) == ctx.max_feasible_cut() == 0
    assert torch.all(TC.batched_card(bctx).cuts == 0)


def test_resolve_compute_errors():
    w = t_cm.Workload(t_get_config("llama32-1b"), BATCH, SEQ)
    with pytest.raises(ValueError):
        t_cm.resolve_compute(w, "measured")          # needs a table
    with pytest.raises(ValueError):
        t_cm.resolve_compute(w, "vibes")             # unknown source
