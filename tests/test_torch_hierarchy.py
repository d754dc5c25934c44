"""The port's hierarchical multi-server CARD (``TieredRoundContext``, the
tiered half of ``core/card``, ``simulate_hierarchical_fleet``): the cases
of ``tests/test_hierarchy.py`` on the port, and the port against the JAX
package.

Tolerances: the assignment stage is the reference's host numpy and equals
it bit for bit on one price matrix; the tiered grid runs float32 tensors on
the CPU here and is held to the JAX grid as the batched engine is (cuts
equal, frequencies rtol 1e-5, costs, delays and energies rtol 1e-4);
assignments are held equal except where the two packages' float64 mean
prices of the servers involved differ by at most ``NEAR_TIE_REL`` relative
(a near tie: the float32 grids may order them either way); hierarchical
round times agree to rtol 1e-4."""
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core import card as JC
from repro.core import channel as j_channel
from repro.core import cost_model as j_cm
from repro.core import hardware as j_hw
from repro.core import scheduler as JS
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.core import card as TC
from repro_torch.core import channel as t_channel
from repro_torch.core import cost_model as t_cm
from repro_torch.core import hardware as t_hw
from repro_torch.core import scheduler as TS
from repro_torch.launch.calibrate import NEAR_TIE_REL

torch.set_num_threads(1)

ARCHS = ("llama32-1b", "qwen3-4b", "granite-moe-3b-a800m")


def _tctx(n_devices=4, n_servers=2, rounds=3, *, capacity=None, seed=1,
          tier_seed=7, state="normal", arch="llama32-1b", hw=t_hw,
          cm=t_cm, channel=t_channel, get_config=t_get_config, **build):
    """``tests/test_hierarchy.py``'s fixture, for either package."""
    sim = hw.DEFAULT_SIM
    wl = cm.Workload(get_config(arch), sim.mini_batch, sim.seq_len)
    devices = (hw.EDGE_FLEET * 2)[:n_devices] if n_devices <= 10 \
        else hw.make_heterogeneous_fleet(n_devices, seed=seed)
    tier = hw.make_server_tier(n_servers, capacity=capacity or n_devices,
                               seed=tier_seed)
    ch = channel.draw_channel_matrix(state, rounds, len(devices), seed=seed,
                                     bandwidth_hz=sim.bandwidth_hz)
    return wl, devices, tier, ch, sim, \
        cm.TieredRoundContext.build(wl, devices, tier, ch, sim, **build)


def _pair(**kw):
    """The same tier problem as (JAX context, port context on the CPU)."""
    j = _tctx(hw=j_hw, cm=j_cm, channel=j_channel,
              get_config=j_get_config, **kw)[-1]
    t = _tctx(device="cpu", **kw)[-1]
    return j, t


def _assert_assignments_match(got, want, price):
    """Equal, except where ``price`` (S, D) says the two servers a device
    went to are a near tie."""
    for d in np.nonzero(got != want)[0]:
        a, b = price[got[d], d], price[want[d], d]
        assert abs(a - b) <= NEAR_TIE_REL * max(abs(a), abs(b)), (d, a, b)


# --- ServerTier (the port's copy of the reference's) -------------------------


def test_server_tier_validation():
    srv = t_hw.SERVER_RTX4060TI
    for kw in (dict(servers=(), capacity=(), backhaul_bits_per_s=()),
               dict(servers=(srv,), capacity=(1, 2),
                    backhaul_bits_per_s=(1e9,)),
               dict(servers=(srv,), capacity=(0,), backhaul_bits_per_s=(1e9,)),
               dict(servers=(srv,), capacity=(1,),
                    backhaul_bits_per_s=(0.0,))):
        with pytest.raises(ValueError):
            t_hw.ServerTier(**kw)


def test_make_server_tier_heterogeneous():
    tier = t_hw.make_server_tier(4, seed=0)
    assert tier.n_servers == 4 and tier.total_capacity == 4000
    assert len({s.f_max for s in tier.servers}) == 4
    arrs = t_hw.tier_arrays(tier)
    assert arrs["f_max"].shape == (4,)
    assert (arrs["backhaul_bits_per_s"] > 0).all()


# --- TieredRoundContext vs flat BatchedRoundContext --------------------------


def test_s1_tier_matches_flat_batched_context():
    """A 1-server tier is the paper's single-server problem: the tiered
    grid gives batched_card's decisions, frequencies and costs bit for bit
    (delays and energies to rtol 1e-6, as the reference holds them)."""
    sim = t_hw.DEFAULT_SIM
    wl = t_cm.Workload(t_get_config("llama32-1b"), sim.mini_batch,
                       sim.seq_len)
    devices = t_hw.EDGE_FLEET[:4]
    ch = t_channel.draw_channel_matrix("normal", 3, 4, seed=2,
                                       bandwidth_hz=sim.bandwidth_hz)
    tier = t_hw.ServerTier(servers=(t_hw.SERVER_RTX4060TI,), capacity=(4,),
                           backhaul_bits_per_s=(1e9,))
    tctx = t_cm.TieredRoundContext.build(wl, devices, tier, ch, sim,
                                         device="cpu")
    bctx = t_cm.BatchedRoundContext.build(wl, devices, t_hw.SERVER_RTX4060TI,
                                          ch, sim, device="cpu")
    h = TC.hierarchical_card(tctx)
    b = TC.batched_card(bctx)
    assert (h.assignment == 0).all()
    np.testing.assert_array_equal(h.cuts, b.cuts.numpy())
    np.testing.assert_array_equal(h.freqs, b.freqs.numpy())
    np.testing.assert_array_equal(h.costs, b.costs.numpy())
    np.testing.assert_allclose(h.delays, b.delays.numpy(), rtol=1e-6)
    np.testing.assert_allclose(h.energies, b.energies.numpy(), rtol=1e-6)
    for got, want in zip(tctx.corners(), bctx.corners()):
        np.testing.assert_array_equal(got[0].numpy(), want.numpy())


def test_tiered_grid_shape_and_masking():
    _, _, tier, _, _, tctx = _tctx(n_devices=5, n_servers=3, rounds=2,
                                   device="cpu")
    assert tctx.shape == (3, 2, 5)
    grid = TC.tiered_card_grid(tctx)
    assert grid.cuts.shape == (3, 2, 5) and grid.cuts.dtype == torch.int32
    mask = np.zeros((3, 5), bool)
    mask[0, :2] = True
    masked = tctx.mask_unassigned(grid.delays, mask).numpy()
    assert np.isnan(masked[1]).all() and np.isnan(masked[0, :, 2:]).all()
    assert np.isfinite(masked[0, :, :2]).all()
    full = tctx.cost(torch.arange(tctx.n_cuts), grid.freqs)
    assert torch.isnan(tctx.mask_unassigned(full, mask)[2]).all()


def test_aggregation_delay_counts_assigned_adapters():
    _, _, tier, _, sim, tctx = _tctx(n_devices=4, n_servers=2, rounds=2,
                                     device="cpu")
    cuts = np.full((2, 4), 3, np.int32)
    mask = np.zeros((2, 4), bool)
    mask[0] = [True, True, False, False]
    mask[1] = [False, False, True, True]
    agg = tctx.aggregation_delay(mask, cuts).numpy()
    assert agg.shape == (2, 2)
    bits = float(tctx.adapter_bits[3])
    for s in range(2):
        expect = 2 * bits / float(tctx.backhaul_bits_per_s[s])
        np.testing.assert_allclose(agg[s], expect, rtol=1e-6)


# --- assignment (host numpy, the reference's, verbatim) ----------------------


def test_assign_greedy_unconstrained_is_argmin():
    rng = np.random.default_rng(0)
    cost = rng.uniform(1, 2, size=(3, 10))
    a = TC.assign_devices(cost, np.array([10, 10, 10]), method="greedy")
    np.testing.assert_array_equal(a, cost.argmin(axis=0))


def test_assign_optimal_matches_exhaustive_random_instances():
    rng = np.random.default_rng(42)
    for trial in range(20):
        n_s, n_d = 2, int(rng.integers(2, 7))
        cost = rng.uniform(1, 5, size=(n_s, n_d))
        cap = rng.integers(1, n_d, size=n_s)
        while cap.sum() < n_d:
            cap[rng.integers(n_s)] += 1
        a = TC.assign_devices(cost, cap, method="optimal")
        e = TC.exhaustive_assignment(cost, cap)
        idx = np.arange(n_d)
        np.testing.assert_allclose(cost[a, idx].sum(), cost[e, idx].sum(),
                                   rtol=1e-12,
                                   err_msg=f"trial {trial}: {a} vs {e}")
        assert (np.bincount(a, minlength=n_s) <= cap).all()


def _outcome(call):
    """The assignment, or the message of the ValueError it raised (a
    greedy pass can strand a device whose feasible servers are full)."""
    try:
        return call()
    except ValueError as err:
        return np.asarray(str(err))


def test_assignment_methods_bit_identical_to_jax():
    """One price matrix, three methods, both packages: the same numpy."""
    rng = np.random.default_rng(7)
    for trial in range(12):
        n_s, n_d = int(rng.integers(2, 4)), int(rng.integers(3, 8))
        cost = rng.uniform(1, 5, size=(n_s, n_d))
        cost[rng.random(cost.shape) < 0.1] = np.inf     # infeasible pairs
        cost[np.argmin(cost, axis=0), np.arange(n_d)] = rng.uniform(1, 2,
                                                                    n_d)
        cap = np.full(n_s, -(-n_d // n_s) + int(rng.integers(0, 2)))
        for method in TC.ASSIGN_METHODS:
            got, want = (_outcome(lambda m=m: m.assign_devices(
                cost, cap, method=method)) for m in (TC, JC))
            np.testing.assert_array_equal(got, want)
        if np.isfinite(cost).all():
            np.testing.assert_array_equal(TC.exhaustive_assignment(cost, cap),
                                          JC.exhaustive_assignment(cost, cap))


def test_assign_capacity_respected_and_infeasible_raises():
    cost = np.ones((2, 4))
    with pytest.raises(ValueError):
        TC.assign_devices(cost, np.array([1, 1]), method="greedy")
    a = TC.assign_devices(cost, np.array([2, 2]), method="optimal")
    assert (np.bincount(a, minlength=2) <= 2).all()
    with pytest.raises(ValueError):
        TC.assign_devices(cost, np.array([2, 2]), method="nope")
    with pytest.raises(ValueError):
        TC.assign_devices(cost, np.array([2, 2, 2]))


# --- the tiered grid and hierarchical_card against the JAX package -----------


def _assert_grid_matches(tg, jg):
    np.testing.assert_array_equal(tg.cuts.numpy(), np.asarray(jg.cuts))
    np.testing.assert_allclose(tg.freqs.numpy(), np.asarray(jg.freqs),
                               rtol=1e-5)
    for k in ("costs", "delays", "energies", "d_server"):
        np.testing.assert_allclose(getattr(tg, k).numpy(),
                                   np.asarray(getattr(jg, k)),
                                   rtol=1e-4, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_tiered_context_and_grid_vs_jax(arch):
    jctx, tctx = _pair(n_devices=12, n_servers=3, rounds=3, arch=arch,
                       state="poor")
    for key in ("dev_flops", "srv_flops", "up_bits", "down_bits",
                "adapter_bits", "peak_flops", "max_cut", "rate_up",
                "rate_down", "server_tp_per_hz", "server_f_max",
                "server_f_min", "backhaul_bits_per_s"):
        np.testing.assert_array_equal(getattr(tctx, key).numpy(),
                                      np.asarray(getattr(jctx, key)), key)
    assert tctx.shape == tuple(jctx.shape)
    assert tctx.capacity == jctx.capacity
    np.testing.assert_allclose(tctx.f_min().numpy(), np.asarray(jctx.f_min()),
                               rtol=1e-6)
    for a, b in zip(tctx.corners(), jctx.corners()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for respect_memory in (True, False):
        _assert_grid_matches(
            TC.tiered_card_grid(tctx, respect_memory=respect_memory),
            JC.tiered_card_grid(jctx, respect_memory=respect_memory))


@pytest.mark.parametrize("assign", TC.ASSIGN_METHODS)
def test_hierarchical_card_vs_jax(assign):
    jctx, tctx = _pair(n_devices=30, n_servers=3, capacity=12, rounds=3)
    jd = JC.hierarchical_card(jctx, assign=assign)
    td = TC.hierarchical_card(tctx, assign=assign)
    price = np.asarray(JC.tiered_card_grid(jctx).costs,
                       np.float64).mean(axis=1)
    _assert_assignments_match(td.assignment, jd.assignment, price)
    same = td.assignment == jd.assignment
    np.testing.assert_array_equal(td.cuts[:, same], np.asarray(jd.cuts)[:, same])
    np.testing.assert_allclose(td.freqs[:, same],
                               np.asarray(jd.freqs)[:, same], rtol=1e-5)
    np.testing.assert_allclose(td.delays[:, same],
                               np.asarray(jd.delays)[:, same], rtol=1e-4)
    np.testing.assert_array_equal(td.server_load, np.asarray(jd.server_load))
    np.testing.assert_allclose(td.aggregation_s, np.asarray(jd.aggregation_s),
                               rtol=1e-5)


def test_hierarchical_scalar_oracle_bit_identical_to_jax():
    wl, devices, tier, ch, sim, _ = _tctx(n_devices=5, n_servers=2,
                                          capacity=3, rounds=2, device="cpu")
    jwl, jdev, jtier, jch, jsim, _ = _tctx(
        n_devices=5, n_servers=2, capacity=3, rounds=2, hw=j_hw, cm=j_cm,
        channel=j_channel, get_config=j_get_config)
    got = TC.hierarchical_card_scalar(wl, devices, tier, ch, sim)
    want = JC.hierarchical_card_scalar(jwl, jdev, jtier, jch, jsim)
    for field in TC.HierarchicalDecision._fields:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), field)


# --- hierarchical_card on the port ------------------------------------------


def test_hierarchical_matches_exhaustive_small_fleets():
    """Decisions match exhaustive assignment enumeration on fleets <= 8
    devices x 2 servers."""
    for n_d, cap, seed in ((4, 3, 7), (6, 4, 11), (8, 5, 3)):
        _, _, tier, _, _, tctx = _tctx(n_devices=n_d, n_servers=2,
                                       capacity=cap, tier_seed=seed,
                                       device="cpu")
        h = TC.hierarchical_card(tctx, assign="optimal")
        e = TC.hierarchical_card_exhaustive(tctx)
        for field in ("assignment", "cuts", "freqs", "aggregation_s"):
            np.testing.assert_array_equal(getattr(h, field),
                                          getattr(e, field))


def test_hierarchical_scalar_vs_batched_equivalence():
    """The float64 scalar loop (RoundContext + card per cell) and the
    float32 (S, R, D, C) grid agree on every decision."""
    wl, devices, tier, ch, sim, tctx = _tctx(n_devices=5, n_servers=2,
                                             capacity=3, rounds=3,
                                             device="cpu")
    hb = TC.hierarchical_card(tctx, assign="optimal")
    hs = TC.hierarchical_card_scalar(wl, devices, tier, ch, sim,
                                     assign="optimal")
    np.testing.assert_array_equal(hb.assignment, hs.assignment)
    np.testing.assert_array_equal(hb.cuts, hs.cuts)
    np.testing.assert_allclose(hb.freqs, hs.freqs, rtol=1e-5)
    np.testing.assert_allclose(hb.delays, hs.delays, rtol=1e-5)
    np.testing.assert_allclose(hb.energies, hs.energies, rtol=1e-4)
    np.testing.assert_allclose(hb.aggregation_s, hs.aggregation_s, rtol=1e-5)


def test_greedy_equals_optimal_with_slack_capacity():
    _, _, _, _, _, tctx = _tctx(n_devices=6, n_servers=3, capacity=6,
                                device="cpu")
    g = TC.hierarchical_card(tctx, assign="greedy")
    o = TC.hierarchical_card(tctx, assign="optimal")
    np.testing.assert_array_equal(g.assignment, o.assignment)


def test_capacity_binds_load():
    _, _, tier, _, _, tctx = _tctx(n_devices=6, n_servers=2, capacity=3,
                                   device="cpu")
    h = TC.hierarchical_card(tctx, assign="optimal")
    assert (h.server_load <= 3).all() and h.server_load.sum() == 6


# --- simulate_hierarchical_fleet --------------------------------------------


def test_simulate_hierarchical_fleet_round_times():
    cfg = t_get_config("llama32-1b")
    fleet = t_hw.make_heterogeneous_fleet(12, seed=3)
    tier = t_hw.make_server_tier(3, capacity=6, seed=2)
    log = TS.simulate_hierarchical_fleet(cfg, tier=tier, rounds=4,
                                         devices=fleet, seed=5, device="cpu")
    assert log.round_s.shape == (4,)
    assert log.server_round_s.shape == (3, 4)
    np.testing.assert_allclose(log.round_s, log.server_round_s.max(axis=0))
    assert np.isfinite(log.mean_round_s())
    assert log.decision.server_load.sum() == 12
    tier1 = t_hw.make_server_tier(1, capacity=12, seed=2)
    log1 = TS.simulate_hierarchical_fleet(cfg, tier=tier1, rounds=4,
                                          devices=fleet, seed=5, device="cpu")
    assert log.mean_round_s() <= log1.mean_round_s() * 1.05


@pytest.mark.parametrize("n_servers,n_devices", [(1, 20), (2, 40), (4, 100)])
def test_simulate_hierarchical_fleet_vs_jax(n_servers, n_devices):
    fleet_kw = dict(rounds=3, seed=5, channel_state="normal")
    jlog = JS.simulate_hierarchical_fleet(
        j_get_config("llama32-1b"),
        tier=j_hw.make_server_tier(n_servers, capacity=-(-n_devices // n_servers),
                                   seed=n_servers),
        devices=j_hw.make_heterogeneous_fleet(n_devices, seed=1), **fleet_kw)
    tlog = TS.simulate_hierarchical_fleet(
        t_get_config("llama32-1b"),
        tier=t_hw.make_server_tier(n_servers, capacity=-(-n_devices // n_servers),
                                   seed=n_servers),
        devices=t_hw.make_heterogeneous_fleet(n_devices, seed=1),
        device="cpu", **fleet_kw)
    np.testing.assert_array_equal(tlog.decision.assignment,
                                  jlog.decision.assignment)
    np.testing.assert_allclose(tlog.round_s, jlog.round_s, rtol=1e-4)
    np.testing.assert_allclose(tlog.server_round_s, jlog.server_round_s,
                               rtol=1e-4)
    assert tlog.mean_delay() == pytest.approx(jlog.mean_delay(), rel=1e-4)
    assert tlog.mean_energy() == pytest.approx(jlog.mean_energy(), rel=1e-4)
