"""The port's fleet simulator (``core/scheduler``, ``launch/mesh``) and its
drivers against the JAX package's ``core/scheduler``.

Tolerances: the scalar engine runs the reference's float64 Python
arithmetic over bit-identical channel streams, so its log equals the JAX
scalar engine's bit for bit; the vectorized engine runs float32 tensors on
the CPU here and is held to the JAX vectorized engine and to the port's own
scalar engine with the tolerances of ``tests/test_fleet_engine.py`` (cuts
equal, frequencies rtol 1e-5, delays and energies rtol 1e-4); a sharded
run equals the unsharded one bit for bit (no lane reads another); the
fault overlay is host numpy and equals the reference's bit for bit on the
same log; reductions over the two packages' vectorized logs agree to rtol
1e-5."""
import json

import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core import faults as j_faults
from repro.core import scheduler as JS
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.core import card as TC
from repro_torch.core import faults as t_faults
from repro_torch.core import hardware as t_hw
from repro_torch.core import measured_cost as t_mc
from repro_torch.core import scheduler as TS
from repro_torch.core.channel import draw_channel_matrix
from repro_torch.core.cost_model import BatchedRoundContext, Workload
from repro_torch.launch import calibrate
from repro_torch.launch.mesh import FleetMesh, make_fleet_mesh

torch.set_num_threads(1)

ARCHS = ("llama32-1b", "qwen3-4b", "granite-moe-3b-a800m")
STATES = ("good", "normal", "poor")
POLICIES = ("card", "server_only", "device_only", "static", "random")
FIELDS = TS.LOG_FIELDS
HEAVY = dict(dropout_prob=0.2, straggler_prob=0.3, outage_prob=0.1,
             leave_prob=0.05)


def _kw(policy):
    return dict(policy=policy, static_cut=9 if policy == "static" else None)


def _assert_logs_match(a, b):
    """The tolerances of ``tests/test_fleet_engine.py``."""
    assert np.array_equal(a.cuts, b.cuts)
    np.testing.assert_allclose(a.freqs, b.freqs, rtol=1e-5)
    np.testing.assert_allclose(a.delays, b.delays, rtol=1e-4)
    np.testing.assert_allclose(a.energies, b.energies, rtol=1e-4, atol=1e-6)
    for k in ("d_device", "d_uplink", "d_server", "d_downlink"):
        np.testing.assert_allclose(getattr(a, k), getattr(b, k), rtol=1e-4,
                                   atol=1e-9)


def _assert_identical(a, b, fields=FIELDS):
    for f in fields:
        got, want = getattr(a, f), getattr(b, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f"field {f}")


# ---------------------------------------------------------------------------
# the scalar engine: bit-identical to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES + ("card+faults",))
def test_scalar_engine_bit_identical_to_jax(policy):
    kw, jkw, tkw = dict(rounds=4, seed=7, engine="scalar"), {}, {}
    if policy == "card+faults":
        policy = "card"
        deadline = dict(quantile=0.9, objective_deadline_s=5.0)
        jkw = dict(fault_model=j_faults.FaultModel(**HEAVY),
                   deadline=j_faults.DeadlinePolicy(**deadline))
        tkw = dict(fault_model=t_faults.FaultModel(**HEAVY),
                   deadline=t_faults.DeadlinePolicy(**deadline))
    a = JS.simulate_fleet(j_get_config("llama32-1b"), **_kw(policy), **kw,
                          **jkw)
    b = TS.simulate_fleet(t_get_config("llama32-1b"), **_kw(policy), **kw,
                          device="cpu", **tkw)
    _assert_identical(a, b)
    assert a.device_names == b.device_names
    if jkw:
        np.testing.assert_array_equal(a.participation, b.participation)
        np.testing.assert_array_equal(a.round_close_s, b.round_close_s)


# ---------------------------------------------------------------------------
# the vectorized engine against the reference's and the port's scalar one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("arch", ARCHS)
def test_vectorized_engine_vs_jax_every_policy(arch, state):
    for policy in POLICIES:
        kw = dict(channel_state=state, rounds=4, seed=7, **_kw(policy))
        a = JS.simulate_fleet(j_get_config(arch), **kw)
        b = TS.simulate_fleet(t_get_config(arch), device="cpu", **kw)
        assert b.cuts.dtype == np.int32 and b.freqs.dtype == np.float64
        _assert_logs_match(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_scalar_matches_port_vectorized(arch):
    cfg = t_get_config(arch)
    for policy in POLICIES:
        kw = dict(rounds=3, seed=11, device="cpu", **_kw(policy))
        _assert_logs_match(TS.simulate_fleet(cfg, engine="scalar", **kw),
                           TS.simulate_fleet(cfg, **kw))


@pytest.mark.parametrize("n_devices,seed,state", [
    (2, 0, "good"), (9, 41, "normal"), (17, 303, "poor"), (24, 999, "normal")])
def test_port_engines_agree_on_heterogeneous_fleets(n_devices, seed, state):
    """Fixed draws of the reference's derandomized property test."""
    cfg = t_get_config("llama32-1b")
    fleet = t_hw.make_heterogeneous_fleet(n_devices, seed=seed)
    kw = dict(channel_state=state, rounds=3, seed=seed, devices=fleet,
              device="cpu")
    _assert_logs_match(TS.simulate_fleet(cfg, engine="scalar", **kw),
                       TS.simulate_fleet(cfg, **kw))


def test_engines_decision_identical_under_faults():
    cfg = t_get_config("llama32-1b")
    kw = dict(rounds=5, seed=11, device="cpu",
              fault_model=t_faults.FaultModel(**HEAVY),
              deadline=t_faults.DeadlinePolicy(quantile=0.9,
                                               objective_deadline_s=5.0))
    a = TS.simulate_fleet(cfg, engine="scalar", **kw)
    b = TS.simulate_fleet(cfg, engine="vectorized", **kw)
    assert np.array_equal(a.cuts, b.cuts)
    np.testing.assert_allclose(a.freqs, b.freqs, rtol=1e-5)
    assert np.array_equal(a.participation, b.participation)
    np.testing.assert_allclose(a.delays, b.delays, rtol=1e-4)


def test_vectorized_engine_makes_one_host_copy(monkeypatch):
    """The decisions come back in one device->host copy, not eight."""
    copies = []
    real = torch.Tensor.cpu

    def counting_cpu(self, *a, **k):
        copies.append(tuple(self.shape))
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    TS.simulate_fleet(t_get_config("llama32-1b"), rounds=3, device="cpu")
    assert copies == [(len(FIELDS), 3, TS.LANE_BLOCK)]


# ---------------------------------------------------------------------------
# the sharded path: bit-identical to the unsharded engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_sharded_bit_identical_to_unsharded(n_shards):
    cfg = t_get_config("llama32-1b")
    mesh = make_fleet_mesh(n_shards, device="cpu")
    assert mesh.n_shards == n_shards
    for n_devices, policies in ((1000, ("card", "random")),
                                (10, POLICIES)):     # ragged: pad lanes
        fleet = t_hw.make_heterogeneous_fleet(n_devices, seed=3)
        for policy in policies:
            kw = dict(rounds=2, devices=fleet, seed=5, device="cpu",
                      **_kw(policy))
            a = TS.simulate_fleet(cfg, **kw)
            b = TS.simulate_fleet(cfg, mesh=mesh, **kw)
            assert b.delays.shape == (2, n_devices)
            assert np.isfinite(b.delays).all()
            _assert_identical(a, b)


def test_sharded_with_a_deadline_and_measured_tables():
    cfg = t_get_config("qwen3-4b")
    fit = t_mc.RooflineFit(inv_compute=2e-13, inv_bandwidth=1e-12,
                           overhead_s=3e-5, achieved_flops_per_s=5e12,
                           rel_residual=0.0, n_probes=8, backend="cuda")
    table = t_mc.LatencyTable.from_fit(cfg, fit, batch=4, seq_len=512)
    fleet = t_hw.make_heterogeneous_fleet(70, seed=8)
    kw = dict(rounds=3, devices=fleet, seed=2, device="cpu",
              cost_source="measured", latency_table=table,
              fault_model=t_faults.FaultModel(straggler_prob=0.3),
              deadline=t_faults.DeadlinePolicy(quantile=0.8,
                                               objective_deadline_s=20.0))
    a = TS.simulate_fleet(cfg, **kw)
    b = TS.simulate_fleet(cfg, mesh=make_fleet_mesh(3, device="cpu"), **kw)
    _assert_identical(a, b)
    np.testing.assert_array_equal(a.participation, b.participation)


def test_fleet_decisions_on_one_context_any_chunking():
    """The path the chip check times: one built context, chunked or not."""
    cfg = t_get_config("llama32-1b")
    fleet = t_hw.make_heterogeneous_fleet(130, seed=1)
    bctx = TS.fleet_context(cfg, channel_state="poor", rounds=2,
                            devices=fleet, server=t_hw.SERVER_RTX4060TI,
                            sim=t_hw.DEFAULT_SIM, seed=4, device="cpu")
    want = TS.fleet_decisions(bctx)
    # batched_card on the unpadded lanes: its last partial SIMD block may
    # round the cube root one ulp apart on the CPU (scheduler.LANE_BLOCK)
    dec = TC.batched_card(bctx)
    np.testing.assert_array_equal(want["cuts"], dec.cuts.numpy())
    np.testing.assert_allclose(want["freqs"], dec.freqs.numpy(), rtol=1e-6)
    for n in (2, 5, 7):
        got = TS.fleet_decisions(bctx, mesh=make_fleet_mesh(n, device="cpu"))
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_make_fleet_mesh_and_engine_errors():
    mesh = make_fleet_mesh(device="cpu")      # one shard per visible card
    assert mesh == FleetMesh(1, (torch.device("cpu"),))
    assert make_fleet_mesh(3, device="cpu").devices == (
        torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        FleetMesh(2, (torch.device("cpu"),))
    cfg = t_get_config("llama32-1b")
    with pytest.raises(ValueError, match="mesh= requires"):
        TS.simulate_fleet(cfg, rounds=1, engine="scalar", mesh=mesh,
                          device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        TS.simulate_fleet(cfg, rounds=1, engine="jit", device="cpu")
    with pytest.raises(ValueError, match="unknown policy"):
        TS.simulate_fleet(cfg, rounds=1, policy="oracle", device="cpu")


# ---------------------------------------------------------------------------
# the fault overlay
# ---------------------------------------------------------------------------


def test_fault_free_log_bit_identical():
    """fault_model=None and the zero-probability model give the same bits."""
    cfg = t_get_config("llama32-1b")
    for engine in ("vectorized", "scalar"):
        base = TS.simulate_fleet(cfg, rounds=6, seed=7, engine=engine,
                                 device="cpu")
        degenerate = TS.simulate_fleet(
            cfg, rounds=6, seed=7, engine=engine, device="cpu",
            fault_model=t_faults.FaultModel(),
            deadline=t_faults.DeadlinePolicy(quantile=1.0))
        _assert_identical(base, degenerate)
        assert degenerate.participation.all()
        assert degenerate.survivor_fraction() == 1.0


@pytest.mark.parametrize("deadline", [None, 0.8])
def test_fault_overlay_equals_the_reference_on_one_log(deadline):
    log = TS.simulate_fleet(t_get_config("llama32-1b"), rounds=10, seed=5,
                            devices=t_hw.make_heterogeneous_fleet(40, seed=2),
                            device="cpu")
    jlog = JS.FleetLog(**{f: getattr(log, f) for f in (
        "policy", "channel_state", "rounds", "device_names") + FIELDS})
    fm = dict(HEAVY, slowdown_min=3.0, slowdown_max=5.0)
    tr = t_faults.FaultModel(**fm).realize(10, 40, seed=5)
    jr = j_faults.FaultModel(**fm).realize(10, 40, seed=5)
    got = TS.apply_faults(log, tr, None if deadline is None
                          else t_faults.DeadlinePolicy(quantile=deadline))
    want = JS.apply_faults(jlog, jr, None if deadline is None
                           else j_faults.DeadlinePolicy(quantile=deadline))
    _assert_identical(got, want, FIELDS + ("participation", "round_close_s"))
    assert 0.0 < got.survivor_fraction() < 1.0
    assert got.mean_delay() == want.mean_delay()
    with pytest.raises(ValueError, match="realization shape"):
        TS.apply_faults(log, t_faults.FaultModel().realize(3, 40, seed=0))


def test_straggler_overlay_and_masked_reductions():
    cfg = t_get_config("llama32-1b")
    fm = t_faults.FaultModel(straggler_prob=0.4, slowdown_min=3.0,
                             slowdown_max=5.0)
    log = TS.simulate_fleet(cfg, rounds=10, seed=5, fault_model=fm,
                            deadline=t_faults.DeadlinePolicy(quantile=0.8),
                            device="cpu")
    assert 0.0 < log.survivor_fraction() < 1.0
    assert np.isnan(log.delays[~log.participation]).all()
    assert np.isfinite(log.round_close_s).all()
    assert all(np.isfinite(v) for v in TS.parallel_round_stats(log).values())
    clean = TS.simulate_fleet(cfg, rounds=4, seed=1, device="cpu")
    mean = clean.mean_delay()
    clean.delays[0, 0] = np.nan
    assert np.isfinite(clean.mean_delay()) and clean.mean_delay() != mean


# ---------------------------------------------------------------------------
# reductions, Fig. 4, scale
# ---------------------------------------------------------------------------


def test_parallel_round_stats_and_compare_policies_vs_jax():
    jgrid = JS.compare_policies(j_get_config("llama32-1b"), rounds=6, seed=3)
    tgrid = TS.compare_policies(t_get_config("llama32-1b"), rounds=6, seed=3,
                                device="cpu")
    from repro_torch.launch.fig4_comparison import reductions
    for policy, by_state in jgrid.items():
        for state, jlog in by_state.items():
            tlog = tgrid[policy][state]
            assert tlog.mean_delay() == pytest.approx(jlog.mean_delay(),
                                                      rel=1e-5)
            assert tlog.mean_energy() == pytest.approx(jlog.mean_energy(),
                                                       rel=1e-5)
            js, ts = (JS.parallel_round_stats(jlog),
                      TS.parallel_round_stats(tlog))
            assert set(js) == set(ts)
            for k in js:
                assert ts[k] == pytest.approx(js[k], rel=1e-5), (policy, k)
            assert (ts["parallel_lower_s"] - 1e-9 <= ts["parallel_exact_s"]
                    <= ts["parallel_upper_s"] + 1e-9)
    jred, tred = (reductions(g, STATES) for g in (jgrid, tgrid))
    for key in ("avg_delay_reduction", "avg_energy_reduction"):
        assert tred[key] == pytest.approx(jred[key], rel=1e-5)


def test_thousand_device_round_end_to_end():
    fleet = t_hw.make_heterogeneous_fleet(1000, seed=0)
    log = TS.simulate_fleet(t_get_config("llama32-1b"), rounds=1,
                            devices=fleet, seed=0, device="cpu")
    assert log.cuts.shape == (1, 1000)
    assert np.isfinite(log.delays).all() and (log.delays > 0).all()
    np.testing.assert_allclose(log.d_device + log.d_uplink + log.d_server
                               + log.d_downlink, log.delays, rtol=1e-6)
    stats = TS.parallel_round_stats(log)
    assert stats["parallel_exact_s"] >= stats["parallel_lower_s"] - 1e-9


# ---------------------------------------------------------------------------
# calibrate's decision_divergence, now through simulate_fleet
# ---------------------------------------------------------------------------


def _old_decision_divergence(tables, archs, states, n_devices, rounds, seed):
    """The pre-scheduler ``decision_divergence``: the fleet, the channels
    and the batched context built by hand, reductions in float32."""
    cells, moved_total, n_total = [], 0, 0
    fleet = t_hw.make_heterogeneous_fleet(n_devices, seed=seed)
    sim = t_hw.DEFAULT_SIM
    for arch in archs:
        workload = Workload(t_get_config(arch), 4, 512)
        for state in states:
            chans = draw_channel_matrix(
                state, rounds, n_devices, seed=seed,
                bandwidth_hz=sim.bandwidth_hz,
                tx_power_dbm_up=sim.tx_power_dbm_up,
                tx_power_dbm_down=sim.tx_power_dbm_down,
                noise_dbm_per_hz=sim.noise_dbm_per_hz)
            a, m = (TC.batched_card(BatchedRoundContext.build(
                workload, fleet, t_hw.SERVER_RTX4060TI, chans, sim,
                device="cpu", **({} if t is None else dict(
                    cost_source="measured", latency_table=t))))
                for t in (None, tables[arch]))
            moved = a.cuts != m.cuts
            moved_total += int(moved.sum())
            n_total += moved.numel()
            cells.append({
                "arch": arch, "channel_state": state,
                "frac_decisions_moved": float(moved.float().mean()),
                "mean_cut_analytic": float(a.cuts.float().mean()),
                "mean_cut_measured": float(m.cuts.float().mean()),
                "mean_freq_shift_ghz": float((m.freqs - a.freqs).mean()
                                             / 1e9),
                "mean_delay_ratio": float(m.delays.mean()
                                          / a.delays.mean().clamp(min=1e-30)),
            })
    return cells, moved_total / n_total


def test_decision_divergence_through_simulate_fleet_equals_the_old_path():
    """Same cells as the hand-built path at 20 devices: the moved fractions
    exactly, the means to float32 resolution (the old path reduced in
    float32, the new one reduces the float32 decisions in float64). The
    fit has the shape of the H100's (no compute slope, a bandwidth and an
    overhead), so that the measured tables move some decisions."""
    fit = t_mc.RooflineFit(inv_compute=0.0, inv_bandwidth=1 / 65e9,
                           overhead_s=2e-5, achieved_flops_per_s=2e12,
                           rel_residual=0.0, n_probes=8, backend="cuda")
    archs = ("llama32-1b", "qwen3-4b", "granite-moe-3b-a800m", "mamba2-370m")
    tables = t_mc.build_latency_tables(fit, batch=4, seq_len=512,
                                       archs=archs)
    new = calibrate.decision_divergence(tables, archs=archs, n_devices=20,
                                        rounds=5, seed=3, device="cpu")
    old_cells, old_overall = _old_decision_divergence(
        tables, archs, STATES, 20, 5, 3)
    assert new["frac_decisions_moved_overall"] == old_overall > 0
    assert len(new["cells"]) == len(old_cells) == 12
    for got, want in zip(new["cells"], old_cells):
        assert set(got) == set(want)
        for key, value in want.items():
            if key == "mean_freq_shift_ghz":
                assert got[key] == pytest.approx(value, rel=1e-5, abs=1e-6)
            elif isinstance(value, float):
                assert got[key] == pytest.approx(value, rel=1e-6), key
            else:
                assert got[key] == value


# ---------------------------------------------------------------------------
# the drivers, on the CPU at tiny sizes
# ---------------------------------------------------------------------------


def test_fig4_twin_matches_the_reference_grid():
    from benchmarks import fig4_comparison as j_fig4
    from repro_torch.launch import fig4_comparison as t_fig4
    jres = j_fig4.run(rounds=3)
    tres = t_fig4.run(rounds=3, device="cpu")
    scal = t_fig4.run(rounds=3, engine="scalar", device="cpu")
    assert tres["device"] == "cpu" and tres["devices"] == 5
    for key in ("avg_delay_reduction", "avg_energy_reduction"):
        assert tres[key] == pytest.approx(jres[key], rel=1e-5)
        assert abs(tres[key] - scal[key]) <= 1e-4
    assert tres["paper_claims"] == jres["paper_claims"]


def test_fig3_twin_and_divergence_on_tables():
    from repro_torch.launch import fig3_decisions as t_fig3
    res = t_fig3.run(rounds=4, device="cpu")
    assert res["bimodal"] in (True, False) and len(res["cuts"]) == 5
    tables = {a: t_mc.LatencyTable.from_analytic(
        Workload(t_get_config(a), 4, 512)) for a in ("llama32-1b",)}
    div = t_fig3.run_divergence(rounds=2, archs=("llama32-1b",),
                                channel_states=("normal",), tables=tables,
                                device="cpu")
    assert div["table_source"] == "tables" and div["fit"] is None
    # a table synthesized from the analytic model moves no decision
    assert div["frac_decisions_moved_overall"] == 0.0


def test_bench_twins_smoke_on_the_cpu(tmp_path):
    from repro_torch.launch import (churn_bench, fleet_scale_bench,
                                    hierarchy_bench)
    fs = fleet_scale_bench.run(sizes=(3,), big=20, rounds=1, big_rounds=1,
                               device="cpu")
    assert fs["device"] == "cpu" and fs["big_fleet"]["devices"] == 20
    hb = hierarchy_bench.run(fleet_sizes=(12,), tier_sizes=(1, 2), rounds=2,
                             device="cpu")
    assert [r["servers"] for r in hb["sweep"]] == [1, 2]
    cb = churn_bench.run(devices=30, rounds=2, dropout_rates=(0.0, 0.4),
                         device="cpu")
    assert cb["sweep"][0]["dropout_rate"] == 0.0
    assert "worst_case_realization" in cb
    out = tmp_path / "churn.json"
    churn_bench.main(["--smoke", "--device", "cpu", "--json", str(out)])
    payload = json.loads(out.read_text())
    assert payload["mode"] == "smoke" and payload["device"] == "cpu"
    assert "worst_case_realization" not in payload


def test_fleet_sweep_and_quickstart_twins_run(capsys):
    from repro_torch.launch import fleet_sweep, quickstart
    fleet_sweep.main(["--smoke", "--device", "cpu"])
    assert "fleet of 100 devices" in capsys.readouterr().out
    res = quickstart.run(pretrain_steps=1, rounds=1, device="cpu")
    assert res["decision"].cut in range(0, 17)
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()

