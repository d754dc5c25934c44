"""The port's measured cost model (``core/measured_cost``) and calibration
entry point (``launch/calibrate``) against the JAX package's
``core/measured_cost``.

The fit and the tables are numpy/Python float arithmetic and must equal the
reference's to rel 1e-12; a table synthesized from the analytic model must
reproduce the analytic ``batched_card`` decisions exactly; the probe ladder
must have the reference's shapes and roofline coordinates. Seconds are not
compared: on the CPU the probes time the plain versions."""
import json

import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core import cost_model as j_cm
from repro.core import measured_cost as j_mc
from repro_torch.configs.base import ARCH_IDS
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.core import card as TC
from repro_torch.core import channel as t_channel
from repro_torch.core import cost_model as t_cm
from repro_torch.core import hardware as t_hw
from repro_torch.core import measured_cost as t_mc
from repro_torch.launch import calibrate

torch.set_num_threads(1)

ARCHS = ("llama32-1b", "qwen3-4b", "granite-moe-3b-a800m")
STATES = ("good", "normal", "poor")
BATCH, SEQ = 4, 512

SHAPES = [(1e6, 1e5), (1e7, 1e6), (1e8, 1e7), (1e9, 5e7),
          (5e9, 1e8), (2e10, 4e8), (1e6, 1e8), (1e7, 5e8)]


def _probes(mod, t0, inv_c, inv_b, noise=0.0):
    rng = np.random.default_rng(0)
    return [mod.ProbeResult(kernel="synthetic", backend="cuda", shape=f"p{i}",
                            flops=f, hbm_bytes=by,
                            seconds=(t0 + f * inv_c + by * inv_b)
                            * (1.0 + noise * rng.standard_normal()))
            for i, (f, by) in enumerate(SHAPES)]


def _approx_dict(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, float):
            assert got[key] == pytest.approx(value, rel=1e-12), key
        elif isinstance(value, list):
            np.testing.assert_allclose(got[key], value, rtol=1e-12, atol=0)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("model", [
    (2e-4, 1e-11, 5e-12, 0.0),      # a known roofline, recovered
    (1e-4, 1e-11, 0.0, 0.0),        # compute only: NNLS clips bandwidth
    (0.0, 0.0, 1e-11, 0.0),         # bandwidth only: achieved-rate currency
    (3e-5, 2e-13, 1e-12, 0.1),      # noisy
])
def test_fit_roofline_equals_the_reference(model):
    *coef, noise = model
    tf = t_mc.fit_roofline(_probes(t_mc, *coef, noise))
    jf = j_mc.fit_roofline(_probes(j_mc, *coef, noise))
    _approx_dict(tf.to_dict(), jf.to_dict())
    assert t_mc.RooflineFit.from_dict(tf.to_dict()) == tf
    assert tf.predict(1e9, 1e7) == pytest.approx(jf.predict(1e9, 1e7),
                                                 rel=1e-12)


def test_fit_requires_probes():
    with pytest.raises(ValueError):
        t_mc.fit_roofline([])


def _fit_pair():
    d = j_mc.fit_roofline(_probes(j_mc, 3e-5, 2e-13, 1e-12, 0.1)).to_dict()
    return j_mc.RooflineFit.from_dict(d), t_mc.RooflineFit.from_dict(d)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_latency_tables_equal_the_reference(arch):
    jfit, tfit = _fit_pair()
    jt = j_mc.LatencyTable.from_fit(j_get_config(arch), jfit, batch=BATCH,
                                    seq_len=SEQ)
    tt = t_mc.LatencyTable.from_fit(t_get_config(arch), tfit, batch=BATCH,
                                    seq_len=SEQ)
    _approx_dict(tt.to_dict(), jt.to_dict())
    assert t_mc.LatencyTable.from_dict(tt.to_dict()) == tt
    jw = j_cm.Workload(j_get_config(arch), BATCH, SEQ)
    tw = t_cm.Workload(t_get_config(arch), BATCH, SEQ)
    _approx_dict(t_mc.LatencyTable.from_analytic(tw).to_dict(),
                 j_mc.LatencyTable.from_analytic(jw).to_dict())
    cfg = t_get_config(arch)
    for fn in ("layer_hbm_bytes", "embed_hbm_bytes", "head_hbm_bytes"):
        assert getattr(t_mc, fn)(cfg, 2048) == getattr(j_mc, fn)(
            j_get_config(arch), 2048)


@pytest.mark.parametrize("arch", ARCHS)
def test_table_compute_equals_the_reference(arch):
    jfit, tfit = _fit_pair()
    jw = j_cm.Workload(j_get_config(arch), BATCH, SEQ)
    tw = t_cm.Workload(t_get_config(arch), BATCH, SEQ)
    jtc = j_mc.TableCompute(workload=jw, table=j_mc.LatencyTable.from_fit(
        jw.cfg, jfit, batch=BATCH, seq_len=SEQ))
    ttc = t_cm.resolve_compute(tw, "measured", t_mc.LatencyTable.from_fit(
        tw.cfg, tfit, batch=BATCH, seq_len=SEQ))
    assert isinstance(ttc, t_mc.TableCompute)
    assert ttc.total_flops() == pytest.approx(jtc.total_flops(), rel=1e-12)
    for c in range(tw.cfg.n_layers + 1):
        assert ttc.device_flops(c) == pytest.approx(jtc.device_flops(c),
                                                    rel=1e-12)
        assert ttc.server_flops(c) == pytest.approx(jtc.server_flops(c),
                                                    rel=1e-12)
    # an analytic table reproduces the Workload accounting
    atc = t_cm.resolve_compute(tw, "measured",
                               t_mc.LatencyTable.from_analytic(tw))
    for c in (0, tw.cfg.n_layers):
        assert atc.device_flops(c) == pytest.approx(tw.device_flops(c),
                                                    rel=1e-12)
    with pytest.raises(ValueError):               # wrong architecture
        t_mc.TableCompute(workload=tw, table=t_mc.LatencyTable.from_analytic(
            t_cm.Workload(t_get_config("mamba2-370m"), BATCH, SEQ)))


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("arch", ARCHS)
def test_measured_with_analytic_table_reproduces_analytic(arch, state):
    """batched_card on an analytic-synthesized table == pure analytic."""
    tw = t_cm.Workload(t_get_config(arch), BATCH, SEQ)
    fleet = t_hw.make_heterogeneous_fleet(10, seed=3)
    chans = t_channel.draw_channel_matrix(state, 5, 10, seed=3)
    args = (tw, fleet, t_hw.SERVER_RTX4060TI, chans, t_hw.DEFAULT_SIM)
    a = TC.batched_card(t_cm.BatchedRoundContext.build(*args, device="cpu"),
                        respect_memory=False)
    m = TC.batched_card(t_cm.BatchedRoundContext.build(
        *args, cost_source="measured",
        latency_table=t_mc.LatencyTable.from_analytic(tw), device="cpu"),
        respect_memory=False)
    assert torch.equal(a.cuts, m.cuts)
    np.testing.assert_allclose(m.freqs.numpy(), a.freqs.numpy(), rtol=1e-5)
    np.testing.assert_allclose(m.delays.numpy(), a.delays.numpy(), rtol=1e-4)
    np.testing.assert_allclose(m.energies.numpy(), a.energies.numpy(),
                               rtol=1e-4, atol=1e-6)


def test_probe_ladder_has_the_reference_coordinates():
    probes = t_mc.probe_kernels(mode="smoke", backend="plain", reps=1,
                                device="cpu")
    want = []
    for kernel, tag, args in j_mc._SMOKE_SHAPES:
        _, flops, bytes_ = j_mc._BUILDERS[kernel](*args, "jnp")
        want.append((kernel, tag, flops, bytes_))
    assert [(p.kernel, p.shape, p.flops, p.hbm_bytes) for p in probes] == want
    assert all(p.backend == "plain" and p.seconds > 0 for p in probes)
    assert ([(k, t, a) for k, t, a in t_mc._FULL_SHAPES]
            == [(k, t, a) for k, t, a in j_mc._FULL_SHAPES])


def test_probe_backends_never_switch():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        t_mc.probe_kernels(backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown probe backend"):
        t_mc.probe_kernels(backend="jnp", device="cpu")


def test_calibrate_pipeline_on_the_cpu():
    payload = calibrate.run(smoke=True, reps=1, device="cpu")
    assert payload["schema"] == "torch-calibrate/v1"
    assert len(payload["probes"]) == 8 and "kernels" not in payload
    assert set(payload["latency_tables"]) == set(ARCH_IDS)
    assert payload["roofline_fit"]["backend"] == "plain"
    rows = payload["measured"]["rows"]
    assert [r["arch"] for r in rows] == list(ARCH_IDS)
    assert all(np.isfinite(r["inflation"]) and r["inflation"] > 0
               for r in rows)
    with pytest.raises(ValueError, match="need a CUDA device"):
        calibrate.bench_flash_decode(torch.device("cpu"))


def test_calibrate_command_line_writes_its_payload(tmp_path, capsys):
    out = tmp_path / "calibrate.json"
    calibrate.main(["--smoke", "--reps", "1", "--device", "cpu",
                    "--json", str(out)])
    payload = json.loads(out.read_text())
    assert payload["mode"] == "smoke" and payload["device"] == "cpu"
    assert "roofline fit [cpu]" in capsys.readouterr().out


def test_decision_divergence_and_scalar_agreement_on_the_cpu():
    _, tfit = _fit_pair()
    tables = t_mc.build_latency_tables(tfit, batch=BATCH, seq_len=SEQ,
                                       archs=("llama32-1b", "mamba2-370m"))
    div = calibrate.decision_divergence(
        tables, archs=("llama32-1b", "mamba2-370m"), states=("normal",),
        n_devices=6, rounds=2, device="cpu")
    assert len(div["cells"]) == 2
    assert 0.0 <= div["frac_decisions_moved_overall"] <= 1.0
    for table in (tables["mamba2-370m"], None):
        res = calibrate.scalar_agreement("mamba2-370m", table, n_devices=6,
                                         rounds=2, device="cpu")
        assert res["decisions"] == 12
        assert res["disagree_beyond_near_ties"] == 0
        assert res["worst_freq_rel_diff"] <= 1e-5
