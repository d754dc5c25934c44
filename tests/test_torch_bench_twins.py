"""The port's benchmark twins (``repro_torch.launch.{serving_bench,
kernel_bench, cost_model_calibration, roofline, ablation_pareto,
check_regression, run}``) against the reference's ``benchmarks/`` scripts,
on the CPU at small sizes.

Tolerances: the serving sweep's counts (requests completed, ticks,
prefills, tokens) and the admission controller's fields that do not read
the clock are integers or sums of the same float64 channel draws, so they
are equal; the measured cost rows come from one fixed fit through float64
arithmetic on both sides (rel 1e-12); the analytic eta is the same float64
formula (rel 1e-12); the ablation's reductions come from float32 decision
grids on both sides (rel 1e-5, as the Fig. 4 twin's)."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core import cost_model as j_cm
from repro.core import measured_cost as j_mc
from repro.models import model as JM
from repro_torch.core import measured_cost as t_mc
from repro_torch.launch import (ablation_pareto, check_regression,
                                cost_model_calibration, kernel_bench, roofline,
                                serving_bench)
from repro_torch.launch import run as t_run

from _torch_parity import to_torch_tree

torch.set_num_threads(1)

SERVING_SMOKE = t_run.SERVING_SMOKE      # the reference's run.py grid
ROW_COUNTS = ("slots", "adapters", "requests", "completed", "drained",
              "ticks", "prefills", "tokens")
ADMISSION_FIELDS = ("capacity_hz", "reserved_hz", "used_hz", "in_flight",
                    "forced_admits")
TENANT_FIELDS = ("submitted", "admitted", "completed", "blocked_attempts",
                 "demand_hz_sum", "mean_demand_hz")


def _reference_weights(seed=0, n_adapters=2):
    """The reference serving bench's own weights, converted leaf by leaf."""
    from benchmarks import serving_bench as ref
    cfg = j_get_config(ref.ARCH).reduced()
    frozen = JM.init_params(jax.random.PRNGKey(seed), cfg)["frozen"]
    adapters = [JM.init_params(jax.random.PRNGKey(s), cfg)["lora"]
                for s in ref.ADAPTER_SEEDS[:n_adapters]]
    return to_torch_tree(frozen), [to_torch_tree(a) for a in adapters]


@pytest.fixture(scope="module")
def serving_pair():
    from benchmarks import serving_bench as ref
    frozen, adapters = _reference_weights()
    port = serving_bench.run(**SERVING_SMOKE, device="cpu", reduced=True,
                             frozen=frozen, adapters=adapters)
    return ref.run(**SERVING_SMOKE), port


def test_serving_twin_sweep_counts_equal_the_reference(serving_pair):
    ref, port = serving_pair
    assert port["arch"] == ref["arch"] == "qwen3-0.6b"
    assert port["engine"] == ref["engine"]
    assert len(port["sweep"]) == len(ref["sweep"]) == 4
    for got, want in zip(port["sweep"], ref["sweep"]):
        assert {k: got[k] for k in ROW_COUNTS} \
            == {k: want[k] for k in ROW_COUNTS}
        assert got["drained"] is True
        for key in ("requests_per_s", "tokens_per_sec", "mean_ttft_s",
                    "wall_s"):
            assert got[key] > 0 and np.isfinite(got[key])
    assert port["device"] == "cpu" and port["reduced"] is True
    # on the CPU the wrappers run their plain versions: no launch
    assert port["launches"] == {"lora_matmul": 0, "lora_matmul_grouped": 0}


def test_serving_twin_admission_equals_the_reference(serving_pair):
    ref, port = serving_pair
    got, want = port["admission"], ref["admission"]
    for key in ADMISSION_FIELDS:
        assert got[key] == want[key], key
    assert list(got["tenants"]) == list(want["tenants"]) == [0, 1]
    for aid, tenant in want["tenants"].items():
        for key in TENANT_FIELDS:
            assert got["tenants"][aid][key] == tenant[key], (aid, key)
    # the tight budget must show contention
    assert sum(t["blocked_attempts"] for t in got["tenants"].values()) > 0


def test_serving_twin_gates_and_device_times(serving_pair):
    ref, port = serving_pair
    assert set(port["gates"]) == set(ref["gates"]) == {
        "serving_decode_tick_s_2slot", "serving_decode_tick_s_4slot"}
    assert all(v > 0 for v in port["gates"].values())
    # no card: no device time, and the gate lines say so
    assert port["decode_tick_device_s"] == {"2slot": None, "4slot": None}


def test_serving_twin_raises_when_a_run_does_not_drain(monkeypatch):
    from repro_torch.serving import ServingEngine
    drain = ServingEngine.run_until_drained
    monkeypatch.setattr(ServingEngine, "run_until_drained",
                        lambda self, max_ticks=0: drain(self, max_ticks=2))
    with pytest.raises(RuntimeError, match="did not drain at slots=2"):
        serving_bench.run(**SERVING_SMOKE, device="cpu", reduced=True)


def test_serving_twin_adapters_have_nonzero_b():
    from repro_torch.configs.base import get_config
    cfg = get_config("qwen3-0.6b").reduced()
    a = serving_bench.make_adapter(cfg, 7, "cpu")
    b = serving_bench.make_adapter(cfg, 7, "cpu")
    c = serving_bench.make_adapter(cfg, 13, "cpu")
    pairs = a["layers"]["attn"]
    for name, pair in pairs.items():
        assert pair["b"].abs().max() > 0, name
        assert torch.equal(pair["b"], b["layers"]["attn"][name]["b"])
        assert not torch.equal(pair["b"], c["layers"]["attn"][name]["b"])


def test_serving_twin_main_prints_the_reference_lines(capsys):
    frozen, adapters = _reference_weights()
    res = serving_bench.run(slot_counts=(2, 4), adapter_counts=(1,),
                            requests=2, prompt_len=5, max_new=2,
                            tick_iters=1, device="cpu", reduced=True,
                            frozen=frozen, adapters=adapters)
    serving_bench.print_table(res)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("slots,adapters,completed,rps,mean_ttft_s,"
                      "tokens_per_sec,ticks")
    assert [ln.split(",")[:3] for ln in out[1:3]] == [["2", "1", "2"],
                                                      ["4", "1", "2"]]
    assert out[3].startswith("gate serving_decode_tick_s_2slot: ")
    assert out[3].endswith("(device not measured)")


# ---------------------------------------------------------------------------
# the cost model: measured and traced
# ---------------------------------------------------------------------------


FIT = {"inv_compute_s_per_flop": 1 / 1.5e14,
       "inv_bandwidth_s_per_byte": 1 / 2.9e12, "overhead_s": 4.2e-6,
       "achieved_flops_per_s": 1.1e14, "rel_residual": 0.3, "n_probes": 12,
       "backend": "cuda"}


def test_run_measured_equals_the_reference_on_one_fit():
    from benchmarks import cost_model_calibration as ref
    want = ref.run_measured(fit=j_mc.RooflineFit.from_dict(FIT))
    got = cost_model_calibration.run_measured(
        fit=t_mc.RooflineFit.from_dict(FIT))
    assert (got["batch"], got["seq_len"]) == (want["batch"], want["seq_len"])
    assert [r["arch"] for r in got["rows"]] == [r["arch"]
                                                for r in want["rows"]]
    for g, w in zip(got["rows"], want["rows"]):
        for key in ("analytic_eta_gflops", "effective_eta_gflops",
                    "inflation"):
            assert g[key] == pytest.approx(w[key], rel=1e-12), (g["arch"],
                                                                 key)


@pytest.fixture(scope="module")
def dryrun_path(tmp_path_factory):
    """Records the port's dry run writes (``--out``) for two train_4k
    combos on ``meta``, each at its reduced width (a full-width trace takes
    seconds a combo here), and a re-run of one that supersedes it."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    path = tmp_path_factory.mktemp("dryrun") / "dryrun.jsonl"
    mp = pytest.MonkeyPatch()
    mp.setattr(dryrun, "combo_config", lambda a, s: get_config(a).reduced())
    try:
        for arch in ("qwen3-0.6b", "mamba2-370m", "qwen3-0.6b"):
            with pytest.raises(SystemExit) as done:
                dryrun.main(["--arch", arch, "--shape", "train_4k",
                             "--out", str(path)])
            assert done.value.code == 0
    finally:
        mp.undo()
    return path


def test_card_calibration_rows_from_the_ports_dryrun_records(dryrun_path):
    from repro.configs.base import INPUT_SHAPES
    rows = cost_model_calibration.run(str(dryrun_path))
    assert [r["arch"] for r in rows] == ["mamba2-370m", "qwen3-0.6b"]
    shape = INPUT_SHAPES["train_4k"]
    recs = {r["arch"]: r for r in roofline.load(str(dryrun_path))}
    for row in rows:
        want = j_cm.Workload(j_get_config(row["arch"]), shape.global_batch,
                             shape.seq_len).total_flops()
        assert row["analytic_eta_pflops"] == pytest.approx(want / 1e15,
                                                           rel=1e-12)
        traced = recs[row["arch"]]["roofline"]["flops"]
        assert row["traced_pflops"] == traced / 1e15
        assert row["ratio_analytic_over_traced"] == pytest.approx(
            want / traced, rel=1e-12)
    assert cost_model_calibration.run(str(dryrun_path), "prefill_32k") == []


def test_card_calibration_payload_ok_and_missing(dryrun_path, tmp_path,
                                                 capsys):
    fit = t_mc.RooflineFit.from_dict(FIT)
    ok = cost_model_calibration.build_payload(path=str(dryrun_path), fit=fit)
    assert ok["dryrun_status"] == "ok" and len(ok["dryrun_rows"]) == 2
    missing = cost_model_calibration.build_payload(
        path=str(tmp_path / "none.jsonl"), fit=fit)
    assert missing["dryrun_status"] == "missing"
    assert missing["dryrun_rows"] == [] and missing["measured"]["rows"]
    assert "skip: no usable dry-run records" in capsys.readouterr().out
    for payload in (ok, missing):
        assert check_regression.validate_payload(payload) == []


def test_roofline_twin_summary_equals_the_reference(dryrun_path, capsys):
    from benchmarks import roofline as ref
    recs = roofline.load(str(dryrun_path))
    assert len(recs) == 2                       # the re-run superseded
    assert ref.load(str(dryrun_path)) == recs
    assert roofline.summary(recs) == ref.summary(recs)
    assert roofline.summary(recs)["ok"] == 2
    text = roofline.table(recs)
    assert len(text.splitlines()) == 4 and "qwen3-0.6b" in text
    for line in text.splitlines()[2:]:     # the record's own fits, 80 GB
        rec = next(r for r in recs if line.startswith(r["arch"]))
        assert line.endswith(" Y") == rec["fits"], line
        assert line.endswith(f"N({rec['memory']['peak_bytes'] / 1e9:.0f}G)"
                             ) != rec["fits"], line
    assert roofline.table(recs, mesh="16x16").count("\n") == 1
    roofline.main(["--path", str(dryrun_path)])
    out = capsys.readouterr().out
    assert "the sharded dry run is not ported" in out
    assert json.loads(out.splitlines()[-1]) == roofline.summary(recs)


# ---------------------------------------------------------------------------
# the ablation, the kernel payload, the gate, the harness
# ---------------------------------------------------------------------------


def test_ablation_twin_matches_the_reference():
    from benchmarks import ablation_pareto as ref
    want = ref.run(rounds=3)
    got = ablation_pareto.run(rounds=3, device="cpu")
    assert got["card_dominates"] == want["card_dominates"]
    assert got["paper_point"] == want["paper_point"]
    assert [f["w"] for f in got["frontier"]] == [f["w"]
                                                 for f in want["frontier"]]
    for g, w in zip(got["frontier"], want["frontier"]):
        for key in ("delay_reduction", "energy_reduction", "mean_freq_ghz"):
            assert g[key] == pytest.approx(w[key], rel=1e-5), (g["w"], key)
    assert set(got["baselines"]) == set(want["baselines"])
    for policy, vals in want["baselines"].items():
        for key, val in vals.items():
            assert got["baselines"][policy][key] == pytest.approx(
                val, rel=1e-5), (policy, key)


@pytest.fixture(scope="module")
def smoke_payloads(serving_pair):
    """Every twin's smoke payload, made on the CPU."""
    from repro_torch.launch import churn_bench, fleet_scale_bench, \
        hierarchy_bench
    kernels = kernel_bench.run(smoke=True, device="cpu")
    calib = cost_model_calibration.build_payload(
        smoke=True, path="no-such-dryrun.jsonl",
        fit=t_mc.RooflineFit.from_dict(kernels["roofline_fit"]))
    serving = dict(serving_pair[1], schema=serving_bench.SCHEMA,
                   mode="smoke")
    out = {"kernels": kernels, "card_calibration": calib,
           "serving": serving}
    for name, mod in (("fleet_scale", fleet_scale_bench),
                      ("churn", churn_bench), ("hierarchy", hierarchy_bench)):
        out[name] = mod.main(["--smoke", "--device", "cpu"])
    return out


def test_kernel_bench_payload_from_calibrate(smoke_payloads):
    p = smoke_payloads["kernels"]
    assert p["schema"] == "torch-bench-kernels/v1" and p["mode"] == "smoke"
    assert p["device"] == "cpu" and "kernels" not in p
    assert set(p["gates"]) == {f"probe_{q['kernel']}_{q['shape']}_s"
                               for q in p["probes"]}
    assert len(p["gates"]) == len(p["probes"]) > 0
    assert p["latency_tables"] and p["roofline_fit"]["backend"] == "plain"


def test_kernel_bench_builds_on_a_calibrate_payload_without_probing():
    cal = {"mode": "full", "device": "NVIDIA H100 80GB HBM3",
           "probes": [{"kernel": "lora_matmul", "shape": "m128k128n128r8",
                       "backend": "cuda", "seconds": 6.3e-6}],
           "roofline_fit": {"backend": "cuda"}, "host_profile": {},
           "latency_tables": {"qwen3-0.6b": {"schema": "latency-table/v1"}},
           "kernels": [{"name": "lora_matmul_512"}]}
    p = kernel_bench.build_payload(cal)
    assert p["gates"] == {"probe_lora_matmul_m128k128n128r8_s": 6.3e-6}
    assert p["kernels"] == cal["kernels"] and p["backend"] == "cuda"
    assert check_regression.validate_payload(p) == []


@pytest.mark.parametrize("name", ["kernels", "card_calibration", "serving",
                                  "fleet_scale", "churn", "hierarchy"])
def test_check_regression_accepts_every_twins_smoke_payload(
        smoke_payloads, tmp_path, name):
    from repro_torch.launch import write_payload
    payload = smoke_payloads[name]
    assert payload["schema"] in check_regression.REQUIRED_KEYS
    path = tmp_path / f"BENCH_torch_{name}.json"
    write_payload(str(path), payload)
    assert check_regression.validate(str(path)) == []
    assert f"BENCH_torch_{name}.json" in check_regression.BENCH_FILES


def _broken(payload, how):
    p = json.loads(json.dumps(payload))
    if how == "missing key":
        del p["engine"]
    elif how == "undrained row":
        p["sweep"][1]["drained"] = False
    elif how == "non-positive gate":
        p["gates"]["serving_decode_tick_s_2slot"] = 0.0
    elif how == "gate key without _s":
        p["gates"]["serving_decode_tick_2slot"] = p["gates"].pop(
            "serving_decode_tick_s_2slot")
    return p


@pytest.mark.parametrize("how,message", [
    ("missing key", "missing required key 'engine'"),
    ("undrained row", "adapters=2 did not drain"),
    ("non-positive gate", "must be a positive finite number, got 0.0"),
    ("gate key without _s", "carries no unit suffix (expected time[s])")])
def test_check_regression_rejects(smoke_payloads, how, message):
    errors = check_regression.validate_payload(
        _broken(smoke_payloads["serving"], how), "BENCH_torch_serving.json")
    assert len(errors) == 1 and message in errors[0], errors


def test_check_regression_unit_check_agrees_with_splint():
    from tools.splint.units import check_key_units
    keys = ["serving_decode_tick_s_2slot", "probe_lora_matmul_m128_s",
            "round_ms", "wait_seconds", "energy_j_per_s", "mixed_s_j",
            "decisions_per_s", "no_unit", "flops_per_s", "tick_us_s"]
    for require in (None, "time[s]"):
        assert check_regression.check_key_units(
            keys, context="x", require=require) \
            == check_key_units(keys, context="x", require=require)
    assert check_regression.key_dimensions("a_flops_per_s_b_bytes") \
        == ["compute[flop]/time[s]", "data[byte]"]


def test_check_regression_flags_a_slower_gate(tmp_path, capsys):
    base, fresh = tmp_path / "base", tmp_path / "fresh"
    base.mkdir()
    fresh.mkdir()
    for d, t in ((base, 0.1), (fresh, 0.25)):
        (d / "BENCH_torch_serving.json").write_text(json.dumps(
            {"gates": {"serving_decode_tick_s_2slot": t,
                       "serving_decode_tick_s_4slot": 0.1}}))
    fails = check_regression.compare_gates(
        str(base / "BENCH_torch_serving.json"),
        str(fresh / "BENCH_torch_serving.json"), 2.0)
    assert len(fails) == 1 and "2.50x" in fails[0]
    assert "serving_decode_tick_s_2slot" in fails[0]
    assert check_regression.compare_gates(
        str(base / "BENCH_torch_serving.json"),
        str(fresh / "BENCH_torch_serving.json"), 3.0) == []
    assert check_regression.main(["--validate", str(
        fresh / "BENCH_torch_serving.json")]) == 1
    assert "unknown schema None" in capsys.readouterr().err


def test_run_smoke_prints_every_row(capsys):
    import pkgutil
    from repro_torch import launch
    t_run.main(["--smoke", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    start = lines.index("name,us_per_call,derived")
    names = [ln.split(",")[0] for ln in lines[start + 1:]]
    modules = sorted(i.name for i in pkgutil.iter_modules(launch.__path__)
                     if i.name != "run")
    assert names == [f"import_{m}" for m in modules] + [
        "fig3_decisions_smoke", "fig4_comparison_smoke",
        "fig4_fleet_scale_smoke", "fleet_scale_smoke", "churn_smoke",
        "serving_smoke", "hierarchy_smoke", "ablation_pareto_smoke"]
    for m in ("serving_bench", "kernel_bench", "cost_model_calibration",
              "roofline", "ablation_pareto", "check_regression"):
        assert f"import_{m}" in names
    rows = dict(ln.split(",", 1) for ln in lines[start + 1:])
    assert "drained=True" in rows["serving_smoke"]


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")


@pytest.mark.parametrize("entry", [
    "serving_bench.run", "kernel_bench.run",
    "cost_model_calibration.run_measured", "ablation_pareto.run",
    "run.main"])
def test_twins_raise_without_a_gpu_by_default(no_gpu, entry):
    calls = {
        "serving_bench.run": lambda: serving_bench.run(reduced=True),
        "kernel_bench.run": lambda: kernel_bench.run(smoke=True),
        "cost_model_calibration.run_measured":
            lambda: cost_model_calibration.run_measured(),
        "ablation_pareto.run": lambda: ablation_pareto.run(rounds=1),
        "run.main": lambda: t_run.main(["--smoke"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
