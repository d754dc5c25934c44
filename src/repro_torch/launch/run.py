"""Benchmark harness of the port — one entry per paper table/figure plus
the system extras.

    python -m repro_torch.launch.run [--smoke] [--device cpu]

Prints ``name,us_per_call,derived`` CSV, as the reference's
``benchmarks/run.py`` does:
  fig3_decisions   — Fig. 3(a)/(b): cut-layer + frequency decisions
  fig4_comparison  — Fig. 4: delay/energy vs Server-only / Device-only
  fleet_scale      — the vectorized engine's throughput on mixed fleets
  churn_sweep      — delay/energy/quorum under dropout
  serving_sweep    — multi-tenant LoRA serving (slots x adapters)
  hierarchy_sweep  — multi-server tier round-time scaling
  card_algorithm   — Alg. 1 runtime (O(I) decisions/second, host)
  split_step       — one split fine-tuning epoch (``core/splitting.py``,
                     the reduced llama32-1b)
  kernel_*         — the four kernel benches (``launch/calibrate.py``; the
                     card only, "not measured" elsewhere)
  ablation_pareto  — the w-sweep of Eq. 12 + static/random baselines
  cost_model_calibration, roofline_table — from the dry run's records
                     (``dryrun.jsonl``), when there are any

``--smoke`` imports every module of ``repro_torch.launch`` and runs tiny
versions of the figure pipelines and benches. ``device=None`` (no
``--device``) is the GPU and raises without one; ``--device cpu`` runs it
all on the CPU, the serving sweep at the reference's reduced width.
"""
from __future__ import annotations

import argparse
import importlib
import pkgutil
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

Row = Tuple[str, float, str]

# the serving sweep of the reference's ``run.py --smoke`` (smaller than the
# serving bench's own ``--smoke`` grid)
SERVING_SMOKE = dict(slot_counts=(2, 4), adapter_counts=(1, 2), requests=4,
                     prompt_len=6, max_new=3, tick_iters=3)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e6, out


def smoke(device=None) -> List[Row]:
    """Import every ``repro_torch.launch`` module, then run the figure
    pipelines and benches tiny."""
    from repro_torch import launch
    from repro_torch.models.common import resolve_device
    dev = resolve_device(device)
    rows: List[Row] = []
    for info in sorted(pkgutil.iter_modules(launch.__path__),
                       key=lambda i: i.name):
        if info.name == "run":
            continue
        us, _ = _timed(lambda name=info.name: importlib.import_module(
            f"repro_torch.launch.{name}"))
        rows.append((f"import_{info.name}", us, "ok"))

    from repro_torch.launch import (ablation_pareto, churn_bench,
                                    fig3_decisions, fig4_comparison,
                                    fleet_scale_bench, hierarchy_bench,
                                    serving_bench)
    us, fig3 = _timed(lambda: fig3_decisions.run(rounds=2, device=dev))
    rows.append(("fig3_decisions_smoke", us, f"bimodal={fig3['bimodal']}"))
    us, fig4 = _timed(lambda: fig4_comparison.run(rounds=2, device=dev))
    rows.append(("fig4_comparison_smoke", us,
                 f"delay_red={fig4['avg_delay_reduction']:.3f}"))
    us, scale = _timed(lambda: fig4_comparison.run_fleet_scale(
        n_devices=50, rounds=2, device=dev))
    rows.append(("fig4_fleet_scale_smoke", us,
                 f"devices=50;delay_red={scale['avg_delay_reduction']:.3f}"))
    us, fleet = _timed(lambda: fleet_scale_bench.run(
        sizes=(5,), big=100, rounds=2, big_rounds=2, device=dev))
    rows.append(("fleet_scale_smoke", us,
                 f"speedup={fleet['speedup_at_largest']:.1f};"
                 f"big_dec_per_s={fleet['big_fleet']['decisions_per_s']:.0f}"))
    us, churn = _timed(lambda: churn_bench.run(
        devices=50, rounds=2, dropout_rates=(0.0, 0.2), device=dev))
    worst = churn["sweep"][-1]
    rows.append(("churn_smoke", us,
                 f"survivors={worst['survivor_fraction']:.2f};"
                 f"quorum_rate={worst['quorum_rate']:.2f}"))
    us, serving = _timed(lambda: serving_bench.run(
        **SERVING_SMOKE, device=dev, reduced=True))
    busiest = serving["sweep"][-1]
    rows.append(("serving_smoke", us,
                 f"completed={busiest['completed']};"
                 f"drained={busiest['drained']};"
                 f"tok_per_s={busiest['tokens_per_sec']:.0f}"))
    us, hier = _timed(lambda: hierarchy_bench.run(
        fleet_sizes=(20, 40), tier_sizes=(1, 2), rounds=2, device=dev))
    widest = hier["sweep"][-1]
    rows.append(("hierarchy_smoke", us,
                 f"servers={widest['servers']};"
                 f"round_s={widest['mean_round_s']:.1f};"
                 f"imbalance={widest['load_imbalance']:.2f}"))
    us, ab = _timed(lambda: ablation_pareto.run(rounds=2, device=dev))
    rows.append(("ablation_pareto_smoke", us,
                 f"card_dominates={ab['card_dominates']};"
                 f"points={len(ab['frontier'])}"))
    return rows


def _card_algorithm() -> Row:
    from repro_torch.configs.base import get_config
    from repro_torch.core import card as card_lib
    from repro_torch.core.channel import WirelessChannel
    from repro_torch.core.cost_model import RoundContext, Workload
    from repro_torch.core.hardware import (DEFAULT_SIM, EDGE_FLEET,
                                           SERVER_RTX4060TI)
    ctx = RoundContext(workload=Workload(get_config("llama32-1b"), 4, 512),
                       device=EDGE_FLEET[0], server=SERVER_RTX4060TI,
                       channel=WirelessChannel("normal").draw(),
                       sim=DEFAULT_SIM)
    n = 200
    t0 = time.perf_counter()
    for _ in range(n):
        card_lib.card(ctx)
    us = (time.perf_counter() - t0) / n * 1e6
    return ("card_algorithm", us, f"decisions_per_s={1e6 / us:.0f}")


def _split_step(dev: torch.device) -> Row:
    """One split epoch at cut 1 of the reduced llama32-1b, after a first
    epoch at the same shape (the allocator's first use)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.splitting import SplitExecutor
    from repro_torch.models import model as model_lib
    tiny = get_config("llama32-1b").reduced()
    params = model_lib.init_params(0, tiny, device=dev)
    ex = SplitExecutor(tiny, compress=True)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, tiny.vocab_size,
                                    (4, 64)).astype(np.int32),
             "labels": rng.integers(0, tiny.vocab_size,
                                    (4, 64)).astype(np.int32)}
    ex.step(params["frozen"], params["lora"], batch, 1)
    t0 = time.perf_counter()
    loss, _ = ex.step(params["frozen"], params["lora"], batch, 1)
    loss = float(loss)                   # the host copy ends the epoch
    us = (time.perf_counter() - t0) * 1e6
    return ("split_step_cut1", us, f"loss={loss:.3f}")


def _kernel_rows(dev: torch.device) -> List[Row]:
    from repro_torch.launch import calibrate
    benches = (calibrate.bench_lora_matmul, calibrate.bench_flash_attention,
               calibrate.bench_ssd_scan, calibrate.bench_flash_decode)
    if dev.type != "cuda":
        names = ("lora_matmul_512", "flash_attention_512", "ssd_scan_512",
                 "flash_decode_1k")
        return [(f"kernel_{n}", 0.0, f"not measured (no CUDA device: {dev})")
                for n in names]
    rows = []
    with torch.no_grad():
        for bench in benches:
            r = bench(dev)
            rows.append((f"kernel_{r['name']}", r["kernel_us"],
                         ";".join(f"{k}={v:.4g}" for k, v in r.items()
                                  if isinstance(v, (int, float)))))
    return rows


def full(device=None) -> List[Row]:
    from repro_torch.models.common import resolve_device
    dev = resolve_device(device)
    rows: List[Row] = []

    from repro_torch.launch import fig3_decisions
    us, fig3 = _timed(lambda: fig3_decisions.run(rounds=40, device=dev))
    rows.append(("fig3_decisions", us,
                 f"bimodal={fig3['bimodal']};"
                 f"offload_monotone={fig3['offload_monotone_with_weakness']}"))

    from repro_torch.launch import fig4_comparison
    us, fig4 = _timed(lambda: fig4_comparison.run(rounds=40, device=dev))
    rows.append(("fig4_comparison", us,
                 f"delay_red={fig4['avg_delay_reduction']:.3f}(paper 0.708);"
                 f"energy_red={fig4['avg_energy_reduction']:.3f}(paper 0.531)"))

    from repro_torch.launch import fleet_scale_bench
    us, fleet = _timed(lambda: fleet_scale_bench.run(
        sizes=(10, 100), big=1000, rounds=5, big_rounds=10, device=dev))
    b = fleet["big_fleet"]
    rows.append(("fleet_scale", us,
                 f"speedup_100dev={fleet['speedup_at_largest']:.0f}x;"
                 f"1000dev_dec_per_s={b['decisions_per_s']:.0f};"
                 f"parallel_speedup={b['parallel_speedup']:.1f}"))

    from repro_torch.launch import churn_bench
    us, churn = _timed(lambda: churn_bench.run(device=dev))
    worst = churn["sweep"][-1]
    rows.append(("churn_sweep", us,
                 f"dropout={worst['dropout_rate']};"
                 f"survivors={worst['survivor_fraction']:.2f};"
                 f"rounds_per_commit={worst['rounds_per_commit']:.2f}"))

    # the published width needs the card; elsewhere the reference's width
    from repro_torch.launch import serving_bench
    us, serving = _timed(lambda: serving_bench.run(
        device=dev, reduced=dev.type != "cuda"))
    busiest = serving["sweep"][-1]
    rows.append(("serving_sweep", us,
                 f"slots={busiest['slots']};adapters={busiest['adapters']};"
                 f"rps={busiest['requests_per_s']:.1f};"
                 f"tok_per_s={busiest['tokens_per_sec']:.0f};"
                 f"ttft_s={busiest['mean_ttft_s']:.4f};"
                 f"reduced={serving['reduced']}"))

    from repro_torch.launch import hierarchy_bench
    us, hier = _timed(lambda: hierarchy_bench.run(device=dev))
    one = next(r for r in hier["sweep"]
               if r["servers"] == 1 and r["devices"] == 1000)
    widest = max(hier["sweep"], key=lambda r: (r["devices"], r["servers"]))
    rows.append(("hierarchy_sweep", us,
                 f"servers={widest['servers']};"
                 f"round_s={widest['mean_round_s']:.1f};"
                 f"tier_speedup={one['mean_round_s'] / widest['mean_round_s']:.1f}"))

    rows.append(_card_algorithm())
    rows.append(_split_step(dev))
    rows += _kernel_rows(dev)

    from repro_torch.launch import ablation_pareto
    us, ab = _timed(lambda: ablation_pareto.run(rounds=10, device=dev))
    best = min(ab["frontier"],
               key=lambda f: abs(f["energy_reduction"] - 0.531))
    rows.append(("ablation_pareto", us,
                 f"card_dominates={ab['card_dominates']};"
                 f"paper_point_nearest_w={best['w']}"))

    from repro_torch.launch import cost_model_calibration
    rows_cal = cost_model_calibration.run()
    if rows_cal:
        dense = [r["ratio_analytic_over_traced"] for r in rows_cal
                 if r["arch"].startswith(("qwen", "phi3", "musicgen",
                                          "internvl"))]
        rows.append(("cost_model_calibration", 0.0,
                     f"dense_ratio_min={min(dense):.2f};"
                     f"dense_ratio_max={max(dense):.2f};"
                     f"archs={len(rows_cal)}"))

    from repro_torch.launch import roofline
    recs = roofline.load()
    if recs:
        s = roofline.summary(recs)
        rows.append(("roofline_table", 0.0,
                     f"ok={s['ok']}/{s['total']};doms={s['dominant_terms']}"))
    else:
        rows.append(("roofline_table", 0.0, "no_dryrun_records"))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> List[Row]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="fast importability/pipeline check")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    rows = smoke(args.device) if args.smoke else full(args.device)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    return rows


if __name__ == "__main__":
    main()
