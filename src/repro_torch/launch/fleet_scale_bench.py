"""Fleet-scale throughput on the port: scalar oracle vs vectorized CARD
engine.

    python -m repro_torch.launch.fleet_scale_bench [--smoke] [--json [PATH]]
                                                   [--device cpu]

Times ``simulate_fleet`` end-to-end (channel draws on the host + decisions
on the card + the host copy of the log) for growing heterogeneous fleets
and reports decisions/second for both engines; the vectorized engine's
walls are the gates (``batched_card_round_s_<D>dev[_big]``). The vectorized engine runs
once at the same shape before it is timed (the allocator's first use). A
1000-device round must complete end-to-end. The twin of the reference's
``benchmarks/fleet_scale_bench.py``, same sizes (``--smoke``: 5 and 20
devices, a 100-device big fleet, 2 rounds).

Nothing is written unless ``--json`` (default path
``BENCH_torch_fleet_scale.json``); ``device=None`` is the GPU and raises
without one. A ``--device cpu`` run times the CPU, which says nothing
about the card.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

from repro_torch.configs.base import get_config
from repro_torch.core.hardware import make_heterogeneous_fleet
from repro_torch.core.scheduler import parallel_round_stats, simulate_fleet
from repro_torch.launch import write_payload
from repro_torch.models.common import describe_device, resolve_device

SCHEMA = "torch-bench-fleet-scale/v1"
DEFAULT_JSON = "BENCH_torch_fleet_scale.json"


def _time_engine(cfg, fleet, *, engine: str, rounds: int, seed: int,
                 warmup: bool, device) -> float:
    kw = dict(rounds=rounds, devices=fleet, seed=seed, engine=engine,
              device=device)
    if warmup:
        simulate_fleet(cfg, **kw)
    t0 = time.perf_counter()
    simulate_fleet(cfg, **kw)        # ends in a host copy: synchronised
    return time.perf_counter() - t0


def run(*, sizes=(10, 100), big: int = 1000, rounds: int = 5,
        big_rounds: int = 10, seed: int = 0, device=None) -> Dict:
    dev = resolve_device(device)
    cfg = get_config("llama32-1b")
    out: Dict = {"device": describe_device(dev), "scaling": [],
                 "speedup_at_largest": None}
    for n in sizes:
        fleet = make_heterogeneous_fleet(n, seed=seed)
        t_scalar = _time_engine(cfg, fleet, engine="scalar", rounds=rounds,
                                seed=seed, warmup=False, device=dev)
        t_vec = _time_engine(cfg, fleet, engine="vectorized", rounds=rounds,
                             seed=seed, warmup=True, device=dev)
        decisions = rounds * n
        out["scaling"].append({
            "devices": n, "rounds": rounds,
            "scalar_s": t_scalar, "vectorized_s": t_vec,
            "scalar_dec_per_s": decisions / t_scalar,
            "vectorized_dec_per_s": decisions / t_vec,
            "speedup": t_scalar / t_vec})
    out["speedup_at_largest"] = out["scaling"][-1]["speedup"]

    # the 1000-device heterogeneous round the paper's "massive devices"
    # claim needs — vectorized only
    fleet = make_heterogeneous_fleet(big, seed=seed)
    kw = dict(rounds=big_rounds, devices=fleet, seed=seed, device=dev)
    simulate_fleet(cfg, **kw)
    t0 = time.perf_counter()
    log = simulate_fleet(cfg, **kw)
    t_big = time.perf_counter() - t0
    stats = parallel_round_stats(log)
    out["big_fleet"] = {
        "devices": big, "rounds": big_rounds, "wall_s": t_big,
        "decisions_per_s": big_rounds * big / t_big,
        "mean_delay_s": log.mean_delay(),
        "mean_energy_j": log.mean_energy(),
        "parallel_exact_s": stats["parallel_exact_s"],
        "parallel_speedup": stats["speedup_exact"],
    }
    # the vectorized engine's round times are the gated hot path (the
    # scalar oracle's are the comparison subject, not a hot path)
    out["gates"] = {
        f"batched_card_round_s_{row['devices']}dev": row["vectorized_s"]
        for row in out["scaling"]}
    out["gates"][f"batched_card_round_s_{big}dev_big"] = t_big
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes, just prove the path runs")
    ap.add_argument("--json", nargs="?", const=DEFAULT_JSON, metavar="PATH",
                    help=f"write the payload (default path {DEFAULT_JSON})")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    if args.smoke:
        res = run(sizes=(5, 20), big=100, rounds=2, big_rounds=2,
                  device=args.device)
    else:
        res = run(device=args.device)
    res["schema"] = SCHEMA
    res["mode"] = "smoke" if args.smoke else "full"
    if args.json:
        write_payload(args.json, res)
    print(f"device: {res['device']}")
    print("devices,rounds,scalar_s,vectorized_s,speedup")
    for row in res["scaling"]:
        print(f"{row['devices']},{row['rounds']},{row['scalar_s']:.3f},"
              f"{row['vectorized_s']:.4f},{row['speedup']:.1f}")
    b = res["big_fleet"]
    print(f"big_fleet,{b['devices']}dev x {b['rounds']}r,"
          f"{b['wall_s']:.3f}s,{b['decisions_per_s']:.0f} dec/s,"
          f"parallel_speedup={b['parallel_speedup']:.1f}")
    return res


if __name__ == "__main__":
    main()
