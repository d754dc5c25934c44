"""Hierarchical multi-server CARD on the port at fleet scale: delay/energy
vs the number of edge servers x fleet size.

    python -m repro_torch.launch.hierarchy_bench [--smoke] [--json [PATH]]
                                                 [--device cpu]

For each (servers, devices) grid point the sweep runs one full hierarchical
round — the (S, R, D, C) tiered grid on the card, the capacity-constrained
device->server assignment on the host, and the per-server backhaul
aggregation — and reports mean per-device delay/energy, the fleet round
time (slowest server including its backhaul push), server load imbalance,
and the warm wall time of the round (run once at the same shape first);
the largest fleet's walls are the gates
(``hierarchical_card_round_s_<S>srv_<D>dev``). One server is the paper's single-server baseline. The twin of the
reference's ``benchmarks/hierarchy_bench.py``, same grid (``--smoke``: 50
and 100 devices x 1 and 2 servers, 3 rounds).

Nothing is written unless ``--json`` (default path
``BENCH_torch_hierarchy.json``); ``device=None`` is the GPU and raises
without one.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

from repro_torch.configs.base import get_config
from repro_torch.core.hardware import make_heterogeneous_fleet, make_server_tier
from repro_torch.core.scheduler import simulate_hierarchical_fleet
from repro_torch.launch import write_payload
from repro_torch.models.common import describe_device, resolve_device

SCHEMA = "torch-bench-hierarchy/v1"
DEFAULT_JSON = "BENCH_torch_hierarchy.json"


def run(*, fleet_sizes=(100, 1000), tier_sizes=(1, 2, 4, 8),
        rounds: int = 5, seed: int = 0, device=None) -> Dict:
    dev = resolve_device(device)
    cfg = get_config("llama32-1b")
    out: Dict = {"arch": "llama32-1b", "rounds": rounds,
                 "device": describe_device(dev), "sweep": [], "gates": {}}
    for n_dev in fleet_sizes:
        fleet = make_heterogeneous_fleet(n_dev, seed=seed)
        for n_srv in tier_sizes:
            tier = make_server_tier(n_srv, capacity=-(-n_dev // n_srv),
                                    seed=seed + n_srv)
            kw = dict(tier=tier, rounds=rounds, devices=fleet, seed=seed,
                      device=dev)
            simulate_hierarchical_fleet(cfg, **kw)
            t0 = time.perf_counter()
            log = simulate_hierarchical_fleet(cfg, **kw)
            wall_s = time.perf_counter() - t0
            load = log.decision.server_load
            out["sweep"].append({
                "servers": n_srv, "devices": n_dev, "wall_s": wall_s,
                "mean_delay_s": log.mean_delay(),
                "mean_energy_j": log.mean_energy(),
                "mean_round_s": log.mean_round_s(),
                "mean_aggregation_s": float(
                    log.decision.aggregation_s.mean()),
                "load_imbalance": float(load.max() / max(1, load.min())),
            })
            if n_dev == max(fleet_sizes):
                out["gates"][
                    f"hierarchical_card_round_s_{n_srv}srv_{n_dev}dev"] = wall_s
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small grid, just prove the path runs")
    ap.add_argument("--json", nargs="?", const=DEFAULT_JSON, metavar="PATH",
                    help=f"write the payload (default path {DEFAULT_JSON})")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    if args.smoke:
        res = run(fleet_sizes=(50, 100), tier_sizes=(1, 2), rounds=3,
                  device=args.device)
    else:
        res = run(device=args.device)
    res["schema"] = SCHEMA
    res["mode"] = "smoke" if args.smoke else "full"
    if args.json:
        write_payload(args.json, res)
    print(f"device: {res['device']}")
    print("servers,devices,wall_s,mean_round_s,mean_delay_s,mean_energy_j,"
          "load_imbalance")
    for row in res["sweep"]:
        print(f"{row['servers']},{row['devices']},{row['wall_s']:.4f},"
              f"{row['mean_round_s']:.3f},{row['mean_delay_s']:.3f},"
              f"{row['mean_energy_j']:.3f},{row['load_imbalance']:.2f}")
    return res


if __name__ == "__main__":
    main()
