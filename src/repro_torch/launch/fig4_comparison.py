"""Paper Fig. 4 on the port: training delay + server energy, CARD vs
Server-only vs Device-only, across channel states.

    python -m repro_torch.launch.fig4_comparison [--smoke] [--json [PATH]]
                                                 [--engine scalar]
                                                 [--device cpu]

Reports the paper's two headline numbers (-70.8% delay vs device-only,
-53.1% energy vs server-only) beside the port's, for two scenarios: the
paper's 5-device Table-I fleet (``run``, 40 rounds x good/normal/poor) and a
1000-device heterogeneous fleet (``run_fleet_scale``) that checks the
headline reductions survive at the "massive mobile devices" scale the paper
motivates. The twin of the reference's ``benchmarks/fig4_comparison.py``.

Nothing is written unless ``--json`` (default path
``BENCH_torch_fig4_comparison.json``). ``device=None`` (no ``--device``) is
the GPU and raises without one.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from repro_torch.configs.base import get_config
from repro_torch.core.hardware import EDGE_FLEET, make_heterogeneous_fleet
from repro_torch.core.scheduler import compare_policies
from repro_torch.launch import write_payload
from repro_torch.models.common import describe_device, resolve_device

SCHEMA = "torch-fig4-comparison/v1"
DEFAULT_JSON = "BENCH_torch_fig4_comparison.json"
PAPER_CLAIMS = {"delay_reduction": 0.708, "energy_reduction": 0.531}


def reductions(grid, states: Sequence[str]) -> Dict:
    """Per-state mean delay and energy of each policy of a
    ``compare_policies`` grid, CARD's reductions, and their averages."""
    out: Dict = {"per_state": {}}
    for state in states:
        row = {}
        for policy in ("card", "server_only", "device_only"):
            log = grid[policy][state]
            row[policy] = {"delay_s": log.mean_delay(),
                           "energy_j": log.mean_energy()}
        row["delay_reduction_vs_device_only"] = \
            1 - row["card"]["delay_s"] / row["device_only"]["delay_s"]
        row["energy_reduction_vs_server_only"] = \
            1 - row["card"]["energy_j"] / row["server_only"]["energy_j"]
        out["per_state"][state] = row
    # averaged headline (paper reports single figures)
    dr = [out["per_state"][s]["delay_reduction_vs_device_only"]
          for s in out["per_state"]]
    er = [out["per_state"][s]["energy_reduction_vs_server_only"]
          for s in out["per_state"]]
    out["avg_delay_reduction"] = sum(dr) / len(dr)
    out["avg_energy_reduction"] = sum(er) / len(er)
    out["paper_claims"] = dict(PAPER_CLAIMS)
    return out


def run(rounds: int = 40, seed: int = 0, *, engine: str = "vectorized",
        device=None) -> Dict:
    """The paper's scenario: 5 Table-I edge devices."""
    dev = resolve_device(device)
    cfg = get_config("llama32-1b")
    states = ("good", "normal", "poor")
    grid = compare_policies(cfg, rounds=rounds, seed=seed,
                            channel_states=states, engine=engine, device=dev)
    out = reductions(grid, states)
    out.update(devices=len(EDGE_FLEET), rounds=rounds, engine=engine,
               device=describe_device(dev))
    return out


def run_fleet_scale(n_devices: int = 1000, rounds: int = 10, seed: int = 0,
                    *, device=None) -> Dict:
    """1000 heterogeneous devices, vectorized engine: do the paper's
    headline reductions hold for a massive, mixed-platform fleet?"""
    dev = resolve_device(device)
    cfg = get_config("llama32-1b")
    fleet = make_heterogeneous_fleet(n_devices, seed=seed)
    states = ("good", "normal", "poor")
    grid = compare_policies(cfg, rounds=rounds, seed=seed,
                            channel_states=states, devices=fleet,
                            engine="vectorized", device=dev)
    out = reductions(grid, states)
    out.update(devices=n_devices, rounds=rounds, engine="vectorized",
               device=describe_device(dev))
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="4 rounds and a 50-device fleet")
    ap.add_argument("--json", nargs="?", const=DEFAULT_JSON, metavar="PATH",
                    help=f"write the payload (default path {DEFAULT_JSON})")
    ap.add_argument("--engine", default="vectorized",
                    choices=("vectorized", "scalar"),
                    help="the engine of the paper's 5-device scenario")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    if args.smoke:
        res = {"paper_fleet": run(rounds=4, engine=args.engine,
                                  device=args.device),
               "fleet_scale": run_fleet_scale(50, rounds=2,
                                              device=args.device)}
    else:
        res = {"paper_fleet": run(engine=args.engine, device=args.device),
               "fleet_scale": run_fleet_scale(device=args.device)}
    res["schema"] = SCHEMA
    res["mode"] = "smoke" if args.smoke else "full"
    if args.json:
        write_payload(args.json, res)
    for name in ("paper_fleet", "fleet_scale"):
        r = res[name]
        print(f"{name} [{r['device']}, {r['devices']} devices x "
              f"{r['rounds']} rounds]: delay -{r['avg_delay_reduction']:.3f}"
              f" vs device-only (paper -0.708), energy "
              f"-{r['avg_energy_reduction']:.3f} vs server-only "
              f"(paper -0.531)")
    return res


if __name__ == "__main__":
    main()
