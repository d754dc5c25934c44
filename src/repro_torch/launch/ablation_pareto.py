"""Ablation on the port: the delay/energy Pareto frontier traced by the
weight w in Eq. 12, plus the static-cut and random-cut baselines the paper
argues against.

    python -m repro_torch.launch.ablation_pareto [--rounds N] [--device cpu]

For each w, CARD's delay reduction against device-only and energy reduction
against server-only (``simulate_fleet`` on the paper's 5-device fleet,
llama32-1b); at the paper's w = 0.2, CARD against a static mid cut (16) and
a random cut. Shows whether the paper's headline operating point (-70.8 %
delay, -53.1 % energy) lies on CARD's achievable frontier. The twin of the
reference's ``benchmarks/ablation_pareto.py``; ``device=None`` is the GPU
and raises without one.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

from repro_torch.configs.base import get_config
from repro_torch.core.hardware import SimParams
from repro_torch.core.scheduler import simulate_fleet
from repro_torch.models.common import describe_device, resolve_device

WEIGHTS = (0.05, 0.2, 0.4, 0.6, 0.8, 0.9, 0.95)
PAPER_POINT = {"delay_reduction": 0.708, "energy_reduction": 0.531}


def run(rounds: int = 15, seed: int = 0, *, device=None) -> Dict:
    dev = resolve_device(device)
    cfg = get_config("llama32-1b")
    kw = dict(rounds=rounds, seed=seed, device=dev)
    frontier: List[Dict] = []
    for w in WEIGHTS:
        sim = SimParams(w=w)
        card = simulate_fleet(cfg, policy="card", sim=sim, **kw)
        dev_only = simulate_fleet(cfg, policy="device_only", sim=sim, **kw)
        srv_only = simulate_fleet(cfg, policy="server_only", sim=sim, **kw)
        frontier.append({
            "w": w,
            "delay_reduction": 1 - card.mean_delay() / dev_only.mean_delay(),
            "energy_reduction":
                1 - card.mean_energy() / srv_only.mean_energy(),
            "mean_freq_ghz": float(card.freqs.mean() / 1e9),
        })
    # static/random baselines at the paper's w
    sim = SimParams(w=0.2)
    extras = {}
    for policy, pkw in (("static_mid", {"policy": "static",
                                        "static_cut": 16}),
                        ("random", {"policy": "random"})):
        log = simulate_fleet(cfg, sim=sim, **pkw, **kw)
        extras[policy] = {"delay_s": log.mean_delay(),
                          "energy_j": log.mean_energy()}
    card = simulate_fleet(cfg, policy="card", sim=sim, **kw)
    extras["card"] = {"delay_s": card.mean_delay(),
                      "energy_j": card.mean_energy()}
    # CARD dominates static/random on the scalarized cost by construction;
    # check that it also weakly dominates on at least one raw axis
    dominated = all(
        extras["card"]["delay_s"] <= extras[p]["delay_s"] + 1e-9
        or extras["card"]["energy_j"] <= extras[p]["energy_j"] + 1e-9
        for p in ("static_mid", "random"))
    return {"frontier": frontier, "baselines": extras,
            "card_dominates": bool(dominated),
            "paper_point": dict(PAPER_POINT), "rounds": rounds,
            "device": describe_device(dev)}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    res = run(rounds=args.rounds, device=args.device)
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
