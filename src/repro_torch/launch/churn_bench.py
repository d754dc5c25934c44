"""Churn tolerance on the port at fleet scale: delay/energy/quorum vs
dropout rate.

    python -m repro_torch.launch.churn_bench [--smoke] [--json [PATH]]
                                             [--artifact PATH] [--device cpu]

Sweeps the fault model's dropout rate (with a fixed straggler/outage mix)
over a 1000-device heterogeneous fleet and reports what the deadline-based
partial aggregation delivers: surviving-mean delay and energy, survivor
fraction, the fraction of rounds that reach quorum, and the expected number
of rounds per committed round; the last rate's warm wall time is the gate
(``churn_sweep_round_s_<D>dev``). The fault realization of the heaviest sweep
point can be written as a JSON artifact (``--artifact``) for a bit-exact
replay. The twin of the reference's ``benchmarks/churn_bench.py``, same
sizes (``--smoke``: 100 devices, 4 rounds).

Nothing is written unless ``--json`` (default path
``BENCH_torch_churn.json``) or ``--artifact``; ``device=None`` is the GPU
and raises without one.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import Dict, Optional, Sequence

from repro_torch.configs.base import get_config
from repro_torch.core.faults import DeadlinePolicy, FaultModel
from repro_torch.core.hardware import make_heterogeneous_fleet
from repro_torch.core.scheduler import FleetLog, simulate_fleet
from repro_torch.launch import write_payload
from repro_torch.models.common import describe_device, resolve_device

SCHEMA = "torch-bench-churn/v1"
DEFAULT_JSON = "BENCH_torch_churn.json"

STRAGGLER_PROB = 0.2
OUTAGE_PROB = 0.05
QUORUM = 0.5


def _quorum_stats(log: FleetLog, quorum: float) -> Dict:
    """Per-round commit accounting from the participation mask."""
    active = log.fault_realization.active
    survivors = log.participation.sum(axis=1)
    members = active.sum(axis=1)
    needed = [max(1, math.ceil(quorum * m)) if m else 1 for m in members]
    committed = sum(int(s >= n) for s, n in zip(survivors, needed))
    rounds = log.delays.shape[0]
    return {
        "rounds": rounds,
        "committed_rounds": committed,
        "quorum_rate": committed / rounds,
        # expected rounds of wall time per committed round (inf-free: the
        # sweep caps dropout below 1, so commits always happen eventually)
        "rounds_per_commit": rounds / committed if committed else float(
            rounds),
    }


def run(*, devices: int = 1000, rounds: int = 10, seed: int = 0,
        dropout_rates=(0.0, 0.1, 0.2, 0.4), device=None) -> Dict:
    dev = resolve_device(device)
    cfg = get_config("llama32-1b")
    fleet = make_heterogeneous_fleet(devices, seed=seed)
    deadline = DeadlinePolicy(quantile=0.9)
    out: Dict = {"devices": devices, "rounds": rounds, "quorum": QUORUM,
                 "straggler_prob": STRAGGLER_PROB,
                 "outage_prob": OUTAGE_PROB,
                 "device": describe_device(dev), "sweep": []}
    worst_realization = None
    for rate in dropout_rates:
        fm = FaultModel(dropout_prob=rate, straggler_prob=STRAGGLER_PROB,
                        outage_prob=OUTAGE_PROB)
        kw = dict(rounds=rounds, devices=fleet, seed=seed, fault_model=fm,
                  deadline=deadline, device=dev)
        simulate_fleet(cfg, **kw)
        t0 = time.perf_counter()
        log = simulate_fleet(cfg, **kw)
        wall_s = time.perf_counter() - t0
        row = {"dropout_rate": rate, "wall_s": wall_s,
               "mean_delay_s": log.mean_delay(),
               "mean_energy_j": log.mean_energy(),
               "survivor_fraction": log.survivor_fraction(),
               "mean_round_close_s": float(log.round_close_s.mean())}
        row.update(_quorum_stats(log, QUORUM))
        out["sweep"].append(row)
        worst_realization = log.fault_realization
    # only the warm sweep is gated: the last rate's wall time
    out["gates"] = {f"churn_sweep_round_s_{devices}dev": wall_s}
    out["worst_case_realization"] = worst_realization.to_jsonable()
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small fleet, just prove the path runs")
    ap.add_argument("--json", nargs="?", const=DEFAULT_JSON, metavar="PATH",
                    help=f"write the payload (default path {DEFAULT_JSON})")
    ap.add_argument("--artifact", metavar="PATH",
                    help="write the heaviest sweep point's fault "
                         "realization here (bit-exact replay)")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    if args.smoke:
        res = run(devices=100, rounds=4, device=args.device)
    else:
        res = run(device=args.device)
    res["schema"] = SCHEMA
    res["mode"] = "smoke" if args.smoke else "full"
    artifact = res.pop("worst_case_realization")
    if args.artifact:
        with open(args.artifact, "w") as f:
            json.dump(artifact, f, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.artifact}")
    if args.json:
        write_payload(args.json, res)
    print(f"device: {res['device']}")
    print("dropout,survivors,quorum_rate,rounds_per_commit,"
          "mean_delay_s,mean_energy_j,wall_s")
    for row in res["sweep"]:
        print(f"{row['dropout_rate']},{row['survivor_fraction']:.3f},"
              f"{row['quorum_rate']:.2f},{row['rounds_per_commit']:.2f},"
              f"{row['mean_delay_s']:.3f},{row['mean_energy_j']:.3f},"
              f"{row['wall_s']:.4f}")
    return res


if __name__ == "__main__":
    main()
