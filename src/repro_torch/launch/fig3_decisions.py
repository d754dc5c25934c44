"""Paper Fig. 3 on the port: optimal cut layer (a) and server frequency (b)
per device across training rounds, under the dynamic wireless channel —
plus the decision-divergence report (``run_divergence``): where
kernel-measured per-layer latencies move the optimal (cut, f) vs the
paper's analytic FLOP constants.

    python -m repro_torch.launch.fig3_decisions [--divergence] [--smoke]
                                                [--json [PATH]] [--device cpu]

The twin of the reference's ``benchmarks/fig3_decisions.py``.
``run_divergence`` takes a ``RooflineFit`` or the calibrate phase's
per-architecture ``LatencyTable``s (``launch/calibrate.py::run``); given
neither, it fits fresh smoke probes on the device. It reads no committed
file. Nothing is written unless ``--json`` (default path
``BENCH_torch_fig3_decisions.json``); ``device=None`` is the GPU and raises
without one.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.core.measured_cost import (LatencyTable, RooflineFit,
                                            fit_roofline, probe_kernels)
from repro_torch.core.scheduler import simulate_fleet
from repro_torch.launch import write_payload
from repro_torch.models.common import describe_device, resolve_device

SCHEMA = "torch-fig3-decisions/v1"
DEFAULT_JSON = "BENCH_torch_fig3_decisions.json"


def run(rounds: int = 50, channel_state: str = "normal", seed: int = 0, *,
        device=None) -> Dict:
    dev = resolve_device(device)
    cfg = get_config("llama32-1b")
    log = simulate_fleet(cfg, policy="card", channel_state=channel_state,
                         rounds=rounds, seed=seed, respect_memory=False,
                         device=dev)
    out = {"rounds": rounds, "devices": log.device_names,
           "device": describe_device(dev)}
    cut_summary = {}
    freq_summary = {}
    for m, name in enumerate(log.device_names):
        cuts = log.cuts[:, m]
        cut_summary[name] = {
            "frac_full_offload": float((cuts == 0).mean()),     # c = 0
            "frac_full_local": float((cuts == cfg.n_layers).mean()),
            "endpoints_only": bool(np.isin(cuts, [0, cfg.n_layers]).all()),
        }
        freq_summary[name] = {
            "mean_ghz": float(log.freqs[:, m].mean() / 1e9),
            "std_ghz": float(log.freqs[:, m].std() / 1e9),
        }
    out["cuts"] = cut_summary
    out["freqs"] = freq_summary
    # paper finding 1: optimal cut is bimodal {0, I}
    out["bimodal"] = all(v["endpoints_only"] for v in cut_summary.values())
    # paper finding 2: weaker devices offload more (cut -> 0 down the fleet)
    offload = [cut_summary[n]["frac_full_offload"] for n in log.device_names]
    out["offload_monotone_with_weakness"] = bool(
        all(b >= a - 1e-9
            for a, b in zip(offload, offload[1:], strict=False)))
    return out


# ---------------------------------------------------------------------------
# Decision divergence: measured latency table vs analytic constants
# ---------------------------------------------------------------------------


def run_divergence(rounds: int = 20, *, seed: int = 0,
                   archs: Sequence[str] = ("llama32-1b", "qwen3-4b",
                                           "granite-moe-3b-a800m"),
                   channel_states: Sequence[str] = ("good", "normal", "poor"),
                   fit: Optional[RooflineFit] = None,
                   tables: Optional[Mapping[str, LatencyTable]] = None,
                   device=None) -> Dict:
    """Where do measured latencies move CARD's decisions?

    For every (arch, channel state), run the same fleet/channel realizations
    through ``cost_source="analytic"`` and ``cost_source="measured"`` and
    compare the per-(round, device) (cut, f) decisions. The measured side
    reads ``tables[arch]`` if given, else a table built from ``fit``, else
    from a fit of fresh smoke probes on ``device``."""
    dev = resolve_device(device)
    if tables is None and fit is None:
        fit = fit_roofline(probe_kernels(mode="smoke", device=dev))
    out: Dict = {"fit": fit.to_dict() if fit is not None else None,
                 "table_source": "tables" if tables is not None else "fit",
                 "cells": [], "rounds": rounds,
                 "device": describe_device(dev)}
    moved_total = 0
    n_total = 0
    for arch in archs:
        cfg = get_config(arch)
        table = (tables[arch] if tables is not None
                 else LatencyTable.from_fit(cfg, fit, batch=4, seq_len=512))
        for state in channel_states:
            kw = dict(channel_state=state, rounds=rounds, seed=seed,
                      respect_memory=False, device=dev)
            a = simulate_fleet(cfg, **kw)
            m = simulate_fleet(cfg, cost_source="measured",
                               latency_table=table, **kw)
            moved = a.cuts != m.cuts
            moved_total += int(moved.sum())
            n_total += moved.size
            out["cells"].append({
                "arch": arch, "channel_state": state,
                "frac_decisions_moved": float(moved.mean()),
                "mean_cut_analytic": float(a.cuts.mean()),
                "mean_cut_measured": float(m.cuts.mean()),
                "mean_abs_cut_shift": float(np.abs(m.cuts.astype(int)
                                                   - a.cuts).mean()),
                "mean_freq_shift_ghz": float((m.freqs - a.freqs).mean()
                                             / 1e9),
                "mean_delay_ratio": float(m.delays.mean()
                                          / max(a.delays.mean(), 1e-30)),
            })
    out["frac_decisions_moved_overall"] = (moved_total / n_total
                                           if n_total else 0.0)
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--divergence", action="store_true",
                    help="analytic-vs-measured decision divergence report "
                         "(fits fresh smoke probes on the device)")
    ap.add_argument("--smoke", action="store_true",
                    help="4 rounds")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--json", nargs="?", const=DEFAULT_JSON, metavar="PATH",
                    help=f"write the payload (default path {DEFAULT_JSON})")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    rounds = args.rounds or (4 if args.smoke else None)
    if args.divergence:
        res = run_divergence(**({"rounds": rounds} if rounds else {}),
                             device=args.device)
    else:
        res = run(**({"rounds": rounds} if rounds else {}),
                  device=args.device)
    res["schema"] = SCHEMA
    res["mode"] = "smoke" if args.smoke else "full"
    if args.json:
        write_payload(args.json, res)
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
