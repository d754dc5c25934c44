"""Fleet sweep on the port: CARD decisions for 1000 heterogeneous edge
devices at once.

    python -m repro_torch.launch.fleet_sweep [--smoke] [--device cpu]

The paper's target is "massive mobile devices"; the vectorized engine makes
that an interactive sweep rather than an overnight loop:

  1. build a 1000-device heterogeneous fleet (Table-I platforms, jittered
     DVFS clocks),
  2. draw every (round, device) channel state up front,
  3. run batched CARD (one argmin over the cost tensor on the card) per
     channel regime, and
  4. report cut mix, frequency spread, and exact parallel-SL round times.

The twin of the reference's ``examples/fleet_sweep.py`` (``--smoke``: 100
devices, 2 rounds). ``device=None`` is the GPU and raises without one.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs.base import get_config
from repro_torch.core.hardware import make_heterogeneous_fleet
from repro_torch.core.scheduler import parallel_round_stats, simulate_fleet
from repro_torch.models.common import describe_device, resolve_device


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="100 devices, 2 rounds a state")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_devices, rounds = (100, 2) if args.smoke else (1000, 5)
    cfg = get_config("llama32-1b")
    fleet = make_heterogeneous_fleet(n_devices, seed=0)
    print(f"== fleet of {len(fleet)} devices, {cfg.name}, {rounds} "
          f"rounds/state, on {describe_device(dev)} ==")
    for state in ("good", "normal", "poor"):
        log = simulate_fleet(cfg, channel_state=state, rounds=rounds,
                             devices=fleet, seed=0, device=dev)
        offload = float((log.cuts == 0).mean())
        local = float((log.cuts == cfg.n_layers).mean())
        stats = parallel_round_stats(log)
        print(f"  {state:>6}: full-offload {offload:5.1%}  "
              f"full-local {local:5.1%}  "
              f"f* {log.freqs.mean() / 1e9:.2f}±{log.freqs.std() / 1e9:.2f} GHz")
        print(f"          round delay {log.mean_delay():8.2f}s seq-equiv | "
              f"parallel-SL exact {stats['parallel_exact_s']:8.2f}s "
              f"(bounds [{stats['parallel_lower_s']:.2f}, "
              f"{stats['parallel_upper_s']:.2f}])")
        print(f"          server energy {log.mean_energy():8.1f} J/device-round")


if __name__ == "__main__":
    main()
