"""End-to-end run on the port: the paper's full experiment — 5
heterogeneous Jetson devices + 1 server, CARD vs the two baselines, real
split LoRA fine-tuning for a few hundred device-rounds, plus the Fig. 4
decision-level comparison on the full-size model.

    python -m repro_torch.launch.edge_finetune [--rounds 20] [--policy card]
        [--channel normal] [--smoke] [--device cpu]

The twin of the reference's ``examples/edge_finetune.py`` (``--smoke``: 4
pre-training steps and 2 rounds). ``device=None`` is the GPU and raises
without one.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.core.channel import WirelessChannel
from repro_torch.core.hardware import EDGE_FLEET, SERVER_RTX4060TI, SimParams
from repro_torch.core.protocol import SplitFineTuner
from repro_torch.core.scheduler import simulate_fleet
from repro_torch.data import make_fleet_datasets
from repro_torch.launch.train import run_training
from repro_torch.models import model as M
from repro_torch.models.common import describe_device, resolve_device
from repro_torch.optim import adamw, warmup_cosine

POLICIES = ("card", "server_only", "device_only")


def decision_comparison(channel: str = "normal", *, rounds: int = 30,
                        device=None) -> Dict[str, Tuple[float, float]]:
    """The paper's Fig. 4 at the decision level on the full-size
    llama32-1b: ``{policy: (mean delay s, mean energy J)}``."""
    full = get_config("llama32-1b")
    out = {}
    for policy in POLICIES:
        log = simulate_fleet(full, policy=policy, channel_state=channel,
                             rounds=rounds, device=device)
        out[policy] = (log.mean_delay(), log.mean_energy())
        print(f"  {policy:12s} delay {out[policy][0]:8.2f}s   "
              f"energy {out[policy][1]:9.1f}J")
    return out


def run(*, rounds: int = 20, policy: str = "card", channel: str = "normal",
        pretrain_steps: int = 100, device=None) -> Dict:
    dev = resolve_device(device)
    print(f"== pre-train backbone on {describe_device(dev)} ==")
    pre = run_training(arch="llama32-1b", steps=0,
                       pretrain_steps=pretrain_steps, batch=8, seq_len=64,
                       log_every=0, device=dev)
    cfg, frozen = pre["cfg"], pre["frozen"]

    print(f"== split fine-tuning: 5 devices, policy={policy}, "
          f"channel={channel}, {rounds} rounds ==")
    sim = SimParams(local_epochs=2, mini_batch=8, seq_len=64)
    lora = M.init_params(2, cfg, dev)["lora"]
    total_steps = rounds * len(EDGE_FLEET) * sim.local_epochs
    ft = SplitFineTuner(
        cfg, frozen, lora, adamw(warmup_cosine(3e-3, 20, total_steps)),
        cost_cfg=get_config("llama32-1b"),
        devices=list(EDGE_FLEET), server=SERVER_RTX4060TI,
        channels=[WirelessChannel(channel, seed=11 * i)
                  for i in range(len(EDGE_FLEET))],
        datasets=make_fleet_datasets(cfg, len(EDGE_FLEET),
                                     vocab=cfg.vocab_size, seed=3),
        sim=sim, policy=policy)
    res = ft.run(rounds)

    losses = res.losses()
    print(f"loss: first5={np.mean(losses[:5]):.3f}  "
          f"last5={np.mean(losses[-5:]):.3f}")
    print(f"simulated: mean delay {res.mean_delay():.2f}s  "
          f"mean server energy {res.mean_energy():.1f}J")
    per_dev: Dict[str, list] = {}
    for log in res.logs:
        per_dev.setdefault(log.device, []).append(log.cut)
    for name, cuts in per_dev.items():
        print(f"  {name}: cuts {sorted(set(cuts))} "
              f"(offload frac {np.mean(np.array(cuts) == 0):.2f})")

    print("== decision-level comparison (paper Fig. 4, full-size model) ==")
    fig4 = decision_comparison(channel, rounds=30, device=dev)
    return {"losses": losses, "cuts": per_dev,
            "mean_delay_s": res.mean_delay(),
            "mean_energy_j": res.mean_energy(), "fig4": fig4}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--policy", default="card", choices=list(POLICIES))
    p.add_argument("--channel", default="normal",
                   choices=["good", "normal", "poor"])
    p.add_argument("--smoke", action="store_true",
                   help="4 pre-training steps and 2 rounds")
    p.add_argument("--device", default=None,
                   help="default: the GPU (raises without one)")
    args = p.parse_args(argv)
    return run(rounds=2 if args.smoke else args.rounds, policy=args.policy,
               channel=args.channel,
               pretrain_steps=4 if args.smoke else 100, device=args.device)


if __name__ == "__main__":
    main()
