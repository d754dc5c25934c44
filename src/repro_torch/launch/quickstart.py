"""Quickstart on the port: split LoRA fine-tuning of a tiny LLaMA on one
device pair.

    python -m repro_torch.launch.quickstart [--smoke] [--device cpu]

Walks the paper's loop end to end:
  1. "pre-train" a tiny backbone (stands in for the pre-trained LLM),
  2. CARD picks (cut layer, server frequency) from a live channel draw,
  3. run split fine-tuning (device stage | compressed channel | server
     stage) for a few rounds and watch the loss drop.

The twin of the reference's ``examples/quickstart.py`` (``--smoke``: 4
pre-training steps and 2 rounds). ``device=None`` is the GPU and raises
without one.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from repro_torch.configs.base import get_config
from repro_torch.core.card import card
from repro_torch.core.channel import WirelessChannel
from repro_torch.core.cost_model import RoundContext, Workload
from repro_torch.core.hardware import EDGE_FLEET, SERVER_RTX4060TI, SimParams
from repro_torch.core.protocol import SplitFineTuner
from repro_torch.data import make_fleet_datasets
from repro_torch.launch.train import run_training
from repro_torch.models import model as M
from repro_torch.models.common import describe_device, resolve_device
from repro_torch.optim import adamw, constant_schedule


def run(*, pretrain_steps: int = 80, rounds: int = 6, device=None) -> Dict:
    dev = resolve_device(device)
    print(f"== 1. pre-train a tiny backbone (the 'pre-trained LLM') on "
          f"{describe_device(dev)} ==")
    pre = run_training(arch="llama32-1b", steps=0,
                       pretrain_steps=pretrain_steps, batch=8, seq_len=64,
                       log_every=0, device=dev)
    cfg, frozen = pre["cfg"], pre["frozen"]
    print(f"   backbone loss after pretraining: {pre['pretrain_loss']:.3f}")

    print("== 2. CARD decision for device1 under a 'normal' channel ==")
    sim = SimParams(local_epochs=2, mini_batch=8, seq_len=64)
    ctx = RoundContext(
        workload=Workload(get_config("llama32-1b"), sim.mini_batch,
                          sim.seq_len),
        device=EDGE_FLEET[0], server=SERVER_RTX4060TI,
        channel=WirelessChannel("normal", seed=0).draw(), sim=sim)
    d = card(ctx)
    print(f"   cut={d.cut}  f*={d.frequency / 1e9:.2f} GHz  "
          f"delay={d.delay:.2f}s  server energy={d.energy:.1f}J")

    print(f"== 3. split fine-tuning, 2 devices x {rounds} rounds ==")
    lora = M.init_params(1, cfg, dev)["lora"]
    ft = SplitFineTuner(
        cfg, frozen, lora, adamw(constant_schedule(3e-3)),
        cost_cfg=get_config("llama32-1b"),
        devices=list(EDGE_FLEET[:2]), server=SERVER_RTX4060TI,
        channels=[WirelessChannel("normal", seed=i) for i in range(2)],
        datasets=make_fleet_datasets(cfg, 2, vocab=cfg.vocab_size, seed=1),
        sim=sim, policy="card")
    res = ft.run(rounds)
    losses = res.losses()
    print(f"   loss: {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} device-rounds")
    print(f"   simulated mean delay {res.mean_delay():.2f}s, "
          f"server energy {res.mean_energy():.1f}J")
    cuts = sorted({log.cut for log in res.logs})
    print("   cuts chosen:", cuts)
    return {"decision": d, "pretrain_loss": pre["pretrain_loss"],
            "losses": losses, "cuts": cuts,
            "mean_delay_s": res.mean_delay(),
            "mean_energy_j": res.mean_energy()}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="4 pre-training steps, 2 rounds")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    if args.smoke:
        return run(pretrain_steps=4, rounds=2, device=args.device)
    return run(device=args.device)


if __name__ == "__main__":
    main()
