"""``python -m repro_torch`` — the command line of the port, the twin of the
reference's ``python -m repro``.

A thin argparse front-end over the decision stack; the heavy imports
(``torch``) are deferred into the subcommand handlers, so ``--help`` needs
neither a card nor PyTorch. ``sweep`` and ``hierarchy`` run on the GPU and
raise without one; ``--device cpu`` asks for the CPU.

Subcommands::

    python -m repro_torch archs                    # list the model registry
    python -m repro_torch sweep --devices 100      # vectorized fleet sweep
    python -m repro_torch hierarchy --servers 4    # multi-server tier sweep
"""
from __future__ import annotations

import argparse
import sys

_DEVICE_HELP = "default: the GPU (raises without one); 'cpu' for the CPU"


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description=("Energy-efficient split learning for LLM fine-tuning "
                     "in edge networks — CARD decision stack CLI."))
    sub = p.add_subparsers(dest="command")

    sub.add_parser("archs", help="list registered model architectures")

    sweep = sub.add_parser(
        "sweep", help="run a vectorized fleet sweep (simulate_fleet)")
    sweep.add_argument("--arch", default="llama32-1b",
                       help="model architecture id (see `archs`)")
    sweep.add_argument("--policy", default="card",
                       choices=("card", "server_only", "device_only",
                                "random", "static"),
                       help="cut/frequency policy")
    sweep.add_argument("--rounds", type=int, default=10)
    sweep.add_argument("--devices", type=int, default=100,
                       help="fleet size (heterogeneous, seeded)")
    sweep.add_argument("--channel", default="normal",
                       help="channel state (e.g. good / normal / poor)")
    sweep.add_argument("--seed", type=int, default=0)
    sweep.add_argument("--shards", type=int, default=0,
                       help="cut the devices axis into N chunks of a "
                            "FleetMesh, one card each where there are N "
                            "(0 = unsharded)")
    sweep.add_argument("--device", default=None, help=_DEVICE_HELP)

    hier = sub.add_parser(
        "hierarchy",
        help="run a multi-server tier sweep (simulate_hierarchical_fleet)")
    hier.add_argument("--arch", default="llama32-1b")
    hier.add_argument("--servers", type=int, default=2)
    hier.add_argument("--capacity", type=int, default=0,
                      help="per-server device capacity (0 = fleet/servers, "
                           "rounded up)")
    hier.add_argument("--rounds", type=int, default=10)
    hier.add_argument("--devices", type=int, default=100)
    hier.add_argument("--channel", default="normal")
    hier.add_argument("--seed", type=int, default=0)
    hier.add_argument("--assign", default="greedy",
                      choices=("greedy", "optimal"))
    hier.add_argument("--device", default=None, help=_DEVICE_HELP)
    return p


def _cmd_archs() -> int:
    from repro_torch.configs.base import ARCH_IDS, get_config
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        print(f"{arch:24s} {cfg.family:8s} {cfg.n_layers:3d} layers  "
              f"d_model={cfg.d_model}")
    return 0


def _cmd_sweep(args: argparse.Namespace) -> int:
    from repro_torch.configs.base import get_config
    from repro_torch.core.hardware import make_heterogeneous_fleet
    from repro_torch.core.scheduler import simulate_fleet

    mesh = None
    if args.shards:
        from repro_torch.launch.mesh import make_fleet_mesh
        mesh = make_fleet_mesh(args.shards, device=args.device)
    fleet = make_heterogeneous_fleet(args.devices, seed=args.seed)
    log = simulate_fleet(get_config(args.arch), policy=args.policy,
                         rounds=args.rounds, devices=fleet,
                         channel_state=args.channel, seed=args.seed,
                         mesh=mesh, device=args.device)
    print(f"policy={log.policy} arch={args.arch} "
          f"rounds={args.rounds} devices={args.devices}"
          + (f" shards={args.shards}" if args.shards else ""))
    print(f"mean delay   {log.mean_delay():12.3f} s")
    print(f"mean energy  {log.mean_energy():12.3f} J")
    return 0


def _cmd_hierarchy(args: argparse.Namespace) -> int:
    from repro_torch.configs.base import get_config
    from repro_torch.core.hardware import (make_heterogeneous_fleet,
                                           make_server_tier)
    from repro_torch.core.scheduler import simulate_hierarchical_fleet

    capacity = args.capacity or -(-args.devices // args.servers)
    tier = make_server_tier(args.servers, capacity=capacity, seed=args.seed)
    fleet = make_heterogeneous_fleet(args.devices, seed=args.seed)
    hlog = simulate_hierarchical_fleet(
        get_config(args.arch), tier=tier, rounds=args.rounds, devices=fleet,
        channel_state=args.channel, seed=args.seed, assign=args.assign,
        device=args.device)
    print(f"servers={args.servers} capacity={capacity} "
          f"devices={args.devices} rounds={args.rounds} "
          f"assign={args.assign}")
    print(f"mean round   {hlog.mean_round_s():12.3f} s")
    print(f"mean delay   {hlog.mean_delay():12.3f} s")
    print(f"mean energy  {hlog.mean_energy():12.3f} J")
    return 0


def main(argv=None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 0
    if args.command == "archs":
        return _cmd_archs()
    if args.command == "sweep":
        return _cmd_sweep(args)
    return _cmd_hierarchy(args)


if __name__ == "__main__":
    sys.exit(main())
