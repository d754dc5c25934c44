"""The fleet mesh: how ``simulate_fleet(..., mesh=...)`` cuts the devices axis.

The reference shards a fleet sweep's devices axis over a 1-D ``("data",)``
JAX mesh (``make_fleet_mesh``) and runs one ``shard_map`` call. Here a
:class:`FleetMesh` names ``n_shards`` chunks of that axis and the card each
chunk runs on: on one GPU the chunks run one after another on it, which
bounds the memory of the ``(rounds, devices, cuts)`` grid by one chunk's;
with several cards, shard ``i`` goes to card ``i mod count``. No lane of the
grid reads another, so the result is the unsharded engine's, bit for bit.

The reference's model meshes (``make_production_mesh`` and the rest) lower
onto a TPU mesh and are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.models.common import resolve_device


@dataclass(frozen=True)
class FleetMesh:
    """``n_shards`` chunks of a fleet's devices axis; ``devices[i]`` is the
    torch device that runs chunk ``i``."""
    n_shards: int
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if self.n_shards < 1 or len(self.devices) != self.n_shards:
            raise ValueError(f"a fleet mesh needs n_shards >= 1 devices, got "
                             f"{self.n_shards} shards on {self.devices}")


def make_fleet_mesh(n_shards: int = 0, *, device=None) -> FleetMesh:
    """A mesh of ``n_shards`` chunks over the visible cards (``device=None``:
    the GPU, raising without one; ``device="cpu"``: every chunk on the CPU).
    ``n_shards=0`` means one shard per visible card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        cards = [dev]
    if n_shards <= 0:
        n_shards = len(cards)
    return FleetMesh(n_shards=n_shards,
                     devices=tuple(cards[i % len(cards)]
                                   for i in range(n_shards)))
