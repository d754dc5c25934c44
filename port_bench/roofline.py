"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit), copied from the port's ``core/hardware.py`` so
that the yardstick cannot move with the program, and the bound of a piece
of work on them."""
from __future__ import annotations

import subprocess
from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
#: FLOP/s by operand type: bf16 on the tensor cores, f32 on the CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(flops: float, bytes_moved: float, dtype: str = "bfloat16"
            ) -> Tuple[float, str]:
    """(least seconds one H100 could take, "operations" | "bytes")."""
    compute = flops / PEAK_FLOPS[dtype]
    memory = bytes_moved / HBM_BYTES_PER_S
    return (compute, "operations") if compute >= memory else (memory, "bytes")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them
    ("" where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.splitlines()[0] if out else ""
