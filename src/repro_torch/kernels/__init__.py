"""Hand-written Hopper kernels and their plain PyTorch versions.

``lora_matmul`` and ``flash_attention`` each hold a wrapper (checks its
arguments, launches the CUDA kernel on a CUDA tensor, uses the plain version
only for a CPU tensor, counts its launches) and the plain version beside it;
``ops`` adapts them to the model's layouts; ``_build`` compiles and binds
``csrc/*.cu``. Nothing is built or loaded at import time.
"""
from __future__ import annotations

from typing import Dict


def _wrappers():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lora_matmul as lm
    return {"lora_matmul": lm.lora_matmul,
            "lora_matmul_grouped": lm.lora_matmul_grouped,
            "flash_attention": fa.flash_attention}


def launch_counts() -> Dict[str, int]:
    """Kernel launches made by each wrapper since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
