"""Hand-written Hopper kernels and their plain PyTorch versions.

``lora_matmul``, ``flash_attention``, ``flash_decode`` and ``ssd_scan`` each
hold a wrapper (checks its arguments, refuses autograd, launches the CUDA
kernel on a CUDA tensor, uses the plain version only for a CPU tensor,
counts its launches)
and the plain version beside it;
``ops`` adapts them to the model's layouts; ``_build`` compiles and binds
``csrc/*.cu``. Nothing is built or loaded at import time.
"""
from __future__ import annotations

from typing import Dict, List

import torch


def refuse_autograd(name: str, *tensors) -> None:
    """Raise if autograd would record a call of kernel ``name``: a kernel
    writes its output through a raw launch, so the result carries no
    gradient, and the JAX package's Pallas kernels cannot be differentiated
    either. The same on every device, so a CPU run shows what the card
    does."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() on inputs "
            "that need no gradient; to train, take the plain path "
            "(attention impl='naive' or 'chunked', use_lora_kernel=False)")


def _wrappers():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ssd_scan as ssd
    return {"lora_matmul": lm.lora_matmul,
            "lora_matmul_grouped": lm.lora_matmul_grouped,
            "flash_attention": fa.flash_attention,
            "flash_decode": fd.flash_decode,
            "ssd_intra_chunk": ssd.ssd_intra_chunk}


# launches captured into CUDA graphs, and the runs their replays made
_captured: Dict[str, int] = {}
_replayed: Dict[str, int] = {}


def launch_counts() -> Dict[str, int]:
    """Kernel launches made by each wrapper since the last reset. A launch
    captured into a CUDA graph counts once, at capture."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def version_counts() -> Dict[str, Dict[str, int]]:
    """Launches since the last reset by version, for each wrapper that has
    more than one version (``<wrapper>.by_version``)."""
    return {name: dict(fn.by_version) for name, fn in _wrappers().items()
            if hasattr(fn, "by_version")}


def versions_since(before: Dict[str, Dict[str, int]]) -> Dict[str, List[str]]:
    """The versions each wrapper launched since ``before`` (a
    ``version_counts()``), for the wrappers that launched any."""
    out = {}
    for name, now in version_counts().items():
        ran = [v for v, n in now.items() if n != before[name].get(v, 0)]
        if ran:
            out[name] = ran
    return out


def note_graph_replays(captured: Dict[str, int], replays: int) -> None:
    """A CUDA graph holding ``captured[name]`` launches of each kernel was
    replayed ``replays`` times (the wrappers saw the capture only)."""
    for name, n in captured.items():
        _captured[name] = _captured.get(name, 0) + n
        _replayed[name] = _replayed.get(name, 0) + n * replays


def runs_on_card() -> Dict[str, int]:
    """Kernel runs the card made since the last reset: each wrapper's
    launches, with those captured into a graph replaced by its replays."""
    return {name: n - _captured.get(name, 0) + _replayed.get(name, 0)
            for name, n in launch_counts().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        for version in getattr(fn, "by_version", {}):
            fn.by_version[version] = 0
    _captured.clear()
    _replayed.clear()
