"""Step analysis: FLOPs, HBM bytes, peak memory and roofline terms of one
traced call, against one NVIDIA H100's published peaks.

The counterpart of the JAX package's ``launch/analysis.py``, which reads
XLA's ``compiled.cost_analysis()`` / ``memory_analysis()`` and parses the
compiled HLO text for collectives. PyTorch has no compiled artifact for an
eager step, so ``analyze_step`` runs the step once (on ``meta`` tensors for
the dry run: shapes only, nothing allocated) and counts its aten ops:

  * FLOPs by ``torch.utils.flop_counter.FlopCounterMode``: matrix products,
    convolutions and attention products only. XLA's ``flops`` also counts
    elementwise ops, so the two differ by the step's elementwise work; the
    dot products, which set the compute term, are the same.
  * HBM bytes by a dispatch mode that sums the bytes of the tensor inputs
    and outputs of every aten op that is not a view. In eager mode each such
    op is one kernel that reads its inputs and writes its outputs; an op
    whose schema returns an alias of an input without writing it (a view)
    moves nothing, and neither does an ``empty`` (an allocation, no kernel).
  * Peak live bytes in the same mode: every storage is tracked from the op
    that creates it until it is freed (a weakref callback), the arguments
    are live from the start, and what autograd saves for the backward is
    live while autograd holds it. ``temp_bytes`` is the peak less the
    argument bytes. The caching allocator's rounding and the temporaries a
    kernel allocates inside one op are not seen.

Collectives (the counterpart of ``parse_collectives``, which reads XLA's
HLO text). A sharded step runs on one rank of a ``LiveMesh``
(``launch/mesh.py``) whose collectives are ``torch.distributed`` calls; each
reaches the dispatcher as a ``c10d`` op (``allreduce_``, ``allgather_``,
``alltoall_base_``, ...), also on ``meta`` tensors over a ``fake`` process
group, where no byte moves. ``StepCounter`` counts them by the reference's
``COLLECTIVE_KINDS`` and its convention: the bytes of each op's result on
this device, so an all-gather counts the group's size times its input, an
all-reduce and an all-to-all their input. A collective's bytes go to the
collective term only: they are not added to the HBM bytes (the reduction
an all-reduce makes on the card is the transport's, not a kernel the step
launches). ``analyze_sharded_step`` is ``analyze_compiled``'s counterpart
for one rank: its roofline's collective term is those bytes over the
H100's NVLink (``H100_NVLINK_BYTES_PER_S`` x ``H100_NVLINK_LINKS``).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.hardware import (H100_HBM_BYTES_PER_S,
                                       H100_NVLINK_BYTES_PER_S,
                                       H100_NVLINK_LINKS, H100_PEAK_FLOPS)

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

#: allocations: an output, but no kernel that writes it
_NO_KERNEL = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
              torch.ops.aten.empty_like, torch.ops.aten.new_empty,
              torch.ops.aten.new_empty_strided}


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def summary(self) -> str:
        parts = [f"{k}: n={self.counts.get(k, 0)} "
                 f"{self.bytes_by_kind.get(k, 0) / 1e9:.3f} GB"
                 for k in COLLECTIVE_KINDS if self.counts.get(k)]
        return "; ".join(parts) if parts else "none"


@dataclass
class Roofline:
    """Per-device roofline terms, seconds, on one H100 SXM."""
    flops: float                 # FlopCounterMode FLOPs (per device)
    hbm_bytes: float             # bytes the step's kernels move (per device)
    collective_bytes: float      # per device
    chips: int
    ici_links: int = H100_NVLINK_LINKS   # NVLink 4 links of one H100 SXM

    @property
    def compute_s(self) -> float:
        return self.flops / H100_PEAK_FLOPS["bfloat16"]

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / H100_HBM_BYTES_PER_S

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (H100_NVLINK_BYTES_PER_S
                                        * self.ici_links)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
        }


def model_flops(cfg, tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params."""
    n = cfg.active_params()
    factor = 6.0 if kind == "train" else 2.0
    return factor * n * tokens


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    """An op whose every output aliases an input and writes none of them."""
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write for r in rets)


#: the c10d ops ``LiveMesh``'s collectives reach, by the reference's kind
_COLLECTIVE_OPS = {"allreduce_": "all-reduce", "allgather_": "all-gather",
                   "alltoall_base_": "all-to-all"}


def _collective_kind(func):
    """The reference's kind of a c10d op, else None (not a c10d op). A c10d
    op this table does not hold raises: its bytes would go uncounted."""
    if func.namespace != "c10d":
        return None
    name = func._schema.name.split("::")[-1]
    if name not in _COLLECTIVE_OPS:
        raise NotImplementedError(f"StepCounter does not count c10d.{name}")
    return _COLLECTIVE_OPS[name]


class StepCounter(TorchDispatchMode):
    """HBM bytes, live / peak storage bytes and collectives of the aten ops
    run under it. ``track`` registers a tensor's storage as live (the
    arguments, before the step); every op's outputs are registered as they
    are made. ``collectives`` holds the c10d ops' counts and result bytes
    by kind (module docstring), none of them in ``hbm_bytes``."""

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.collectives = CollectiveStats()
        self._sizes: Dict[int, int] = {}       # storage key -> bytes
        self._refs: Dict[int, weakref.ref] = {}

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self._refs[key] = weakref.ref(st, lambda _r, k=key: self._free(k))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._sizes.pop(key)
        del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = _collective_kind(func)
        if kind is not None:
            stats = self.collectives
            stats.counts[kind] = stats.counts.get(kind, 0) + 1
            # the result is written into the first argument: the tensors of
            # an all-reduce in place, the output list of an all-gather, the
            # output of an all-to-all
            stats.bytes_by_kind[kind] = (stats.bytes_by_kind.get(kind, 0)
                                         + sum(map(_nbytes,
                                                   _tensors(args[0]))))
            return out
        outs = _tensors(out)
        if not _is_view(func):
            if func._overloadpacket not in _NO_KERNEL:
                self.hbm_bytes += sum(map(_nbytes, _tensors((args, kwargs))))
                self.hbm_bytes += sum(map(_nbytes, outs))
            for t in outs:
                self.track(t)
        return out


def analyze_step(fn: Callable, *args: Any, chips: int = 1
                 ) -> Tuple[Roofline, CollectiveStats, Dict]:
    """Run ``fn(*args)`` once under the counters; returns (roofline,
    collectives, memory). ``memory`` has the reference's keys
    (``argument_bytes``, ``output_bytes``, ``temp_bytes``,
    ``generated_code_bytes``: None, an eager step has no compiled code)
    plus ``peak_bytes``, the most bytes live at once, arguments included."""
    arg_tensors = _tensors(args)
    counter = StepCounter()
    for t in arg_tensors:
        counter.track(t)
    argument_bytes = counter.live_bytes
    with FlopCounterMode(display=False) as flops, counter:
        out = fn(*args)
    seen = set()
    output_bytes = 0
    for t in _tensors(out):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            output_bytes += st.nbytes()
    coll = counter.collectives
    roof = Roofline(flops=float(flops.get_total_flops()),
                    hbm_bytes=float(counter.hbm_bytes),
                    collective_bytes=float(coll.total_bytes), chips=chips)
    mem = {"argument_bytes": argument_bytes, "output_bytes": output_bytes,
           "temp_bytes": counter.peak_bytes - argument_bytes,
           "generated_code_bytes": None, "peak_bytes": counter.peak_bytes}
    return roof, coll, mem


def analyze_sharded_step(fn: Callable, *args: Any, mesh
                         ) -> Tuple[Roofline, CollectiveStats, Dict]:
    """``analyze_step`` of ``fn(*args)`` on this rank of ``mesh`` (a
    ``LiveMesh``: a live process group, or a ``fake`` one on ``meta``), run
    under ``shardctx.mesh_ctx(mesh)``; ``args`` are the rank's own
    (``sharding.shard_params``: its blocks of the parameters and, for a
    decode step, of the cache under ``sharding.cache_specs``, which the
    step updates in place and the memory counts as an argument). The counterpart of the reference's
    ``analyze_compiled`` for one device: FLOPs, HBM bytes and peak bytes of
    this rank, and the collectives it takes part in (module docstring)."""
    from repro_torch import shardctx

    def step(*a):
        with shardctx.mesh_ctx(mesh):
            return fn(*a)
    return analyze_step(step, *args, chips=mesh.size)
