"""Meshes: the model meshes of the sharding layer, and the fleet mesh.

Model meshes. The reference names two production meshes of TPU chips:
one pod, ``(16, 16)`` over ``("data", "model")``, and two pods, ``(2, 16,
16)`` over ``("pod", "data", "model")``, where ``"pod"`` is data-parallel
across pods. Here a mesh comes in two kinds:

  * :class:`AbstractMesh`: the shape and the axis names, no device and no
    process group. The sharding rules (``launch/sharding.py``) and the
    per-chip accounting of the dry run read nothing else.
  * :class:`LiveMesh`: the same, seen from one rank of an initialised
    ``torch.distributed`` process group of exactly ``prod(shape)`` ranks:
    this rank's coordinates, its torch device, and a process group for each
    axis group the expert-parallel MoE reduces over (the data-parallel
    axes, ``"model"``, and both). Ranks lie on the mesh in row-major order,
    as devices do on ``jax.make_mesh``'s.

``spawn_mesh`` starts one process a rank and calls a function with each
rank's ``LiveMesh``: the counterpart of ``jax.make_mesh`` over forced host
devices. Several ranks may share one card; ``gloo`` then carries the
collectives (NCCL refuses two ranks on one device).

The fleet mesh. The reference shards a fleet sweep's devices axis over a
1-D ``("data",)`` JAX mesh (``make_fleet_mesh``) and runs one ``shard_map``
call. Here a :class:`FleetMesh` names ``n_shards`` chunks of that axis and
the card each chunk runs on: on one GPU the chunks run one after another on
it, which bounds the memory of the ``(rounds, devices, cuts)`` grid by one
chunk's; with several cards, shard ``i`` goes to card ``i mod count``. No
lane of the grid reads another, so the result is the unsharded engine's,
bit for bit.
"""
from __future__ import annotations

import math
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.models.common import resolve_device

Axes = Union[str, Sequence[str], None]

DP_AXES = ("pod", "data")
_POLL_S = 0.2          # spawn_mesh's wait between looks at the ranks


def _as_axes(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names, no device: ``.shape`` maps each name
    to its size, in axis order (as ``jax``'s ``mesh.shape``)."""
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names) \
                or len(set(self.axis_names)) != len(self.axis_names) \
                or any(int(s) < 1 for s in self.sizes):
            raise ValueError(f"a mesh needs one size >= 1 for each distinct "
                             f"axis name, got {self.sizes} over "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def axis_size(self, axes: Axes) -> int:
        """Product of the sizes of ``axes`` (1 for none)."""
        return math.prod(self.shape[a] for a in _as_axes(axes))


@dataclass(frozen=True, eq=False)
class LiveMesh(AbstractMesh):
    """One rank's view of a mesh over an initialised process group.

    ``groups`` maps an axis tuple to the process group of the ranks that
    differ from this one on those axes only (``None`` where the tuple's
    size is 1: every collective over it is the identity). Autograd runs
    through the collectives below as JAX's transposes run through
    ``all_to_all``/``psum``: the backward of a sum over ranks is the same
    sum, of an exchange the same exchange (``torch.distributed.nn.
    functional``'s rules, which torch 2.13 deprecates, written out here).
    """
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: str = "gloo"
    groups: Optional[Dict[Tuple[str, ...], Any]] = None

    @classmethod
    def build(cls, shape, axes, device) -> "LiveMesh":
        """This rank's mesh over the initialised default group, on its
        backend: every rank creates every axis group, in the same order
        (``dist.new_group`` is collective), and keeps its own."""
        import itertools

        import torch.distributed as dist
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        world, rank = dist.get_world_size(), dist.get_rank()
        if world != math.prod(shape):
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                             f"the process group has {world}")
        dp = tuple(a for a in axes if a in DP_AXES)
        wanted = [dp, tuple(a for a in axes if a == "model"),
                  tuple(a for a in axes if a in DP_AXES + ("model",))]
        groups: Dict[Tuple[str, ...], Any] = {}
        strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
        for key in wanted:
            if key in groups or math.prod(shape[axes.index(a)]
                                          for a in key) == 1:
                continue
            if len(key) == len(axes):
                groups[key] = dist.group.WORLD
                continue
            inner = [axes.index(a) for a in key]
            outer = [i for i in range(len(axes)) if i not in inner]
            for fixed in itertools.product(*(range(shape[i]) for i in outer)):
                base = sum(c * strides[i] for c, i in zip(fixed, outer))
                ranks = sorted(
                    base + sum(c * strides[i] for c, i in zip(free, inner))
                    for free in itertools.product(*(range(shape[i])
                                                    for i in inner)))
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[key] = group
        return cls(sizes=shape, axis_names=axes, rank=rank, device=device,
                   backend=dist.get_backend(), groups=groups)

    @property
    def coords(self) -> Dict[str, int]:
        out, r = {}, self.rank
        for name, size in reversed(tuple(self.shape.items())):
            out[name] = r % size
            r //= size
        return {a: out[a] for a in self.axis_names}

    @property
    def transport(self) -> str:
        """How a collective's buffers travel: ``gloo`` takes CUDA tensors and
        copies them through host memory itself (checked on the H100 with
        torch 2.11: ``all_to_all_single``, ``all_reduce`` and
        ``all_gather``); NCCL moves them card to card."""
        if self.backend == "nccl":
            return "nccl: card to card"
        if self.device.type == "cuda":
            return "gloo: cuda tensors, gloo copies them through host memory"
        return "gloo: host tensors"

    def axis_index(self, axes: Axes) -> int:
        """This rank's row-major coordinate over ``axes``, in their order
        (the block a dim split over ``axes`` gives this rank)."""
        idx, coords = 0, self.coords
        for a in _as_axes(axes):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def group(self, axes: Axes):
        axes = _as_axes(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        if key != axes:
            raise ValueError(f"axes {axes} must be mesh axes in mesh order "
                             f"{self.axis_names}")
        if self.axis_size(axes) == 1:
            return None
        if key not in self.groups:
            raise ValueError(f"no process group over {key}: a live mesh holds "
                             f"groups over {tuple(self.groups)}")
        return self.groups[key]

    # ---- collectives (autograd-aware) ------------------------------------

    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Sum over the ranks of ``axes``; its backward is the same sum."""
        group = self.group(axes)
        return x if group is None else _AllReduce.apply(x, group)

    def all_to_all(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``jax.lax.all_to_all(x, axes, 0, 0, tiled=True)``: block ``j`` of
        dim 0 goes to the rank with coordinate ``j`` over ``axes``, and
        block ``i`` of the result came from the rank with coordinate ``i``;
        its backward is the same exchange."""
        group = self.group(axes)
        return x if group is None else _AllToAll.apply(x, group)

    def enter(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """A ``shard_map`` input: ``x`` is the global value, the same on
        every rank; the result is this rank's block of dim 0 over ``axes``.
        Backward (shard_map's transpose): the blocks' cotangents gathered
        over ``axes`` and summed over the mesh's other axes."""
        return _Enter.apply(x, self, _as_axes(axes))

    def leave(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """A ``shard_map`` output: the blocks of dim 0 over ``axes`` gathered
        into the global value on every rank (``axes=()``: ``x`` is already
        the same on every rank). Backward: this rank's block of the
        cotangent over the size of the other axes, which the value is
        replicated over (shard_map's transpose of an unmentioned axis)."""
        return _Leave.apply(x, self, _as_axes(axes))

    # ---- resharding between enter and leave ------------------------------
    #
    # Between ``enter`` and ``leave`` a value is either split over some axes
    # (each rank holds its block, and its cotangent is that block's) or
    # replicated over them. The cotangent of a replicated value is held as
    # partial sums: the true cotangent is the sum over its replicas of what
    # each rank holds. ``leave``'s backward hands each replica its share
    # (1 / their count), and ``enter``'s sums them back; in between every
    # op keeps the rule: a rank's local op is linear in the cotangent, a
    # ``psum``'s backward (a psum) turns the replicas' partials into the
    # true cotangent of each summand, and the two below complete it. A
    # gradient of a parameter replicated over some axes is then the psum of
    # the ranks' gradients over those axes (``sharding.reduce_grads``).

    def split(self, x: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
        """This rank's block of dim ``dim`` of a value replicated over
        ``axes``. Backward: the block's cotangent padded with zeros, this
        rank's partial of the replicated value's."""
        axes = _as_axes(axes)
        n = self.axis_size(axes)
        if n == 1:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axes} ({n} ranks)")
        blk = x.shape[dim] // n
        return x.narrow(dim, self.axis_index(axes) * blk, blk)

    def gather(self, x: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
        """The blocks of dim ``dim`` over ``axes`` joined into the value,
        replicated over ``axes``. Backward: the replicas' partial cotangents
        summed over ``axes`` (a psum), and this rank's block of the sum."""
        group = self.group(axes)
        return x if group is None else _Gather.apply(
            x, group, self.axis_index(axes), dim)

    def pmax(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Elementwise maximum over the ranks of ``axes``, no gradient (the
        shift of a log-sum-exp)."""
        import torch.distributed as dist
        group = self.group(axes)
        out = x.detach().clone(memory_format=torch.contiguous_format)
        if group is not None:
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
        return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, dim):
        import torch.distributed as dist
        ctx.group, ctx.index, ctx.dim = group, index, dim
        ctx.blk = x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = _AllReduce.apply(g, ctx.group)
        return (g.narrow(ctx.dim, ctx.index * ctx.blk, ctx.blk), None, None,
                None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


def _other_axes(mesh: LiveMesh, axes: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a not in axes)


def _gather_blocks(x: torch.Tensor, mesh: LiveMesh,
                   axes: Tuple[str, ...]) -> torch.Tensor:
    import torch.distributed as dist
    group = mesh.group(axes)
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.axis_size(axes))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=0)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        n = mesh.axis_size(axes)
        if x.shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over "
                             f"{axes} ({n} ranks)")
        blk = x.shape[0] // n
        return x.narrow(0, mesh.axis_index(axes) * blk, blk).clone()

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        mesh, axes = ctx.mesh, ctx.axes
        full = _gather_blocks(g, mesh, axes)
        group = mesh.group(_other_axes(mesh, axes))
        if group is not None:
            full = full.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(full, group=group)
        return full, None, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        ctx.blk = x.shape[0] if x.dim() else None
        return _gather_blocks(x, mesh, axes) if axes else x.clone()

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.mesh, ctx.axes
        if axes:
            g = g.narrow(0, mesh.axis_index(axes) * ctx.blk, ctx.blk)
        return g / mesh.axis_size(_other_axes(mesh, axes)), None, None


# ---------------------------------------------------------------------------
# Factories (the reference's names)
# ---------------------------------------------------------------------------


def make_abstract_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]
                       ) -> AbstractMesh:
    """A device-free mesh for the sharding rules and the per-chip counts."""
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axes))


def _mesh(shape, axes, device):
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == math.prod(shape):
        return LiveMesh.build(shape, axes, resolve_device(device))
    return make_abstract_mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """``(16, 16)`` over ``("data", "model")``, or with ``multi_pod``
    ``(2, 16, 16)`` over ``("pod", "data", "model")``. Abstract unless a
    process group of exactly that many ranks is initialised: then this
    rank's :class:`LiveMesh` on ``device`` (``None``: the card, raising
    without one)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_debug_mesh(shape=(1, 1), axes=("data", "model"), device=None):
    """A small mesh for tests, abstract or live as ``make_production_mesh``."""
    return _mesh(tuple(shape), tuple(axes), device)


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes that shard the batch dimension."""
    return tuple(a for a in mesh.axis_names if a in DP_AXES)


def model_axis(mesh) -> str:
    return "model"


def choose_backend(device: torch.device, world: int) -> str:
    """``nccl`` when every rank has a card of its own, ``gloo`` otherwise
    (the CPU, or several ranks on one card)."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


# ---------------------------------------------------------------------------
# spawn_mesh
# ---------------------------------------------------------------------------


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank, call_file, shape, axes, device, backend, init_file,
               results, timeout_s):
    import torch.distributed as dist
    with open(call_file, "rb") as f:
        fn, args = pickle.load(f)
    world = math.prod(shape)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    try:
        mesh = LiveMesh.build(shape, axes, dev)
        # pickled here, by value: a tensor put on the queue as it is would
        # travel as a shared-memory handle that dies with this process
        results.put((rank, pickle.dumps(_to_host(fn(mesh, *args)))))
    finally:
        dist.destroy_process_group()


def spawn_mesh(fn: Callable, shape: Tuple[int, ...], axes: Tuple[str, ...],
               *, device=None, args: Tuple = (), rendezvous: Optional[str] = None,
               timeout_s: float = 900.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on each of ``prod(shape)`` ranks, each a
    process of its own (``torch.multiprocessing``, spawn), and return what
    each rank returned, in rank order (tensors moved to the host).

    ``device=None`` is the card, and raises without one; ``device="cpu"``
    runs every rank on the CPU. The backend is :func:`choose_backend`'s,
    decided here from the device and the card count before any rank
    starts. The ranks meet through a ``file://`` store in
    ``rendezvous`` (a fresh temporary directory if not given), where the
    call is left for them too: ``fn`` and ``args`` must pickle, ``fn`` is
    looked up by its module and name. A rank
    that raises fails the call (the others are stopped); so does a call
    that outlasts ``timeout_s`` seconds."""
    import torch.multiprocessing as tmp
    dev = resolve_device(device)
    world = math.prod(shape)
    backend = choose_backend(dev, world)
    own_dir = rendezvous is None
    rdv = tempfile.mkdtemp(prefix="spawn_mesh_") if own_dir else rendezvous
    stem = os.path.join(rdv, f"{os.getpid()}-{time.time_ns()}")
    init_file, call_file = stem + ".init", stem + ".call"
    # the call goes by file: a spawn sends each process its arguments down
    # a pipe, and a pickle larger than the pipe holds makes the parent wait
    # until that child has imported everything, one child after another
    with open(call_file, "wb") as f:
        pickle.dump((fn, tuple(args)), f)
    results = tmp.get_context("spawn").Queue()
    out: Dict[int, Any] = {}

    def drain():
        while True:
            try:
                rank, value = results.get_nowait()
            except queue_mod.Empty:
                return
            out[rank] = pickle.loads(value)

    try:
        ctx = tmp.start_processes(
            _rank_main, args=(call_file, tuple(shape), tuple(axes),
                              str(dev), backend, init_file, results,
                              timeout_s),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while True:
            drain()
            if ctx.join(timeout=_POLL_S):
                break
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"spawn_mesh: {world} ranks did not end "
                                   f"within {timeout_s} s")
        t_end = time.monotonic() + 10
        while len(out) < world and time.monotonic() < t_end:
            drain()
            time.sleep(0.05)
    finally:
        results.close()
        if own_dir:
            shutil.rmtree(rdv, ignore_errors=True)
        else:
            for path in (init_file, call_file):
                if os.path.exists(path):
                    os.remove(path)
    if len(out) != world:
        raise RuntimeError(f"spawn_mesh: {world - len(out)} of {world} ranks "
                           "returned nothing")
    return [out[r] for r in range(world)]


# ---------------------------------------------------------------------------
# The fleet mesh
# ---------------------------------------------------------------------------


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
