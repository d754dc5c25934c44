"""The active mesh: lets model code ask for the mesh's axis sizes, and lay
out its activations, without threading the mesh through every call.

A launcher wraps a step in ``mesh_ctx(mesh)`` (an ``AbstractMesh`` or this
rank's ``LiveMesh``, ``launch/mesh.py``); model code reads ``active()``,
``axis_size('dp')`` / ``axis_size('model')``, ``dp_axes()`` and ``mesh()``.
``models/moe_shard_map.py`` picks its expert layout from them. Outside a
context the mesh is one chip: ``axis_size`` is 1 and every MoE block runs
``moe_forward``.

Tags, as in the reference: ``'dp'`` is the data-parallel axes (``"pod"``,
``"data"``), ``'model'`` the tensor-parallel axis. ``constrain`` is the
reference's guarded ``with_sharding_constraint``: a dim tagged ``'dp'`` is
split over the data axes only if they divide it, a dim tagged ``'model'``
over the model axis only if it divides it. The reference hands that layout
to GSPMD, which reshards where the weights' layout disagrees; eager PyTorch
has no partitioner, so on a ``LiveMesh`` of several ranks ``constrain`` is
where the resharding happens: the caller says how its block is laid out
now (``have``), and gets its block under the guarded layout. Without a
context, on an ``AbstractMesh`` or on one rank it returns its input.

``live()`` is the mesh the tensor-parallel model code runs on: the active
``LiveMesh`` if it has more than one rank, else None (one chip, the path
as it is without a mesh, bit for bit).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

_CTX: Optional[Dict] = None


def set_ctx(mesh) -> None:
    global _CTX
    dp = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    model = mesh.shape.get("model", 1)
    _CTX = {"dp": dp, "dp_size": dp_size, "model": model, "mesh": mesh}


def clear_ctx() -> None:
    global _CTX
    _CTX = None


@contextlib.contextmanager
def mesh_ctx(mesh):
    set_ctx(mesh)
    try:
        yield
    finally:
        clear_ctx()


def active() -> bool:
    return _CTX is not None


def axis_size(tag: str) -> int:
    """Size of the 'model' or 'dp' axis group (1 without a context)."""
    if _CTX is None:
        return 1
    return _CTX["dp_size"] if tag == "dp" else _CTX["model"]


def dp_axes() -> Tuple[str, ...]:
    return _CTX["dp"] if _CTX else ()


def mesh():
    return _CTX["mesh"] if _CTX else None


def live():
    """The active ``LiveMesh`` when it has more than one rank, else None."""
    from repro_torch.launch.mesh import LiveMesh
    m = mesh()
    return m if isinstance(m, LiveMesh) and m.size > 1 else None


def guarded_spec(shape, *tags) -> Tuple:
    """The reference's guard: one spec entry per dim of a tensor of global
    ``shape`` (the data axes, ``"model"`` or None)."""
    if len(tags) != len(shape):
        raise ValueError(f"constrain: {len(tags)} tags for a {len(shape)}-d "
                         "tensor")
    spec = []
    for n, tag in zip(shape, tags):
        if tag == "dp" and _CTX["dp"] and n % _CTX["dp_size"] == 0:
            spec.append(_CTX["dp"])
        elif tag == "model" and _CTX["model"] > 1 and n % _CTX["model"] == 0:
            spec.append("model")
        else:
            spec.append(None)
    return tuple(spec)


def constrain(x: torch.Tensor, *tags, have=None) -> torch.Tensor:
    """The reference's layout hint, one tag per dim. On a ``LiveMesh`` of
    several ranks ``x`` is this rank's block under the spec ``have`` (one
    entry per dim; None: the same on every rank) and the result is its
    block under the guarded spec of ``tags``: a dim split there and not in
    ``have`` is narrowed to this rank's block, a dim split in ``have`` and
    not there is gathered over its axes (``LiveMesh.split`` /
    ``LiveMesh.gather``). Elsewhere ``x`` unchanged."""
    if _CTX is None:
        return x
    have = tuple(have) if have is not None else (None,) * x.dim()
    m = live()
    if m is None:
        guarded_spec(tuple(x.shape), *tags)     # the same argument check
        return x
    if len(have) != x.dim():
        raise ValueError(f"constrain: a {len(have)}-entry layout for a "
                         f"{x.dim()}-d tensor")
    shape = tuple(n * m.axis_size(ax) for n, ax in zip(x.shape, have))
    want = guarded_spec(shape, *tags)
    for dim, (h, w) in enumerate(zip(have, want)):
        if h != w and h is not None:
            x = m.gather(x, h, dim)
    for dim, (h, w) in enumerate(zip(have, want)):
        if h != w and w is not None:
            x = m.split(x, w, dim)
    return x
