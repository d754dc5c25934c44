"""The active mesh: lets model code ask for the mesh's axis sizes without
threading the mesh through every call.

A launcher wraps a step in ``mesh_ctx(mesh)`` (an ``AbstractMesh`` or this
rank's ``LiveMesh``, ``launch/mesh.py``); model code reads ``active()``,
``axis_size('dp')`` / ``axis_size('model')``, ``dp_axes()`` and ``mesh()``.
``models/moe_shard_map.py`` picks its expert layout from them. Outside a
context the mesh is one chip: ``axis_size`` is 1 and every MoE block runs
``moe_forward``.

Tags, as in the reference: ``'dp'`` is the data-parallel axes (``"pod"``,
``"data"``), ``'model'`` the tensor-parallel axis. ``constrain`` is the
reference's guarded ``with_sharding_constraint``, a layout hint to GSPMD
that never changes a value; eager PyTorch has no partitioner to hint, so
here it returns its input unchanged.
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


def constrain(x: torch.Tensor, *tags) -> torch.Tensor:
    """The reference's layout hint, one tag per dim: ``x`` unchanged."""
    if _CTX is not None and len(tags) != x.dim():
        raise ValueError(f"constrain: {len(tags)} tags for a {x.dim()}-d "
                         "tensor")
    return x
