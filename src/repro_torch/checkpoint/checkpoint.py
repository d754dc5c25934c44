"""Tree checkpointing: npz payload + JSON structure manifest, in the JAX
package's on-disk format, so that a checkpoint written by either package
loads into the other.

The npz holds one array per leaf (``leaf_i``); the manifest lists each
leaf's "/"-joined dict keys (or list indices), its array name and dtype,
plus ``step`` and ``extra``. bfloat16, which npz cannot hold, is stored as
its raw uint16 bits under the tag ``"bfloat16"``. Leaves are matched by
key, never by position: JAX flattens dicts in sorted key order, the port in
insertion order.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [("/".join(prefix), tree)]
    return [kv for k, v in items
            for kv in _flatten_with_paths(v, prefix + (str(k),))]


def _unflatten(like, leaves, prefix: Tuple[str, ...] = ()):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(like))
    return leaves["/".join(prefix)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree, *, step: int = 0, extra: Dict = None
                    ) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (key, leaf) in enumerate(_flatten_with_paths(tree)):
        name = f"leaf_{i}"
        arrays[name] = _to_numpy(leaf)
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        manifest["leaves"].append({
            "key": key, "name": name,
            "dtype": "bfloat16" if bf16 else str(arrays[name].dtype)})
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)


def load_checkpoint(path: str, tree_like) -> Tuple[Any, int]:
    """Restore into the structure of ``tree_like`` (a tree of tensors):
    each leaf with the stored dtype, on its ``tree_like`` leaf's device.
    Returns (tree, step)."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    by_key = {}
    with np.load(path) as data:
        for leaf in manifest["leaves"]:
            arr = data[leaf["name"]]
            if leaf["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            by_key[leaf["key"]] = t
    leaves = {}
    for key, like in _flatten_with_paths(tree_like):
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = by_key[key]
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch at {key}: "
                             f"{tuple(t.shape)} vs {tuple(like.shape)}")
        leaves[key] = t.to(like.device)
    return _unflatten(tree_like, leaves), manifest["step"]
