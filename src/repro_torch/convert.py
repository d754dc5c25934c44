"""Parameter trees from numpy: the bridge by which a tree made elsewhere
(for instance by the JAX reference, through ``np.asarray`` on every leaf)
becomes the port's nested dict of tensors, leaf for leaf, same keys, same
stacking. This module knows numpy and torch only.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "int8": torch.int8, "int32": torch.int32}


def _as_dtype(d: Union[str, torch.dtype, None]):
    if d is None or isinstance(d, torch.dtype):
        return d
    return _DTYPES[str(d)]


def _leaf(x: Any, device, dtype) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":       # ml_dtypes array: reinterpret bits
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    dtype = _as_dtype(dtype)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_numpy_tree(tree, device, dtype=None):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``.

    ``dtype``: ``None`` keeps every leaf's own dtype; a dtype (or its name)
    casts every floating leaf to it; a nested dict of the same structure
    holding dtype names casts leaf by leaf — the way bfloat16 leaves travel
    as float32 numpy arrays and are cast back on arrival."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(
                    v, device, dtype[k] if isinstance(dtype, dict) else dtype)
                for k, v in tree.items()}
    return _leaf(tree, device, dtype)
