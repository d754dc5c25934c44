"""Helpers shared by the ``test_torch_*`` files: the same numpy-seeded
inputs and the same weights go through the JAX reference (``repro``) and the
PyTorch port (``repro_torch``). Not a test module."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import model as JM
from repro_torch.configs.base import get_config as torch_get_config
from repro_torch.convert import from_numpy_tree


def to_numpy_tree(tree):
    """JAX tree -> (float32/int numpy tree, tree of the leaves' dtype names):
    bfloat16 leaves travel as float32 and are cast back on arrival."""
    names = jax.tree_util.tree_map(lambda x: str(x.dtype), tree)
    arrays = jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(jnp.float32)
                             if jnp.issubdtype(x.dtype, jnp.floating) else x),
        tree)
    return arrays, names


def to_torch_tree(tree):
    arrays, names = to_numpy_tree(tree)
    return from_numpy_tree(arrays, "cpu", names)


def nonzero_b(lora, seed, std=0.02):
    """The adapter with every B overwritten by seeded non-zero values: the
    standard init has B = 0, so that every adapter computes the backbone and
    a comparison between adapters passes vacuously."""
    rng = np.random.default_rng(seed)

    def fix(path, leaf):
        if path[-1].key == "b":
            return jnp.asarray(rng.standard_normal(leaf.shape) * std,
                               leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(fix, lora)


def make_pair(arch, seed=0, **overrides):
    """(jax cfg, torch cfg, jax params, torch params) at the reduced size,
    adapters with non-zero B, same weights on both sides."""
    jcfg = jax_get_config(arch).reduced()
    tcfg = torch_get_config(arch).reduced()
    if overrides:
        jcfg = dataclasses.replace(jcfg, **overrides)
        tcfg = dataclasses.replace(tcfg, **overrides)
    jparams = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    jparams = {"frozen": jparams["frozen"],
               "lora": nonzero_b(jparams["lora"], seed + 1000)}
    if jcfg.qkv_bias:       # zero biases would hide a missing bias add
        rng = np.random.default_rng(seed + 2000)
        attn = dict(jparams["frozen"]["layers"]["attn"])
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(
                rng.standard_normal(attn[name].shape) * 0.1, attn[name].dtype)
        layers = dict(jparams["frozen"]["layers"], attn=attn)
        jparams["frozen"] = dict(jparams["frozen"], layers=layers)
    return jcfg, tcfg, jparams, to_torch_tree(jparams)


def make_adapters(jcfg, seeds):
    """Adapters with non-zero B for a bank: (jax list, torch list)."""
    jl = [nonzero_b(JM.init_params(jax.random.PRNGKey(s), jcfg)["lora"],
                    s + 1000) for s in seeds]
    return jl, [to_torch_tree(a) for a in jl]


def t2n(x: torch.Tensor) -> np.ndarray:
    return x.detach().to(torch.float32).cpu().numpy()


def j2n(x) -> np.ndarray:
    return np.asarray(x, np.float32)
