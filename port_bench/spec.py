"""What the harness finds by name: ``BENCHMARK.json`` at the root of the
checkout, a cell's file under ``workloads/``, its configuration under
``configs/``, its traffic mix under ``traffic/`` and the Python files of a
traffic driver, an operation count and a per-layer metric.

Nothing here names a cell, a configuration or a metric: each is looked up
from the names that ``BENCHMARK.json`` gives.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, Optional

import numpy as np

HERE = Path(__file__).resolve().parent          # port_bench/
CHECKOUT = HERE.parent                          # the root of the checkout
SRC = CHECKOUT / "src"                          # where the port's package lies


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = CHECKOUT) -> Dict[str, Any]:
    return read_json(root / "BENCHMARK.json")


def cell_entry(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in bench['workloads']]}")


def config_entry(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_module(folder: str, name: str, root: Path = HERE) -> ModuleType:
    """``<root>/<folder>/<name>.py`` as a module (a name may hold dots)."""
    path = root / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} (the {folder} file of {name!r})")
    mod_name = "port_bench_" + f"{folder}_{name}".replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """Everything one run of one cell needs, read from the files that its
    entry in ``BENCHMARK.json`` names."""
    name: str
    chips: int
    config: Dict[str, Any]          # configs/<config>.json
    workload: Dict[str, Any]        # workloads/<cell>.json (limits)
    mix: Dict[str, Any]             # traffic/<traffic>.json
    driver: str                     # traffic/<driver>.py
    end_to_end: list                # the cell's end-to-end metric entries
    per_layer: list                 # the cell's per-layer metric entries


def _for_cell(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: Dict[str, Any], name: str, root: Path = CHECKOUT,
            here: Path = HERE) -> Cell:
    entry = cell_entry(bench, name)
    cfg_entry = config_entry(bench, entry["config"])
    config = read_json(root / cfg_entry["file"])
    workload = read_json(here / "workloads" / f"{name}.json")
    if workload.get("config") != entry["config"] \
            or workload.get("traffic") != entry["traffic"]:
        raise ValueError(f"workloads/{name}.json names config "
                         f"{workload.get('config')!r} and traffic "
                         f"{workload.get('traffic')!r}; BENCHMARK.json "
                         f"{entry['config']!r} and {entry['traffic']!r}")
    mix = read_json(here / "traffic" / f"{entry['traffic']}.json")
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                workload=workload, mix=mix, driver=mix["driver"],
                end_to_end=[m for m in bench["end_to_end"]
                            if _for_cell(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _for_cell(m, name)])


# ---------------------------------------------------------------------------
# Seeds: one run's seed (any whole number) to the streams of its parts
# ---------------------------------------------------------------------------


def seed_sequence(seed: int, *purpose: int) -> np.random.SeedSequence:
    return np.random.SeedSequence(entropy=int(seed) % 2 ** 64,
                                  spawn_key=tuple(purpose))


def rng(seed: int, *purpose: int) -> np.random.Generator:
    return np.random.default_rng(seed_sequence(seed, *purpose))


def torch_seed(seed: int, *purpose: int) -> int:
    """A seed for a ``torch.Generator`` (63 bits)."""
    return int(seed_sequence(seed, *purpose).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


# purposes, so that no two parts of a run draw from one stream
WEIGHTS, ADAPTERS, REQUESTS, BATCHES, CHANNELS, SAMPLE = range(6)


# ---------------------------------------------------------------------------
# The port's model configuration of a config file
# ---------------------------------------------------------------------------

#: a config file's published key -> the port's ``ModelConfig`` field
PORT_FIELDS = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "intermediate_size": "d_ff", "vocab_size": "vocab_size",
    "head_dim": "head_dim", "rope_theta": "rope_theta",
    "rms_norm_eps": "rms_eps", "qkv_bias": "qkv_bias",
    "attention_bias": "qkv_bias", "torch_dtype": "dtype",
    "tie_word_embeddings": "tie_embeddings",
}


def model_config(config: Dict[str, Any], override: Optional[Dict] = None):
    """The port's ``ModelConfig`` for a config file: the port's registry
    entry (``port_arch``) with every field the file gives set to the file's
    value, and the LoRA group's rank, alpha and adapter type."""
    from repro_torch.configs.base import get_config
    vals = dict(config["model"])
    vals.update(override or {})
    cfg = get_config(config["port_arch"])
    fields = {PORT_FIELDS[k]: v for k, v in vals.items() if k in PORT_FIELDS}
    # a published window applies unless the config switches it off
    window = vals.get("sliding_window") or 0
    fields["sliding_window"] = (int(window) if vals.get("use_sliding_window",
                                                        True) else 0)
    lora = config["lora"]
    fields["lora"] = dataclasses.replace(
        cfg.lora, rank=int(lora["r"]), alpha=float(lora["alpha"]),
        dtype=lora["dtype"], targets=tuple(lora["targets"]))
    return dataclasses.replace(cfg, **fields)
