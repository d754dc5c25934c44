"""Every cell of BENCHMARK.json is found by name: its configuration, its
workload and traffic files, its driver, its operation count and the reader
of each per-layer metric it reports; and the file keeps the contract's
shape."""
import json
import re

import pytest

from port_bench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(cell):
    c = spec.resolve(BENCH, cell)
    assert (spec.HERE / "traffic" / f"{c.driver}.py").is_file()
    assert (spec.HERE / "flops" / f"{c.driver}.py").is_file()
    for m in c.per_layer:
        mod = spec.load_module("metrics", m["name"])
        assert mod.read({}) is None          # nothing to read: no number
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [x["name"] for x in BENCH[k]]
        assert len(ns) == len(set(ns))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_states_its_cuts(config):
    entry = spec.config_entry(BENCH, config)
    data = spec.read_json(spec.CHECKOUT / entry["file"])
    assert data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"]
    assert data["name"] == config
    # no width is cut: the port's model takes the file's widths as they are
    cfg = spec.model_config(data)
    m = data["model"]
    assert (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.n_layers, cfg.vocab_size) == (
        m["hidden_size"], m["intermediate_size"], m["num_attention_heads"],
        m["num_key_value_heads"], m["head_dim"], m["num_hidden_layers"],
        m["vocab_size"])
