"""A cell is added as files alone: a traffic mix (data for an existing
driver), a workload file and its entry in BENCHMARK.json. In a copy of the
benchmark, with no code edited, the new cell runs."""
import json
import shutil
import subprocess
import sys

from port_bench import spec

SCRIPT = """
import json, sys, time
sys.path[:0] = [{copy!r}, {src!r}]
from port_bench import harness, spec
from port_bench.tests import tiny
bench = spec.benchmark()
line, _ = harness.run_cell(tiny.run("prefill_short.qwen2-7b", bench=bench))
mods = harness.forbidden_modules(sys.modules)
print(json.dumps({{"line": line, "here": str(spec.HERE), "bad": mods}}))
"""


def test_new_cell_from_files_alone(tmp_path):
    shutil.copy(spec.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "port_bench").rglob("*.py")}
    mix = spec.read_json(spec.HERE / "traffic" / "prefill_pool.json")
    mix.update(chunk_counts=[1, 2], per_block=[1, 1], clients=2, slots=2,
               why="short prompts of one or two chunks")
    (tmp_path / "port_bench/traffic/prefill_short.json").write_text(
        json.dumps(mix))
    (tmp_path / "port_bench/workloads/prefill_short.qwen2-7b.json"
     ).write_text(json.dumps({"config": "qwen2-7b",
                              "traffic": "prefill_short",
                              "limits": {"served_gap": 1e9,
                                         "served_logit_err": 1e9,
                                         "kv_rel_err": 1e9}}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "prefill_short.qwen2-7b",
                               "config": "qwen2-7b",
                               "traffic": "prefill_short", "chips": 1,
                               "why": "short prompts"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "prefill_pool.qwen2-7b" in m.get("workloads", []):
            m["workloads"].append("prefill_short.qwen2-7b")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    p = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(copy=str(tmp_path),
                                             src=str(spec.SRC))],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["here"] == str(tmp_path / "port_bench")
    assert out["bad"] == []
    assert set(out["line"]["metrics"]) == {"prefill_tokens_per_s",
                                           "setup_s"}
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "port_bench").rglob("*.py")}
    assert after == before                       # no code was edited
