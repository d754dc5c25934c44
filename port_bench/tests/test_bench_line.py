"""A run's result line has the contract's keys, the compared numbers last,
on the CPU at a tiny size; the command refuses to run without a card."""
import json
import subprocess
import sys

import pytest

from port_bench import harness, spec
from port_bench.tests import tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_line_keys(cell):
    line, _ = harness.run_cell(tiny.run(cell))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = {m["name"] for m in spec.resolve(spec.benchmark(),
                                            cell).end_to_end}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_command_refuses_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, str(spec.HERE / "run.py"),
                        "--workload", CELLS[0], "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=spec.CHECKOUT, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_command_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and port_bench/."""
    import shutil
    shutil.copy(spec.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace",
                        "0"], capture_output=True, text=True, cwd=tmp_path,
                       timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""
