"""A run of each cell loads no module whose top-level name (the part before
the first dot, compared whole: the port's ``repro_torch`` begins with the
JAX package's name) is ``jax``, ``jaxlib``, ``flax`` or ``repro``."""
import json
import subprocess
import sys

import pytest

from port_bench import harness, spec

SCRIPT = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from port_bench import harness
from port_bench.tests import tiny
harness.run_cell(tiny.run({cell!r}, trace=True))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell", [w["name"]
                                  for w in spec.benchmark()["workloads"]])
def test_no_jax_in_a_run(cell):
    p = subprocess.run([sys.executable, "-c", SCRIPT.format(
        root=str(spec.CHECKOUT), src=str(spec.SRC), cell=cell)],
        capture_output=True, text=True, timeout=300, cwd=spec.CHECKOUT)
    assert p.returncode == 0, p.stderr[-3000:]
    top = json.loads(p.stdout.strip().splitlines()[-1])
    assert "repro_torch" in top and "port_bench" in top
    assert harness.forbidden_modules(top) == []


def test_forbidden_names_are_whole():
    assert harness.forbidden_modules(["repro_torch.models", "reprox"]) == []
    assert harness.forbidden_modules(["repro.kernels", "jax.numpy"]) == [
        "jax", "repro"]
