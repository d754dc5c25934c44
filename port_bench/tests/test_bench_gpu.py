"""On the card: each cell's command runs briefly, prints the contract's
line and comes out correct. Skips without a CUDA device."""
import json
import subprocess
import sys

import pytest

from port_bench import spec


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"]
                                  for w in spec.benchmark()["workloads"]])
def test_cell_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        cell, "--seed", str(2 ** 31 + 11), "--seconds", "3",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=spec.CHECKOUT, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
