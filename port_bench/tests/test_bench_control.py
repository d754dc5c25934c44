"""The control and the faults, at a size a test run holds: the plain
reference put in the program's place and computed in float8 (the precision
below the configurations' bfloat16), and each fault the control readings
take, go through the cell's own check and come out not correct under the
cell's own limits, as they do on the card at the cells' own sizes
(``control.py``), while the program comes out correct. The training
cells run eight layers here: the worst leaf is taken over enough leaves to
read as it does at the published depth."""
import pytest

from port_bench import control, harness
from port_bench.tests import tiny


def _sides(cell, layers=None):
    run = tiny.run(cell, layers=layers)
    run.control = True
    line, notes = harness.run_cell(run)
    return line, control.judged(line, notes, run.cell.workload["limits"])


def test_prefill_control_is_not_correct():
    line, sides = _sides("prefill_pool.qwen2-7b")
    assert line["correct"] and sides["program"]["correct"]
    assert not sides["control"]["correct"]
    assert not sides["token_altered"]["correct"]
    # the control's logits at the served positions lie farther from the
    # reference's than the program's do
    assert sides["control"]["numbers"]["served_logit_err"] > \
        sides["program"]["numbers"]["served_logit_err"]


@pytest.mark.parametrize("cell", ["split_finetune.phi3-medium-14b",
                                  "split_finetune.qwen2-7b"])
def test_train_control_and_half_batch_are_not_correct(cell):
    line, sides = _sides(cell, layers=8)
    assert line["correct"] and sides["program"]["correct"]
    assert not sides["control"]["correct"]
    assert not sides["half_batch"]["correct"]
