"""% of the H100's bf16 peak: the operations the window's local epochs
need (``flops/split_finetune.py``) over the window's seconds."""
from port_bench import readers


def read(rec):
    return readers.mfu(rec)
