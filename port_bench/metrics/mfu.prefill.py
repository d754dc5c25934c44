"""% of the H100's bf16 peak: the operations the window's prompts need
(``flops/prefill_pool.py``) over the window's seconds."""
from port_bench import readers


def read(rec):
    return readers.mfu(rec)
