"""% of its roofline that the port's ``lora_matmul`` reaches at the seven
projection shapes of a prefill chunk (CUDA-event time by graph replay,
inputs past the L2 cache; the bound by the benchmark's own operations and
bytes), each shape weighted by its calls a chunk."""
from port_bench import readers


def read(rec):
    return readers.roofline_share(rec.get("layer", {}).get("lora"))
