"""Device-busy ms of the traced segment over the prefill chunks the
engine ran in it (its ``prefills`` counter)."""
from port_bench import readers


def read(rec):
    return readers.per_unit_device_ms(rec, "trace_prefills")
