"""% of the prefill pool's window in which the device ran no operation:
the window's prefill chunks at the device time a chunk takes in the traced
segment, against the window's seconds."""
from port_bench import readers


def read(rec):
    return readers.idle_share(rec, "trace_prefills", "window_prefills")
