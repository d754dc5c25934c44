"""% of split fine-tuning's window in which the device ran no operation:
the window's local epochs at the device time an epoch takes in the traced
segment, against the window's seconds."""
from port_bench import readers


def read(rec):
    return readers.idle_share(rec, "trace_epochs", "window_epochs")
