"""Median wait of a request between its submission and its admission
(``Request.admitted_at - Request.submitted_at``), over the window's."""
from port_bench import readers


def read(rec):
    return readers.median(rec.get("layer", {}).get("queue_waits"))
