"""What the per-layer metrics read from a driver's record (``None`` where
the record holds nothing to read: the harness then leaves the metric
out)."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from port_bench import roofline


def idle_share(rec: Dict, trace_units: str, window_units: str
               ) -> Optional[float]:
    """% of the untraced window in which the device ran no operation: one
    minus the window's units (chunks, epochs) times the device time of a
    unit in the traced segment, over the window's seconds. The profiler
    slows the host, not the device, so the traced segment's own idle share
    (``device.busy_s`` over ``device.window_s``) reads higher."""
    lay = rec.get("layer", {})
    per_unit = per_unit_device_ms(rec, trace_units)
    if per_unit is None or not lay.get(window_units) \
            or not lay.get("window_s"):
        return None
    busy_s = 1e-3 * per_unit * lay[window_units]
    return 100.0 * (1.0 - busy_s / lay["window_s"])


def mfu(rec: Dict, dtype: str = "bfloat16") -> Optional[float]:
    """% of the card's peak: the operations the window's completed work
    needs over the window's seconds."""
    lay = rec.get("layer", {})
    if not lay.get("window_ops") or not lay.get("window_s"):
        return None
    return 100.0 * lay["window_ops"] / (lay["window_s"]
                                        * roofline.PEAK_FLOPS[dtype])


def per_unit_device_ms(rec: Dict, count_key: str) -> Optional[float]:
    """Device-busy ms of the traced segment over the units it ran."""
    tr, n = rec.get("trace"), rec.get("layer", {}).get(count_key)
    if not tr or not n or tr["busy_s"] <= 0:
        return None
    return 1e3 * tr["busy_s"] / n


def median(values) -> Optional[float]:
    return float(np.median(values)) if values else None


def percentile(values, q: float) -> Optional[float]:
    return float(np.percentile(values, q)) if values else None


def roofline_share(rows) -> Optional[float]:
    """% : the calls' least time on the card over their measured time,
    each shape weighted by its calls."""
    if not rows:
        return None
    bound = sum(r["bound_s"] * r["calls_per_chunk"] for r in rows)
    took = sum(r["time_s"] * r["calls_per_chunk"] for r in rows)
    return 100.0 * bound / took if took > 0 else None
