"""The profiler's reading of a traced segment: the seconds in which the
device ran an operation (the union of its kernels, copies and sets), the
operations that took the most device time, and the idle gaps of the device
by the host operation in flight at each (the innermost one: an aten op, a
runtime call, or a span the harness opened with ``span``)."""
from __future__ import annotations

import heapq
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

TOP = 10               # entries of each breakdown list
GAP_MIN_NS = 5_000     # shorter gaps are summed under "short gaps"


#: what the names of the harness's host spans begin with
SPAN = "bench:"


def span(name: str):
    """A host span in the trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(SPAN + name)


class Trace:
    """``with Trace(device) as tr:`` traces the block; ``tr.summary`` is
    read after it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.summary: Optional[Dict] = None
        self.read_s = 0.0

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            t = time.perf_counter()
            self.summary = summarise(_events(self._prof), window_s)
            self.read_s = time.perf_counter() - t
        return False


def _events(prof) -> Tuple[List, List]:
    """(device intervals, host intervals) as (start_ns, end_ns, name)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if d > 0:
            (dev if e.device_type() == cuda else host).append(
                (s, s + d, e.name()))
    # a host span is mirrored on the device's timeline as a range that
    # covers the kernels launched under it: it is no device operation
    return [e for e in dev if not e[2].startswith(SPAN)], host


def _union(intervals: List[Tuple[int, int, str]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e, _ in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summarise(events: Tuple[List, List], window_s: float) -> Dict:
    dev, host = events
    busy = _union(dev)
    busy_ns = sum(e - s for s, e in busy)
    by_op: Dict[str, int] = defaultdict(int)
    for s, e, name in dev:
        by_op[name] += e - s
    device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = []
    if busy and host:
        lo = min(s for s, _, _ in host)
        edges = [(lo, busy[0][0])] + [(busy[i][1], busy[i + 1][0])
                                      for i in range(len(busy) - 1)]
        gaps = [(s, e) for s, e in edges if e - s > 0]
    idle = _attribute(gaps, host)
    return {"busy_s": busy_ns * 1e-9, "window_s": window_s,
            "device_ops": [[n, ns * 1e-9] for n, ns in device_ops],
            "idle_gaps": [[n, ns * 1e-9] for n, ns in idle]}


def _attribute(gaps: List[Tuple[int, int]], host: List) -> List:
    """Gap nanoseconds summed by the innermost host event in flight at
    each gap's middle (the latest-starting one that still runs: a sweep
    over the host events by start, with a heap of those begun), the
    ``TOP`` largest sums."""
    sums: Dict[str, int] = defaultdict(int)
    sums["short gaps"] = sum(e - s for s, e in gaps if e - s < GAP_MIN_NS)
    host = sorted(host)
    begun: List = []                  # (-start, end, name)
    i = 0
    for s, e in sorted(g for g in gaps if g[1] - g[0] >= GAP_MIN_NS):
        mid = (s + e) // 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(begun, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while begun and begun[0][1] < mid:
            heapq.heappop(begun)
        sums[begun[0][2] if begun else "host (no traced op)"] += e - s
    return sorted(((n, v) for n, v in sums.items() if v > 0),
                  key=lambda kv: -kv[1])[:TOP]
