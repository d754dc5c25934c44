"""The window and the clocks: the host clock around whole units of work
(a tick, a round) that end in a synchronisation, CUDA events on the stage
hook of the split step, and a kernel timer that replays a CUDA graph over
inputs that lie past the L2 cache (a copy of the port's
``core/measured_cost.time_cuda``, so that the yardstick cannot move with
the program)."""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Sequence

import torch


class Window:
    """``seconds`` of host time, counted in whole units: a unit starts only
    while the window is open, and the window closes when the unit in flight
    ends (each unit ends in a synchronisation of the device)."""

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.t_open = self.t_close = self.wall_close = None

    def open(self) -> "Window":
        self.t_open = time.perf_counter()
        return self

    def running(self) -> bool:
        return time.perf_counter() - self.t_open < self.seconds

    def close(self, device: torch.device) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.t_close = time.perf_counter()
        self.wall_close = time.time()
        return self.elapsed

    @property
    def elapsed(self) -> float:
        return self.t_close - self.t_open


class StageClock:
    """The ``mark`` hook of the port's split step: a CUDA event as each
    stage of a local epoch begins ("device_forward", "server",
    "device_backward", "end"), read after the window as device ms per
    stage of each epoch."""

    STAGES = ("device_forward", "server", "device_backward", "end")

    def __init__(self):
        self.events: List = []

    def __call__(self, stage: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((stage, ev))

    def epochs(self) -> List[Dict[str, float]]:
        torch.cuda.synchronize()
        n = len(self.STAGES)
        out = []
        for i in range(0, len(self.events) - n + 1, n):
            names, evs = zip(*self.events[i:i + n])
            if names != self.STAGES:
                raise RuntimeError(f"stage marks out of order: {names}")
            out.append({a: evs[j].elapsed_time(evs[j + 1])
                        for j, a in enumerate(self.STAGES[:-1])})
        return out


#: the device time one graph replay should take
GRAPH_WINDOW_S = 0.02


def time_cuda(calls: Sequence[Callable], reps: int = 10) -> float:
    """Best-of-``reps`` device seconds per call. ``calls`` is one round of
    thunks over distinct buffers (enough of them to exceed the L2 cache).
    One eager round sizes the graph; ``n`` rounds are captured into a CUDA
    graph, and each rep replays it between two CUDA events."""

    def round_():
        for c in calls:
            c()

    round_()                                # first call pays any set-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    round_()
    stop.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(stop) * 1e-3
    n = max(1, min(200, math.ceil(GRAPH_WINDOW_S / max(eager, 1e-7))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            round_()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(max(reps, 1)):
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) * 1e-3 / (n * len(calls)))
    return best
