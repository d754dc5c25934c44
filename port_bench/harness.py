"""One run of one cell, driven by data: the cell's entry in
``BENCHMARK.json`` names its configuration and traffic mix, the mix names
its driver (``traffic/<driver>.py``), and each per-layer metric is read by
``metrics/<metric>.py``. The driver sets up, runs the window, checks what
the window produced against the plain reference and returns a record; this
module turns the record into the result line."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch

from port_bench import spec
from port_bench.reference.model import Dims, dims_of

#: top-level module names that no run may have loaded: JAX and the JAX
#: package beside the port (whole names: the port's begins with the latter)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a traffic driver is handed."""
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float                  # host clock at the start of the process
    cfg: Any                        # the port's ModelConfig
    dims: Dims                      # the reference's reading of the config
    rank: int
    #: also compare the control and the faults in the program's place
    #: (``control.py``; the benchmark's own runs never set it)
    control: bool = False


def make_run(bench: Dict, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, model_override: Optional[Dict] = None,
             mix_override: Optional[Dict] = None) -> Run:
    cell = spec.resolve(bench, name)
    if model_override:
        cell.config = dict(cell.config,
                           model=dict(cell.config["model"], **model_override))
    if mix_override:
        cell.mix = dict(cell.mix, **mix_override)
    return Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
               device=torch.device(device), t_start=t_start,
               cfg=spec.model_config(cell.config), dims=dims_of(cell.config),
               rank=int(cell.config["lora"]["r"]))


def forbidden_modules(modules) -> List[str]:
    return sorted({m.split(".")[0] for m in modules}
                  & set(FORBIDDEN_MODULES))


def judge(checks: List[Dict]) -> bool:
    """Every compared number within its limit (a number that is not finite
    is not within any)."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks)


def compared(numbers: Dict[str, float], limits: Dict[str, float]):
    """(the checks: each number that the cell's file gives a limit, beside
    it, in the file's order; the numbers it gives none, which are not
    compared). A limit whose number the driver did not work out is an
    error."""
    missing = [k for k in limits if k not in numbers]
    if missing:
        raise KeyError(f"limits of numbers the check has not: {missing}")
    return ([{"name": k, "value": numbers[k], "limit": limits[k]}
             for k in limits],
            {k: v for k, v in numbers.items() if k not in limits})


def run_cell(run: Run):
    """(the result line's object, ``checks`` last; the driver's notes: what
    an earlier line of the run prints)."""
    driver = spec.load_module("traffic", run.cell.driver)
    rec = driver.run(run)
    want = [m["name"] for m in (run.cell.per_layer if run.trace
                                else run.cell.end_to_end)]
    units = {m["name"]: m["unit"] for m in run.cell.end_to_end
             + run.cell.per_layer}
    metrics: Dict[str, Dict] = {}
    if run.trace:
        for name in want:
            value = spec.load_module("metrics", name).read(rec)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        missing = [m for m in want if m not in rec["e2e"]]
        if missing:
            raise RuntimeError(f"the {run.cell.driver} driver measured no "
                               f"{missing}")
        metrics = {m: {"value": rec["e2e"][m], "unit": units[m]}
                   for m in want}
    device = {"platform": "gpu" if run.device.type == "cuda" else
              run.device.type,
              "kind": (torch.cuda.get_device_name(run.device)
                       if run.device.type == "cuda" else run.device.type),
              "count": run.cell.chips,
              "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out: Dict[str, Any] = {"correct": judge(rec["checks"])
                           and rec["failed"] == 0,
                           "attempted": int(rec["attempted"]),
                           "failed": int(rec["failed"]),
                           "metrics": metrics, "device": device}
    if run.trace and rec.get("trace"):
        tr = rec["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in rec["checks"]}
    return out, rec.get("notes", {})
