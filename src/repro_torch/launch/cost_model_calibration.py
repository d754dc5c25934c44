"""Cross-layer consistency of CARD's cost model on the port, two ways:

  * ``run()``          — the paper-side analytic model (Sec. III, eta =
    FLOPs of the fine-tuning step) against the FLOPs of the same step as the
    port's dry run counts them (``launch/dryrun.py``: the step traced on
    ``meta`` at full published width, one H100 as the mesh, the whole
    global batch);
  * ``run_measured()`` — the analytic model against the *measured* cost
    model: per-arch effective eta from a ``LatencyTable`` calibrated on the
    card's kernel timings (``launch/calibrate.run_measured``), reported as
    an inflation factor. It needs no dry-run records.

    python -m repro_torch.launch.cost_model_calibration [--smoke]
        [--json [PATH]] [--dryrun-path PATH] [--device cpu]

The twin of the reference's ``benchmarks/cost_model_calibration.py``. The
reference keeps its ``16x16`` records and multiplies one chip's HLO FLOPs
by 256; the port's records (``"mesh": "1"``) already count the whole step.
The dry run's matrix leaves llama32-1b out, so a full matrix gives ten rows.
Nothing is written unless ``--json`` (default path
``BENCH_torch_card_calibration.json``); ``device=None`` is the GPU and
raises without one.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence

from repro_torch.configs.base import INPUT_SHAPES, get_config
from repro_torch.core.cost_model import Workload
from repro_torch.core.measured_cost import (RooflineFit, fit_roofline,
                                            probe_kernels)
from repro_torch.launch import calibrate, write_payload
from repro_torch.launch.roofline import DEFAULT_PATH, MESH
from repro_torch.models.common import resolve_device

SCHEMA = "torch-bench-card-calibration/v1"
DEFAULT_JSON = "BENCH_torch_card_calibration.json"


def run(path: str = DEFAULT_PATH, shape_name: str = "train_4k"
        ) -> List[Dict]:
    """Analytic eta vs the traced step's FLOPs, one row per arch with an
    ``ok`` record of ``shape_name`` on one card (the last one wins)."""
    shape = INPUT_SHAPES[shape_name]
    recs = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                if r.get("ok") and r["shape"] == shape_name \
                        and r["mesh"] == MESH and "roofline" in r:
                    recs[r["arch"]] = r
    rows = []
    for arch, r in sorted(recs.items()):
        # a record whose batch was cut (the card check's) counts that batch
        batch = (r.get("reduced") or {}).get(
            "global_batch", (shape.global_batch, shape.global_batch))[1]
        w = Workload(get_config(arch), batch, shape.seq_len)
        analytic = w.total_flops()                   # eta (Eq. 8 numerator)
        traced = r["roofline"]["flops"] * r["chips"]
        rows.append({
            "arch": arch,
            "analytic_eta_pflops": analytic / 1e15,
            "traced_pflops": traced / 1e15,
            "ratio_analytic_over_traced": analytic / traced,
        })
    return rows


def run_measured(*, smoke: bool = True, batch: int = 4, seq_len: int = 512,
                 fit: Optional[RooflineFit] = None, device=None) -> Dict:
    """Analytic eta vs measured effective eta for every architecture
    (``calibrate.run_measured``); without ``fit`` the probe ladder is timed
    on ``device`` and fitted first."""
    if fit is None:
        fit = fit_roofline(probe_kernels(mode="smoke" if smoke else "full",
                                         device=resolve_device(device)))
    return calibrate.run_measured(fit, batch=batch, seq_len=seq_len)


def build_payload(*, smoke: bool = False, path: str = DEFAULT_PATH,
                  fit: Optional[RooflineFit] = None, device=None) -> Dict:
    """The payload; ``fit`` (a calibrate run's) saves probing again."""
    dryrun_rows = run(path)
    if not dryrun_rows:
        # an empty table would look like a pass while measuring nothing:
        # say so, and still calibrate against the measured tables
        print(f"skip: no usable dry-run records at {os.path.abspath(path)} "
              "(regenerate with: PYTHONPATH=src python -m "
              "repro_torch.launch.dryrun --all --out dryrun.jsonl); "
              "emitting measured-vs-analytic calibration only")
    measured = run_measured(smoke=smoke, fit=fit, device=device)
    return {
        "schema": SCHEMA,
        "mode": "smoke" if smoke else "full",
        "dryrun_status": "ok" if dryrun_rows else "missing",
        "dryrun_rows": dryrun_rows,
        "measured": measured,
        # nothing here is a timed hot path: the gate dict is empty
        "gates": {},
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small probe ladder for the measured comparison")
    ap.add_argument("--json", nargs="?", const=DEFAULT_JSON, metavar="PATH",
                    help=f"write the payload (default path {DEFAULT_JSON})")
    ap.add_argument("--dryrun-path", default=DEFAULT_PATH)
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    payload = build_payload(smoke=args.smoke, path=args.dryrun_path,
                            device=args.device)
    if args.json:
        write_payload(args.json, payload)
    for row in payload["dryrun_rows"]:
        print(f"{row['arch']:24s} eta={row['analytic_eta_pflops']:9.2f}P "
              f"traced={row['traced_pflops']:9.2f}P "
              f"ratio={row['ratio_analytic_over_traced']:.3f}")
    for row in payload["measured"]["rows"]:
        print(f"{row['arch']:24s} eta={row['analytic_eta_gflops']:9.1f}G "
              f"effective={row['effective_eta_gflops']:9.1f}G "
              f"inflation={row['inflation']:.3f}")
    return payload


if __name__ == "__main__":
    main()
