"""Kernel benches and the measured-cost calibration payload on the port.

    python -m repro_torch.launch.kernel_bench [--smoke] [--json [PATH]]
                                              [--reps N] [--device cpu]

The payload of ``launch/calibrate.run`` in the schema of the reference's
``benchmarks/kernel_bench.py::run``: the timing probes over the kernel
ladder (the port's Hopper kernels, CUDA-event times), the roofline fit, one
``LatencyTable`` per architecture, and, outside ``--smoke``, the four kernel
benches (``lora_matmul_512``, ``flash_attention_512``, ``ssd_scan_512``,
``flash_decode_1k``; f32, the reference's shapes) against their plain
versions and against the least time an H100 could take for the same work
(``calibrate.h100_bound_s``; as three tf32 products,
``calibrate.h100_bound_3xtf32_s``). ``gates`` holds every probe's time,
``probe_<kernel>_<shape>_s``.

``build_payload`` takes a calibrate payload already measured (the chip
check passes its own), so nothing is probed twice. Nothing is written
unless ``--json`` (default path ``BENCH_torch_kernels.json``);
``device=None`` is the GPU and raises without one. ``--device cpu
--smoke`` times the plain versions on the CPU, which says nothing about a
device; the kernel benches need the card.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from repro_torch.launch import calibrate, write_payload

SCHEMA = "torch-bench-kernels/v1"
DEFAULT_JSON = "BENCH_torch_kernels.json"


def build_payload(calibration: Dict) -> Dict:
    """The kernel-bench payload from a ``calibrate.run`` payload."""
    payload: Dict = {
        "schema": SCHEMA,
        "mode": calibration["mode"],
        "device": calibration["device"],
        "backend": calibration["roofline_fit"]["backend"],
        **{k: calibration[k] for k in ("probes", "roofline_fit",
                                       "host_profile", "latency_tables")},
        "gates": {f"probe_{p['kernel']}_{p['shape']}_s": p["seconds"]
                  for p in calibration["probes"]},
    }
    if "kernels" in calibration:
        payload["kernels"] = calibration["kernels"]
    return payload


def run(*, smoke: bool = False, reps: int = 3, device=None) -> Dict:
    """Probe -> fit -> per-arch latency tables (-> the kernel benches
    unless ``smoke``), as one JSON-able payload."""
    return build_payload(calibrate.run(smoke=smoke, reps=reps,
                                       device=device))


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the small probe ladder only, no kernel benches")
    ap.add_argument("--json", nargs="?", const=DEFAULT_JSON, metavar="PATH",
                    help=f"write the payload (default path {DEFAULT_JSON})")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    payload = run(smoke=args.smoke, reps=args.reps, device=args.device)
    if args.json:
        write_payload(args.json, payload)
    fit = payload["roofline_fit"]
    print(f"roofline fit [{payload['device']}]: "
          f"C={fit['compute_flops_per_s']:.4g} FLOP/s "
          f"B={fit['bandwidth_bytes_per_s']:.4g} B/s "
          f"overhead={fit['overhead_s'] * 1e6:.2f}us "
          f"rel_residual={fit['rel_residual']:.4f}")
    for r in payload.get("kernels", ()):
        print(f"{r['name']}: {r['kernel_us']:.2f} us ({r['version']}), "
              f"plain {r['plain_us']:.2f} us, H100 bound "
              f"{r['h100_bound_us']:.3f} us ({r['bound_by']}), as 3xTF32 "
              f"{r['h100_bound_3xtf32_us']:.3f} us")
    return payload


if __name__ == "__main__":
    main()
