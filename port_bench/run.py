"""The benchmark of the port (``repro_torch``) on NVIDIA H100s.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Sets up the cell that ``BENCHMARK.json``
names, warms up, measures for ``--seconds``, checks what the window
produced against the plain reference (``port_bench/reference``), prints
each compared number beside its limit on standard error and, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` and, traced, ``breakdown``; the
compared numbers last, under ``checks``. Without a CUDA device, or with
fewer than the cell asks for, it prints no result and exits 2.
"""
import time

T_START = time.perf_counter()

import argparse                                          # noqa: E402
import json                                              # noqa: E402
import os                                                # noqa: E402
import sys                                               # noqa: E402
from pathlib import Path                                 # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout:
    the port's nvcc libraries where its build puts them by default, and
    Triton's, should anything use it."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(
        CHECKOUT / "src" / "repro_torch" / "csrc" / "build")
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / ".cache" / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    for p in (str(CHECKOUT / "src"), str(CHECKOUT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from port_bench import harness, roofline, spec

    bench = spec.benchmark(CHECKOUT)
    cell = spec.cell_entry(bench, args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    run = harness.make_run(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    line, notes = harness.run_cell(run)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    notes = dict(notes, card=roofline.card_line())
    print(json.dumps({"notes": notes}), flush=True)
    print(f"correct = {line['correct']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
