"""The readings that a cell's limits are set from, on the card at the
cell's own size, several seeds in one process. Each seed is one run of the
cell (with a short window) whose check also puts, in the program's place:

* ``control``: the plain reference computed in float8 (e4m3), the precision
  below the configurations' bfloat16;
* a fault the cell can have: a served token replaced by the next id
  (``token_altered``, the prefill pool), or half of each batch left out,
  the mean taken over the rest (``half_batch``, training; a step that
  leaves the adapters unchanged reads 1 on ``change_norm_gap`` by
  definition).

Every side goes through the cell's own check (``traffic/<driver>.py``) and
is judged by its limits, as the program is.

    python3 port_bench/control.py --workload <cell> --seeds 1 2 3 \
        [--program-seconds 3] [--out <file>.jsonl]

The benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse                                          # noqa: E402
import gc                                                # noqa: E402
import json                                              # noqa: E402
import sys                                               # noqa: E402
from pathlib import Path                                 # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
for _p in (str(CHECKOUT / "src"), str(CHECKOUT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def judged(line, notes, limits):
    """{side: {"numbers": ..., "correct": ...}} of one run with the
    control on: the program's and each side's numbers under the cell's
    limits."""
    from port_bench import harness
    sides = {"program": {k: c["value"] for k, c in line["checks"].items()}}
    sides.update(notes.get("sides", {}))
    return {name: {"numbers": nums, "correct": harness.judge(
        [{"name": k, "value": nums[k], "limit": v}
         for k, v in limits.items() if k in nums])}
        for name, nums in sides.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program-seconds", type=float, default=3.0)
    ap.add_argument("--no-control", action="store_true",
                    help="the program's numbers only")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from port_bench import harness, spec
    from port_bench.run import _caches
    _caches()
    if not torch.cuda.is_available():
        print("control readings need a CUDA device", file=sys.stderr)
        return 2
    bench = spec.benchmark(CHECKOUT)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            run = harness.make_run(bench, args.workload, seed,
                                   args.program_seconds, False, "cuda", t0)
            run.control = not args.no_control
            line, notes = harness.run_cell(run)
            sides = judged(line, notes, run.cell.workload["limits"])
            notes.pop("sides", None)
            rec = {"workload": args.workload, "seed": seed, "sides": sides,
                   "metrics": line["metrics"], "notes": notes,
                   "run_s": time.perf_counter() - t0}
            print(json.dumps(rec), flush=True)
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            del run, line
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
