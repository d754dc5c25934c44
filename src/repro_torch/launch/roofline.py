"""The per-(arch x shape) roofline table of the port's dry run: each step's
compute, memory and collective times against one H100, the dominant term,
the MODEL_FLOPS / traced FLOPs usefulness ratio and whether its peak fits
the card.

    python -m repro_torch.launch.roofline [--path dryrun.jsonl]

Reads the JSONL records of ``launch/dryrun.py`` (``--out``). The twin of
the reference's ``benchmarks/roofline.py``: the reference's records are per
chip of a 16x16 or 2x16x16 TPU mesh and its ``fits`` column compares their
bytes with one TPU's memory; the port's are one H100 (``"mesh": "1"``), and
``fits`` is the record's own, its peak bytes against the card's 80 GB. The
sharded dry run is not ported, so there is no multi-pod table.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence

DEFAULT_PATH = "dryrun.jsonl"    # ``launch/dryrun.py --out``'s records
MESH = "1"                       # the port's dry run: one H100


def load(path: str = DEFAULT_PATH) -> List[Dict]:
    """The records at ``path``, the last one per (arch, shape, mesh, cut)
    (re-runs supersede); none if the file is missing."""
    recs: Dict = {}
    if not os.path.exists(path):
        return []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            recs[(r["arch"], r["shape"], r["mesh"], r.get("cut", 0))] = r
    return list(recs.values())


def table(recs: List[Dict], mesh: Optional[str] = MESH) -> str:
    rows = []
    hdr = (f"{'arch':<22} {'shape':<12} {'mesh':<8} {'comp_s':>9} "
           f"{'mem_s':>9} {'coll_s':>9} {'dominant':>10} {'useful':>7} fits")
    rows.append(hdr)
    rows.append("-" * len(hdr))
    for r in sorted(recs, key=lambda x: (x["arch"], x["shape"], x["mesh"])):
        if mesh and r["mesh"] != mesh:
            continue
        if not r.get("ok"):
            rows.append(f"{r['arch']:<22} {r['shape']:<12} {r['mesh']:<8} "
                        f"FAILED: {r.get('error', '?')[:60]}")
            continue
        roof = r["roofline"]
        peak = (r.get("memory") or {}).get("peak_bytes") or 0
        fits = "Y" if r.get("fits") else f"N({peak / 1e9:.0f}G)"
        ratio = r.get("useful_flops_ratio")
        rows.append(
            f"{r['arch']:<22} {r['shape']:<12} {r['mesh']:<8} "
            f"{roof['compute_s']:>9.4g} {roof['memory_s']:>9.4g} "
            f"{roof['collective_s']:>9.4g} {roof['dominant']:>10} "
            f"{ratio if ratio is None else round(ratio, 3):>7} {fits}")
    return "\n".join(rows)


def summary(recs: List[Dict]) -> Dict:
    ok = [r for r in recs if r.get("ok")]
    doms: Dict[str, int] = {}
    for r in ok:
        doms[r["roofline"]["dominant"]] = doms.get(
            r["roofline"]["dominant"], 0) + 1
    return {"total": len(recs), "ok": len(ok),
            "failed": len(recs) - len(ok), "dominant_terms": doms}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", default=DEFAULT_PATH,
                    help="the dry run's JSONL records")
    args = ap.parse_args(argv)
    recs = load(args.path)
    if not recs:
        print("no dry-run records; run: PYTHONPATH=src python -m "
              "repro_torch.launch.dryrun --all --out dryrun.jsonl")
        return summary(recs)
    print(table(recs, mesh=MESH))
    print()
    print("mesh 2x16x16: the sharded dry run is not ported (it needs "
          "several cards; ROADMAP.md, Queue 1)")
    print()
    s = summary(recs)
    print(json.dumps(s))
    return s


if __name__ == "__main__":
    main()
