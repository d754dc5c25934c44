"""Perf gate over the port's ``BENCH_torch_*.json`` payloads.

    # schema validation only (fails on malformed output)
    python -m repro_torch.launch.check_regression --validate \
        BENCH_torch_serving.json ...

    # full gate: fresh outputs against a baseline directory
    python -m repro_torch.launch.check_regression \
        --baseline-dir bench_baseline --fresh-dir . --threshold 2.0

Validates benchmark payloads against their schemas (the ``torch-bench-*``
tags of the port's drivers) and compares their ``gates`` (hot-path wall
times, seconds) with a baseline's; exits 1 when a gated path is more than
``--threshold`` times slower. The twin of the reference's
``benchmarks/check_regression.py``, same rules. Its check that gate keys
carry a ``time[s]`` unit suffix is a copy of the reference repo's splint
registry (``UNIT_SUFFIXES``, ``ALIAS_SUFFIXES``, ``check_key_units``), so
the port needs nothing outside its own package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

BENCH_FILES = ("BENCH_torch_kernels.json",
               "BENCH_torch_card_calibration.json",
               "BENCH_torch_fleet_scale.json", "BENCH_torch_churn.json",
               "BENCH_torch_serving.json", "BENCH_torch_hierarchy.json")

# required top-level keys per schema tag; every payload must carry
# "schema", "mode", and a (possibly empty) "gates" dict of positive floats
REQUIRED_KEYS: Dict[str, Tuple[str, ...]] = {
    "torch-bench-kernels/v1": ("probes", "roofline_fit", "latency_tables"),
    "torch-bench-card-calibration/v1": ("dryrun_status", "dryrun_rows",
                                        "measured"),
    "torch-bench-fleet-scale/v1": ("scaling", "big_fleet"),
    "torch-bench-churn/v1": ("sweep", "devices", "quorum"),
    "torch-bench-serving/v1": ("sweep", "arch", "engine"),
    "torch-bench-hierarchy/v1": ("sweep", "arch", "rounds"),
}

# ---------------------------------------------------------------------------
# Unit suffixes of payload keys (the reference repo's splint registry)
# ---------------------------------------------------------------------------

#: suffix token -> dimension; scale variants are distinct dimensions
UNIT_SUFFIXES: Dict[str, str] = {
    "s": "time[s]", "ms": "time[ms]", "us": "time[us]", "ns": "time[ns]",
    "joules": "energy[J]", "j": "energy[J]",
    "flops": "compute[flop]", "flop": "compute[flop]",
    "bytes": "data[byte]", "bits": "data[bit]",
    "hz": "frequency[Hz]", "ghz": "frequency[GHz]",
    "w": "power[W]", "watts": "power[W]",
    "db": "level[dB]", "dbm": "power[dBm]", "m": "length[m]",
}

#: near-miss spellings that should be normalized, never introduced
ALIAS_SUFFIXES: Dict[str, str] = {
    "sec": "s", "secs": "s", "second": "s", "seconds": "s",
    "msec": "ms", "msecs": "ms", "usec": "us", "micros": "us",
    "joule": "joules", "joul": "joules",
    "byte": "bytes", "bit": "bits",
    "hertz": "hz", "watt": "w",
    "millis": "ms", "nanos": "ns",
}


def key_dimensions(key: str) -> List[str]:
    """All unit dimensions a snake_case payload key mentions, with
    ``a_per_b`` rate groups collapsed to one dimension."""
    toks = key.rstrip("_").split("_")
    dims: List[str] = []
    i = 0
    while i < len(toks):
        if (i + 2 < len(toks) and toks[i + 1] == "per"
                and toks[i] in UNIT_SUFFIXES and toks[i + 2] in UNIT_SUFFIXES):
            dims.append(f"{UNIT_SUFFIXES[toks[i]]}/{UNIT_SUFFIXES[toks[i + 2]]}")
            i += 3
        elif toks[i] in UNIT_SUFFIXES:
            dims.append(UNIT_SUFFIXES[toks[i]])
            i += 1
        else:
            i += 1
    return dims


def check_key_units(keys: Sequence[str], *, context: str = "payload",
                    require: Optional[str] = None) -> List[str]:
    """Errors for payload keys with alias or inconsistent unit suffixes;
    ``require`` (a dimension, e.g. ``"time[s]"``) also demands that every
    key mention that dimension."""
    errors: List[str] = []
    for key in keys:
        for tok in key.rstrip("_").split("_"):
            if tok in ALIAS_SUFFIXES:
                errors.append(
                    f"{context}: key {key!r} uses nonstandard unit token "
                    f"'{tok}' (use '{ALIAS_SUFFIXES[tok]}')")
        dims = key_dimensions(key)
        plain = [d for d in dims if "/" not in d]
        if len(set(plain)) > 1:
            errors.append(f"{context}: key {key!r} mixes unit suffixes "
                          f"{sorted(set(plain))}")
        if require and not dims:
            errors.append(f"{context}: key {key!r} carries no unit suffix "
                          f"(expected {require})")
        elif require and dims and require not in dims \
                and not any(d.startswith(require) or f"/{require}" in d
                            for d in dims):
            errors.append(f"{context}: key {key!r} has units {dims}, "
                          f"expected {require}")
    return errors


# ---------------------------------------------------------------------------
# Validation and the gate
# ---------------------------------------------------------------------------


def _positive(val) -> bool:
    return (isinstance(val, (int, float)) and val > 0 and val == val
            and val != float("inf"))


def _grid_errors(path: str, sweep, keys, axes) -> List[str]:
    """A sweep's rows: every ``keys`` value positive and finite, at least
    two distinct values along each of ``axes``."""
    errors = []
    if not sweep:
        errors.append(f"{path}: sweep is empty")
    for row in sweep:
        for key in keys:
            if not _positive(row.get(key)):
                errors.append(f"{path}: sweep {key} must be a positive "
                              f"finite number, got {row.get(key)!r}")
    for axis in axes:
        vals = {row.get(axis) for row in sweep}
        if len(vals) < 2:
            errors.append(f"{path}: sweep covers only {sorted(vals)} "
                          f"for {axis!r} (need >= 2 distinct values)")
    return errors


def validate_payload(payload: Dict, path: str = "payload") -> List[str]:
    """Schema errors of one payload (empty = valid); ``path`` names it in
    the messages."""
    schema = payload.get("schema")
    if schema not in REQUIRED_KEYS:
        return [f"{path}: unknown schema {schema!r} "
                f"(expected one of {sorted(REQUIRED_KEYS)})"]
    errors = [f"{path}: missing required key {key!r}"
              for key in REQUIRED_KEYS[schema] + ("mode", "gates")
              if key not in payload]
    gates = payload.get("gates")
    if not isinstance(gates, dict):
        errors.append(f"{path}: 'gates' must be a dict")
    else:
        for name, val in gates.items():
            if not _positive(val):
                errors.append(f"{path}: gate {name!r} must be a positive "
                              f"finite number, got {val!r}")
        # gates are wall seconds by contract: every key must carry a
        # time[s] suffix and no alias/mixed unit tokens
        errors += check_key_units(gates.keys(), context=path,
                                  require="time[s]")
    if errors:
        return errors
    if schema == "torch-bench-kernels/v1":
        tables = payload["latency_tables"]
        if not tables:
            errors.append(f"{path}: latency_tables is empty")
        for arch, tab in tables.items():
            if tab.get("schema") != "latency-table/v1":
                errors.append(f"{path}: latency table {arch!r} has bad "
                              f"schema tag {tab.get('schema')!r}")
    elif schema == "torch-bench-card-calibration/v1":
        if not payload["measured"].get("rows"):
            errors.append(f"{path}: measured.rows is empty — the "
                          "no-dryrun fallback must still calibrate")
    elif schema == "torch-bench-churn/v1":
        if not payload["sweep"]:
            errors.append(f"{path}: sweep is empty")
        for row in payload["sweep"]:
            frac = row.get("survivor_fraction")
            if not isinstance(frac, (int, float)) or not 0.0 <= frac <= 1.0:
                errors.append(f"{path}: survivor_fraction {frac!r} "
                              "not in [0, 1]")
    elif schema == "torch-bench-serving/v1":
        for row in payload["sweep"]:
            if row.get("drained") is not True:
                errors.append(f"{path}: sweep row slots={row.get('slots')} "
                              f"adapters={row.get('adapters')} did not "
                              "drain — throughput numbers are meaningless")
        errors += _grid_errors(path, payload["sweep"],
                               ("requests_per_s", "tokens_per_sec",
                                "mean_ttft_s"), ("slots", "adapters"))
    elif schema == "torch-bench-hierarchy/v1":
        errors += _grid_errors(path, payload["sweep"],
                               ("mean_round_s", "mean_delay_s",
                                "mean_energy_j"), ("servers", "devices"))
    return errors


def validate(path: str) -> List[str]:
    """Schema errors of the payload file at ``path`` (empty = valid)."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable ({e})"]
    return validate_payload(payload, path)


def compare_gates(baseline_path: str, fresh_path: str,
                  threshold: float) -> List[str]:
    """Regression messages (empty = gate green)."""
    with open(baseline_path) as f:
        base = json.load(f).get("gates", {})
    with open(fresh_path) as f:
        fresh = json.load(f).get("gates", {})
    common = sorted(set(base) & set(fresh))
    if base and fresh and not common:
        return [f"{fresh_path}: no gate keys overlap the baseline "
                f"({sorted(base)[:3]}... vs {sorted(fresh)[:3]}...) — "
                "schema drift?"]
    failures = []
    for name in common:
        ratio = fresh[name] / base[name]
        marker = "FAIL" if ratio > threshold else "ok"
        print(f"  gate {name}: {base[name]:.6g}s -> {fresh[name]:.6g}s "
              f"({ratio:.2f}x) {marker}")
        if ratio > threshold:
            failures.append(f"{fresh_path}: {name} regressed {ratio:.2f}x "
                            f"(> {threshold:.1f}x allowed)")
    return failures


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--validate", nargs="+", metavar="FILE",
                    help="only validate these payloads, no baseline compare")
    ap.add_argument("--baseline-dir", default=".",
                    help="directory holding the baseline BENCH_torch_*.json")
    ap.add_argument("--fresh-dir", default=".",
                    help="directory holding the fresh BENCH_torch_*.json")
    ap.add_argument("--threshold", type=float, default=2.0,
                    help="fail on > threshold x slowdown of a gated path")
    args = ap.parse_args(argv)

    errors: List[str] = []
    if args.validate:
        for path in args.validate:
            errors += validate(path)
    else:
        for name in BENCH_FILES:
            fresh = os.path.join(args.fresh_dir, name)
            base = os.path.join(args.baseline_dir, name)
            if not os.path.exists(fresh):
                errors.append(f"{fresh}: missing fresh benchmark output")
                continue
            errors += validate(fresh)
            if not os.path.exists(base):
                print(f"  {name}: no baseline yet — skipping compare "
                      "(first run)")
                continue
            print(f"{name}:")
            errors += compare_gates(base, fresh, args.threshold)

    if errors:
        print("\nbench gate FAILED:", file=sys.stderr)
        for e in errors:
            print(f"  {e}", file=sys.stderr)
        return 1
    print("bench gate green")
    return 0


if __name__ == "__main__":
    sys.exit(main())
