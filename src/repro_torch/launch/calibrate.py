"""Calibrate CARD on the card's own kernel timings.

    python -m repro_torch.launch.calibrate [--smoke] [--json PATH] [--reps N]
                                           [--device cpu]

The measured-cost pipeline of the paper's decision stack, on the GPU: time
the port's Hopper kernels over the probe ladder (``measured_cost``), fit the
roofline, build one ``LatencyTable`` per architecture at the fleet workload
(batch 4, sequence 512), and compare the analytic and the measured
fine-tuning cost per architecture. Without ``--smoke`` it also times the
four kernel benches (``lora_matmul``, ``flash_attention``, ``ssd_scan``,
``flash_decode``) against their plain versions and against the least time
an H100 could take for the same work. It is the counterpart of the
reference's ``benchmarks/kernel_bench.py::run`` and
``benchmarks/cost_model_calibration.py::run_measured``.

``decision_divergence`` then runs ``simulate_fleet`` (``batched_card``) over
a fleet with the analytic and with the measured tables and reports where
the measured latencies move CARD's cut; ``scalar_agreement`` holds the
batched decisions (float32, on the card) to the scalar float64 oracle
``card``.

Nothing is written unless ``--json`` is given. ``device=None`` (no
``--device``) means the GPU and raises without one; ``--device cpu`` with
``--smoke`` times the plain versions on the CPU, which says nothing about a
device.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core import card as C
from repro_torch.core.channel import draw_channel_matrix
from repro_torch.core.cost_model import (BatchedRoundContext, RoundContext,
                                         Workload, resolve_compute)
from repro_torch.core.hardware import (DEFAULT_SIM, SERVER_RTX4060TI,
                                       make_heterogeneous_fleet,
                                       profile_from_throughput)
from repro_torch.core.measured_cost import (LatencyTable, RooflineFit,
                                            _time_call, build_latency_tables,
                                            fit_roofline, normal_inputs,
                                            probe_kernels)
from repro_torch.core.scheduler import simulate_fleet
from repro_torch.launch import write_payload
from repro_torch.models.common import describe_device, resolve_device

SCHEMA = "torch-calibrate/v1"
DEFAULT_TABLE_BATCH = 4     # SimParams.mini_batch — the fleet workload shape
DEFAULT_TABLE_SEQ = 512     # SimParams.seq_len

# published peaks of one H100 SXM (dense): bytes/s of HBM3, FLOP/s by type
H100_HBM_BYTES_PER_S = 3.35e12
H100_PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

#: the kernel benches' shapes (the reference's): lora_matmul (M, K, N, r);
#: flash_attention (B, S, Hq, Hkv, D), causal; ssd_scan (B, L, nh, hp, ns,
#: chunk); flash_decode (B, S, Hq, Hkv, D) at t = S - 1
BENCH_SHAPES = {"lora_matmul": (512, 512, 512, 16),
                "flash_attention": (1, 512, 8, 4, 64),
                "ssd_scan": (1, 512, 4, 64, 64, 128),
                "flash_decode": (2, 1024, 8, 4, 64)}

#: the relative gap between the two best scalar costs below which a float32
#: batched decision may rightly pick the other cut
NEAR_TIE_REL = 1e-5


def h100_bound_s(hbm_bytes: float, flops: float, dtype=torch.float32):
    """(least seconds an H100 could take, "bytes" | "operations")."""
    t_bytes = hbm_bytes / H100_HBM_BYTES_PER_S
    t_ops = flops / H100_PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------------------
# Kernel benches (f32, the reference's shapes)
# ---------------------------------------------------------------------------


def _bench_row(name, kernel_fn, plain_fn, hbm_bytes, flops, device, reps,
               **extra) -> Dict:
    if device.type != "cuda":
        raise ValueError("the kernel benches time the CUDA kernels and need "
                         f"a CUDA device, not {device}")
    kernel_s = _time_call(kernel_fn, reps, device)
    plain_s = _time_call(plain_fn, reps, device)
    bound, by = h100_bound_s(hbm_bytes, flops)
    return {"name": name, "kernel_us": kernel_s * 1e6,
            "plain_us": plain_s * 1e6, "h100_bound_us": bound * 1e6,
            "bound_by": by, "flops": flops, "hbm_bytes": hbm_bytes, **extra}


def bench_lora_matmul(device, reps: int = 3) -> Dict:
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ops
    m, k, n, r = BENCH_SHAPES["lora_matmul"]
    x, w, a, b = normal_inputs(0, device, (m, k), (k, n), (k, r), (r, n))
    flops = 2.0 * m * k * n + 2.0 * m * k * r + 2.0 * m * r * n
    return _bench_row("lora_matmul_512",
                      lambda: ops.lora_matmul(x, w, a, b, 2.0),
                      lambda: lm.lora_matmul_ref(x, w, a, b, 2.0),
                      4.0 * (m * k + k * n + k * r + r * n + m * n), flops,
                      device, reps)


def bench_flash_attention(device, reps: int = 3) -> Dict:
    from repro_torch.kernels import ops
    from repro_torch.models.attention import chunked_attention
    b, s, hq, hkv, d = BENCH_SHAPES["flash_attention"]
    q, k, v = normal_inputs(1, device, (b, s, hq, d), (b, s, hkv, d),
                            (b, s, hkv, d))
    pos = torch.arange(s, device=device).expand(b, s)
    pairs = s * (s + 1) // 2                 # unmasked (query, key) pairs
    return _bench_row(
        "flash_attention_512", lambda: ops.flash_attention(q, k, v),
        lambda: chunked_attention(q, k, v, causal=True, window=0,
                                  q_positions=pos, k_positions=pos),
        4.0 * (2 * b * s * hq * d + 2 * b * s * hkv * d),
        4.0 * d * pairs * b * hq, device, reps)


def bench_ssd_scan(device, reps: int = 3) -> Dict:
    from repro_torch.kernels import ops
    from repro_torch.models.mamba import ssd_chunked
    b, length, nh, hp, ns, chunk = BENCH_SHAPES["ssd_scan"]
    xt, a, B, Cm = normal_inputs(2, device, (b, length, nh, hp),
                                 (b, length, nh), (b, length, ns),
                                 (b, length, ns))
    xt, a, B, Cm = xt * 0.2, -a.abs() * 0.1, B * 0.3, Cm * 0.3
    di = nh * hp
    flops = float(b * length) * (2.0 * chunk * di + 4.0 * di * ns)
    return _bench_row(
        "ssd_scan_512", lambda: ops.ssd_scan(xt, a, B, Cm, chunk),
        lambda: ssd_chunked(xt, a, B, Cm, chunk),
        4.0 * b * length * (2 * nh * hp + nh + 2 * ns), flops, device, reps)


def bench_flash_decode(device, reps: int = 3) -> Dict:
    from repro_torch.kernels import ops
    from repro_torch.models.attention import naive_attention
    b, s, hq, hkv, d = BENCH_SHAPES["flash_decode"]
    q, k, v = normal_inputs(3, device, (b, 1, hq, d), (b, s, hkv, d),
                            (b, s, hkv, d))
    t = s - 1
    pos = torch.full((b, 1), t, dtype=torch.int32, device=device)
    kpos = torch.arange(s, device=device).expand(b, s)
    return _bench_row(
        "flash_decode_1k", lambda: ops.flash_decode(q, k, v, t),
        lambda: naive_attention(q, k, v, causal=True, window=0,
                                q_positions=pos, k_positions=kpos),
        4.0 * (2 * b * hq * d + 2 * b * s * hkv * d), 4.0 * b * hq * s * d,
        device, reps)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


def run_measured(fit: RooflineFit, *, batch: int = DEFAULT_TABLE_BATCH,
                 seq_len: int = DEFAULT_TABLE_SEQ,
                 archs: Sequence[str] = ARCH_IDS) -> Dict:
    """Analytic eta vs measured effective eta for every architecture:
    ``inflation = effective / analytic``, how much costlier the step is on
    the fitted roofline than the paper's peak-FLOPs accounting says."""
    tables = build_latency_tables(fit, batch=batch, seq_len=seq_len,
                                  archs=archs)
    rows = []
    for arch in archs:
        w = Workload(get_config(arch), batch, seq_len)
        analytic = resolve_compute(w, "analytic").total_flops()
        measured = resolve_compute(w, "measured", tables[arch]).total_flops()
        rows.append({"arch": arch, "analytic_eta_gflops": analytic / 1e9,
                     "effective_eta_gflops": measured / 1e9,
                     "inflation": measured / analytic})
    return {"fit": fit.to_dict(), "batch": batch, "seq_len": seq_len,
            "rows": rows}


def run(*, smoke: bool = False, reps: int = 3, device=None) -> Dict:
    """Probe -> fit -> per-arch latency tables (-> kernel benches unless
    ``smoke``), as one JSON-able payload."""
    dev = resolve_device(device)
    t0 = time.time()
    probes = probe_kernels(mode="smoke" if smoke else "full", reps=reps,
                           device=dev)
    fit = fit_roofline(probes)
    tables = build_latency_tables(fit, batch=DEFAULT_TABLE_BATCH,
                                  seq_len=DEFAULT_TABLE_SEQ)
    host = profile_from_throughput("calibrated-card", fit.ref_throughput)
    payload: Dict = {
        "schema": SCHEMA,
        "mode": "smoke" if smoke else "full",
        "device": describe_device(dev),
        "probes": [p.to_dict() for p in probes],
        "roofline_fit": fit.to_dict(),
        "host_profile": {"name": host.name, "peak_flops": host.peak_flops},
        "latency_tables": {a: t.to_dict() for a, t in tables.items()},
        "measured": run_measured(fit),
    }
    if not smoke:
        with torch.no_grad():
            payload["kernels"] = [bench_lora_matmul(dev, reps),
                                  bench_flash_attention(dev, reps),
                                  bench_ssd_scan(dev, reps),
                                  bench_flash_decode(dev, reps)]
    payload["seconds"] = time.time() - t0
    return payload


def _fleet(arch: str, state: str, n_devices: int, rounds: int, seed: int):
    """The fleet workload, a heterogeneous fleet and its channel draws."""
    workload = Workload(get_config(arch), DEFAULT_TABLE_BATCH,
                        DEFAULT_TABLE_SEQ)
    fleet = make_heterogeneous_fleet(n_devices, seed=seed)
    sim = DEFAULT_SIM
    chans = draw_channel_matrix(state, rounds, n_devices, seed=seed,
                                bandwidth_hz=sim.bandwidth_hz,
                                tx_power_dbm_up=sim.tx_power_dbm_up,
                                tx_power_dbm_down=sim.tx_power_dbm_down,
                                noise_dbm_per_hz=sim.noise_dbm_per_hz)
    return workload, fleet, chans


def _source(table: Optional[LatencyTable]) -> Dict:
    """``cost_source`` keywords: analytic without a table, else measured."""
    if table is None:
        return {}
    return {"cost_source": "measured", "latency_table": table}


def decision_divergence(tables: Dict[str, LatencyTable], *,
                        archs: Sequence[str] = ("llama32-1b", "qwen3-4b",
                                                "granite-moe-3b-a800m",
                                                "mamba2-370m"),
                        states: Sequence[str] = ("good", "normal", "poor"),
                        n_devices: int = 100, rounds: int = 20, seed: int = 0,
                        device=None) -> Dict:
    """Where do measured latencies move CARD's decisions? For every (arch,
    channel state), the same fleet and channel draws through
    ``simulate_fleet`` (``batched_card`` on ``device``) with
    ``cost_source="analytic"`` and ``"measured"``."""
    dev = resolve_device(device)
    fleet = make_heterogeneous_fleet(n_devices, seed=seed)
    cells = []
    moved_total = n_total = 0
    for arch in archs:
        for state in states:
            a, m = (simulate_fleet(get_config(arch), channel_state=state,
                                   rounds=rounds, devices=fleet, seed=seed,
                                   device=dev, **_source(table))
                    for table in (None, tables[arch]))
            moved = a.cuts != m.cuts
            moved_total += int(moved.sum())
            n_total += moved.size
            cells.append({
                "arch": arch, "channel_state": state,
                "frac_decisions_moved": float(moved.mean()),
                "mean_cut_analytic": float(a.cuts.mean()),
                "mean_cut_measured": float(m.cuts.mean()),
                "mean_freq_shift_ghz": float((m.freqs - a.freqs).mean()
                                             / 1e9),
                "mean_delay_ratio": float(m.delays.mean()
                                          / max(a.delays.mean(), 1e-30)),
            })
    return {"cells": cells, "rounds": rounds, "n_devices": n_devices,
            "frac_decisions_moved_overall": (moved_total / n_total
                                             if n_total else 0.0)}


def is_near_tie(ctx: RoundContext, frequency: float) -> bool:
    """Whether the scalar costs of the two best feasible cuts at
    ``frequency`` differ by at most ``NEAR_TIE_REL`` relative: there a
    float32 batched decision may rightly pick the other cut."""
    corners = ctx.corners()
    costs = sorted(ctx.cost(c, frequency, corners)
                   for c in range(ctx.max_feasible_cut() + 1))
    return (len(costs) > 1 and costs[1] - costs[0]
            <= NEAR_TIE_REL * max(abs(costs[0]), abs(costs[1])))


def scalar_agreement(arch: str, table: Optional[LatencyTable], *,
                     state: str = "normal", n_devices: int = 100,
                     rounds: int = 20, seed: int = 0, device=None) -> Dict:
    """``batched_card`` (float32 tensors on ``device``) against the scalar
    float64 ``card`` on every (round, device): the cuts must be equal
    wherever the scalar costs of the two best cuts differ by more than
    ``NEAR_TIE_REL`` relative; the near-ties are counted."""
    dev = resolve_device(device)
    workload, fleet, chans = _fleet(arch, state, n_devices, rounds, seed)
    kw = _source(table)
    dec_b = C.batched_card(BatchedRoundContext.build(
        workload, fleet, SERVER_RTX4060TI, chans, DEFAULT_SIM, device=dev,
        **kw))
    batched, bfreqs = dec_b.cuts.cpu().numpy(), dec_b.freqs.cpu().numpy()
    near_ties = disagree = 0
    worst_freq_rel = 0.0
    for r in range(rounds):
        for d, profile in enumerate(fleet):
            ctx = RoundContext(workload=workload, device=profile,
                               server=SERVER_RTX4060TI,
                               channel=chans.state(r, d), sim=DEFAULT_SIM,
                               **kw)
            dec = C.card(ctx)
            if is_near_tie(ctx, dec.frequency):
                near_ties += 1
            elif batched[r, d] != dec.cut:
                disagree += 1
            worst_freq_rel = max(worst_freq_rel,
                                 abs(float(bfreqs[r, d]) - dec.frequency)
                                 / dec.frequency)
    return {"arch": arch, "cost_source": kw.get("cost_source", "analytic"),
            "channel_state": state, "decisions": rounds * n_devices,
            "near_ties": near_ties, "disagree_beyond_near_ties": disagree,
            "worst_freq_rel_diff": worst_freq_rel}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the small probe ladder only, no kernel benches")
    ap.add_argument("--json", metavar="PATH",
                    help="write the payload here")
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
    for row in payload["measured"]["rows"]:
        print(f"{row['arch']:24s} eta={row['analytic_eta_gflops']:9.1f}G "
              f"effective={row['effective_eta_gflops']:9.1f}G "
              f"inflation={row['inflation']:.3f}")
    for row in payload.get("kernels", ()):
        print(row)


if __name__ == "__main__":
    main()
