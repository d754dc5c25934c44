"""Multi-tenant serving throughput on the port: RPS / TTFT / tokens-per-sec
over slot counts x adapter counts.

    python -m repro_torch.launch.serving_bench [--smoke] [--json [PATH]]
                                               [--reduced] [--device cpu]

Sweeps the continuous-batching engine over slot counts x adapter counts
(one frozen backbone, per-request LoRA adapters gathered from an
``AdapterBank``, the fused LoRA kernels on: ``lora_matmul`` in every prefill
chunk, ``lora_matmul_grouped`` in every decode tick) and reports
requests-per-second, mean time-to-first-token and decoded tokens-per-second
for each point. A run that fails to drain is a hard error. A second run
admits requests through the channel-aware controller under a tight
bandwidth budget and keeps its per-tenant queueing stats. The gates are the
warm wall time of one decode tick per slot count (every slot occupied);
beside each, on the card, the device time of the same tick.

The twin of the reference's ``benchmarks/serving_bench.py``, same grids
(``--smoke``: slots (2, 4) x adapters (1, 2), 6 requests). The reference
serves qwen3-0.6b at its reduced width; here it is served at its published
width (28 layers, d_model 1024, vocab 151,936, bf16) unless ``--reduced``,
with random weights from the seed and adapters whose B is seeded and
non-zero (the standard B = 0 would make every adapter the backbone).

Nothing is written unless ``--json`` (default path
``BENCH_torch_serving.json``); ``device=None`` is the GPU and raises without
one. On the CPU every kernel wrapper runs its plain version and no device
time is taken.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.measured_cost import time_cuda
from repro_torch.launch import write_payload
from repro_torch.models import blocks
from repro_torch.models import model as model_lib
from repro_torch.models.common import (Params, describe_device,
                                       make_generator, resolve_device,
                                       tree_map)
from repro_torch.serving import (AdapterBank, ChannelAdmissionController,
                                 Request, ServingEngine)

SCHEMA = "torch-bench-serving/v1"
DEFAULT_JSON = "BENCH_torch_serving.json"
ARCH = "qwen3-0.6b"
ADAPTER_SEEDS = (0, 7, 13, 21, 42, 77, 101, 202)
B_STD = 0.02                 # std of an adapter's seeded B
LORA_KERNELS = ("lora_matmul", "lora_matmul_grouped")
# the reference's grids: ``--smoke`` and the full run
SMOKE_GRID = dict(slot_counts=(2, 4), adapter_counts=(1, 2), requests=6,
                  prompt_len=9, max_new=4, tick_iters=10)
FULL_GRID = dict(slot_counts=(2, 4, 8), adapter_counts=(1, 4, 8),
                 requests=24, prompt_len=24, max_new=12, max_len=128,
                 tick_iters=50)


def make_adapter(cfg: ModelConfig, seed: int, device) -> Params:
    """One adapter tree: the standard A from ``seed`` and B overwritten with
    seeded non-zero values (std ``B_STD``)."""
    gen = make_generator(seed, device)
    layers = [blocks.init_layer_lora(gen, cfg, device)
              for _ in range(cfg.n_layers)]
    lora = {"layers": tree_map(lambda *xs: torch.stack(xs), *layers)}
    rng = np.random.default_rng(seed)

    def fill(tree: Params) -> None:
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                fill(leaf)
            elif key == "b":
                b = rng.standard_normal(tuple(leaf.shape)) * B_STD
                tree[key] = torch.from_numpy(b.astype(np.float32)).to(
                    device=leaf.device, dtype=leaf.dtype)
    fill(lora)
    return lora


def _make_requests(cfg: ModelConfig, n: int, n_adapters: int,
                   prompt_len: int, max_new: int, seed: int = 0
                   ) -> List[Request]:
    rng = np.random.default_rng(seed)
    return [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size, prompt_len,
                                        dtype=np.int32).astype(np.int32),
                    max_new=max_new, adapter_id=i % n_adapters)
            for i in range(n)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_decode_tick(cfg: ModelConfig, frozen: Params, bank: AdapterBank,
                      slots: int, max_len: int, iters: int, *,
                      use_lora_kernel: bool, device: torch.device):
    """(wall seconds, device seconds or None) of ONE decode tick on a fresh
    engine, every slot occupied, per-slot positions and adapter ids: the
    wall time is the mean of ``iters`` warm ``eng._step`` calls ended by a
    synchronise (the reference's gate). The device time, on the card only,
    is the same tick's kernels without the host between them: the tick
    (``eng._step_on_device`` on inputs already on the card) captured into a
    CUDA graph and replayed between CUDA events, best of ``iters``
    (``measured_cost.time_cuda``)."""
    eng = ServingEngine(cfg, frozen, bank, slots=slots, max_len=max_len,
                        use_lora_kernel=use_lora_kernel, device=device)
    toks = np.ones((slots, 1), np.int32)
    ts = np.arange(1, slots + 1, dtype=np.int32)
    ids = np.arange(slots, dtype=np.int32) % bank.n
    eng._step(toks, ts, ids)                         # warm
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        eng._step(toks, ts, ids)
    _sync(device)
    wall_s = (time.perf_counter() - t0) / iters
    device_s = None
    if device.type == "cuda":
        args = [torch.as_tensor(a, device=device) for a in (toks, ts, ids)]
        device_s = time_cuda([lambda: eng._step_on_device(*args)], iters)
    return wall_s, device_s


def run(*, slot_counts=(2, 4), adapter_counts=(1, 4), requests: int = 8,
        prompt_len: int = 12, max_new: int = 6, prefill_chunk: int = 4,
        max_len: int = 64, tick_iters: int = 20, seed: int = 0,
        device=None, reduced: bool = False, use_lora_kernel: bool = True,
        frozen: Optional[Params] = None,
        adapters: Optional[Sequence[Params]] = None) -> Dict:
    """The sweep, the admission run and the gates as one JSON-able dict.
    ``frozen`` and ``adapters`` (at least ``max(adapter_counts)``) replace
    the seeded weights; they must lie on ``device``."""
    dev = resolve_device(device)
    cfg = get_config(ARCH)
    if reduced:
        cfg = cfg.reduced()
    if frozen is None:
        frozen = model_lib.init_params(seed, cfg, device=dev)["frozen"]
    n_max = max(adapter_counts)
    if adapters is None:
        adapters = [make_adapter(cfg, s, dev) for s in ADAPTER_SEEDS[:n_max]]
    if len(adapters) < n_max:
        raise ValueError(f"{len(adapters)} adapters given, the sweep needs "
                         f"{n_max}")
    adapters = list(adapters)[:n_max]
    launches0 = kernels.launch_counts()
    versions0 = kernels.version_counts()
    # one request through its own engine first (a prefill chunk and decode
    # ticks), so that no row pays for first-call set-up
    warm = ServingEngine(cfg, frozen, AdapterBank(adapters[:1]),
                         slots=slot_counts[0], max_len=max_len,
                         prefill_chunk=prefill_chunk,
                         use_lora_kernel=use_lora_kernel, device=dev)
    warm.submit(_make_requests(cfg, 1, 1, prompt_len, 2, seed)[0])
    warm.run_until_drained()

    out: Dict = {"arch": ARCH, "reduced": reduced,
                 "device": describe_device(dev),
                 "use_lora_kernel": use_lora_kernel,
                 "engine": {"max_len": max_len,
                            "prefill_chunk": prefill_chunk,
                            "requests": requests,
                            "prompt_len": prompt_len,
                            "max_new": max_new},
                 "sweep": []}
    for slots in slot_counts:
        for n_adapters in adapter_counts:
            bank = AdapterBank(adapters[:n_adapters])
            eng = ServingEngine(cfg, frozen, bank, slots=slots,
                                max_len=max_len, prefill_chunk=prefill_chunk,
                                use_lora_kernel=use_lora_kernel, device=dev)
            for req in _make_requests(cfg, requests, n_adapters,
                                      prompt_len, max_new, seed):
                eng.submit(req)
            stats = eng.run_until_drained(max_ticks=50_000)
            if not stats["drained"]:
                raise RuntimeError(
                    f"serving bench did not drain at slots={slots} "
                    f"adapters={n_adapters}: pending={stats['pending']} "
                    f"after {stats['ticks']} ticks")
            out["sweep"].append({
                "slots": slots,
                "adapters": n_adapters,
                "requests": requests,
                **{k: stats[k] for k in (
                    "completed", "drained", "ticks", "prefills", "tokens",
                    "requests_per_s", "tokens_per_sec", "mean_ttft_s",
                    "wall_s")},
            })

    # channel-aware admission under a tight budget: contention must show up
    # in the per-tenant queueing stats (informational, not gated)
    bank = AdapterBank(adapters[:min(2, n_max)])
    ctl = ChannelAdmissionController(
        bandwidth_hz=4e4, training_reserve_frac=0.5,
        token_rate_per_s=2000.0, bits_per_token=32.0, seed=seed)
    eng = ServingEngine(cfg, frozen, bank, slots=max(slot_counts),
                        max_len=max_len, prefill_chunk=prefill_chunk,
                        admission=ctl, use_lora_kernel=use_lora_kernel,
                        device=dev)
    for req in _make_requests(cfg, requests, bank.n, prompt_len, max_new,
                              seed + 1):
        eng.submit(req)
    adm_stats = eng.run_until_drained(max_ticks=50_000)
    if not adm_stats["drained"]:
        raise RuntimeError("admission-controlled serving run did not drain: "
                           f"pending={adm_stats['pending']}")
    out["admission"] = adm_stats["admission"]

    bank_full = AdapterBank(adapters)
    out["gates"], out["decode_tick_device_s"] = {}, {}
    for slots in slot_counts:
        wall_s, device_s = _time_decode_tick(
            cfg, frozen, bank_full, slots, max_len, tick_iters,
            use_lora_kernel=use_lora_kernel, device=dev)
        out["gates"][f"serving_decode_tick_s_{slots}slot"] = wall_s
        out["decode_tick_device_s"][f"{slots}slot"] = device_s

    launches = kernels.launch_counts()
    versions = kernels.version_counts()
    out["launches"] = {k: launches[k] - launches0[k] for k in LORA_KERNELS}
    out["launches_by_version"] = {
        k: {v: n - versions0[k][v] for v, n in versions[k].items()}
        for k in LORA_KERNELS}
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sweep, just prove the path runs")
    ap.add_argument("--json", nargs="?", const=DEFAULT_JSON, metavar="PATH",
                    help=f"write the payload (default path {DEFAULT_JSON})")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reference's reduced width, not the "
                         "published one")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    kw = dict(device=args.device, reduced=args.reduced)
    res = run(**(SMOKE_GRID if args.smoke else FULL_GRID), **kw)
    res["schema"] = SCHEMA
    res["mode"] = "smoke" if args.smoke else "full"
    if args.json:
        write_payload(args.json, res)
    print(f"device: {res['device']}")
    print_table(res)
    return res


def print_table(res: Dict) -> None:
    """The reference's CSV and gate lines, with each tick's device time."""
    print("slots,adapters,completed,rps,mean_ttft_s,tokens_per_sec,ticks")
    for row in res["sweep"]:
        print(f"{row['slots']},{row['adapters']},{row['completed']},"
              f"{row['requests_per_s']:.2f},{row['mean_ttft_s']:.4f},"
              f"{row['tokens_per_sec']:.1f},{row['ticks']}")
    for name, val in res["gates"].items():
        dev_s = res["decode_tick_device_s"][name.rsplit("_", 1)[-1]]
        device = "not measured" if dev_s is None else f"{dev_s * 1e3:.2f} ms"
        print(f"gate {name}: {val * 1e3:.2f} ms (device {device})")


if __name__ == "__main__":
    main()
