"""Measured cost model: kernel timing probes -> roofline fit -> LatencyTable.

A port of the reference's ``core/measured_cost.py``. The bridge between the
kernels and CARD's decisions:

  1. ``probe_kernels``     — time the port's Hopper kernels (backend
                             ``"cuda"``) or their plain PyTorch versions
                             (backend ``"plain"``) at a ladder of shapes,
                             recording (FLOPs, HBM bytes, seconds) per probe;
  2. ``fit_roofline``      — least-squares fit of the two-term roofline
                             ``t = flops / C + bytes / B`` plus a per-call
                             overhead to the probe samples (numpy, the
                             reference's arithmetic);
  3. ``LatencyTable``      — per-architecture per-layer forward latencies
                             predicted from the fit (or synthesized from
                             the analytic model), the pluggable backend
                             ``cost_model.RoundContext`` /
                             ``BatchedRoundContext`` consume via
                             ``cost_source="measured"``.

The currency trick: a ``LatencyTable`` stores *seconds at a reference
throughput*; ``TableCompute`` converts them back into **effective FLOPs**
(``seconds * ref_throughput``), so every downstream equation of the paper
(Eqs. 7, 8, 11 and the closed-form Eq. 16 frequency) applies unchanged.

Timing: on a CUDA device a probe is timed with CUDA events around the
replay of a CUDA graph that holds the call several times, best of ``reps``:
the device's time, not the host's (see ``time_cuda``). On the CPU (plain
backend only) the host clock is used. A
probe never switches backend on its own: the ``"cuda"`` backend without a
CUDA device raises.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from functools import cached_property
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, ModelConfig, get_config
from repro_torch.core.cost_model import (LORA_TRAIN_FACTOR, Workload,
                                         embed_fwd_flops_per_token,
                                         head_fwd_flops_per_token,
                                         layer_fwd_flops_per_token)
from repro_torch.models.common import resolve_device

#: serialization schema tag for latency tables
LATENCY_TABLE_SCHEMA = "latency-table/v1"

PROBE_BACKENDS = ("cuda", "plain")

#: device seconds one graph replay window should last
_GRAPH_WINDOW_S = 2e-3


# ---------------------------------------------------------------------------
# Timing probes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ProbeResult:
    """One timed kernel invocation with its roofline coordinates."""
    kernel: str        # lora_matmul | flash_attention | ssd_scan
    backend: str       # "cuda" (the Hopper kernels) | "plain" (PyTorch)
    shape: str         # human-readable shape tag
    flops: float       # analytic FLOPs of the call
    hbm_bytes: float   # bytes moved between HBM and compute (inputs+outputs)
    seconds: float     # best-of-reps time
    version: str = "plain"   # the kernel version timed ("plain" backend: "plain")

    def to_dict(self) -> Dict:
        return {"kernel": self.kernel, "backend": self.backend,
                "shape": self.shape, "flops": self.flops,
                "hbm_bytes": self.hbm_bytes, "seconds": self.seconds,
                "version": self.version}


def time_cuda(calls: Sequence[Callable], reps: int) -> float:
    """Best-of-reps device seconds per call. ``calls`` is one round of
    thunks (several over distinct buffers keep the inputs out of the L2
    cache, as on a model's path). One round between two CUDA events sizes
    the window; then ``n`` rounds are captured into a CUDA graph, and each
    rep replays it between the events (seconds per call = elapsed / (n *
    len(calls))). Every call goes through the graph, the short ones as well
    as the long: an eager call that the host cannot launch faster than the
    card runs it would time the host, and the events would not show it.

    The wrappers count a captured launch once, at capture; the graph's
    replays are handed to ``kernels.note_graph_replays`` so that
    ``kernels.runs_on_card`` counts what the card ran."""
    from repro_torch import kernels

    def round_():
        for c in calls:
            c()

    round_()                               # first call pays build and set-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    round_()
    stop.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(stop) * 1e-3
    n = max(1, min(200, math.ceil(_GRAPH_WINDOW_S / max(eager, 1e-7))))
    before = kernels.launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            round_()
    captured = {k: c - before[k] for k, c in kernels.launch_counts().items()}
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(max(reps, 1)):
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) * 1e-3 / (n * len(calls)))
    kernels.note_graph_replays(captured, 1 + max(reps, 1))
    return best


def _time_host(fn: Callable, reps: int) -> float:
    """Best-of-reps host wall seconds; one untimed call pays set-up."""
    fn()
    best = float("inf")
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _time_call(fn: Callable, reps: int, device: torch.device) -> float:
    if device.type == "cuda":
        return time_cuda([fn], reps)
    return _time_host(fn, reps)


def normal_inputs(seed: int, device, *shapes) -> List[torch.Tensor]:
    """Standard-normal f32 tensors of ``shapes`` on ``device``, drawn with
    numpy from ``seed`` (the probes' and benches' inputs)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                             ).to(device) for s in shapes]


def _lora_probe(m: int, k: int, n: int, r: int, backend: str, device):
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ops
    x, w, a, b = normal_inputs(0, device, (m, k), (k, n), (k, r), (r, n))
    call = ops.lora_matmul if backend == "cuda" else lm.lora_matmul_ref
    fn = lambda: call(x, w, a, b, 2.0)  # noqa: E731
    flops = 2 * m * k * n + 2 * m * k * r + 2 * m * r * n
    bytes_ = 4 * (m * k + k * n + k * r + r * n + m * n)
    return fn, float(flops), float(bytes_)


def _attention_probe(b: int, s: int, hq: int, hkv: int, d: int, backend: str,
                     device):
    from repro_torch.kernels import ops
    from repro_torch.models.attention import chunked_attention
    q, k, v = normal_inputs(1, device, (b, s, hq, d), (b, s, hkv, d),
                      (b, s, hkv, d))
    if backend == "cuda":
        fn = lambda: ops.flash_attention(q, k, v)  # noqa: E731
    else:
        pos = torch.arange(s, device=device).expand(b, s)
        fn = lambda: chunked_attention(  # noqa: E731
            q, k, v, causal=True, window=0, q_positions=pos, k_positions=pos)
    # causal scores + weighted sum: 2 matmuls x (S^2/2) x D per (b, hq)
    flops = 2.0 * b * hq * s * s * d
    bytes_ = 4.0 * (b * s * hq * d * 2 + b * s * hkv * d * 2)
    return fn, flops, bytes_


def _ssd_probe(b: int, length: int, nh: int, hp: int, ns: int, chunk: int,
               backend: str, device):
    from repro_torch.kernels import ops
    from repro_torch.models.mamba import ssd_chunked
    xt, a, B, C = normal_inputs(2, device, (b, length, nh, hp), (b, length, nh),
                          (b, length, ns), (b, length, ns))
    xt, a, B, C = xt * 0.2, -a.abs() * 0.1, B * 0.3, C * 0.3
    call = ops.ssd_scan if backend == "cuda" else ssd_chunked
    fn = lambda: call(xt, a, B, C, chunk)  # noqa: E731
    di = nh * hp
    flops = float(b * length) * (2.0 * chunk * di + 4.0 * di * ns)
    bytes_ = 4.0 * b * length * (2 * nh * hp + nh + 2 * ns)
    return fn, flops, bytes_


# shape ladders: varied size and arithmetic intensity so the compute,
# bandwidth, and per-call-overhead terms are separable in the fit (the tiny
# shapes pin the overhead intercept; the large ones pin compute)
_SMOKE_SHAPES: Tuple[Tuple[str, str, tuple], ...] = (
    ("lora_matmul", "128x128x128r8", (128, 128, 128, 8)),
    ("lora_matmul", "256x256x256r8", (256, 256, 256, 8)),
    ("lora_matmul", "512x512x512r16", (512, 512, 512, 16)),
    ("flash_attention", "b1s128h4", (1, 128, 4, 2, 32)),
    ("flash_attention", "b1s256h4", (1, 256, 4, 2, 32)),
    ("flash_attention", "b1s512h4", (1, 512, 4, 2, 32)),
    ("ssd_scan", "l128c32", (1, 128, 4, 32, 16, 32)),
    ("ssd_scan", "l256c64", (1, 256, 4, 32, 16, 64)),
)

_FULL_SHAPES: Tuple[Tuple[str, str, tuple], ...] = _SMOKE_SHAPES + (
    ("lora_matmul", "1024x1024x1024r16", (1024, 1024, 1024, 16)),
    ("lora_matmul", "256x1024x512r16", (256, 1024, 512, 16)),
    ("flash_attention", "b1s512h8", (1, 512, 8, 4, 64)),
    ("ssd_scan", "l512c128", (1, 512, 4, 64, 64, 128)),
)

_BUILDERS = {"lora_matmul": _lora_probe, "flash_attention": _attention_probe,
             "ssd_scan": _ssd_probe}
#: the kernel wrapper each probe's "cuda" backend launches
_WRAPPER = {"lora_matmul": "lora_matmul", "flash_attention": "flash_attention",
            "ssd_scan": "ssd_intra_chunk"}


def timed_version(wrapper: str, before) -> str:
    """The version(s) of ``wrapper`` launched since ``before`` (a
    ``kernels.version_counts()``), "+"-joined; "" if it launched none."""
    from repro_torch import kernels
    return "+".join(kernels.versions_since(before).get(wrapper, []))


def probe_kernels(*, mode: str = "smoke", backend: Optional[str] = None,
                  reps: int = 3, device=None) -> List[ProbeResult]:
    """Time the kernel ladder; returns one ``ProbeResult`` per shape.

    ``device=None`` means the GPU (raising without one); ``backend=None``
    means ``"cuda"`` on a CUDA device and ``"plain"`` elsewhere."""
    dev = resolve_device(device)
    backend = backend or ("cuda" if dev.type == "cuda" else "plain")
    if backend not in PROBE_BACKENDS:
        raise ValueError(f"unknown probe backend {backend!r}; expected one "
                         f"of {PROBE_BACKENDS}")
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError("the 'cuda' probe backend times the CUDA kernels "
                         f"and needs a CUDA device, not {dev}")
    if mode not in ("smoke", "full"):
        raise ValueError(f"mode must be 'smoke' or 'full', not {mode!r}")
    shapes = _SMOKE_SHAPES if mode == "smoke" else _FULL_SHAPES
    from repro_torch import kernels
    out = []
    with torch.no_grad():
        for kernel, tag, args in shapes:
            fn, flops, bytes_ = _BUILDERS[kernel](*args, backend, dev)
            before = kernels.version_counts()
            seconds = _time_call(fn, reps, dev)
            version = (timed_version(_WRAPPER[kernel], before)
                       if backend == "cuda" else "plain")
            out.append(ProbeResult(kernel=kernel, backend=backend, shape=tag,
                                   flops=flops, hbm_bytes=bytes_,
                                   seconds=seconds, version=version))
    return out


# ---------------------------------------------------------------------------
# Roofline fit: t = flops / C + bytes / B
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RooflineFit:
    """Host roofline fitted from probes.

    ``t = overhead_s + flops * inv_compute + bytes * inv_bandwidth`` — the
    two-term roofline of ``benchmarks/roofline.py`` plus a per-call launch
    overhead intercept (without it, small-shape probes poison the slopes).
    ``achieved_flops_per_s`` (best observed FLOPs rate across probes) is
    the fallback currency when the compute slope is not identifiable on a
    bandwidth-bound host.
    """
    inv_compute: float     # seconds per FLOP (1/C)
    inv_bandwidth: float   # seconds per byte (1/B)
    overhead_s: float      # per-call launch/dispatch overhead
    achieved_flops_per_s: float
    rel_residual: float    # ||t_pred - t|| / ||t|| over the fit samples
    n_probes: int
    backend: str

    @property
    def compute_flops_per_s(self) -> float:
        return 1.0 / self.inv_compute if self.inv_compute > 0 else float("inf")

    @property
    def bandwidth_bytes_per_s(self) -> float:
        return (1.0 / self.inv_bandwidth if self.inv_bandwidth > 0
                else float("inf"))

    @property
    def ref_throughput(self) -> float:
        """Finite FLOP/s currency for latency tables: the fitted sustained
        compute rate, or the best achieved rate when compute never bound."""
        if self.inv_compute > 0:
            return self.compute_flops_per_s
        return self.achieved_flops_per_s

    def predict(self, flops: float, hbm_bytes: float) -> float:
        """Roofline-model seconds for a call of the given footprint."""
        return (self.overhead_s + flops * self.inv_compute
                + hbm_bytes * self.inv_bandwidth)

    def to_dict(self) -> Dict:
        return {"inv_compute_s_per_flop": self.inv_compute,
                "inv_bandwidth_s_per_byte": self.inv_bandwidth,
                "overhead_s": self.overhead_s,
                "achieved_flops_per_s": self.achieved_flops_per_s,
                "compute_flops_per_s": self.compute_flops_per_s,
                "bandwidth_bytes_per_s": self.bandwidth_bytes_per_s,
                "rel_residual": self.rel_residual,
                "n_probes": self.n_probes, "backend": self.backend}

    @classmethod
    def from_dict(cls, d: Dict) -> "RooflineFit":
        return cls(inv_compute=d["inv_compute_s_per_flop"],
                   inv_bandwidth=d["inv_bandwidth_s_per_byte"],
                   overhead_s=d.get("overhead_s", 0.0),
                   achieved_flops_per_s=d.get("achieved_flops_per_s", 0.0),
                   rel_residual=d.get("rel_residual", 0.0),
                   n_probes=d.get("n_probes", 0),
                   backend=d.get("backend", "unknown"))


def _nnls(A: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Tiny active-set NNLS: drop negative coefficients and refit until all
    survivors are nonnegative (at most ``A.shape[1]`` iterations)."""
    active = list(range(A.shape[1]))
    coef = np.zeros(A.shape[1])
    while active:
        c, *_ = np.linalg.lstsq(A[:, active], t, rcond=None)
        if (c >= 0).all():
            coef[:] = 0.0
            coef[active] = c
            return coef
        active.pop(int(np.argmin(c)))
    return coef


def fit_roofline(probes: Sequence[ProbeResult]) -> RooflineFit:
    """Nonnegative least squares of ``t = t0 + a*flops + b*bytes``.

    Rows are weighted by 1/t (relative error): probe times span orders of
    magnitude and an absolute-error fit would ignore everything but the
    largest shape.
    """
    if not probes:
        raise ValueError("fit_roofline needs at least one probe")
    A = np.array([[1.0, p.flops, p.hbm_bytes] for p in probes], np.float64)
    t = np.array([p.seconds for p in probes], np.float64)
    w = 1.0 / np.maximum(t, 1e-12)
    coef = _nnls(A * w[:, None], t * w)
    pred = A @ coef
    rel = float(np.linalg.norm((pred - t) * w)) / np.sqrt(len(probes))
    achieved = max(p.flops / p.seconds for p in probes if p.seconds > 0)
    return RooflineFit(overhead_s=float(coef[0]),
                       inv_compute=float(coef[1]),
                       inv_bandwidth=float(coef[2]),
                       achieved_flops_per_s=float(achieved),
                       rel_residual=rel,
                       n_probes=len(probes),
                       backend=probes[0].backend)


# ---------------------------------------------------------------------------
# Per-layer HBM footprint (the bandwidth coordinate of a model layer)
# ---------------------------------------------------------------------------

_WEIGHT_BYTES = 2   # bf16 resident backbone
_ACT_BYTES = 4      # fp32 probe/compute activations


def layer_hbm_bytes(cfg: ModelConfig, tokens: int) -> float:
    """One decoder layer's forward HBM traffic: stream the (bf16) weights
    once + read/write/residual the activation tensor."""
    return (cfg.params_per_layer() * _WEIGHT_BYTES
            + 3.0 * tokens * cfg.d_model * _ACT_BYTES)


def embed_hbm_bytes(cfg: ModelConfig, tokens: int) -> float:
    """Embedding lookup: gather ``tokens`` rows + write the activations."""
    return (tokens * cfg.d_model * _WEIGHT_BYTES
            + tokens * cfg.d_model * _ACT_BYTES)


def head_hbm_bytes(cfg: ModelConfig, tokens: int) -> float:
    """LM head: stream the (d, V) matrix + write the logits."""
    return (cfg.d_model * cfg.vocab_size * _WEIGHT_BYTES
            + tokens * cfg.vocab_size * _ACT_BYTES)


# ---------------------------------------------------------------------------
# LatencyTable — the measured backend cost_model.py plugs in
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LatencyTable:
    """Per-layer forward latencies for one (arch, batch, seq) workload.

    ``seconds * ref_throughput`` is the effective-FLOPs currency consumed by
    ``TableCompute`` — with ``ref_throughput=1.0`` and seconds equal to the
    analytic FLOP counts, the table reproduces the analytic model exactly
    (the equivalence the tests pin down).
    """
    arch: str
    batch: int
    seq_len: int
    ref_throughput: float        # FLOP/s the seconds are normalized against
    embed_s: float               # forward seconds for the whole mini-batch
    layer_s: Tuple[float, ...]   # per decoder layer, len == cfg.n_layers
    head_s: float
    source: str = "measured"     # "analytic" | "measured:<backend>"

    def __post_init__(self):
        if not (0 < self.ref_throughput < float("inf")):
            raise ValueError("ref_throughput must be positive and finite")
        if any(s < 0 for s in self.layer_s):
            raise ValueError("negative per-layer latency")

    @property
    def n_layers(self) -> int:
        return len(self.layer_s)

    # ---- constructors ------------------------------------------------------
    @classmethod
    def from_analytic(cls, workload: Workload) -> "LatencyTable":
        """Synthesize the table that reproduces the analytic model exactly:
        ref_throughput 1.0, 'seconds' = forward FLOPs of each component."""
        cfg, tok = workload.cfg, workload.tokens
        layer = layer_fwd_flops_per_token(cfg, workload.seq_len) * tok
        return cls(arch=cfg.name, batch=workload.batch,
                   seq_len=workload.seq_len, ref_throughput=1.0,
                   embed_s=embed_fwd_flops_per_token(cfg) * tok,
                   layer_s=(layer,) * cfg.n_layers,
                   head_s=head_fwd_flops_per_token(cfg) * tok,
                   source="analytic")

    @classmethod
    def from_fit(cls, cfg: ModelConfig, fit: RooflineFit, *, batch: int,
                 seq_len: int) -> "LatencyTable":
        """Predict per-layer latency from the fitted roofline: compute term
        (analytic FLOPs / C) + bandwidth term (HBM footprint / B)."""
        tok = batch * seq_len
        layer = fit.predict(layer_fwd_flops_per_token(cfg, seq_len) * tok,
                            layer_hbm_bytes(cfg, tok))
        return cls(arch=cfg.name, batch=batch, seq_len=seq_len,
                   ref_throughput=fit.ref_throughput,
                   embed_s=fit.predict(embed_fwd_flops_per_token(cfg) * tok,
                                       embed_hbm_bytes(cfg, tok)),
                   layer_s=(layer,) * cfg.n_layers,
                   head_s=fit.predict(head_fwd_flops_per_token(cfg) * tok,
                                      head_hbm_bytes(cfg, tok)),
                   source=f"measured:{fit.backend}")

    # ---- serialization (the BENCH_kernels.json payload) --------------------
    def to_dict(self) -> Dict:
        return {"schema": LATENCY_TABLE_SCHEMA, "arch": self.arch,
                "batch": self.batch, "seq_len": self.seq_len,
                "ref_throughput": self.ref_throughput,
                "embed_s": self.embed_s, "layer_s": list(self.layer_s),
                "head_s": self.head_s, "source": self.source}

    @classmethod
    def from_dict(cls, d: Dict) -> "LatencyTable":
        if d.get("schema") != LATENCY_TABLE_SCHEMA:
            raise ValueError(f"not a latency table: {d.get('schema')!r}")
        return cls(arch=d["arch"], batch=d["batch"], seq_len=d["seq_len"],
                   ref_throughput=d["ref_throughput"], embed_s=d["embed_s"],
                   layer_s=tuple(d["layer_s"]), head_s=d["head_s"],
                   source=d.get("source", "measured"))


def build_latency_tables(fit: RooflineFit, *, batch: int, seq_len: int,
                         archs: Sequence[str] = ARCH_IDS
                         ) -> Dict[str, LatencyTable]:
    """One calibrated table per architecture config from a single fit."""
    return {a: LatencyTable.from_fit(get_config(a), fit, batch=batch,
                                     seq_len=seq_len) for a in archs}


# ---------------------------------------------------------------------------
# TableCompute — cost_model's "measured" ComputeSource implementation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TableCompute:
    """Effective-FLOPs view of a ``LatencyTable`` for one workload.

    The interface ``cost_model.resolve_compute`` expects: ``device_flops``,
    ``server_flops``, ``total_flops`` — drop-in for ``AnalyticCompute``, so
    ``card``/``batched_card`` decide on measured numbers transparently.
    """
    workload: Workload
    table: LatencyTable

    def __post_init__(self):
        cfg = self.workload.cfg
        if self.table.arch != cfg.name:
            raise ValueError(f"latency table is for {self.table.arch!r}, "
                             f"workload is {cfg.name!r}")
        if self.table.n_layers != cfg.n_layers:
            raise ValueError(f"table has {self.table.n_layers} layers, "
                             f"config has {cfg.n_layers}")
        if (self.table.batch, self.table.seq_len) != (self.workload.batch,
                                                      self.workload.seq_len):
            raise ValueError(
                f"table measured at (batch={self.table.batch}, "
                f"seq={self.table.seq_len}) but workload is "
                f"(batch={self.workload.batch}, seq={self.workload.seq_len})")

    @cached_property
    def _cum_layer_s(self) -> np.ndarray:
        # cum[c] = forward seconds of layers [0, c); cum[0] = 0
        return np.concatenate([[0.0], np.cumsum(np.asarray(self.table.layer_s,
                                                           np.float64))])

    def device_flops(self, cut: int) -> float:
        """Effective eta_D(c): embedding + layers [0, cut), fwd+bwd."""
        t = self.table
        return (LORA_TRAIN_FACTOR * (t.embed_s + self._cum_layer_s[cut])
                * t.ref_throughput)

    def total_flops(self) -> float:
        t = self.table
        return (LORA_TRAIN_FACTOR
                * (t.embed_s + self._cum_layer_s[t.n_layers] + t.head_s)
                * t.ref_throughput)

    def server_flops(self, cut: int) -> float:
        return self.total_flops() - self.device_flops(cut)
