"""Driver of split LoRA fine-tuning: the port's ``SplitFineTuner`` over the
paper's fleet of edge devices in turn, one ``run_round`` a device-round: a
fresh channel draw, CARD's cut and server frequency (Alg. 1), then the
configuration's T local epochs of split training (int8 channel both ways,
AdamW on the adapters).

The benchmark makes everything the fine-tuner is handed from the seed: the
backbone and the adapters (on the card), each device's token batches
(uniform token ids, every row its own) and channel states (the mix's path
loss with Rayleigh fading), and the device and server profiles of the mix
file (the paper's Table I).

Set-up builds the fine-tuner and drives it through its first round, at the
configuration's T, through the window's own ``run_round``; the same object
then runs the window. The plain reference follows that round: the cut (CARD
again from the same channel state, at the same T), each local epoch's loss,
the first gradient (read from the optimizer's first moment after one step)
and the adapters' change after the round. The cut of every round of the
window is checked by the reference's CARD as well.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import clock, harness, spec, weights
from port_bench.flops import split_finetune as flops
from port_bench.reference import card as ref_card
from port_bench.reference import model as ref
from port_bench.trace import Trace, span

#: seconds of the traced segment that follows the window (whole rounds)
TRACE_S = 4.0
PATHLOSS_EXPONENT = {"good": 2.0, "normal": 4.0, "poor": 6.0}
#: leaves whose reference gradient is below this share of the median
#: leaf's move by round-off alone under Adam: their change is not compared
TINY_GRADIENT = 1e-3


class Batches:
    """A device's data: ``minibatch(batch, seq_len)`` is the next seeded
    batch of uniform token ids (labels: the tokens shifted by one)."""

    def __init__(self, vocab: int, seed: int, device_idx: int):
        self.rng = spec.rng(seed, spec.BATCHES, device_idx)
        self.vocab = vocab
        self.log: List[Dict] = []

    def minibatch(self, batch: int, seq_len: int) -> Dict[str, np.ndarray]:
        toks = self.rng.integers(0, self.vocab, size=(batch, seq_len + 1),
                                 dtype=np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        self.log.append(out)
        return out


class Channel:
    """A device's link: ``draw()`` is the next seeded block-fading state."""

    def __init__(self, mix: Dict, seed: int, device_idx: int):
        sim = mix["sim"]
        self.rng = spec.rng(seed, spec.CHANNELS, device_idx)
        self.bandwidth = float(sim["bandwidth_hz"])
        noise = sim["noise_dbm_per_hz"] + 10 * math.log10(self.bandwidth)
        loss = 30.0 + 10.0 * PATHLOSS_EXPONENT[mix["channel"]] * math.log10(
            max(float(mix["distance_m"]), 1.0))
        self.mean_up = sim["tx_power_dbm_up"] - loss - noise
        self.mean_down = sim["tx_power_dbm_down"] - loss - noise
        self.log: List[Dict] = []

    def draw(self):
        from repro_torch.core.channel import ChannelState
        g_up, g_dn = (10 * math.log10(max(self.rng.exponential(1.0), 1e-6))
                      for _ in range(2))
        st = {"snr_up_db": self.mean_up + g_up,
              "snr_down_db": self.mean_down + g_dn,
              "bandwidth_hz": self.bandwidth}
        self.log.append(st)
        return ChannelState(**st)


def _profile(d: Dict):
    from repro_torch.core.hardware import DeviceProfile
    return DeviceProfile(**d)


def build(r):
    """(fine-tuner, its initial adapters (a copy), datasets, channels)."""
    from repro_torch.core.hardware import SimParams
    from repro_torch.core.protocol import SplitFineTuner
    from repro_torch.optim import adamw, constant_schedule
    mix, cfg, conf = r.cell.mix, r.cfg, r.cell.config
    frozen = weights.make_frozen(cfg, r.seed, r.device)
    lora = weights.adapter(weights.make_adapters(
        cfg, r.seed, r.device, 1, spec.ADAPTERS), 0)
    lora0 = weights.clone(lora)
    n_dev = len(mix["devices"])
    datasets = [Batches(cfg.vocab_size, r.seed, m) for m in range(n_dev)]
    channels = [Channel(mix, r.seed, m) for m in range(n_dev)]
    s = mix["sim"]
    sim = SimParams(xi=s["xi"], w=s["w"],
                    local_epochs=int(conf["local_epochs"]), phi=s["phi"],
                    act_bytes=s["act_bytes"],
                    adapter_bytes=s["adapter_bytes"],
                    bandwidth_hz=s["bandwidth_hz"],
                    tx_power_dbm_up=s["tx_power_dbm_up"],
                    tx_power_dbm_down=s["tx_power_dbm_down"],
                    noise_dbm_per_hz=s["noise_dbm_per_hz"],
                    mini_batch=int(conf["mini_batch"]),
                    seq_len=int(conf["seq_len"]))
    a = mix["adam"]
    opt = adamw(constant_schedule(float(mix["lr"])), b1=a["b1"], b2=a["b2"],
                eps=a["eps"], weight_decay=a["weight_decay"])
    ft = SplitFineTuner(cfg, frozen, lora, opt,
                        devices=[_profile(d) for d in mix["devices"]],
                        server=_profile(mix["server"]), channels=channels,
                        datasets=datasets, sim=sim, policy=mix["policy"],
                        compress=bool(mix["compress"]), cost_cfg=cfg)
    return ft, frozen, lora0, datasets, channels


class Watch:
    """Records what the fine-tuner's own calls produce in one round: each
    local epoch's loss (as the executor returns it) and the optimizer's
    state after its first update. Wraps the instance's calls and puts them
    back on ``close``."""

    def __init__(self, ft):
        self.ft, self.losses, self.state1 = ft, [], None
        step, opt = ft.executor.step, ft.optimizer

        def watched_step(*a, **k):
            loss, grads = step(*a, **k)
            self.losses.append(loss.detach())
            return loss, grads

        def watched_update(grads, state, params):
            updates, new = opt.update(grads, state, params)
            if self.state1 is None:
                self.state1 = new
            return updates, new

        self.opt = opt
        ft.executor.step = watched_step
        ft.optimizer = dataclasses.replace(opt, update=watched_update)

    def close(self):
        del self.ft.executor.step
        self.ft.optimizer = self.opt
        return [float(x) for x in self.losses]


def run(r) -> Dict:
    mix, conf, dev = r.cell.mix, r.cell.config, r.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ft, frozen, lora0, datasets, channels = build(r)
    n_dev = len(datasets)
    epochs_per_round = int(conf["local_epochs"])
    # ---- the first round (set-up and the check) ----------------------------
    watch = Watch(ft)
    log0 = ft.run_round(0, 0)
    losses = watch.close()
    m1 = weights.clone(watch.state1["m"])
    del watch
    lora_after = weights.clone(ft.lora)
    first = {"cut": log0.cut, "losses": losses, "device": 0,
             "batches": datasets[0].log[-epochs_per_round:],
             "channel": channels[0].log[-1]}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - r.t_start

    # ---- the window: whole device-rounds --------------------------------
    stages = clock.StageClock() if r.trace and dev.type == "cuda" else None
    ft.executor.mark = stages
    n = 1
    win = clock.Window(r.seconds).open()
    rounds, round_s, decided = [], [], []
    while win.running():
        t = time.perf_counter()
        with span("run_round"):
            rounds.append(ft.run_round(n, n % n_dev))
        round_s.append(time.perf_counter() - t)
        decided.append((n % n_dev, channels[n % n_dev].log[-1],
                        rounds[-1].cut))
        n += 1
    window_s = win.close(dev)
    ft.executor.mark = None
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    batch, seq = int(conf["mini_batch"]), int(conf["seq_len"])
    epochs = len(rounds) * epochs_per_round
    rec: Dict = {"memory_peak_bytes": peak}
    rec["e2e"] = {"train_tokens_per_s": epochs * batch * seq / window_s,
                  "setup_s": setup_s}
    rec["attempted"] = len(rounds)
    rec["failed"] = sum(1 for lg in rounds
                        if lg.status != "ok" or not math.isfinite(lg.loss))
    rec["layer"] = {"window_s": window_s, "window_epochs": epochs,
                    "window_ops": epochs * flops.epoch_ops(r.dims, r.rank,
                                                           batch, seq)}
    if stages is not None:
        rec["layer"]["stage_ms"] = stages.epochs()
    rec["notes"] = {"rounds": len(rounds), "epochs": epochs,
                    "round_s": round_s,
                    "window_s": window_s,
                    "cuts": sorted({lg.cut for lg in rounds}),
                    "first_cut": first["cut"],
                    "first_losses": first["losses"]}

    # ---- the traced segment ------------------------------------------------
    if r.trace:
        n0 = n
        with Trace(dev) as tr:
            t_end = time.perf_counter() + min(TRACE_S, r.seconds)
            while time.perf_counter() < t_end:
                with span("run_round"):
                    ft.run_round(n, n % n_dev)
                n += 1
        rec["trace"] = tr.summary
        rec["layer"]["trace_epochs"] = (n - n0) * epochs_per_round
        rec["notes"]["trace_read_s"] = tr.read_s

    # ---- the check, once the window has closed --------------------------
    del ft
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    sides = check(r, frozen, lora0, first, m1, lora_after, decided)
    rec["notes"]["check_s"] = time.perf_counter() - t
    rec["checks"], rest = harness.compared(sides.pop("program"),
                                           r.cell.workload["limits"])
    if rest:
        rec["notes"]["not_compared"] = rest
    if sides:
        rec["notes"]["sides"] = sides
    return rec


def job(r) -> Dict:
    conf = r.cell.config
    return {"mini_batch": int(conf["mini_batch"]),
            "seq_len": int(conf["seq_len"]),
            "local_epochs": int(conf["local_epochs"])}


def costs(r, device: int, channel: Dict):
    mix = r.cell.mix
    return ref_card.Costs(r.dims, r.rank, job(r), mix["sim"],
                          mix["devices"][device], mix["server"], channel)


def follow(r, frozen, lora0, first, rnd=ref.exact, rows=None):
    """The reference through the checked round, at the cut its own CARD
    takes: (losses, first gradient, adapters after the round). ``rows``
    keeps only those rows of each batch (a fault)."""
    mix = r.cell.mix
    ref.no_tf32()
    a = mix["adam"]
    cut, _, _ = ref_card.decide(costs(r, first["device"], first["channel"]))
    params, state = weights.clone(lora0), None
    losses, g1 = [], None
    for b in first["batches"]:
        tokens = torch.as_tensor(b["tokens"], dtype=torch.long)
        labels = torch.as_tensor(b["labels"], dtype=torch.long)
        if rows is not None:
            tokens, labels = tokens[rows], labels[rows]
        loss, grads = ref.split_step(frozen, params, tokens, labels, cut,
                                     r.dims, rnd, bool(mix["compress"]))
        losses.append(loss)
        if g1 is None:
            g1 = grads
        params, state = ref.adamw(params, grads, state, float(mix["lr"]),
                                  a["b1"], a["b2"], a["eps"],
                                  a["weight_decay"])
    return losses, g1, params


def per_layer_norms(tree, n_layers: int) -> Dict:
    """{(path, layer): norm} of every per-layer slice of every leaf."""
    out = {}
    for path, t in weights.leaves(tree):
        for i in range(n_layers):
            out[path + (i,)] = torch.linalg.vector_norm(
                t[i].float()).item()
    return out


def norm_gap(got: Dict, want: Dict, keys) -> float:
    """Worst leaf's |norm - reference norm| over the larger of the leaf's
    reference norm and the median leaf's."""
    keys = list(keys)
    if not keys:
        return 0.0
    median = float(np.median([want[k] for k in keys]))
    gaps = [abs(got[k] - want[k]) / max(want[k], median, 1e-30)
            for k in keys]
    return max(g if math.isfinite(g) else math.inf for g in gaps)


def numbers(r, losses, g1, after, lora0, ref_out) -> Dict[str, float]:
    """The numbers compared, of one side's round (each epoch's ``losses``,
    first gradient ``g1``, adapters ``after`` the round) against the
    reference's (``follow``)."""
    ref_losses, g1_ref, params_ref = ref_out
    n = r.dims.layers
    g_got, g_ref = per_layer_norms(g1, n), per_layer_norms(g1_ref, n)
    d_got = per_layer_norms(_delta(after, lora0), n)
    d_ref = per_layer_norms(_delta(params_ref, lora0), n)
    median_g = float(np.median(list(g_ref.values())))
    moved = [k for k in g_ref if g_ref[k] >= TINY_GRADIENT * median_g]
    if len(losses) != len(ref_losses):
        loss_gap = math.inf
    else:
        loss_gap = max(abs(p - q) / abs(q) if math.isfinite(p) else math.inf
                       for p, q in zip(losses, ref_losses))
    return {"loss_gap": loss_gap,
            "grad_norm_gap": norm_gap(g_got, g_ref, g_ref.keys()),
            "change_norm_gap": norm_gap(d_got, d_ref, moved)}


def check(r, frozen, lora0, first, m1, lora_after, decided
          ) -> Dict[str, Dict[str, float]]:
    """The numbers compared, by side: ``program``, and with ``r.control``
    the float8 reference (``control``) and the reference with half of each
    batch left out (``half_batch``) in the program's place. The program's
    first gradient is its optimizer's first moment after one step over (1 -
    beta1); ``cut_excess`` is the worst of the checked round's and every
    window round's cut."""
    beta1 = float(r.cell.mix["adam"]["b1"])
    g1 = {"layers": _map(lambda m: m / (1 - beta1), m1["layers"])}
    want = follow(r, frozen, lora0, first)
    excess = max(ref_card.cut_excess(costs(r, d, ch), cut) for d, ch, cut
                 in [(first["device"], first["channel"], first["cut"])]
                 + list(decided))
    sides = {"program": dict(
        cut_excess=excess,
        **numbers(r, first["losses"], g1, lora_after, lora0, want))}
    if r.control:
        batch = int(r.cell.config["mini_batch"])
        for name, kw in (("control", {"rnd": ref.fp8}),
                         ("half_batch", {"rows": list(range(batch // 2))})):
            got = follow(r, frozen, lora0, first, **kw)
            sides[name] = numbers(r, got[0], got[1], got[2], lora0, want)
    return sides


def _delta(after, before):
    return {"layers": _map(lambda a, b: a.float() - b.float(),
                           after["layers"], before["layers"])}


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(x[k] for x in rest)) for k, v in tree.items()}
    return fn(tree, *rest)
