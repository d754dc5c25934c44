"""The slice as a whole: the port's ``ServingEngine`` against the JAX
``ServingEngine`` on the same weights, the same bank of three adapters with
non-zero B, and the same requests. Greedy tokens are compared for identity:
the logits of the two sides agree to ~1e-5 (f32, summation order), far below
the gaps between the top two logits of these 512-token vocabularies."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import make_adapters, make_pair
from repro.launch.serve import generate as j_generate
from repro.serving import AdapterBank as JBank
from repro.serving import ChannelAdmissionController as JController
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.launch.serve import generate as t_generate
from repro_torch.serving import (AdapterBank, ChannelAdmissionController,
                                 Request, ServingEngine)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg, jp, tp = make_pair("qwen3-0.6b", seed=0)
    jads, tads = make_adapters(jcfg, (0, 7, 13))
    return jcfg, tcfg, jp, tp, jads, tads


def _requests(cls, cfg, n, seed=3, max_new=4):
    rng = np.random.default_rng(seed)
    return [cls(uid=i,
                prompt=rng.integers(0, cfg.vocab_size, 4 + (i % 3) * 3,
                                    dtype=np.int64).astype(np.int32),
                max_new=max_new, adapter_id=i % 3) for i in range(n)]


@pytest.fixture(scope="module")
def jax_outputs(setup):
    """The reference engine's tokens on the shared request list."""
    jcfg, _, jp, _, jads, _ = setup
    eng = JEngine(jcfg, jp["frozen"], JBank(jads), slots=3, max_len=32,
                  prefill_chunk=4)
    reqs = _requests(JRequest, jcfg, 6)
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert stats["completed"] == 6 and stats["drained"]
    return {r.uid: list(r.output) for r in reqs}, stats


@pytest.mark.parametrize("use_lora_kernel", [False, True])
def test_engine_token_identical_to_jax_engine(setup, jax_outputs,
                                              use_lora_kernel):
    _, tcfg, _, tp, _, tads = setup
    want, jstats = jax_outputs
    eng = ServingEngine(tcfg, tp["frozen"], AdapterBank(tads), slots=3,
                        max_len=32, prefill_chunk=4,
                        use_lora_kernel=use_lora_kernel, device="cpu")
    reqs = _requests(Request, tcfg, 6)
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert stats["completed"] == 6 and stats["drained"]
    for key in ("ticks", "prefills", "tokens"):
        assert stats[key] == jstats[key], key
    for r in reqs:
        assert list(r.output) == want[r.uid], f"uid={r.uid}"
        assert r.first_token_at is not None and r.done


def test_adapters_really_differ(setup):
    """With B non-zero the three adapters must give different tokens for
    one prompt — otherwise every multi-adapter comparison is vacuous."""
    _, tcfg, _, tp, _, tads = setup
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (1, 6)).astype(np.int32))
    outs = [t_generate(tcfg, tp["frozen"], a, prompt, 6,
                       device="cpu")[0].tolist() for a in tads]
    assert len({tuple(o) for o in outs}) > 1


def test_engine_matches_port_generate_and_jax_generate(setup):
    jcfg, tcfg, jp, tp, jads, tads = setup
    eng = ServingEngine(tcfg, tp["frozen"], tads, slots=2, max_len=32,
                        prefill_chunk=4, device="cpu")
    reqs = _requests(Request, tcfg, 4, seed=11)
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    for r in reqs:
        got = t_generate(tcfg, tp["frozen"], tads[r.adapter_id],
                         torch.from_numpy(r.prompt)[None], 4, device="cpu")
        assert got.dtype == torch.int32 and tuple(got.shape) == (1, 4)
        assert [int(t) for t in got[0]] == list(r.output), f"uid={r.uid}"
    r = reqs[1]
    want = np.asarray(j_generate(jcfg, jp["frozen"], jads[r.adapter_id],
                                 jnp.asarray(r.prompt)[None], max_new=4))[0]
    assert want.tolist() == list(r.output)


def test_generate_sampled_is_seeded_and_in_vocab(setup):
    _, tcfg, _, tp, _, tads = setup
    prompt = torch.from_numpy(np.asarray([[5, 9, 2]], np.int32))
    outs = []
    for seed in (0, 0, 1):
        gen = torch.Generator().manual_seed(seed)
        sampled = t_generate(tcfg, tp["frozen"], tads[0], prompt, 8,
                             temperature=1.0, generator=gen, device="cpu")
        outs.append([int(t) for t in sampled[0]])
    assert outs[0] == outs[1]
    assert all(0 <= t < tcfg.vocab_size for o in outs for t in o)


def test_chunked_prefill_matches_token_by_token(setup):
    _, tcfg, _, tp, _, tads = setup
    prompt = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, 11).astype(np.int32)
    outs = {}
    for chunk in (0, 4):
        eng = ServingEngine(tcfg, tp["frozen"], tads[1], slots=2, max_len=32,
                            prefill_chunk=chunk, device="cpu")
        eng.submit(Request(uid=0, prompt=prompt, max_new=5))
        stats = eng.run_until_drained()
        assert stats["completed"] == 1
        assert stats["prefills"] == (2 if chunk else 0)
        outs[chunk] = list(eng.completed[0].output)
    assert outs[0] == outs[4]


def test_whole_prompt_chunked_first_token_from_prefill(setup):
    """A prompt that is a whole number of chunks emits its first token from
    the prefill logits, before any tick."""
    _, tcfg, _, tp, _, tads = setup
    prompt = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, 8).astype(np.int32)
    eng = ServingEngine(tcfg, tp["frozen"], tads[2], slots=1, max_len=32,
                        prefill_chunk=4, device="cpu")
    eng.submit(Request(uid=0, prompt=prompt, max_new=3))
    eng._admit()
    assert eng.prefills == 2 and eng.ticks == 0
    assert len(eng.slots[0].request.output) == 1
    eng.run_until_drained()
    want = t_generate(tcfg, tp["frozen"], tads[2],
                      torch.from_numpy(prompt)[None], 3, device="cpu")
    assert want[0].tolist() == eng.completed[0].output


def test_slot_recycling_does_not_perturb_neighbor(setup):
    _, tcfg, _, tp, _, tads = setup
    bank = AdapterBank(tads)
    rng = np.random.default_rng(9)
    long_prompt = rng.integers(0, tcfg.vocab_size, 5).astype(np.int32)
    short_prompt = rng.integers(0, tcfg.vocab_size, 3).astype(np.int32)
    solo = ServingEngine(tcfg, tp["frozen"], bank, slots=2, max_len=64,
                         device="cpu")
    solo.submit(Request(uid=0, prompt=long_prompt, max_new=12, adapter_id=0))
    solo.run_until_drained()
    want = list(solo.completed[0].output)

    eng = ServingEngine(tcfg, tp["frozen"], bank, slots=2, max_len=64,
                        device="cpu")
    eng.submit(Request(uid=0, prompt=long_prompt, max_new=12, adapter_id=0))
    for i in range(1, 4):
        eng.submit(Request(uid=i, prompt=short_prompt, max_new=2,
                           adapter_id=i % 3))
    stats = eng.run_until_drained()
    assert stats["completed"] == 4
    long_req = next(r for r in eng.completed if r.uid == 0)
    assert list(long_req.output) == want


def test_on_overflow_reject_and_truncate(setup):
    _, tcfg, _, tp, _, tads = setup
    prompt = np.arange(10, dtype=np.int32)
    eng = ServingEngine(tcfg, tp["frozen"], tads[0], slots=1, max_len=16,
                        device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(Request(uid=0, prompt=prompt, max_new=7))
    with pytest.raises(ValueError, match="on_overflow"):
        ServingEngine(tcfg, tp["frozen"], tads[0], on_overflow="drop",
                      device="cpu")
    eng = ServingEngine(tcfg, tp["frozen"], tads[0], slots=1, max_len=16,
                        on_overflow="truncate", device="cpu")
    req = Request(uid=1, prompt=prompt, max_new=20)
    eng.submit(req)
    assert req.truncated and req.max_new == 6
    stats = eng.run_until_drained()
    assert stats["completed"] == 1 and len(req.output) == 6
    with pytest.raises(ValueError, match="alone exceeds"):
        eng.submit(Request(uid=2, prompt=np.arange(16, dtype=np.int32),
                           max_new=1))


def test_adapter_id_validated_and_eos_stops(setup):
    _, tcfg, _, tp, _, tads = setup
    eng = ServingEngine(tcfg, tp["frozen"], AdapterBank(tads), slots=1,
                        max_len=32, device="cpu")
    with pytest.raises(ValueError, match="adapter_id"):
        eng.submit(Request(uid=0, prompt=np.asarray([1, 2], np.int32),
                           max_new=1, adapter_id=3))
    prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
    eng.submit(Request(uid=1, prompt=prompt, max_new=6, adapter_id=1))
    eng.run_until_drained()
    full = eng.completed[0].output
    eos = full[2]
    eng2 = ServingEngine(tcfg, tp["frozen"], AdapterBank(tads), slots=1,
                         max_len=32, eos_id=eos, device="cpu")
    eng2.submit(Request(uid=2, prompt=prompt, max_new=6, adapter_id=1))
    eng2.run_until_drained()
    out = eng2.completed[0].output
    assert out == full[:full.index(eos) + 1]


def test_adapter_bank_stack_and_gather(setup):
    _, _, _, _, _, tads = setup
    bank = AdapterBank(tads)
    assert bank.n == 3
    leaf = bank.stacked["layers"]["attn"]["wq"]["a"]
    assert leaf.shape[:2] == (3, 2)
    id_list = [2, 0, 2, 1]
    ids = torch.as_tensor(id_list)
    g = AdapterBank.gather(bank.stacked, ids)["layers"]["attn"]["wq"]["a"]
    assert g.shape[:2] == (2, 4)
    for row, aid in enumerate(id_list):
        assert torch.equal(g[:, row], tads[aid]["layers"]["attn"]["wq"]["a"])
    with pytest.raises(ValueError, match="at least one"):
        AdapterBank([])
    with pytest.raises(ValueError, match="structure differs"):
        AdapterBank([tads[0], {"layers": {"attn": {}}}])


def _admission_counts(stats):
    adm = stats["admission"]
    per_tenant = {
        aid: {k: t[k] for k in ("submitted", "admitted", "completed",
                                "blocked_attempts", "demand_hz_sum",
                                "mean_demand_hz")}
        for aid, t in adm["tenants"].items()}
    return {k: adm[k] for k in ("capacity_hz", "reserved_hz", "used_hz",
                                "in_flight", "forced_admits")}, per_tenant


@pytest.mark.parametrize("tight", [True, False])
def test_admission_stats_equal_to_jax_controller(setup, tight):
    """Same seed, same requests: the port's controller prices and admits
    exactly as the reference's does (everything but the wall-clock waits)."""
    jcfg, tcfg, jp, tp, jads, tads = setup
    kw = (dict(bandwidth_hz=4e4, training_reserve_frac=0.5,
               token_rate_per_s=2000.0, bits_per_token=32.0, seed=0)
          if tight else
          dict(bandwidth_hz=20e6, training_reserve_frac=0.5,
               token_rate_per_s=20.0, seed=1))
    jeng = JEngine(jcfg, jp["frozen"], JBank(jads), slots=3, max_len=32,
                   admission=JController(**kw))
    teng = ServingEngine(tcfg, tp["frozen"], AdapterBank(tads), slots=3,
                         max_len=32, admission=ChannelAdmissionController(**kw),
                         device="cpu")
    for r in _requests(JRequest, jcfg, 5, max_new=3):
        jeng.submit(r)
    for r in _requests(Request, tcfg, 5, max_new=3):
        teng.submit(r)
    jstats, tstats = jeng.run_until_drained(), teng.run_until_drained()
    assert tstats["completed"] == 5 and tstats["drained"]
    assert _admission_counts(tstats) == _admission_counts(jstats)
    adm = tstats["admission"]
    assert adm["in_flight"] == 0 and adm["used_hz"] == 0.0
    blocked = sum(t["blocked_attempts"] for t in adm["tenants"].values())
    if tight:       # the tight budget must actually have caused queueing
        assert blocked > 0 or adm["forced_admits"] > 0
    else:
        assert blocked == 0 and adm["forced_admits"] == 0
    with pytest.raises(ValueError, match="training_reserve_frac"):
        ChannelAdmissionController(training_reserve_frac=1.0)
