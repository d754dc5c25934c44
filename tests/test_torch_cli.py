"""``python -m repro_torch`` and the two example twins
(``launch/serve_multiarch.py``, ``launch/edge_finetune.py``) on the CPU,
held against the reference's ``python -m repro``, ``generate`` and
``simulate_fleet``.

Tolerances: the fleet means as ``test_torch_scheduler.py`` holds the
vectorized engine (rtol 1e-4), read from the printed lines (three
decimals, so also within 5e-4 absolute); greedy tokens equal; logits of
one decode step atol 2e-4 (as ``test_torch_model.py``).
"""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import j2n, make_pair, t2n
from repro import __main__ as jax_cli
from repro.configs.base import get_config as jax_get_config
from repro.core.scheduler import simulate_fleet as jax_simulate_fleet
from repro.launch.serve import generate as jax_generate
from repro.models import model as JM
from repro_torch import __main__ as cli
from repro_torch.launch import edge_finetune, serve_multiarch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = re.compile(r"^mean (\w+)\s+(-?[\d.]+)")


def _means(text):
    return {m.group(1): float(m.group(2))
            for m in map(NUM.match, text.splitlines()) if m}


def test_help_needs_neither_a_gpu_nor_torch():
    code = ("import runpy, sys\n"
            "sys.argv = ['repro_torch', '--help']\n"
            "try:\n"
            "    runpy.run_module('repro_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code in (0, None), e.code\n"
            "print('heavy:', sorted(m for m in ('torch', 'jax', 'numpy')\n"
            "                       if m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "python -m repro_torch" in out.stdout
    for sub in ("archs", "sweep", "hierarchy"):
        assert sub in out.stdout
    assert out.stdout.rstrip().endswith("heavy: []")


def test_archs_prints_the_reference_lines(capsys):
    assert jax_cli.main(["archs"]) == 0
    want = capsys.readouterr().out
    assert cli.main(["archs"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert len(got.splitlines()) == 11


@pytest.mark.parametrize("args", [
    [], ["--policy", "device_only", "--channel", "poor", "--rounds", "4"],
    ["--arch", "qwen3-4b", "--devices", "64", "--seed", "3"],
    ["--shards", "2"]])
def test_sweep_prints_the_reference_means(capsys, args):
    """``--shards 2`` cuts the devices axis into a ``FleetMesh`` of two
    chunks on the CPU; the reference runs unsharded (the sharded log is
    bit-identical to the unsharded one)."""
    ref_args = [a for a in args if a not in ("--shards", "2")]
    assert jax_cli.main(["sweep", *ref_args]) == 0
    want = capsys.readouterr().out
    assert cli.main(["sweep", *args, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[0] == (want.splitlines()[0]
                                   + (" shards=2" if "--shards" in args
                                      else ""))
    w, g = _means(want), _means(got)
    assert set(g) == {"delay", "energy"} == set(w)
    for key in w:
        assert g[key] == pytest.approx(w[key], rel=1e-4, abs=5e-4), key


def test_hierarchy_prints_the_reference_means(capsys):
    args = ["hierarchy", "--devices", "100", "--servers", "2"]
    assert jax_cli.main(args) == 0
    want = capsys.readouterr().out
    assert cli.main([*args, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]
    w, g = _means(want), _means(got)
    assert set(g) == {"round", "delay", "energy"} == set(w)
    for key in w:
        assert g[key] == pytest.approx(w[key], rel=1e-4, abs=5e-4), key


@pytest.mark.parametrize("arch", serve_multiarch.ARCHS)
def test_serve_multiarch_greedy_tokens_equal_the_reference(arch, capsys):
    """Each of the five reduced configs: the same weights and prompt, 12
    greedy tokens through the twin's ``serve_arch`` and the reference's
    ``generate``."""
    jcfg, tcfg, jp, tp = make_pair(arch, seed=0)
    prompt = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                         jcfg.vocab_size), np.int32)
    want = jax_generate(jcfg, jp["frozen"], jp["lora"], jnp.asarray(prompt),
                        max_new=12, temperature=0.0)
    got = serve_multiarch.serve_arch(tcfg, tp, torch.from_numpy(prompt),
                                     max_new=12, temperature=0.0,
                                     device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    line = capsys.readouterr().out
    assert line.startswith(f"{arch:24s} [{tcfg.family:6s}] generated (2, 12)")


def test_serve_multiarch_frame_decode_matches_the_reference():
    jcfg, tcfg, jp, tp = make_pair("musicgen-large", seed=0)
    frame = np.array(jax.random.normal(jax.random.PRNGKey(3),
                                       (1, 1, jcfg.d_model)) * 0.02,
                     np.float32)
    want, _ = JM.decode_step(jp["frozen"], jp["lora"],
                             JM.init_cache(jcfg, 1, 16), jnp.asarray(frame),
                             jnp.int32(0), jcfg)
    got = serve_multiarch.frame_decode(tcfg, tp, torch.from_numpy(frame),
                                       device="cpu")
    np.testing.assert_allclose(t2n(got), j2n(want), atol=2e-4, rtol=0)


def test_serve_multiarch_main_and_continuous_batching_run_on_the_cpu(capsys):
    out = serve_multiarch.main(["--device", "cpu"])
    assert set(out) == set(serve_multiarch.ARCHS) | {"musicgen-large"}
    for arch in serve_multiarch.ARCHS:
        assert tuple(out[arch].shape) == (2, 12)
    text = capsys.readouterr().out
    assert "continuous batching: 6 reqs x 3 adapters, 48 tokens" in text
    assert text.count("tenant adapter=") == 3


@pytest.mark.parametrize("channel", ["good", "normal", "poor"])
def test_edge_finetune_decision_comparison_equals_the_reference(channel):
    got = edge_finetune.decision_comparison(channel, rounds=30, device="cpu")
    full = jax_get_config("llama32-1b")
    assert list(got) == ["card", "server_only", "device_only"]
    for policy, (delay, energy) in got.items():
        log = jax_simulate_fleet(full, policy=policy, channel_state=channel,
                                 rounds=30)
        assert delay == pytest.approx(log.mean_delay(), rel=1e-4), policy
        assert energy == pytest.approx(log.mean_energy(), rel=1e-4), policy


def test_edge_finetune_smoke_runs_on_the_cpu(capsys):
    res = edge_finetune.main(["--smoke", "--device", "cpu"])
    assert len(res["losses"]) == 2 * 5
    assert all(np.isfinite(res["losses"]))
    assert sorted(res["cuts"]) == [f"device{i}" for i in range(1, 6)]
    text = capsys.readouterr().out
    for policy in ("card", "server_only", "device_only"):
        assert f"  {policy:12s} delay" in text
