"""The port as a package: it imports without JAX and without the reference
package, its entry points insist on a GPU unless told otherwise, and (on a
machine with a GPU only) its CUDA kernels build, launch and agree with their
plain versions. Run the GPU cases with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_package.py``.
"""
import importlib
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(repro_torch.__file__)


def _module_names():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_without_jax_or_reference_package():
    """In a fresh interpreter: import every module of the port, then look
    at ``sys.modules``."""
    names = _module_names()
    assert "repro_torch.serving.engine" in names
    assert "repro_torch.kernels._build" in names
    for name in ("core.splitting", "core.faults", "core.protocol",
                 "optim.optimizer", "data.pipeline", "checkpoint.checkpoint",
                 "launch.train", "launch.trainer", "core.scheduler",
                 "launch.mesh", "launch.fig4_comparison",
                 "launch.fig3_decisions", "launch.fleet_scale_bench",
                 "launch.hierarchy_bench", "launch.churn_bench",
                 "launch.fleet_sweep", "launch.quickstart", "__main__",
                 "launch.serve_multiarch", "launch.edge_finetune",
                 "launch.dryrun", "launch.analysis"):
        assert f"repro_torch.{name}" in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('imported', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("imported")


def test_sources_name_neither_jax_nor_reference_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(PKG_DIR):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as fh:
            for lineno, line in enumerate(fh, 1):
                assert not pat.match(line), f"{path}:{lineno}: {line}"


def test_csrc_holds_the_three_kernels():
    """The serving slice's three kernels, and since the calibration slice
    the other two: all five TPU kernels of the reference; ``lora_matmul``,
    ``lora_matmul_grouped`` and ``flash_attention`` also on the tensor cores
    (``wgmma``), ``ssd_intra_chunk`` too (``mma.sync`` with tf32), and the
    f32 ``lora_matmul`` and ``flash_attention`` on ``mma.sync`` with tf32,
    the shared three-product helpers in ``tf32x3.cuh``."""
    csrc = os.path.join(PKG_DIR, "csrc")
    text = {n: open(os.path.join(csrc, n)).read()
            for n in ("lora_matmul.cu", "lora_matmul_tc.cu",
                      "lora_matmul_tf32.cu", "lora_matmul_grouped_tc.cu",
                      "flash_attention.cu", "flash_attention_tc.cu",
                      "flash_attention_tf32.cu", "flash_decode.cu",
                      "ssd_scan.cu", "ssd_scan_tc.cu", "common.cuh",
                      "hopper.cuh", "tf32x3.cuh")}
    assert "lora_matmul_kernel" in text["lora_matmul.cu"]
    assert "lora_matmul_tc_split_kernel" in text["lora_matmul_tc.cu"]
    assert ("lora_matmul_grouped_tc_split_kernel"
            in text["lora_matmul_grouped_tc.cu"])
    assert "flash_attention_tc_kernel" in text["flash_attention_tc.cu"]
    assert "wgmma.mma_async" in text["hopper.cuh"]
    assert "lora_matmul_grouped_kernel" in text["lora_matmul.cu"]
    assert "flash_attention_kernel" in text["flash_attention.cu"]
    assert "flash_decode_split_kernel" in text["flash_decode.cu"]
    assert "cudaLaunchAttributeClusterDimension" in text["flash_decode.cu"]
    assert "ssd_intra_chunk_kernel" in text["ssd_scan.cu"]
    assert ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32"
            in text["tf32x3.cuh"])
    for name in ("ssd_scan_tc.cu", "lora_matmul_tf32.cu",
                 "flash_attention_tf32.cu"):
        assert '#include "tf32x3.cuh"' in text[name], name
    assert "lora_matmul_tf32_split_kernel" in text["lora_matmul_tf32.cu"]
    assert "flash_attention_tf32_kernel" in text["flash_attention_tf32.cu"]
    from repro_torch.kernels import _build, launch_counts
    assert set(_build.SOURCES) == {"lora_matmul", "lora_matmul_tc",
                                   "lora_matmul_tf32",
                                   "lora_matmul_grouped_tc",
                                   "flash_attention", "flash_attention_tc",
                                   "flash_attention_tf32", "flash_decode",
                                   "ssd_scan", "ssd_scan_tc"}
    assert set(launch_counts()) == {"lora_matmul", "lora_matmul_grouped",
                                    "flash_attention", "flash_decode",
                                    "ssd_intra_chunk"}
    for name, src in text.items():      # hand-written: no library products
        for banned in ("cublas", "cudnn", "cutlass", "torch/extension"):
            assert banned not in src.lower(), (name, banned)


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")


@pytest.mark.parametrize("entry", ["init_params", "init_cache", "generate",
                                   "ServingEngine", "make_serve_step",
                                   "make_prefill_step", "probe_kernels",
                                   "BatchedRoundContext.build",
                                   "calibrate.run", "run_training",
                                   "simulate_fleet",
                                   "simulate_fleet(engine='scalar')",
                                   "simulate_hierarchical_fleet",
                                   "TieredRoundContext.build",
                                   "make_fleet_mesh", "fig4_comparison.run",
                                   "quickstart.run", "python -m repro_torch",
                                   "serve_multiarch.main",
                                   "edge_finetune.run"])
def test_entry_points_raise_without_a_gpu_by_default(no_gpu, entry):
    from repro_torch.configs.base import get_config
    from repro_torch.core import (channel, cost_model, hardware, measured_cost,
                                  scheduler)
    from repro_torch import __main__ as cli
    from repro_torch.launch import (calibrate, edge_finetune, fig4_comparison,
                                    mesh, quickstart, serve, serve_multiarch,
                                    train)
    from repro_torch.models import model as M
    from repro_torch.serving import ServingEngine
    cfg = get_config("llama32-1b").reduced()

    def build_context():
        w = cost_model.Workload(get_config("llama32-1b"), 4, 512)
        chans = channel.draw_channel_matrix("normal", 1, 2, seed=0)
        return cost_model.BatchedRoundContext.build(
            w, hardware.EDGE_FLEET[:2], hardware.SERVER_RTX4060TI, chans,
            hardware.DEFAULT_SIM)

    def build_tier():
        w = cost_model.Workload(get_config("llama32-1b"), 4, 512)
        chans = channel.draw_channel_matrix("normal", 1, 2, seed=0)
        return cost_model.TieredRoundContext.build(
            w, hardware.EDGE_FLEET[:2], hardware.make_server_tier(2), chans,
            hardware.DEFAULT_SIM)

    calls = {
        "init_params": lambda: M.init_params(0, cfg),
        "init_cache": lambda: M.init_cache(cfg, 1, 8),
        "generate": lambda: serve.generate(cfg, {}, None,
                                           torch.zeros(1, 2, dtype=torch.int32),
                                           1),
        "ServingEngine": lambda: ServingEngine(cfg, {}, None),
        "make_serve_step": lambda: serve.make_serve_step(cfg),
        "make_prefill_step": lambda: serve.make_prefill_step(cfg),
        "probe_kernels": lambda: measured_cost.probe_kernels(),
        "BatchedRoundContext.build": build_context,
        "calibrate.run": lambda: calibrate.run(smoke=True),
        "run_training": lambda: train.run_training(steps=1, pretrain_steps=0),
        "simulate_fleet": lambda: scheduler.simulate_fleet(
            get_config("llama32-1b"), rounds=1),
        "simulate_fleet(engine='scalar')": lambda: scheduler.simulate_fleet(
            get_config("llama32-1b"), rounds=1, engine="scalar"),
        "simulate_hierarchical_fleet":
            lambda: scheduler.simulate_hierarchical_fleet(
                get_config("llama32-1b"), tier=hardware.make_server_tier(2),
                rounds=1),
        "TieredRoundContext.build": build_tier,
        "make_fleet_mesh": lambda: mesh.make_fleet_mesh(2),
        "fig4_comparison.run": lambda: fig4_comparison.run(rounds=1),
        "quickstart.run": lambda: quickstart.run(pretrain_steps=0, rounds=1),
        "python -m repro_torch": lambda: cli.main(["sweep", "--rounds", "1"]),
        "serve_multiarch.main": lambda: serve_multiarch.main([]),
        "edge_finetune.run": lambda: edge_finetune.run(rounds=1,
                                                       pretrain_steps=0),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_engine_refuses_parameters_on_another_device():
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import ServingEngine
    cfg = get_config("llama32-1b").reduced()
    params = M.init_params(0, cfg, device="cpu")
    meta = {"embed": params["frozen"]["embed"].to("meta")}
    with pytest.raises(ValueError, match="parameters lie on"):
        ServingEngine(cfg, meta, None, device="cpu")


def test_build_module_is_inert_at_import_and_names_its_sources():
    from repro_torch.kernels import _build
    assert _build._libs == {}
    for name in _build.SOURCES:
        assert (_build.CSRC_DIR / f"{name}.cu").exists()
        assert set(_build._SIGNATURES[name])
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    with pytest.raises(RuntimeError, match="cudaError 7"):
        _build.check(7, "probe")
    _build.check(0, "probe")


# ---------------------------------------------------------------------------
# GPU only
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(device).to(dtype)


def _misaligned(t):
    """A copy of ``t`` one element past a 16-byte boundary, which the
    wrappers hand to their SIMT kernels."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    out = out.view(t.shape).copy_(t)
    assert out.data_ptr() % 16
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c", [(torch.float32, 2e-4),
                                     (torch.bfloat16, 1e-2)])
def test_gpu_lora_matmul_kernel(cuda, dtype, c):
    from repro_torch.kernels import lora_matmul as lm
    rng = np.random.default_rng(0)
    for m, k, n, r in ((37, 53, 41, 3), (64, 256, 192, 16), (70, 130, 90, 40)):
        x, w = _rand(rng, (m, k), dtype, cuda), _rand(rng, (k, n), dtype, cuda)
        a, b = _rand(rng, (k, r), dtype, cuda), _rand(rng, (r, n), dtype, cuda)
        version = lm.lora_matmul_version(dtype, k, n, r, True)
        before = lm.lora_matmul.launches
        before_version = lm.lora_matmul.by_version[version]
        got = lm.lora_matmul(x, w, a, b, 0.5).float()
        torch.cuda.synchronize()
        assert lm.lora_matmul.launches == before + 1
        assert lm.lora_matmul.by_version[version] == before_version + 1
        want = lm.lora_matmul_ref(x, w, a, b, 0.5).float()
        assert (got - want).abs().max() <= c * want.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c", [(torch.float32, 2e-4),
                                     (torch.bfloat16, 1e-2)])
def test_gpu_lora_matmul_grouped_kernel(cuda, dtype, c):
    from repro_torch.kernels import lora_matmul as lm
    rng = np.random.default_rng(1)
    for g, m, k, n, r, e in ((3, 1, 64, 48, 4, 2), (9, 2, 53, 41, 3, 4),
                             (8, 1, 1100, 96, 16, 4)):
        x, w = (_rand(rng, (g, m, k), dtype, cuda),
                _rand(rng, (k, n), dtype, cuda))
        a, b = (_rand(rng, (e, k, r), dtype, cuda),
                _rand(rng, (e, r, n), dtype, cuda))
        ids = torch.as_tensor(rng.integers(0, e, g), dtype=torch.int32,
                              device=cuda)
        before = lm.lora_matmul_grouped.launches
        got = lm.lora_matmul_grouped(x, w, a, b, ids, 0.5).float()
        torch.cuda.synchronize()
        assert lm.lora_matmul_grouped.launches == before + 1
        want = lm.lora_matmul_grouped_ref(x, w, a, b, ids, 0.5).float()
        assert (got - want).abs().max() <= c * want.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_gpu_flash_attention_kernel(cuda, dtype, atol):
    """bf16 through the wgmma version; f32 through the SIMT version, which
    misaligned inputs take (aligned f32 takes tf32x3, tested below)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    rng = np.random.default_rng(2)
    f32 = dtype == torch.float32
    version = "simt" if f32 else "wgmma"
    for b, s, hq, hkv, d, window in ((2, 65, 4, 4, 16, 0),
                                     (2, 130, 8, 2, 32, 64),
                                     (1, 200, 4, 2, 64, 0)):
        q = _rand(rng, (b, s, hq, d), dtype, cuda)
        k = _rand(rng, (b, s, hkv, d), dtype, cuda)
        v = _rand(rng, (b, s, hkv, d), dtype, cuda)
        if f32:
            q, k, v = (_misaligned(t) for t in (q, k, v))
        before = fa.flash_attention.launches
        before_version = fa.flash_attention.by_version[version]
        got = ops.flash_attention(q, k, v, causal=True, window=window).float()
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == before + 1
        assert fa.flash_attention.by_version[version] == before_version + 1
        want = fa.flash_attention_ref(
            q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
            v.permute(0, 2, 1, 3), causal=True, window=window
        ).permute(0, 2, 1, 3).float()
        assert (got - want).abs().max() <= atol


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,r", [(64, 2048, 2048, 16), (64, 2048, 512, 16),
                                     (64, 2048, 8192, 16), (64, 8192, 2048, 16),
                                     (37, 136, 72, 8), (200, 520, 264, 64)])
def test_gpu_lora_matmul_tensor_core_kernel(cuda, m, k, n, r):
    """bf16 at the four serving shapes and ragged M: the wgmma version."""
    from repro_torch.kernels import lora_matmul as lm
    rng = np.random.default_rng(5)
    x, w = _rand(rng, (m, k), torch.bfloat16, cuda), \
        _rand(rng, (k, n), torch.bfloat16, cuda)
    a, b = _rand(rng, (k, r), torch.bfloat16, cuda), \
        _rand(rng, (r, n), torch.bfloat16, cuda)
    before = lm.lora_matmul.by_version["wgmma"]
    got = lm.lora_matmul(x, w, a, b, 2.0).float()
    torch.cuda.synchronize()
    assert lm.lora_matmul.by_version["wgmma"] == before + 1
    want = lm.lora_matmul_ref(x, w, a, b, 2.0).float()
    assert (got - want).abs().max() <= 1e-2 * want.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("g,m,k,n,r,e,strided", [
    (8, 1, 2048, 2048, 16, 4, False), (8, 1, 2048, 512, 16, 4, True),
    (8, 1, 2048, 8192, 16, 4, False), (8, 1, 8192, 2048, 16, 4, False),
    (5, 3, 1096, 72, 16, 3, False), (7, 10, 520, 264, 24, 5, False),
    (32, 1, 256, 64, 8, 4, False)])
def test_gpu_lora_matmul_grouped_tensor_core_kernel(cuda, g, m, k, n, r, e,
                                                    strided):
    """bf16 at the four decode shapes (one with the strided in-place bank
    of ``AdapterBank.gather``), ragged K, two row tiles, blocks of x@A
    only: the wgmma version."""
    from repro_torch.kernels import lora_matmul as lm
    rng = np.random.default_rng(7)
    bf16 = torch.bfloat16
    x, w = _rand(rng, (g, m, k), bf16, cuda), _rand(rng, (k, n), bf16, cuda)
    a, b = _rand(rng, (e, k, r), bf16, cuda), _rand(rng, (e, r, n), bf16, cuda)
    if strided:
        a = torch.stack([a, a], dim=1)[:, 1]
        b = torch.stack([b, b], dim=1)[:, 0]
    ids = torch.as_tensor(rng.integers(0, e, g), dtype=torch.int32,
                          device=cuda)
    before = lm.lora_matmul_grouped.by_version["wgmma"]
    got = lm.lora_matmul_grouped(x, w, a, b, ids, 2.0).float()
    torch.cuda.synchronize()
    assert lm.lora_matmul_grouped.by_version["wgmma"] == before + 1
    want = lm.lora_matmul_grouped_ref(x, w, a, b, ids, 2.0).float()
    assert (got - want).abs().max() <= 1e-2 * want.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,hq,hkv,d,t,window", [
    (8, 512, 32, 8, 64, 0, 0), (2, 512, 8, 4, 64, 1100, 600),
    (1, 4096, 8, 1, 64, 4095, 0), (1, 4096, 8, 1, 64, 5000, 4096)])
def test_gpu_flash_decode_one_piece_and_most_pieces(cuda, dtype, atol, b, s,
                                                    hq, hkv, d, t, window):
    """Runs of one piece (one launch, no merge) and of the most pieces, for
    a linear cache and a ring buffer."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    rng = np.random.default_rng(8)
    q = _rand(rng, (b, 1, hq, d), dtype, cuda)
    k = _rand(rng, (b, s, hkv, d), dtype, cuda)
    v = _rand(rng, (b, s, hkv, d), dtype, cuda)
    got = ops.flash_decode(q, k, v, t, window=window).float()
    torch.cuda.synchronize()
    want = fd.flash_decode_ref(
        q[:, 0].reshape(b, hkv, hq // hkv, d), k.permute(0, 2, 1, 3),
        v.permute(0, 2, 1, 3), t, window=window).float()
    assert (got.reshape(want.shape) - want).abs().max() <= atol


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window", [
    (2, 130, 130, 4, 4, 16, True, 0), (1, 200, 200, 8, 2, 64, True, 0),
    (1, 150, 150, 4, 1, 128, True, 0), (2, 200, 200, 4, 2, 64, True, 64),
    (2, 96, 96, 25, 5, 16, True, 64), (2, 70, 150, 4, 2, 32, False, 0)])
def test_gpu_flash_attention_tensor_core_kernel(cuda, b, sq, skv, hq, hkv, d,
                                                causal, window):
    """bf16 head dims 16/32/64/128, windows, GQA groups 1-5 and non-causal
    Sq != Skv: the wgmma version, at the bf16 tolerance."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(6)
    q = _rand(rng, (b, hq, sq, d), torch.bfloat16, cuda)
    k = _rand(rng, (b, hkv, skv, d), torch.bfloat16, cuda)
    v = _rand(rng, (b, hkv, skv, d), torch.bfloat16, cuda)
    before = fa.flash_attention.by_version["wgmma"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window).float()
    torch.cuda.synchronize()
    assert fa.flash_attention.by_version["wgmma"] == before + 1
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert (got - want.float()).abs().max() <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,r", [(128, 128, 128, 8), (512, 512, 512, 16),
                                     (256, 1024, 512, 16), (70, 260, 196, 12),
                                     (37, 136, 72, 8), (200, 520, 264, 64)])
def test_gpu_lora_matmul_tf32x3_kernel(cuda, m, k, n, r):
    """f32 at calibrate probe shapes, ragged M and K, r up to 64: the
    tf32x3 version, at the f32 tolerance."""
    from repro_torch.kernels import lora_matmul as lm
    rng = np.random.default_rng(9)
    x, w = _rand(rng, (m, k), torch.float32, cuda), \
        _rand(rng, (k, n), torch.float32, cuda)
    a, b = _rand(rng, (k, r), torch.float32, cuda), \
        _rand(rng, (r, n), torch.float32, cuda)
    before = lm.lora_matmul.by_version["tf32x3"]
    got = lm.lora_matmul(x, w, a, b, 2.0)
    assert lm.lora_matmul.by_version["tf32x3"] == before + 1
    torch.cuda.synchronize()
    want = lm.lora_matmul_ref(x, w, a, b, 2.0)
    assert (got - want).abs().max() <= 2e-4 * want.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window", [
    (1, 512, 512, 8, 4, 64, True, 0), (1, 256, 256, 4, 2, 32, True, 0),
    (2, 130, 130, 4, 4, 16, True, 64), (1, 150, 150, 2, 1, 128, True, 0),
    (1, 200, 200, 4, 2, 128, True, 64), (2, 96, 96, 25, 5, 16, True, 64),
    (2, 70, 150, 4, 2, 32, False, 0), (2, 150, 70, 4, 2, 64, False, 0)])
def test_gpu_flash_attention_tf32x3_kernel(cuda, b, sq, skv, hq, hkv, d,
                                           causal, window):
    """f32 head dims 16/32/64/128, windows, GQA groups 1-5 and non-causal
    Sq != Skv: the tf32x3 version, at the f32 tolerance."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(10)
    q = _rand(rng, (b, hq, sq, d), torch.float32, cuda)
    k = _rand(rng, (b, hkv, skv, d), torch.float32, cuda)
    v = _rand(rng, (b, hkv, skv, d), torch.float32, cuda)
    before = fa.flash_attention.by_version["tf32x3"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.by_version["tf32x3"] == before + 1
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert (got - want).abs().max() <= 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_gpu_flash_decode_kernel(cuda, dtype, atol):
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    rng = np.random.default_rng(3)
    for b, s, hq, hkv, d, t, window in ((2, 100, 8, 4, 32, 0, 0),
                                        (2, 100, 8, 4, 32, 60, 32),
                                        (2, 64, 4, 4, 16, 150, 64),
                                        (3, 77, 25, 5, 128, 50, 0)):
        q = _rand(rng, (b, 1, hq, d), dtype, cuda)
        k = _rand(rng, (b, s, hkv, d), dtype, cuda)
        v = _rand(rng, (b, s, hkv, d), dtype, cuda)
        before = fd.flash_decode.launches
        got = ops.flash_decode(q, k, v, t, window=window).float()
        torch.cuda.synchronize()
        assert fd.flash_decode.launches == before + 1
        want = fd.flash_decode_ref(
            q[:, 0].reshape(b, hkv, hq // hkv, d), k.permute(0, 2, 1, 3),
            v.permute(0, 2, 1, 3), t, window=window).float()
        assert (got.reshape(want.shape) - want).abs().max() <= atol


@pytest.mark.gpu
def test_gpu_ssd_intra_chunk_kernel(cuda):
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.mamba import ssd_chunked
    rng = np.random.default_rng(4)
    for b, nc, cl, nh, hp, ns in ((2, 3, 16, 2, 8, 12), (1, 2, 100, 3, 16, 24),
                                  (1, 1, 256, 2, 64, 128)):
        xt = _rand(rng, (b, nc, cl, nh, hp), torch.float32, cuda) * 0.2
        a = -_rand(rng, (b, nc, cl, nh), torch.float32, cuda).abs() * 0.1
        B = _rand(rng, (b, nc, cl, ns), torch.float32, cuda) * 0.3
        C = _rand(rng, (b, nc, cl, ns), torch.float32, cuda) * 0.3
        before = ss.ssd_intra_chunk.launches
        got = ss.ssd_intra_chunk(xt, a, B, C)
        torch.cuda.synchronize()
        assert ss.ssd_intra_chunk.launches == before + 1
        for g, w in zip(got, ss.ssd_intra_chunk_ref(xt, a, B, C)):
            assert (g - w).abs().max() <= 1e-4
    y, h = ops.ssd_scan(xt[:, 0], a[:, 0], B[:, 0], C[:, 0], 64)
    y2, h2 = ssd_chunked(xt[:, 0], a[:, 0], B[:, 0], C[:, 0], 64)
    assert (y - y2).abs().max() <= 1e-4 and (h - h2).abs().max() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("b,nc,cl,nh,hp,ns", [
    (1, 2, 256, 5, 64, 128), (2, 2, 128, 10, 64, 16), (1, 3, 100, 3, 32, 24),
])
def test_gpu_ssd_intra_chunk_tensor_core_and_simt(cuda, b, nc, cl, nh, hp, ns):
    """Both versions against the plain one: the tensor-core kernel for
    aligned inputs, the SIMT kernel for an xt one element off 16 bytes."""
    from repro_torch.kernels import ssd_scan as ss
    rng = np.random.default_rng(5)
    xt = _rand(rng, (b, nc, cl, nh, hp), torch.float32, cuda) * 0.2
    a = -_rand(rng, (b, nc, cl, nh), torch.float32, cuda).abs() * 0.1
    B = _rand(rng, (b, nc, cl, ns), torch.float32, cuda) * 0.3
    C = _rand(rng, (b, nc, cl, ns), torch.float32, cuda) * 0.3
    want = ss.ssd_intra_chunk_ref(xt, a, B, C)
    buf = torch.empty(xt.numel() + 1, device=cuda)
    off = buf[1:].view(xt.shape)
    off.copy_(xt)
    for x_in, version in ((xt, "tc"), (off, "simt")):
        before = ss.ssd_intra_chunk.by_version[version]
        got = ss.ssd_intra_chunk(x_in, a, B, C)
        torch.cuda.synchronize()
        assert ss.ssd_intra_chunk.by_version[version] == before + 1
        for g, w in zip(got, want):
            assert (g - w).abs().max() <= 1e-4


@pytest.mark.gpu
def test_gpu_wrappers_raise_instead_of_falling_back(cuda):
    """A CUDA tensor the kernel does not take raises; it is never handed to
    the plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd_scan as ss
    q = torch.zeros(1, 2, 8, 24, device=cuda)       # head dim 24: no kernel
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        fd.flash_decode(q[:, :, :1], q, q, 3)
    with pytest.raises(ValueError, match="queries per group"):
        fd.flash_decode(torch.zeros(1, 1, 9, 16, device=cuda),
                        torch.zeros(1, 1, 8, 16, device=cuda),
                        torch.zeros(1, 1, 8, 16, device=cuda), 3)
    x = torch.zeros(1, 1, 8, 2, 4, device=cuda, dtype=torch.bfloat16)
    a = torch.zeros(1, 1, 8, 2, device=cuda, dtype=torch.bfloat16)
    bc = torch.zeros(1, 1, 8, 4, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32 only"):
        ss.ssd_intra_chunk(x, a, bc, bc)
    from repro_torch.core import measured_cost
    with pytest.raises(ValueError, match="unknown probe backend"):
        measured_cost.probe_kernels(backend="jnp", device=cuda)


@pytest.mark.gpu
def test_gpu_f32_logits_of_a_bf16_model_have_a_backward(cuda):
    """``torch.mm(..., out_dtype=float32)`` has no derivative of its own;
    the model's autograd Function gives dX = (dY @ Wᵀ) in f32, rounded once
    to x's dtype, as JAX's transpose of an f32-preferred dot does."""
    from repro_torch.models import model as M
    rng = np.random.default_rng(4)
    x = _rand(rng, (2, 3, 64), torch.bfloat16, cuda).requires_grad_()
    w = _rand(rng, (64, 96), torch.bfloat16, cuda)
    y = M._matmul_f32_out(x, w)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, x.detach().float() @ w.float(),
                               rtol=1e-5, atol=1e-4)
    gy = _rand(rng, tuple(y.shape), torch.float32, cuda)
    (gx,) = torch.autograd.grad(y, x, gy)
    want = (gy.reshape(-1, 96) @ w.float().t()).to(torch.bfloat16)
    assert gx.dtype == torch.bfloat16
    torch.testing.assert_close(gx.reshape(-1, 64).float(), want.float(),
                               rtol=8e-3, atol=1e-3)


@pytest.mark.gpu
def test_gpu_wrappers_refuse_autograd(cuda):
    """On the card, as on the CPU: a kernel's output would carry no
    gradient, so a call under grad with an input that needs one raises."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lora_matmul as lm
    rng = np.random.default_rng(5)
    x = _rand(rng, (64, 256), torch.bfloat16, cuda).requires_grad_()
    w = _rand(rng, (256, 128), torch.bfloat16, cuda)
    a = _rand(rng, (256, 16), torch.bfloat16, cuda)
    b = _rand(rng, (16, 128), torch.bfloat16, cuda)
    before = lm.lora_matmul.launches
    with pytest.raises(RuntimeError, match="lora_matmul has no backward"):
        lm.lora_matmul(x, w, a, b, 0.5)
    assert lm.lora_matmul.launches == before
    with torch.no_grad():
        lm.lora_matmul(x, w, a, b, 0.5)
    assert lm.lora_matmul.launches == before + 1
    q = _rand(rng, (1, 4, 128, 64), torch.bfloat16, cuda).requires_grad_()
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        fa.flash_attention(q, q[:, :2].detach(), q[:, :2].detach())


@pytest.mark.gpu
@pytest.mark.parametrize("arch,nc", [("mamba2-370m", 4), ("hymba-1.5b", 8)])
def test_gpu_ssd_scan_at_the_model_path_shapes(cuda, arch, nc):
    """The scan of ``mamba_forward(impl="flash")`` on (4, 1024) tokens at
    the full published width: ``ops.ssd_scan`` takes the tensor-core
    version once a call and agrees with ``ssd_chunked`` to 1e-4; one f32
    Mamba block through either scan agrees to 2e-4 of its largest output."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import mamba as mb
    cfg = get_config(arch)
    nh, hp, ns, chunk = (cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state,
                         cfg.ssm_chunk)
    assert 1024 // chunk == nc
    rng = np.random.default_rng(6)
    xt = _rand(rng, (4, 1024, nh, hp), torch.float32, cuda) * 0.2
    a = -_rand(rng, (4, 1024, nh), torch.float32, cuda).abs() * 0.1
    B = _rand(rng, (4, 1024, ns), torch.float32, cuda) * 0.3
    C = _rand(rng, (4, 1024, ns), torch.float32, cuda) * 0.3
    before = dict(ss.ssd_intra_chunk.by_version)
    y, h = ops.ssd_scan(xt, a, B, C, chunk)
    torch.cuda.synchronize()
    assert ss.ssd_intra_chunk.by_version["tc"] == before["tc"] + 1
    assert ss.ssd_intra_chunk.by_version["simt"] == before["simt"]
    y2, h2 = mb.ssd_chunked(xt, a, B, C, chunk)
    assert (y - y2).abs().max() <= 1e-4 and (h - h2).abs().max() <= 1e-4

    gen = torch.Generator(device=cuda).manual_seed(0)
    params = mb.init_mamba(gen, cfg, torch.float32, cuda)
    x = _rand(rng, (4, 1024, cfg.d_model), torch.float32, cuda)
    with torch.no_grad():
        want = mb.mamba_forward(params, None, x, cfg, impl="chunked")
        got = mb.mamba_forward(params, None, x, cfg, impl="flash")
    torch.cuda.synchronize()
    assert ss.ssd_intra_chunk.by_version["tc"] == before["tc"] + 2
    assert (got - want).abs().max() <= 2e-4 * want.abs().max()


@pytest.mark.gpu
def test_gpu_serving_twin_launches_both_lora_kernels(cuda):
    """The serving twin (``launch/serving_bench.py``) at the reference's
    reduced width on the card, with the fused LoRA kernels: every row
    drained, both kernels launched through the version their rules pick,
    each gate's device time taken."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.launch import run as t_run
    from repro_torch.launch import serving_bench
    cfg = get_config(serving_bench.ARCH).reduced()
    dtype, r = getattr(torch, cfg.dtype), cfg.lora.rank
    d, q, kv, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    shapes = ((d, q), (d, kv), (q, d), (d, ff), (ff, d))
    # the reduced width is f32: tf32x3 prefill chunks, SIMT ticks
    want = {name: {fn(dtype, k, n, r, True) for k, n in shapes}
            for name, fn in (("lora_matmul", lm.lora_matmul_version),
                             ("lora_matmul_grouped",
                              lm.lora_matmul_grouped_version))}
    res = serving_bench.run(**t_run.SERVING_SMOKE, reduced=True)
    assert all(row["drained"] for row in res["sweep"])
    for name, versions in want.items():
        assert len(versions) == 1, (name, versions)
        assert res["launches"][name] > 0, res["launches"]
        assert res["launches_by_version"][name][versions.pop()] \
            == res["launches"][name], (name, res["launches_by_version"])
    assert all(v is not None and v > 0
               for v in res["decode_tick_device_s"].values())
