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
    csrc = os.path.join(PKG_DIR, "csrc")
    text = {n: open(os.path.join(csrc, n)).read()
            for n in ("lora_matmul.cu", "flash_attention.cu", "common.cuh")}
    assert "lora_matmul_kernel" in text["lora_matmul.cu"]
    assert "lora_matmul_grouped_kernel" in text["lora_matmul.cu"]
    assert "flash_attention_kernel" in text["flash_attention.cu"]
    for name, src in text.items():      # hand-written: no library products
        for banned in ("cublas", "cudnn", "cutlass", "torch/extension"):
            assert banned not in src.lower(), (name, banned)


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")


@pytest.mark.parametrize("entry", ["init_params", "init_cache", "generate",
                                   "ServingEngine", "make_serve_step",
                                   "make_prefill_step"])
def test_entry_points_raise_without_a_gpu_by_default(no_gpu, entry):
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving import ServingEngine
    cfg = get_config("llama32-1b").reduced()
    calls = {
        "init_params": lambda: M.init_params(0, cfg),
        "init_cache": lambda: M.init_cache(cfg, 1, 8),
        "generate": lambda: serve.generate(cfg, {}, None,
                                           torch.zeros(1, 2, dtype=torch.int32),
                                           1),
        "ServingEngine": lambda: ServingEngine(cfg, {}, None),
        "make_serve_step": lambda: serve.make_serve_step(cfg),
        "make_prefill_step": lambda: serve.make_prefill_step(cfg),
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c", [(torch.float32, 2e-4),
                                     (torch.bfloat16, 1e-2)])
def test_gpu_lora_matmul_kernel(cuda, dtype, c):
    from repro_torch.kernels import lora_matmul as lm
    rng = np.random.default_rng(0)
    for m, k, n, r in ((37, 53, 41, 3), (64, 256, 192, 16), (70, 130, 90, 40)):
        x, w = _rand(rng, (m, k), dtype, cuda), _rand(rng, (k, n), dtype, cuda)
        a, b = _rand(rng, (k, r), dtype, cuda), _rand(rng, (r, n), dtype, cuda)
        before = lm.lora_matmul.launches
        got = lm.lora_matmul(x, w, a, b, 0.5).float()
        torch.cuda.synchronize()
        assert lm.lora_matmul.launches == before + 1
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
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    rng = np.random.default_rng(2)
    for b, s, hq, hkv, d, window in ((2, 65, 4, 4, 16, 0),
                                     (2, 130, 8, 2, 32, 64),
                                     (1, 200, 4, 2, 64, 0)):
        q = _rand(rng, (b, s, hq, d), dtype, cuda)
        k = _rand(rng, (b, s, hkv, d), dtype, cuda)
        v = _rand(rng, (b, s, hkv, d), dtype, cuda)
        before = fa.flash_attention.launches
        got = ops.flash_attention(q, k, v, causal=True, window=window).float()
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == before + 1
        want = fa.flash_attention_ref(
            q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
            v.permute(0, 2, 1, 3), causal=True, window=window
        ).permute(0, 2, 1, 3).float()
        assert (got - want).abs().max() <= atol


@pytest.mark.gpu
def test_gpu_wrappers_raise_instead_of_falling_back(cuda):
    """A CUDA tensor the kernel does not take raises; it is never handed to
    the plain version."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros(1, 2, 8, 24, device=cuda)       # head dim 24: no kernel
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
