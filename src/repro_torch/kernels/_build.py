"""Builds the CUDA sources under ``csrc/`` and binds them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds): ``nvcc`` for ``sm_90a``,
one process per source, all started together on the first request. The
libraries land in ``csrc/build/`` (override with ``REPRO_TORCH_BUILD_DIR``),
named by a hash of the source, the shared header and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import time: the first kernel launch builds and loads.
A failed build raises; there is no other path for a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("lora_matmul", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures (see the ``extern "C"`` blocks of the sources)
_SIGNATURES = {
    "lora_matmul": {
        # x, w, a, b, y, M, K, N, r, scale, is_bf16, stream
        "lora_matmul_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
        # x, w, a_bank, b_bank, ids, y, rows, rows_per_group, K, N, r,
        # a_stride, b_stride, scale, is_bf16, stream
        "lora_matmul_grouped_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _L, _L, _F, _I, _P],
    },
    "flash_attention": {
        # q, k, v, o, B, Hq, Hkv, Sq, Skv, D, 12 strides (q,k,v,o x b,h,s),
        # causal, window, is_bf16, stream
        "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I]
                                  + [_L] * 12 + [_I, _I, _I, _P],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}            # nvcc output (ptxas -v) per source


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR", CSRC_DIR / "build"))


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and $CUDA_HOME/bin): the CUDA "
        "kernels of repro_torch cannot be built on this machine")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in (CSRC_DIR / f"{name}.cu", CSRC_DIR / "common.cuh"):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return build_dir() / f"{name}.{_digest(name)}.so"


def build_all(force: bool = False) -> float:
    """Compile every source that has no up-to-date library; returns the
    seconds spent (0.0 when everything was already built)."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo: List[Tuple[str, Path, Path]] = []
    for name in SOURCES:
        target = _target(name)
        if force or not target.exists():
            tmp = target.with_suffix(f".tmp{os.getpid()}.so")
            todo.append((name, target, tmp))
    if not todo:
        return 0.0
    nvcc = find_nvcc()
    t0 = time.time()
    procs = []
    for name, _, tmp in todo:                  # one nvcc per source, together
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    failures = []
    for (name, target, tmp), proc in zip(todo, procs):
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, target)                # atomic: safe across processes
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.time() - t0


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built first if need be."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_target(name)))
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if code != 0:
        raise RuntimeError(
            f"{what}: CUDA launch failed with cudaError {code} "
            "(see cudaGetErrorString in the CUDA runtime API)")
