"""The flash-decode kernel's plain version (what the port's wrapper computes
for a CPU tensor) against the JAX Pallas kernel run in interpret mode through
``repro.kernels.ops.flash_decode``, over the cases of
``tests/test_kernels.py`` (first token, mid-cache, full cache, a window over
a linear cache, a ring buffer past its end) and caches whose length is not a
multiple of the reference kernel's block. Inputs are made with numpy from a
seed and handed to both sides. Tolerances: the reference's own, 2e-5
absolute in f32 and 3e-2 in bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import j2n, t2n
from repro.kernels import ops as jops
from repro_torch.kernels import flash_decode as t_fd
from repro_torch.kernels import launch_counts
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)


def _inputs(seed, b, s, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, 1, hq, d), (b, s, hkv, d), (b, s, hkv, d))]


CASES = [
    (100, 8, 4, 32, 0, 0),      # first token
    (100, 8, 4, 32, 42, 0),     # mid-cache
    (100, 8, 4, 32, 99, 0),     # full cache
    (100, 8, 4, 32, 60, 32),    # sliding window over linear cache
    (64, 4, 4, 16, 150, 64),    # ring buffer (window == slots, t > slots)
    # not a multiple of the reference kernel's 32-slot block
    (77, 8, 2, 16, 50, 0),
    (77, 8, 2, 16, 200, 77),    # ring buffer over a padded block
    (77, 6, 2, 64, 30, 20),     # window over a linear cache, group of 3
]


@pytest.mark.parametrize("s,hq,hkv,d,t,window", CASES)
def test_flash_decode_plain_vs_pallas(s, hq, hkv, d, t, window):
    q, k, v = _inputs(7, 2, s, hq, hkv, d)
    want = j2n(jops.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.int32(t), window=window,
                                 block_k=32))
    before = launch_counts()["flash_decode"]
    got = tops.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), t, window=window)
    assert tuple(got.shape) == (2, 1, hq, d)
    np.testing.assert_allclose(t2n(got), want, atol=2e-5, rtol=0)
    assert launch_counts()["flash_decode"] == before      # CPU: plain only


def test_flash_decode_bf16():
    q, k, v = _inputs(8, 1, 96, 4, 2, 32)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = j2n(jops.flash_decode(jq, jk, jv, jnp.int32(95), block_k=32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = tops.flash_decode(tq, tk, tv, 95)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(t2n(got), want, atol=3e-2, rtol=0)


def test_kernel_form_takes_the_reference_layout():
    """(BH, G, D) / (BH, S, D), the TPU kernel's own contract."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((6, 2, 32)).astype(np.float32)
    k = rng.standard_normal((6, 40, 32)).astype(np.float32)
    v = rng.standard_normal((6, 40, 32)).astype(np.float32)
    from repro.kernels.flash_decode import flash_decode as j_fd
    want = j2n(j_fd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.int32(25), block_k=16, interpret=True))
    got = t_fd.flash_decode(*(torch.from_numpy(x) for x in (q, k, v)), 25)
    np.testing.assert_allclose(t2n(got), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("t,window,slots,want", [
    (5, 0, 8, [1, 1, 1, 1, 1, 1, 0, 0]),  # linear
    (12, 10, 8, [0, 0, 0, 1, 1, 1, 1, 1]),  # linear, window > slots
    (5, 3, 8, [0, 0, 0, 1, 1, 1, 0, 0]),  # ring, not yet wrapped
    (10, 4, 4, [1, 1, 1, 1]),             # ring, full
    (2, 4, 4, [1, 1, 1, 0]),              # ring, not yet wrapped
    (9, 3, 4, [1, 1, 0, 1]),              # ring, window < slots
])
def test_valid_slots(t, window, slots, want):
    got = t_fd.valid_slots(t, slots, window, "cpu")
    assert got.tolist() == [bool(x) for x in want]


def test_wrapper_checks_its_arguments():
    q = torch.zeros(1, 2, 2, 16)
    kv = torch.zeros(1, 2, 8, 16)
    # a (B,) t (a position per row) is refused, as the reference refuses it;
    # a 0-d integer tensor is one position, as the reference's jnp scalar
    with pytest.raises(ValueError, match="one position"):
        t_fd.flash_decode(q, kv, kv, torch.zeros(2, dtype=torch.int32))
    torch.testing.assert_close(
        t_fd.flash_decode(q, kv, kv, torch.tensor(5)),
        t_fd.flash_decode(q, kv, kv, 5), rtol=0, atol=0)
    with pytest.raises(TypeError, match="integer"):
        t_fd.flash_decode(q, kv, kv, torch.tensor(5.0))
    with pytest.raises(ValueError, match="shapes do not agree"):
        t_fd.flash_decode(q, kv[:, :1], kv, 0)
    with pytest.raises(TypeError, match="float32 or all"):
        t_fd.flash_decode(q.double(), kv.double(), kv.double(), 0)
