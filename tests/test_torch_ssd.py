"""The SSD intra-chunk kernel's plain version and the port's ``ops.ssd_scan``
/ ``models.mamba.ssd_chunked`` against the JAX package: the Pallas kernel in
interpret mode, its ``kernels/ref.py`` oracle, ``ops.ssd_scan`` and the
model's ``ssd_chunked``, at the shapes of ``tests/test_kernels.py``. Inputs
are made with numpy from a seed and handed to both sides. Tolerance: 1e-4
absolute, the reference's own (f32, summation order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import j2n, t2n
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_intra_chunk as j_intra
from repro.models.mamba import ssd_chunked as j_chunked
from repro_torch.kernels import launch_counts
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as t_ssd
from repro_torch.models.mamba import ssd_chunked as t_chunked

torch.set_num_threads(1)

ATOL = 1e-4


def _inputs(seed, lead, nh, hp, ns):
    """xt, a, B, C as the reference tests draw them (scaled normals, a <= 0),
    as numpy f32."""
    rng = np.random.default_rng(seed)
    xt = rng.standard_normal(lead + (nh, hp)) * 0.2
    a = -np.abs(rng.standard_normal(lead + (nh,))) * 0.1
    B = rng.standard_normal(lead + (ns,)) * 0.3
    C = rng.standard_normal(lead + (ns,)) * 0.3
    return [x.astype(np.float32) for x in (xt, a, B, C)]


def test_intra_chunk_plain_vs_pallas_and_ref():
    b, nc, cl, nh, hp, ns = 2, 3, 16, 2, 8, 12       # test_kernels.py:170
    arrays = _inputs(5, (b, nc, cl), nh, hp, ns)
    before = launch_counts()["ssd_intra_chunk"]
    got = t_ssd.ssd_intra_chunk(*(torch.from_numpy(x) for x in arrays))
    assert launch_counts()["ssd_intra_chunk"] == before   # CPU: plain only
    jx = [jnp.asarray(x) for x in arrays]
    for want in (j_intra(*jx, interpret=True), jref.ssd_intra_chunk_ref(*jx)):
        for g, w, shape in zip(got, want, ((b, nc, cl, nh, hp),
                                           (b, nc, nh, ns, hp),
                                           (b, nc, cl, nh, 2))):
            assert tuple(g.shape) == shape
            np.testing.assert_allclose(t2n(g), j2n(w), atol=ATOL, rtol=0)


def test_intra_chunk_long_chunk_masks_the_future():
    """Over a 256-long chunk exp(cum_i - cum_j) overflows for j > i; the
    plain version must mask it out, not carry inf or nan."""
    arrays = _inputs(6, (1, 1, 256), 2, 8, 8)
    arrays[1] = arrays[1] * 40.0                     # cum reaches about -800
    y, st, dec = t_ssd.ssd_intra_chunk(*(torch.from_numpy(x) for x in arrays))
    assert all(torch.isfinite(t).all() for t in (y, st, dec))
    want = jref.ssd_intra_chunk_ref(*(jnp.asarray(x) for x in arrays))
    for g, w in zip((y, st, dec), want):
        np.testing.assert_allclose(t2n(g), j2n(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("l,nh,hp,ns,chunk", [
    (64, 2, 16, 16, 16), (100, 3, 16, 24, 32), (256, 4, 32, 64, 64),
])
def test_ssd_scan_vs_jax_ops_and_chunked(l, nh, hp, ns, chunk):
    arrays = _inputs(4, (2, l), nh, hp, ns)
    tx = [torch.from_numpy(x) for x in arrays]
    jx = [jnp.asarray(x) for x in arrays]
    y, h = tops.ssd_scan(*tx, chunk)
    assert tuple(y.shape) == (2, l, nh, hp)
    assert tuple(h.shape) == (2, nh, hp, ns)
    for yw, hw in (jops.ssd_scan(*jx, chunk), j_chunked(*jx, chunk)):
        np.testing.assert_allclose(t2n(y), j2n(yw), atol=ATOL, rtol=0)
        np.testing.assert_allclose(t2n(h), j2n(hw), atol=ATOL, rtol=0)
    y2, h2 = t_chunked(*tx, chunk)
    np.testing.assert_allclose(t2n(y2), t2n(y), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t2n(h2), t2n(h), atol=ATOL, rtol=0)


def test_ssd_scan_with_initial_state():
    l, nh, hp, ns, chunk = 100, 3, 16, 24, 32
    arrays = _inputs(7, (2, l), nh, hp, ns)
    h0 = (np.random.default_rng(8).standard_normal((2, nh, hp, ns)) * 0.5
          ).astype(np.float32)
    tx = [torch.from_numpy(x) for x in arrays]
    jx = [jnp.asarray(x) for x in arrays]
    y, h = tops.ssd_scan(*tx, chunk, torch.from_numpy(h0))
    for yw, hw in (jops.ssd_scan(*jx, chunk, jnp.asarray(h0)),
                   j_chunked(*jx, chunk, jnp.asarray(h0))):
        np.testing.assert_allclose(t2n(y), j2n(yw), atol=ATOL, rtol=0)
        np.testing.assert_allclose(t2n(h), j2n(hw), atol=ATOL, rtol=0)
    y2, h2 = t_chunked(*tx, chunk, torch.from_numpy(h0))
    np.testing.assert_allclose(t2n(y2), t2n(y), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t2n(h2), t2n(h), atol=ATOL, rtol=0)


def test_intra_chunk_rejects_mismatched_shapes():
    xt, a, B, C = (torch.zeros(s) for s in ((1, 1, 8, 2, 4), (1, 1, 8, 3),
                                           (1, 1, 8, 5), (1, 1, 8, 5)))
    with pytest.raises(ValueError, match="shapes do not agree"):
        t_ssd.ssd_intra_chunk(xt, a, B, C)


def _steep(arrays):
    """a = -|N(0, 1)| * 2: over a 256-row chunk cum falls to about -400, so
    exp(cum_i) * exp(-cum_j) would overflow where the segment form does not."""
    arrays[1] = -np.abs(np.random.default_rng(9).standard_normal(
        arrays[1].shape)).astype(np.float32) * 2.0
    return arrays


def test_intra_chunk_steep_decay_vs_pallas():
    b, nc, cl, nh, hp, ns = 1, 2, 256, 3, 16, 32
    arrays = _steep(_inputs(10, (b, nc, cl), nh, hp, ns))
    got = t_ssd.ssd_intra_chunk(*(torch.from_numpy(x) for x in arrays))
    want = j_intra(*(jnp.asarray(x) for x in arrays), interpret=True)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(t2n(g), j2n(w), atol=ATOL, rtol=0)


def test_ssd_scan_steep_decay_vs_jax_ops():
    l, nh, hp, ns, chunk = 300, 3, 16, 32, 256       # not a multiple of chunk
    arrays = _steep(_inputs(11, (2, l), nh, hp, ns))
    y, h = tops.ssd_scan(*(torch.from_numpy(x) for x in arrays), chunk)
    yw, hw = jops.ssd_scan(*(jnp.asarray(x) for x in arrays), chunk)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    np.testing.assert_allclose(t2n(y), j2n(yw), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t2n(h), j2n(hw), atol=ATOL, rtol=0)


@pytest.mark.parametrize("nh", [10, 5])
def test_intra_chunk_hymba_like_vs_pallas(nh):
    """hymba-1.5b reduced: ns = 16, chunk 128, a head count that is not a
    multiple of the tensor-core kernel's head group (8 or 4)."""
    b, nc, cl, hp, ns = 1, 2, 128, 16, 16
    arrays = _inputs(12, (b, nc, cl), nh, hp, ns)
    got = t_ssd.ssd_intra_chunk(*(torch.from_numpy(x) for x in arrays))
    want = j_intra(*(jnp.asarray(x) for x in arrays), interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(t2n(g), j2n(w), atol=ATOL, rtol=0)
