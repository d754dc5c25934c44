"""The schedule of the warp-specialised bf16 ``flash_attention`` kernel
(``csrc/flash_attention_ws.cu``), on the CPU through its Python mirror in
``repro_torch.kernels.flash_attention``: the work items (batch, head, query
tile of 128) in the order the persistent blocks take them, and the KV tiles
each one visits, at each instantiation's key tile (``ws_keys``: 128 keys at
D = 64 and 128, 64 at D = 192 and 256). The kernel computes the same order
on the card; ``chip_smoke.py`` counts the visited tile pairs from this
mirror.
"""
import numpy as np
import pytest

from repro_torch.kernels import flash_attention as fa

Q_TILE = fa.WS_QUERIES
# the key tiles of the kernel's instantiations (D = 64 / 128, 192 / 256)
KEYS = sorted({fa.ws_keys(d) for d in fa.WS_INSTANCES})


def _seen(sq, skv, causal, window):
    """(Sq, Skv) bool: may query q see key k (positions 0..S-1)."""
    q = np.arange(sq)[:, None]
    k = np.arange(skv)[None, :]
    ok = np.ones((sq, skv), dtype=bool)
    if causal:
        ok &= k <= q
    if window:
        ok &= k > q - window
    return ok


def _want_tiles(seen, qt, keys):
    """The KV tiles (of ``keys`` keys) with at least one (query, key) pair
    of query tile qt left unmasked, by brute force over the mask."""
    rows = seen[qt * Q_TILE:(qt + 1) * Q_TILE]
    n_kt = -(-seen.shape[1] // keys)
    return [kt for kt in range(n_kt)
            if rows[:, kt * keys:(kt + 1) * keys].any()]


def _check(b, hq, hkv, sq, skv, causal, window, keys):
    items = fa.ws_items(b, hq, sq, skv, causal, window, keys)
    nqt = -(-sq // Q_TILE)
    # every (batch, head, query tile) exactly once
    assert sorted(items) == sorted((bi, h, qt) for bi in range(b)
                                   for h in range(hq) for qt in range(nqt))
    seen = _seen(sq, skv, causal, window)
    weight = {}
    for qt in range(nqt):
        tiles = fa.ws_tiles(qt, sq, skv, causal, window, keys)
        # exactly the tiles with an unmasked pair, and never past the keys
        assert list(tiles) == _want_tiles(seen, qt, keys), (qt, tiles)
        weight[qt] = len(tiles)
    # heavier items never follow lighter ones
    w = [weight[qt] for _, _, qt in items]
    assert all(a >= c for a, c in zip(w, w[1:])), w
    # the heads of a query tile and batch are consecutive and in order, so
    # the heads of a GQA group (which read one KV head) run side by side
    group = hq // hkv
    for i in range(0, len(items), hq):
        run = items[i:i + hq]
        assert len({(bi, qt) for bi, _, qt in run}) == 1
        assert [h for _, h, _ in run] == list(range(hq))
        assert [h // group for _, h, _ in run] == sorted(
            h // group for _, h, _ in run)
    return items, weight


@pytest.mark.parametrize("keys", KEYS)
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 127, 1024])
@pytest.mark.parametrize("hq,hkv", [(16, 8), (28, 4), (48, 8), (4, 1)])
@pytest.mark.parametrize("b", [1, 4])
def test_ws_schedule_covers_each_item_once_heaviest_first(b, hq, hkv, s,
                                                          causal, window,
                                                          keys):
    _check(b, hq, hkv, s, s, causal, window, keys)


@pytest.mark.parametrize("keys", KEYS)
@pytest.mark.parametrize("sq,skv,causal,window", [
    (70, 300, False, 0), (300, 70, False, 0), (150, 300, False, 64),
    (1000, 1000, True, 1024), (1000, 1000, True, 64), (300, 1000, True, 0),
    (1000, 300, True, 0), (1000, 300, True, 64), (2000, 500, False, 300),
    (300, 1000, True, 100), (1000, 1000, True, 100), (65, 1000, True, 0)])
def test_ws_schedule_ragged_and_sq_not_skv(sq, skv, causal, window, keys):
    """Ragged lengths, Sq != Skv, windows past S; with a window and more
    queries than keys the weight rises, stays, then falls (some tiles visit
    nothing), and the order still never puts a lighter item first."""
    _check(2, 6, 2, sq, skv, causal, window, keys)


def test_ws_order_examples():
    """Causal, Sq == Skv, no window: the weight of tile t is t + 1, so the
    order is the last tile first, as the grid of csrc/flash_attention_tc.cu
    runs them."""
    assert fa.ws_qtile_order(1024, 1024, True, 0, 128) == list(
        range(7, -1, -1))
    # a window of 64: every tile but the first sees two KV tiles; ties keep
    # the rising side first, then the tiles after the peak in order
    assert fa.ws_qtile_order(1000, 1000, True, 64, 128) == [
        1, 2, 3, 4, 5, 6, 7, 0]
    # non-causal with a window: the first tiles see the most keys
    assert fa.ws_qtile_order(2000, 500, False, 300, 128)[:3] == [0, 1, 2]
    # tiles of 64 keys (D = 192, 256): causal, tile t sees 2 t + 2 of them;
    # a ragged last tile of 104 queries sees 2 t + 1 + ... up to key 999
    assert fa.ws_qtile_order(1024, 1024, True, 0, 64) == list(
        range(7, -1, -1))
    assert [len(fa.ws_tiles(t, 1000, 1000, True, 0, 64))
            for t in range(8)] == [2, 4, 6, 8, 10, 12, 14, 16]
    assert [len(fa.ws_tiles(t, 300, 1000, True, 0, 64))
            for t in range(3)] == [2, 4, 5]
    # a window of 64 over tiles of 64 keys: two or three tiles a query tile
    assert [len(fa.ws_tiles(t, 1000, 1000, True, 64, 64))
            for t in range(8)] == [2, 3, 3, 3, 3, 3, 3, 3]


@pytest.mark.parametrize("n_items,blocks", [(896, 132), (1536, 132),
                                            (1024, 114), (7, 132), (1, 1),
                                            (265, 132), (500, 7)])
def test_ws_block_items_split_the_items(n_items, blocks):
    """The persistent grid: every item to exactly one block, each block's
    items in increasing order (the kernel walks the order forward), and no
    block more than one item ahead of another."""
    blocks = fa.ws_blocks(n_items, blocks)
    assert blocks == min(n_items, blocks)
    per = [fa.ws_block_items(n_items, blocks, i) for i in range(blocks)]
    assert sorted(i for p in per for i in p) == list(range(n_items))
    for p in per:
        assert p == sorted(p)
    counts = [len(p) for p in per]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("b,hq,hkv,d", [(4, 28, 4, 128), (4, 48, 8, 128),
                                        (4, 32, 8, 64), (4, 16, 4, 256),
                                        (4, 16, 4, 192), (4, 32, 8, 40)])
def test_ws_blocks_balance_at_the_model_shapes(b, hq, hkv, d):
    """At the (4, 1024) causal shapes of qwen2-7b, internvl2-26b,
    llama32-1b and qwen3-4b at head dim 256 (and the timing rows at head
    dims 192 and 40) on 132 SMs, the rounds that run forward and backward in
    turn leave no block more than 256 keys of work above the mean (two
    tiles of 128 keys, four of 64)."""
    keys = fa.ws_keys(d)
    items, weight = _check(b, hq, hkv, 1024, 1024, True, 0, keys)
    blocks = fa.ws_blocks(len(items), 132)
    work = [sum(weight[items[i][2]] for i in
                fa.ws_block_items(len(items), blocks, blk))
            for blk in range(blocks)]
    excess = (max(work) - sum(work) / blocks) * keys
    assert excess <= 256.0, (max(work), sum(work), keys)
