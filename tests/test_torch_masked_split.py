"""The host-side pieces of M1's split tiles (``csrc/masked_raster.cu``), on
the CPU: the packed winner word the items of a split tile merge with
(``masked_pack`` / ``masked_unpack``, a 64-bit ``atomicMax`` on the card)
and the work items the plan kernel lays out (``masked_split``); and the
plain count of the alpha taps a level needs (``masked_needed_taps``), which
M1's bound counts.  M1 itself is held to its plain version on the card
(``tests/test_torch_cuda.py -k masked``)."""

import numpy as np
import pytest
import torch

from unclerenderer_tpu_torch.ops import raster_kernels as rk
from unclerenderer_tpu_torch.render.testing import (
    masked_raster_args,
    masked_raster_atlas,
    masked_raster_setup,
)
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def _pairs(seed, n_pix, n):
    """``n`` (pixel, key, id) pairs over ``n_pix`` pixels, some pixels
    empty: keys from a few values (ties), +0 and -0, 1.0 and the least
    positive float; ids spanning int32 with repeats."""
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, n_pix - 3, n)  # the last three pixels stay empty
    keys = rng.choice(np.array([0.0, -0.0, 1.0, 0.5, 0.25, np.float32(2.0**-149),
                                np.nextafter(np.float32(1.0), np.float32(0.0))], np.float32), n)
    free = rng.random(n) < 0.3
    keys[free] = rng.random(int(free.sum()), np.float32)
    ids = rng.choice(np.array([0, 1, 2, 7, INT32_MAX, INT32_MIN, -1, 123456], np.int64), n)
    return pix, keys.astype(np.float32), ids.astype(np.int32)


def _winners(pix, keys, ids, n_pix):
    """Per pixel the max key, then the min id at that key, by value (+0 and
    -0 tie); -1 and -1 where no pair: the reference's block and tile merge,
    written out pair by pair."""
    best = [None] * n_pix
    for p, k, i in zip(pix, keys, ids):
        b = best[p]
        if b is None or k > b[0] or (k == b[0] and i < b[1]):
            best[p] = (float(k), int(i))
    key = np.array([-1.0 if b is None else b[0] + 0.0 for b in best], np.float32)
    win = np.array([-1 if b is None else b[1] for b in best], np.int32)
    return key, win


def _merge(pix, keys, ids, n_pix):
    words = torch.zeros(n_pix, dtype=torch.int64)
    return words.scatter_reduce(0, torch.from_numpy(pix), rk.masked_pack(
        torch.from_numpy(keys), torch.from_numpy(ids)), reduce="amax", include_self=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_word_merge_is_max_key_then_min_id(seed):
    """The max packed word of each pixel's pairs unpacks to its winner,
    key bits included (+0.0 for a zero key), -1 / -1 on empty pixels; the
    same in any order of the pairs and split into any sub-ranges merged by
    max, as the items of a split tile merge."""
    n_pix, n = 40, 600
    pix, keys, ids = _pairs(seed, n_pix, n)
    want_key, want_id = _winners(pix, keys, ids, n_pix)
    key, win = rk.masked_unpack(_merge(pix, keys, ids, n_pix))
    assert np.array_equal(key.numpy().view(np.int32), want_key.view(np.int32))
    assert np.array_equal(win.numpy(), want_id)
    assert (win[-3:] == -1).all() and (key[-3:] == -1).all()
    rng = np.random.default_rng(seed + 10)
    for _ in range(4):
        order = rng.permutation(n)
        cuts = np.sort(rng.choice(np.arange(1, n), rng.integers(1, 6), replace=False))
        parts = [_merge(pix[o], keys[o], ids[o], n_pix) for o in np.split(order, cuts)]
        merged = torch.stack(parts).amax(0)
        assert torch.equal(merged, _merge(pix, keys, ids, n_pix))


def test_packed_word_order_and_round_trip():
    """Words order as (key, -id) over the edge values, and unpack to what
    was packed; a negative key (nothing won) packs to 0."""
    keys = torch.tensor([0.0, -0.0, 2.0**-149, 0.5, 1.0, -1.0])
    ids = torch.tensor([INT32_MIN, -1, 0, 1, INT32_MAX], dtype=torch.int32)
    k, i = (x.reshape(-1) for x in torch.meshgrid(keys, ids.float(), indexing="ij"))
    i = i.to(torch.int64).to(torch.int32)
    w = rk.masked_pack(k, i)
    got_k, got_i = rk.masked_unpack(w)
    hit = k >= 0
    assert torch.equal(w[~hit], torch.zeros_like(w[~hit]))
    assert torch.equal(got_k[hit].view(torch.int32), (k[hit] + 0.0).view(torch.int32))
    assert torch.equal(got_i[hit], i[hit]) and (got_i[~hit] == -1).all()
    rank = [(float(a), -int(b)) for a, b in zip(k[hit], i[hit])]  # +0 and -0 tie
    words = w[hit].tolist()
    for a in range(len(rank)):
        for b in range(len(rank)):
            assert (words[a] < words[b]) == (rank[a] < rank[b])


@pytest.mark.parametrize("split", [1, 2, 4, 0])
def test_split_covers_each_tile_range_once(split):
    """Each tile's items cover its block range exactly once, in order: tiles
    of 0 blocks (no item: M1 writes their output after its items), of exactly
    ``split`` and ``split + 1`` blocks, and larger ones; a tile of more
    than ``split`` blocks gets items of at most ``split`` blocks, any other
    tile one item; 0 splits nothing."""
    s = max(split, 1)
    count = torch.tensor([0, s, s + 1, 1, 0, 3 * s + 2, 2 * s, 7], dtype=torch.int32)
    start = torch.cumsum(count, 0).to(torch.int32) - count
    n_blocks = int(count.sum()) + 5  # dead budget blocks past the live ones
    tile, first, nb = rk.masked_split(start, count, n_blocks, split)
    assert torch.equal(tile, torch.sort(tile).values)
    for t in range(count.shape[0]):
        mine = tile == t
        c = int(count[t])
        parts = 0 if c == 0 else -(-c // split) if split and c > split else 1
        assert int(mine.sum()) == parts
        blocks = [b for f, n in zip(first[mine].tolist(), nb[mine].tolist())
                  for b in range(f, f + n)]
        assert blocks == list(range(int(start[t]), int(start[t]) + c))
        if parts > 1:
            assert int(nb[mine].max()) <= split
    assert tile.shape[0] <= count.shape[0] + n_blocks // s


def test_split_of_overlapping_ranges_splits_nothing():
    """Ranges whose items would overflow M1's table (n_tiles + n_blocks
    entries; tile_block_ranges' disjoint ranges never do) give every tile
    one item over its whole range, an empty tile too."""
    count = torch.tensor([6, 6, 0, 6], dtype=torch.int32)
    start = torch.zeros(4, dtype=torch.int32)
    tile, first, nb = rk.masked_split(start, count, 6, 1)
    assert torch.equal(tile, torch.arange(4)) and torch.equal(nb, count.long())
    assert torch.equal(first, start.long())


@pytest.mark.parametrize("cutoff", ["as made", "all pass", "none pass"])
@pytest.mark.parametrize("form", ["binned", "exhaustive"])
def test_needed_taps_count_each_pixels_pairs_down_to_its_winner(form, cutoff):
    """``masked_needed_taps``: a pixel's covered pairs from its best down to
    its winner.  Every pair passing its alpha test, that is one a pixel
    won; none passing, every covered pair; otherwise between the two.
    ``covered`` is the plain version's count."""
    setup, arec = masked_raster_setup("random", 1, "cpu", 64, 64, n=60)
    if cutoff != "as made":
        arec = arec.clone()
        arec[:, 18] = -np.inf if cutoff == "all pass" else np.inf
    atlas, aw = masked_raster_atlas("quad4", torch.float32, "cpu")
    args = masked_raster_args(setup, arec, atlas, aw, 64, 64, form, 32)
    n = rk.masked_needed_taps(*args)
    _, win, counts = rk.masked_raster_ref(*args, stats=True)
    won = int((win >= 0).sum())
    assert n["covered"] == int(counts["covered"]) > 0
    if cutoff == "all pass":
        assert n["needed"] == won > 0
    elif cutoff == "none pass":
        assert won == 0 and n["needed"] == n["covered"]
    else:
        assert 0 < won < n["needed"] < n["covered"]
