"""K1/K2 at chunk sizes that the kernels do not stage as they come: the
fitting helpers of ``ops/raster_kernels.py`` (``fit_binned_blocks``,
``fit_giant_chunks``) recut a level's inputs into bin blocks of at most
128 slots, a multiple of 4, and giant chunks of at most 256 rows.  On the
CPU the fitted inputs, run through the plain versions, give the plain
versions' keys and ids on the raw inputs bit for bit; at chunks that fit
(the defaults among them) the helpers hand back their inputs themselves,
with no copy.  The kernels at these chunks are checked on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from unclerenderer_tpu_torch.ops import raster_kernels as rk
from unclerenderer_tpu_torch.ops.binning import bin_triangles
from unclerenderer_tpu_torch.ops.raster import (
    CULL_NONE,
    normalize_ortho_setup,
    triangle_setup_from_components,
)

SIZE = 128  # image width and height


def _setup(n, seed, size, w=256, h=256):
    """The reference raster tests' random triangles, set up by the port."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    ctr[:, 2] = rng.uniform(0.1, 0.9, n)
    d1 = rng.normal(0, size, (n, 3)).astype(np.float32)
    d2 = rng.normal(0, size, (n, 3)).astype(np.float32)
    v = torch.from_numpy(np.stack([ctr - d1, ctr + d2, ctr + d1], 1))
    px = [(v[:, k, 0] * 0.5 + 0.5) * w for k in range(3)]
    py = [(0.5 - v[:, k, 1] * 0.5) * h for k in range(3)]
    pw = [torch.ones(n) for _ in range(3)]
    return triangle_setup_from_components(
        px[0], py[0], pw[0], px[1], py[1], pw[1], px[2], py[2], pw[2],
        v[:, 0, 2], v[:, 1, 2], v[:, 2, 2], torch.ones(n, dtype=torch.bool), CULL_NONE, w, h)


def _same(a, b):
    for x, y in zip(a, b):
        if x is None:
            assert y is None
        else:
            assert torch.equal(x, y)


class _Captured(Exception):
    pass


def _binned_args(chunk, want_ids, ortho, tile=(16, 64)):
    s = _setup(500, 5, 0.08, SIZE, SIZE)
    if ortho:
        s = normalize_ortho_setup(s)
    bins = bin_triangles(s, SIZE, SIZE, tile[0], tile[1], chunk)
    n_tx = -(-SIZE // tile[1])
    start, count = rk.tile_block_ranges(bins, n_tx * -(-SIZE // tile[0]))
    return (bins.coef, bins.tri_id, bins.valid, start, count, tile[0], tile[1], n_tx, 0.0,
            want_ids, ortho)


def _giant_args(chunk, want_ids, ortho, with_ids):
    """The arguments that ``rasterize_giant`` gives K2 (captured, not run)."""
    s = _setup(600, 3, 0.3, SIZE, SIZE)
    if ortho:
        s = normalize_ortho_setup(s)
    calls = []

    def capture(*a):
        calls.append(a)
        raise _Captured

    with pytest.MonkeyPatch.context() as mp, pytest.raises(_Captured):
        mp.setattr(rk, "giant_raster", capture)
        rk.rasterize_giant(s, SIZE, SIZE, tile_h=32, tile_w=64, chunk=chunk, want_ids=want_ids,
                           ortho=ortho, ids=torch.arange(600) * 3 + 11 if with_ids else None)
    return calls[0]


# 66 (no multiple of 4) and 256 (over 128 slots); 3 is below one 4-slot group,
# 130 splits into two 68-slot runs with padding, 200 into two 100-slot runs
@pytest.mark.parametrize("chunk", [66, 256, 3, 130, 200])
@pytest.mark.parametrize("want_ids,ortho", [(True, False), (False, True)])
def test_fit_binned_blocks_keeps_keys_and_ids(chunk, want_ids, ortho):
    args = _binned_args(chunk, want_ids, ortho)
    fitted = rk.fit_binned_blocks(*args[:5])
    k = -(-chunk // rk.BINNED_MAX_CHUNK)
    width = fitted[0].shape[-1]
    assert width % 4 == 0 and width <= rk.BINNED_MAX_CHUNK and width * k >= chunk
    assert fitted[0].shape == (args[0].shape[0] * k, 16, width)
    assert torch.equal(fitted[3], args[3] * k) and torch.equal(fitted[4], args[4] * k)
    assert int((fitted[2] > 0).sum()) == int((args[2] > 0).sum())  # padding is invalid
    assert all(t.is_contiguous() for t in fitted)  # as the kernel reads them
    want = rk.binned_raster_ref(*args)
    assert int((want[0] >= 0).sum()) > 2000  # the tiles are really covered
    _same(rk.binned_raster_ref(*fitted, *args[5:]), want)


# 512 halves with the ids untouched; 300 and 257 pad their pieces; 1024 is
# one chunk of the 600 rows, in quarters
@pytest.mark.parametrize("chunk", [512, 300, 257, 1024])
@pytest.mark.parametrize("want_ids,ortho,with_ids", [(True, False, True), (True, True, False),
                                                     (False, False, False)])
def test_fit_giant_chunks_keeps_keys_and_ids(chunk, want_ids, ortho, with_ids):
    args = _giant_args(chunk, want_ids, ortho, with_ids)
    coef, valid, overlap, ids = rk.fit_giant_chunks(*args[:4])
    k = -(-chunk // rk.GIANT_MAX_CHUNK)
    assert coef.shape[-1] <= rk.GIANT_MAX_CHUNK and valid.shape == (args[1].shape[0] * k,
                                                                    coef.shape[-1])
    assert overlap.shape == (args[2].shape[0], args[2].shape[1] * k)
    assert all(t is None or t.is_contiguous() for t in (coef, valid, overlap, ids))
    if chunk % k == 0:  # local ids keep their numbers: the map is the caller's own
        assert ids is args[3]
    want = rk.giant_raster_ref(*args)
    assert int((want[0] >= 0).sum()) > 2000
    _same(rk.giant_raster_ref(coef, valid, overlap, ids, *args[4:]), want)


@pytest.mark.parametrize("chunk", [64, 32, 8, 128, 4])
def test_fit_helpers_hand_back_chunks_that_fit(chunk):
    """Default chunks (64 fine, 32 mid, 8 giant) and the limits take no copy."""
    args = _binned_args(chunk, True, False)
    fitted = rk.fit_binned_blocks(*args[:5])
    assert all(f is a for f, a in zip(fitted, args[:5]))
    gargs = _giant_args(chunk, True, False, True)
    gfitted = rk.fit_giant_chunks(*gargs[:4])
    assert all(f is a for f, a in zip(gfitted, gargs[:4]))
