"""X1's row masks (``csrc/exhaustive_raster.cu``) in their plain versions,
on the CPU: the exhaustive raster finds a tile's rows as its band's mask AND
its column's, so

* ``band_masks_plain`` holds, for every (band, row), exactly the y half of
  the box test of ``ops/raster.py rasterize`` (and the row's valid flag),
  and ``column_masks_plain`` exactly the x half;
* a band's mask AND a column's selects exactly the (tile, row) pairs that
  the full box test passes, in row order (bit b of word w is row 32 w + b,
  zeros past the table);
* the plain raster of each tile restricted to those rows is the tile of the
  full image;

on boxes on band and column edges, rows with ``valid`` false, non-finite
and huge boxes, tables of 0 rows and of no multiple of 32, and a nonzero
``y_offset``.  The kernel's masks against these are in
``tests/test_torch_cuda.py`` (card only)."""

import numpy as np
import pytest
import torch

from unclerenderer_tpu_torch.ops import raster_kernels as rk
from unclerenderer_tpu_torch.ops.raster import (
    CULL_NONE,
    RasterSetup,
    rasterize,
    triangle_setup_from_components,
)
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

F32 = np.float32
TILE_H, TILE_W = 16, 64


def _edge_boxes(t, height, width, y_offset, seed):
    """(4, t) f32 boxes: random ones, then boxes whose y0 or y1 (x0 or x1)
    lie on a band's (column's) first or last row, one ulp off it, or half a
    pixel off it; huge, infinite and NaN coordinates; inverted boxes."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-20, width + 20, t).astype(F32)
    y0 = rng.uniform(-20, height + 20, t).astype(F32) + F32(y_offset)
    box = np.stack([x0, y0, x0 + rng.uniform(0, 80, t).astype(F32),
                    y0 + rng.uniform(0, 40, t).astype(F32)])
    edges_y = [F32(b * TILE_H) + F32(y_offset) for b in range(height // TILE_H + 1)]
    edges_y += [e + F32(TILE_H - 1) for e in edges_y]
    edges_x = [F32(c * TILE_W) for c in range(width // TILE_W + 1)]
    edges_x += [e + F32(TILE_W - 1) for e in edges_x]
    special = [F32(1e30), F32(-1e30), F32(np.inf), F32(-np.inf), F32(np.nan)]
    for i in range(t):
        kind = i % 7
        if kind in (1, 2):  # a y coordinate on a band edge, exactly, one ulp or 0.5 off
            e = edges_y[rng.integers(len(edges_y))]
            v = [e, np.nextafter(e, F32(np.inf)), np.nextafter(e, F32(-np.inf)), e + F32(0.5),
                 e - F32(0.5)][rng.integers(5)]
            box[1 if kind == 1 else 3, i] = v
        elif kind == 3:  # an x coordinate on a column edge
            e = edges_x[rng.integers(len(edges_x))]
            box[0 if rng.integers(2) else 2, i] = [e, np.nextafter(e, F32(np.inf)),
                                                   np.nextafter(e, F32(-np.inf))][rng.integers(3)]
        elif kind == 4:  # a non-finite or huge coordinate
            box[rng.integers(4), i] = special[rng.integers(len(special))]
        elif kind == 5:  # inverted: y0 > y1
            box[1, i], box[3, i] = box[3, i] + F32(1), box[1, i]
    return box


def _table(t, height, width, y_offset, seed):
    rng = np.random.default_rng(seed + 1)
    valid = rng.random(t) < 0.8
    return RasterSetup(coef=torch.zeros((t, 16)), valid=torch.from_numpy(valid),
                       bbox=torch.from_numpy(_edge_boxes(t, height, width, y_offset, seed)))


def _halves(setup, height, width, y_offset):
    """The box test of ``ops/raster.py rasterize`` restated in numpy f32:
    the y half (with valid) per (band, row), the x half per (column, row)."""
    b = setup.bbox.numpy()
    valid = setup.valid.numpy()
    y0 = (np.arange(-(-height // TILE_H)) * TILE_H).astype(F32) + F32(y_offset)
    y1 = y0 + F32(TILE_H - 1)
    x0 = (np.arange(-(-width // TILE_W)) * TILE_W).astype(F32)
    x1 = x0 + F32(TILE_W - 1)
    yh = valid[None] & (b[1][None] <= y1[:, None]) & (b[3][None] >= y0[:, None])
    xh = (b[0][None] <= x1[:, None]) & (b[2][None] >= x0[:, None])
    return yh, xh


CASES = [(77, 0.0), (256, 48.0), (1000, 37.25), (0, 0.0), (33, -16.0)]


@pytest.mark.parametrize("t,y_offset", CASES)
def test_masks_are_the_halves_of_the_box_test(t, y_offset):
    height, width = 128, 200
    s = _table(t, height, width, y_offset, seed=t)
    yh, xh = _halves(s, height, width, y_offset)
    band = rk.band_masks_plain(s, height, TILE_H, y_offset)
    col = rk.column_masks_plain(s, width, TILE_W)
    n_words = -(-t // 256) * 8
    assert band.dtype == col.dtype == torch.int32
    assert tuple(band.shape) == (-(-height // TILE_H), n_words)
    assert tuple(col.shape) == (-(-width // TILE_W), n_words)
    np.testing.assert_array_equal(rk.mask_bits(band, t).numpy(), yh)
    np.testing.assert_array_equal(rk.mask_bits(col, t).numpy(), xh)
    # nothing past the table
    assert not rk.mask_bits(band, n_words * 32)[:, t:].any()
    assert not rk.mask_bits(col, n_words * 32)[:, t:].any()
    if t:  # the boxes reach every class: on an edge, past it, non-finite, invalid
        assert yh.any() and (~yh).any() and xh.any() and (~xh).any()
        assert (~s.valid).any() and (~torch.isfinite(s.bbox)).any()


@pytest.mark.parametrize("t,y_offset", CASES)
def test_band_and_column_select_the_box_test_pairs(t, y_offset):
    """band[ty] AND column[tx] = the full per-(tile, row) box test, for
    every tile and row, as words: the rows of each tile in row order."""
    height, width = 128, 200
    s = _table(t, height, width, y_offset, seed=t + 5)
    b = s.bbox.numpy()
    n_ty, n_tx = -(-height // TILE_H), -(-width // TILE_W)
    tile = np.arange(n_ty * n_tx)
    tx0 = ((tile % n_tx) * TILE_W).astype(F32)[:, None]
    ty0 = ((tile // n_tx) * TILE_H).astype(F32)[:, None] + F32(y_offset)
    full = (s.valid.numpy()[None] & (b[0][None] <= tx0 + F32(TILE_W - 1)) & (b[2][None] >= tx0)
            & (b[1][None] <= ty0 + F32(TILE_H - 1)) & (b[3][None] >= ty0))
    band = rk.band_masks_plain(s, height, TILE_H, y_offset)
    col = rk.column_masks_plain(s, width, TILE_W)
    pairs = band[torch.from_numpy(tile // n_tx)] & col[torch.from_numpy(tile % n_tx)]
    np.testing.assert_array_equal(rk.mask_bits(pairs, t).numpy(), full)


def _triangles(n, seed, height, width):
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-1, 1, (n, 3)).astype(F32)
    ctr[:, 2] = rng.uniform(0.1, 0.9, n)
    d1 = rng.normal(0, 0.15, (n, 3)).astype(F32)
    d2 = rng.normal(0, 0.15, (n, 3)).astype(F32)
    v = torch.from_numpy(np.stack([ctr - d1, ctr + d2, ctr + d1], 1))
    px = [(v[:, k, 0] * 0.5 + 0.5) * width for k in range(3)]
    py = [(0.5 - v[:, k, 1] * 0.5) * height for k in range(3)]
    pw = [torch.ones(n) for _ in range(3)]
    return triangle_setup_from_components(
        px[0], py[0], pw[0], px[1], py[1], pw[1], px[2], py[2], pw[2],
        v[:, 0, 2], v[:, 1, 2], v[:, 2, 2], torch.from_numpy(rng.random(n) < 0.9),
        CULL_NONE, width, height)


@pytest.mark.parametrize("y_offset", [0.0, 32.0])
def test_tiles_over_their_masked_rows_are_the_image(y_offset):
    """Each tile of the plain raster over only the rows its band AND column
    masks select equals that tile of the full image (depth and ids): the
    rows the masks drop change no pixel of the tile.  The wrapper's CPU
    path (``want_masks``) returns the image and those masks."""
    height, width = 96, 160
    s = _triangles(90, 3, height + int(y_offset), width)
    full_d, full_i, masks = rk.rasterize_exhaustive(s, width, height, tile_h=TILE_H,
                                                    tile_w=TILE_W, chunk=32, y_offset=y_offset,
                                                    want_masks=True)
    band_w = rk.band_masks_plain(s, height, TILE_H, y_offset)
    col_w = rk.column_masks_plain(s, width, TILE_W)
    assert torch.equal(masks, torch.cat([band_w, col_w]))
    t = s.coef.shape[0]
    band, col = rk.mask_bits(band_w, t), rk.mask_bits(col_w, t)
    for ty in range(-(-height // TILE_H)):
        for tx in range(-(-width // TILE_W)):
            sub = RasterSetup(coef=s.coef, valid=s.valid & band[ty] & col[tx], bbox=s.bbox)
            d, i = rasterize(sub, width, height, tile_h=TILE_H, tile_w=TILE_W, chunk=32,
                             y_offset=y_offset)
            ys = slice(ty * TILE_H, (ty + 1) * TILE_H)
            xs = slice(tx * TILE_W, (tx + 1) * TILE_W)
            assert torch.equal(d[ys, xs], full_d[ys, xs]) and torch.equal(i[ys, xs],
                                                                           full_i[ys, xs])
    assert (full_i >= 0).sum() > 2000
