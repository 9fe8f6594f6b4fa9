"""Port vs reference: the three-level binned raster (plain versions of K1
and K2/K3) against the reference's Pallas kernels in interpret mode, on the
cases of tests/test_pallas_kernels.py.  Depth, tri_id and the drop counters
are bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_kernels import _setup as _random_setup  # the reference tests' random triangles

from unclerenderer_tpu.ops import raster as jr
from unclerenderer_tpu.ops.pallas_raster import rasterize_binned as j_binned
from unclerenderer_tpu.ops.pallas_raster import rasterize_pallas as j_pallas
from unclerenderer_tpu_torch.ops import raster as tr
from unclerenderer_tpu_torch.ops import raster_kernels as rk
from unclerenderer_tpu_torch.ops.binning import bin_triangles
from unclerenderer_tpu_torch.ops.fma import fma
from unclerenderer_tpu_torch.sweeps import raster as sweep


def T(x):
    return torch.from_numpy(np.array(x))


def _tie_setup():
    """Three identical small and three identical giant triangles."""
    tri_small = np.array([[10.0, 10.0, 0.5], [40.0, 10.0, 0.5], [10.0, 40.0, 0.5]], np.float32)
    tri_big = np.array([[0.0, 0.0, 0.7], [250.0, 0.0, 0.7], [0.0, 250.0, 0.7]], np.float32)
    v = np.concatenate([np.tile(tri_small, (3, 1)), np.tile(tri_big, (3, 1))])
    clip = np.stack([v[:, 0] / 128.0 - 1.0, 1.0 - v[:, 1] / 128.0, v[:, 2],
                     np.ones(len(v), np.float32)], axis=1)
    tris = jnp.arange(len(v), dtype=jnp.int32).reshape(-1, 3)
    pix_h = jr.viewport_homogeneous(jnp.asarray(clip), 256, 256)
    return jr.triangle_setup(pix_h, jnp.asarray(clip[:, 2]), tris, jnp.ones(6, bool),
                             jr.CULL_NONE, 256, 256)


def _coplanar_setup(n_small, n_big, n_other=6, seed=11):
    """``n_small`` copies of one small triangle and ``n_big`` of one giant
    triangle (equal keys, ids in ascending runs), between random small
    triangles so the copies' ids start past 0."""
    tri_small = np.array([[70.0, 70.0, 0.5], [100.0, 70.0, 0.5], [70.0, 100.0, 0.5]], np.float32)
    tri_big = np.array([[0.0, 0.0, 0.7], [250.0, 0.0, 0.7], [0.0, 250.0, 0.7]], np.float32)
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(20.0, 230.0, (2 * n_other, 1, 2))
    other = np.concatenate([ctr + rng.normal(0.0, 6.0, (2 * n_other, 3, 2)),
                            rng.uniform(0.2, 0.9, (2 * n_other, 3, 1))], -1).astype(np.float32)
    v = np.concatenate([other[:n_other].reshape(-1, 3), np.tile(tri_small, (n_small, 1)),
                        np.tile(tri_big, (n_big, 1)), other[n_other:].reshape(-1, 3)])
    clip = np.stack([v[:, 0] / 128.0 - 1.0, 1.0 - v[:, 1] / 128.0, v[:, 2],
                     np.ones(len(v), np.float32)], axis=1)
    n = len(v) // 3
    tris = jnp.arange(len(v), dtype=jnp.int32).reshape(-1, 3)
    pix_h = jr.viewport_homogeneous(jnp.asarray(clip), 256, 256)
    return jr.triangle_setup(pix_h, jnp.asarray(clip[:, 2]), tris, jnp.ones(n, bool),
                             jr.CULL_NONE, 256, 256)


def _port(s):
    return tr.RasterSetup(coef=T(s.coef), valid=T(s.valid), bbox=T(s.bbox))


KW = dict(tile_h=16, tile_w=64, chunk=32, big_tile_h=32, big_tile_w=128, big_chunk=32)
CASES = {
    "small": (lambda: _random_setup(150, seed=0, size=0.04), dict(mid_divisor=2, giant_divisor=4)),
    "mixed": (lambda: _random_setup(60, seed=2, size=0.2), dict(mid_divisor=2, giant_divisor=4)),
    "giant": (lambda: _random_setup(40, seed=3, size=0.6), dict(mid_divisor=2, giant_divisor=4)),
    "min_id_ties": (_tie_setup, dict(mid_divisor=2, giant_divisor=2)),
    "budget_overflow": (lambda: _random_setup(2000, seed=5, size=0.04), dict(budget_factor=0.001)),
    "giant_truncated": (lambda: _random_setup(64, seed=7, size=0.8), dict(mid_divisor=64, giant_divisor=64)),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("want_ids,depth_mode", [(True, jr.DEPTH_MAX), (False, jr.DEPTH_MIN)])
def test_rasterize_binned_bit_equal(case, want_ids, depth_mode):
    make, kw = CASES[case]
    s = make()
    jd, ji, js = j_binned(s, 256, 256, **KW, **kw, depth_mode=depth_mode, want_ids=want_ids,
                          interpret=True)
    td, ti, ts = rk.rasterize_binned(_port(s), 256, 256, **KW, **kw, depth_mode=depth_mode,
                                     want_ids=want_ids)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    if want_ids:
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert (ti >= 0).sum() > 100
    for k in ("pair_overflow", "giant_truncated"):
        assert int(ts[k]) == int(js[k]), k
    if case == "budget_overflow":
        assert int(ts["pair_overflow"]) > 0
    if case == "giant_truncated":
        assert int(ts["giant_truncated"]) > 0
    if case == "min_id_ties" and want_ids:
        assert set(np.unique(ti.numpy()).tolist()) <= {-1, 0, 3}


# fine chunks that the K1 kernel takes only after ``fit_binned_blocks`` (66:
# no multiple of 4; 256: over 128), and a mid and giant chunk of 66
@pytest.mark.parametrize("chunk,big_chunk", [(66, 32), (256, 32), (66, 66)])
@pytest.mark.parametrize("want_ids,depth_mode", [(True, jr.DEPTH_MAX), (False, jr.DEPTH_MIN)])
def test_rasterize_binned_chunks_bit_equal(chunk, big_chunk, want_ids, depth_mode):
    s = _random_setup(60, seed=2, size=0.2)
    kw = dict(KW, chunk=chunk, big_chunk=big_chunk, mid_divisor=2, giant_divisor=4,
              depth_mode=depth_mode, want_ids=want_ids)
    jd, ji, js = j_binned(s, 256, 256, **kw, interpret=True)
    td, ti, ts = rk.rasterize_binned(_port(s), 256, 256, **kw)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    if want_ids:
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert (ti >= 0).sum() > 100
    for k in ("pair_overflow", "giant_truncated"):
        assert int(ts[k]) == int(js[k]), k


@pytest.mark.parametrize("onepass", [True, False])
@pytest.mark.parametrize("size,depth_mode", [(0.05, jr.DEPTH_MAX), (0.3, jr.DEPTH_MAX),
                                             (0.05, jr.DEPTH_MIN)])
def test_giant_plain_matches_rasterize_pallas(size, depth_mode, onepass):
    """K2 (one-pass grid) and K3 (tiles x chunks grid) are one port kernel;
    its plain version equals both."""
    s = _random_setup(80, seed=1, size=size)
    jd, ji = j_pallas(s, 256, 256, tile_h=16, tile_w=64, chunk=32, depth_mode=depth_mode,
                      interpret=True, onepass=onepass)
    td, ti = rk.rasterize_giant(_port(s), 256, 256, tile_h=16, tile_w=64, chunk=32,
                                depth_mode=depth_mode)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_giant_plain_depth_only_matches_rasterize_pallas():
    s = jr.flip_depth_key(_random_setup(60, seed=4, size=0.3))
    jk, _ = j_pallas(s, 256, 256, tile_h=16, tile_w=64, chunk=32, want_ids=False,
                     interpret=True, onepass=True)
    tk, none = rk.rasterize_giant(_port(s), 256, 256, tile_h=16, tile_w=64, chunk=32,
                                  want_ids=False)
    assert none is None
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_exhaustive_rasterize_matches_reference():
    s = _random_setup(100, seed=6, size=0.1)
    for mode in (jr.DEPTH_MAX, jr.DEPTH_MIN):
        jd, ji = jr.rasterize(s, 256, 256, tile_h=16, tile_w=64, chunk=32, depth_mode=mode)
        td, ti = tr.rasterize(_port(s), 256, 256, tile_h=16, tile_w=64, chunk=32, depth_mode=mode)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_kernel_wrappers_take_the_plain_path_only_on_cpu():
    """A CPU tensor runs the plain version and launches nothing; any other
    device is refused rather than silently computed elsewhere."""
    from unclerenderer_tpu_torch.ops import _cuda

    before = dict(_cuda.LAUNCHES)
    s = _port(_random_setup(50, seed=0, size=0.05))
    rk.rasterize_binned(s, 128, 128, **KW)
    assert _cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        rk.binned_raster(torch.zeros((1, 16, 32), device="meta"), None, None, None, None,
                         16, 64, 2)


# coplanar copies with different ids: within one bin block (20 < chunk 32),
# across the blocks of one tile (70 copies: three blocks), and across giant
# chunks (20 copies in chunks of 8)
COPLANAR = {"one_block": (20, 0), "blocks_of_a_tile": (70, 0), "giant_chunks": (0, 20)}


@pytest.mark.parametrize("case", list(COPLANAR))
@pytest.mark.parametrize("want_ids,depth_mode", [(True, jr.DEPTH_MAX), (False, jr.DEPTH_MIN)])
def test_coplanar_copies_go_to_the_smallest_id(case, want_ids, depth_mode):
    """The tie rule the K1/K2 kernels keep: equal keys go to the smallest
    id (K1, min over a tile's blocks) or row (K2, rows in ascending order);
    the plain versions equal the reference's kernels in interpret mode."""
    n_small, n_big = COPLANAR[case]
    s = _coplanar_setup(n_small, n_big)
    first = 6  # the first copy's id: six random triangles come before
    if n_big:
        kw = dict(tile_h=16, tile_w=64, chunk=8, depth_mode=depth_mode)
        jd, ji = j_pallas(s, 256, 256, **kw, want_ids=want_ids, interpret=True, onepass=True)
        td, ti = rk.rasterize_giant(_port(s), 256, 256, **kw, want_ids=want_ids)
        if not want_ids:  # depth-only: raw keys
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
            return
    else:
        kw = dict(**KW, mid_divisor=2, giant_divisor=4, depth_mode=depth_mode)
        jd, ji, _ = j_binned(s, 256, 256, **kw, want_ids=want_ids, interpret=True)
        td, ti, _ = rk.rasterize_binned(_port(s), 256, 256, **kw, want_ids=want_ids)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    if want_ids:
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        ids = ti.numpy()
        copies = set(range(first, first + max(n_small, n_big)))
        won = set(np.unique(ids).tolist()) & copies
        assert won == {first}, won  # only the first copy ever wins


def _centre(origin, offset):
    """Pixel centres as the kernels compute them, in f32."""
    return (origin + torch.as_tensor(offset, dtype=torch.float32)) + 0.5


def _edge(a, b, c, qx, qy):
    return fma(a, qx, b * qy) + c


def _inside(ev, a, b):
    top_left = (a > 0) | ((a == 0) & (b > 0))
    return (ev > 0) | ((ev == 0) & top_left)


def test_edge_threshold_equals_the_top_left_test():
    """The kernels test ``ev >= lo`` with lo = 0 on a top-left edge and the
    least positive float (2^-149) otherwise: the same as the reference's
    ``ev > 0 | (ev == 0 & top_left)`` for every ev, signed zeros,
    denormals, infinities and NaN included."""
    tiny = np.float32(2.0**-149)
    evs = np.array([0.0, -0.0, tiny, -tiny, 2 * tiny, 1e-38, -1e-38, 1.0, -1.0, np.inf,
                    -np.inf, np.nan, 3.4e38], np.float32)
    coefs = np.array([0.0, -0.0, 1.0, -1.0, tiny, -tiny, np.nan], np.float32)
    ev, a, b = (torch.from_numpy(x.reshape(-1)) for x in np.meshgrid(evs, coefs, coefs))
    top_left = (a > 0) | ((a == 0) & (b > 0))
    lo = torch.where(top_left, torch.zeros_like(ev), torch.full_like(ev, float(tiny)))
    assert torch.equal(ev >= lo, _inside(ev, a, b))


def _edge_rows(rng, x0, y0, rect_h, rect_w):
    """Edge rows (a, b, c), one per rectangle at (x0, y0), of every kind the
    warp skip meets: random scales, lines through two pixel centres on or
    near the rectangle (ev == 0 exactly at some), axis-aligned edges with
    signed zeros, and values near the f32 range."""
    n = x0.shape[0]
    scale = 10.0 ** rng.uniform(-4, 4, (n, 1))
    a, b, c = (rng.standard_normal((n, 1)) * scale for _ in range(3))
    k = n // 2
    px = x0[:k, None] + np.floor(rng.uniform(-4, rect_w + 4, (k, 2))) + 0.5
    py = y0[:k, None] + np.floor(rng.uniform(-4, rect_h + 4, (k, 2))) + 0.5
    a[:k, 0] = py[:, 0] - py[:, 1]
    b[:k, 0] = px[:, 1] - px[:, 0]
    c[:k, 0] = -(a[:k, 0] * px[:, 0] + b[:k, 0] * py[:, 0])
    a[k:k + k // 2:2], b[k + 1:k + k // 2:2] = 0.0, -0.0  # axis-aligned, signed zeros
    c[n - 32:n - 16] = 3e38
    a[n - 16:] = -3e38
    return [torch.from_numpy(x.astype(np.float32)) for x in (a, b, c)]


# the warp rectangles (rows, columns) of K1 and K2 (csrc kRectH, kRectW); the
# claim holds for any rectangle
@pytest.mark.parametrize("rect", [(16, 8), (8, 32)], ids=["K1", "K2"])
@pytest.mark.parametrize("y_offset", [0.0, 37.25])
def test_warp_skip_never_drops_a_passing_pixel(y_offset, rect):
    """The K1/K2 warp skip: a warp drops a row when an edge, evaluated at
    the corner of the warp's pixel rectangle where it is largest, fails
    the edge test.  The computed edge function is monotone in x and y, so
    no pixel of the rectangle may pass that edge: checked over every pixel
    of random rectangles, with the kernels' f32 arithmetic."""
    rh, rw = rect
    rng = np.random.default_rng(int(y_offset))
    n = 8192
    x0 = rng.integers(0, 64, n).astype(np.float32) * rw
    y0 = rng.integers(0, 64, n).astype(np.float32) * rh
    a, b, c = _edge_rows(rng, x0, y0 + np.float32(y_offset), rh, rw)
    x0 = torch.from_numpy(x0)[:, None]
    y0 = torch.from_numpy(y0)[:, None] + y_offset
    cols, rows = torch.arange(rw), torch.arange(rh)
    qx = _centre(x0, cols).repeat(1, rh)  # (n, rh * rw): row-major pixels
    qy = _centre(y0, rows).repeat_interleave(rw, dim=1)
    passes = _inside(_edge(a, b, c, qx, qy), a, b).any(dim=1)
    cx = torch.where(a > 0, _centre(x0, rw - 1), _centre(x0, 0))
    cy = torch.where(b > 0, _centre(y0, rh - 1), _centre(y0, 0))
    may = _inside(_edge(a, b, c, cx, cy), a, b)[:, 0]
    assert not (passes & ~may).any()  # a skipped row has no passing pixel
    assert 0.2 < float(may.float().mean()) < 0.8  # both outcomes are exercised


def _call_args(kernel, tile):
    """The arguments of one K1 or K2 call on random triangles at ``tile``."""
    s = _port(_random_setup(120, seed=8, size=0.15))
    th, tw = tile
    n_tx = -(-256 // tw)
    if kernel == "binned_raster":
        bins = bin_triangles(s, 256, 256, th, tw, 32)
        start, count = rk.tile_block_ranges(bins, n_tx * -(-256 // th))
        return (bins.coef, bins.tri_id, bins.valid, start, count, th, tw, n_tx, 0.0, True, False)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rk, "giant_raster", lambda *a: calls.append(a) or rk.giant_raster_ref(*a))
        rk.rasterize_giant(s, 256, 256, tile_h=th, tile_w=tw, chunk=8)
    return calls[0]


@pytest.mark.parametrize("kernel,tile", [("binned_raster", (16, 64)), ("binned_raster", (24, 36)),
                                         ("giant_raster", (32, 256)), ("giant_raster", (12, 40))])
def test_warp_rows_counts_the_kernels_skip(kernel, tile):
    """``sweeps.raster.warp_rows`` (the work behind the K1/K2 bound) against
    a tile-by-tile, rectangle-by-rectangle count: the (warp rectangle,
    valid row) pairs tested, those kept, their pixels (a partial rectangle
    at the tile's edge is tested at the whole rectangle's corners, as the
    kernels do, and counts only its pixels inside); the kept pixels cover
    every (pixel, row) pair whose three edges pass."""
    args = _call_args(kernel, tile)
    binned = kernel == "binned_raster"
    rh, rw = sweep.BINNED_RECT if binned else sweep.GIANT_RECT
    th, tw = tile
    n_tx = args[7] if binned else args[6]
    tested = kept = kept_pix = inside_pairs = 0
    for t in range((args[3] if binned else args[2]).shape[0]):
        if binned:
            b0, nb = int(args[3][t]), int(args[4][t])
            rows = args[0][b0:b0 + nb].transpose(1, 2).reshape(-1, 16)
            ok = args[2][b0:b0 + nb, 0].reshape(-1) > 0
        else:
            live = torch.nonzero(args[2][t] != 0)[:, 0]
            rows = args[0][live].transpose(1, 2).reshape(-1, 16)
            ok = args[1][live].reshape(-1) > 0
        rows = rows[ok]
        x0, y0 = float((t % n_tx) * tw), float((t // n_tx) * th)
        for ry in range(0, th, rh):
            for rx in range(0, tw, rw):
                h, w = min(rh, th - ry), min(rw, tw - rx)
                qx = _centre(x0, torch.arange(rx, rx + w)).repeat(h)
                qy = _centre(y0, torch.arange(ry, ry + h)).repeat_interleave(w)
                may = torch.ones(rows.shape[0], dtype=torch.bool)
                passes = torch.ones((rows.shape[0], h * w), dtype=torch.bool)
                for e in range(3):
                    a, b, c = (rows[:, i] for i in (e, 3 + e, 6 + e))
                    # the corners of the whole rectangle, as the kernels take them
                    cx = torch.where(a > 0, _centre(x0, rx + rw - 1), _centre(x0, rx))
                    cy = torch.where(b > 0, _centre(y0, ry + rh - 1), _centre(y0, ry))
                    may &= _inside(_edge(a, b, c, cx, cy), a, b)
                    passes &= _inside(_edge(a[:, None], b[:, None], c[:, None], qx, qy),
                                      a[:, None], b[:, None])
                may |= ~torch.isfinite(rows[:, :9]).all(1)
                tested += rows.shape[0]
                kept += int(may.sum())
                kept_pix += int(may.sum()) * h * w
                inside_pairs += int(passes.sum())
    assert sweep.warp_rows(kernel, args) == (tested, kept, kept_pix)
    assert 0 < inside_pairs <= kept_pix < tested * rh * rw  # the skip drops some, never a hit
