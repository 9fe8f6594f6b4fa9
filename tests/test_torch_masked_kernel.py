"""M1, the masked raster's kernel (``ops/raster_kernels.py masked_raster``),
through its wrapper on the CPU (its plain version ``masked_raster_ref``), on
the synthetic setups of ``render/testing.py masked_raster_setup``: random
triangles, coplanar copies (equal keys), depth planes of +0 and -0 (keys of
exactly 0 that tie), slivers covering pixels past their (shrunk) boxes and
vertex alphas within ulps of the cutoff, over every atlas layout the frame
samples.

* The wrapper given every block slot of a level, dead blocks included, and
  each tile's block range, equals the live-block path it replaced in the
  frame (``_alpha_level`` over ``blk_live.nonzero()``), and its device-tensor
  counts equal that path's counts; the exhaustive form given every chunk
  equals ``_alpha_level`` over every (tile, chunk) pair, so the chunk skip
  drops nothing that covers a pixel.  Binned levels at y_offset 0 and 48.
* The port's masked raster (``_rasterize_alpha_binned`` at caps -1 and the
  exact count, ``_rasterize_alpha`` at cap 0, both through M1) equals the
  reference's on the same setups, 128x128: depth and ids bit-equal.
* The wrapper refuses layouts M1 does not take with ``ValueError``.

On the card ``tests/test_torch_cuda.py -k masked`` holds the kernel to the
plain version on the same setups."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unclerenderer_tpu.ops.raster import RasterSetup as JSetup
from unclerenderer_tpu.render import common as jcommon
from unclerenderer_tpu.render.params import RenderSettings as JSettings
from unclerenderer_tpu_torch.ops import raster_kernels as rk
from unclerenderer_tpu_torch.render import common as tcommon
from unclerenderer_tpu_torch.render.params import RenderSettings
from unclerenderer_tpu_torch.render.testing import (
    MASKED_CASES,
    masked_raster_args,
    masked_raster_atlas,
    masked_raster_setup,
)
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

W = H = 256
# each case's atlas: every layout and element type the frame's samplers take
ATLAS = {"random": ("quad4", torch.float32), "ties": ("quad16", torch.uint8),
         "zero": ("packed", torch.uint8), "slivers": ("quad4", torch.bfloat16),
         "cutoff": ("packed", torch.float32)}


def _case(case, size=W, n=120):
    setup, arec = masked_raster_setup(case, 0, "cpu", size, size, n)
    atlas, aw = masked_raster_atlas(*ATLAS[case], "cpu")
    return setup, arec, atlas, aw


def _live_path(args, bins=None):
    """The frame's path before M1: ``_alpha_level`` over the live blocks
    (``blk_live.nonzero()``), or over every (tile, chunk) pair."""
    coef, ids, valid, rows, _, _, arec, atlas, aw, th, tw, w, h, y0, full_h, bil = args
    n_tiles = -(-w // tw) * -(-h // th)
    if bins is not None:
        live = bins.blk_live.nonzero(as_tuple=True)[0]
        tiles = bins.blk_tile[live].long()
    else:  # every chunk against every tile
        live = torch.arange(coef.shape[0]).repeat(n_tiles)
        tiles = torch.arange(n_tiles).repeat_interleave(coef.shape[0])
    valid = valid.reshape(coef.shape[0], -1) > 0.0
    blocks = (coef[live], rows.reshape(coef.shape[0], -1)[live],
              ids.reshape(coef.shape[0], -1)[live], valid[live], tiles)
    return rk._alpha_level(blocks, atlas, aw, arec, th, tw, w, h, full_h or h, bil, y0)


@pytest.mark.parametrize("y_offset", [0, 48])
@pytest.mark.parametrize("form", ["binned", "exhaustive"])
@pytest.mark.parametrize("case", MASKED_CASES)
def test_wrapper_equals_the_live_block_path(case, form, y_offset):
    setup, arec, atlas, aw = _case(case)
    bilinear = case == "slivers"
    args = masked_raster_args(setup, arec, atlas, aw, W, H - y_offset, form,
                              y_offset=y_offset, full_height=H, bilinear=bilinear)
    key, ids, counts = rk.masked_raster(*args, stats=True)
    bins = None
    if form == "binned":
        from unclerenderer_tpu_torch.ops.binning import bin_triangles

        bins = bin_triangles(setup, W, H - y_offset, 16, 64, 64, max_span=4, budget_factor=4.0,
                             y_offset=y_offset, full_height=H)
        assert args[0].shape[0] == bins.blk_live.shape[0]  # every block slot, dead ones too
        assert int(bins.blk_live.sum()) < bins.blk_live.shape[0]
    want_key, want_ids, want = _live_path(args, bins)
    assert torch.equal(key.view(torch.int32), want_key.view(torch.int32))
    assert torch.equal(ids, want_ids)
    assert int((ids >= 0).sum()) > (0 if case == "slivers" else 1000)
    assert all(v.dtype == torch.int64 and v.shape == () for v in counts.values())
    assert int(counts["covered"]) == want["covered"] > 0
    assert int(counts["tapped"]) == int(counts["covered"])  # the plain version taps them all
    if form == "binned":
        assert int(counts["blocks"]) == want["blocks"] == int(bins.blk_live.sum())
    else:  # the chunks some valid slot may reach the tile by
        assert 0 < int(counts["blocks"]) <= want["blocks"]


def test_ties_and_zero_keys_go_to_the_min_id():
    """Coplanar copies tie: the lower id wins; a -0.0 key ties a +0.0 key,
    and the image holds +0.0."""
    for case in ("ties", "zero"):
        setup, arec, atlas, aw = _case(case)
        key, ids, _ = rk.masked_raster(*masked_raster_args(setup, arec, atlas, aw, W, H,
                                                           "exhaustive"))
        won = ids >= 0
        assert int(won.sum()) > 1000
        assert bool((ids[won] % 2 == 0).all())  # the first of each copy pair
        if case == "zero":
            assert bool((key[won] == 0.0).all())
            assert not bool(torch.signbit(key[won]).any())


@functools.lru_cache(maxsize=None)
def _reference(cap, height, filt):
    """The reference's masked level raster at ``cap``, jitted once a cap."""
    settings = JSettings(width=height, height=height, masked_tri_cap=cap, texture_filter=filt,
                         raster_backend="pallas", pallas_interpret=True)
    fn = jcommon._rasterize_alpha_binned if cap != 0 else jcommon._rasterize_alpha

    def run(quad_img, coef, valid, bbox, arec):
        return fn(JSetup(coef=coef, valid=valid, bbox=bbox), arec[:, 0:3], arec[:, 3:6],
                  arec[:, 6:9], arec[:, 9:12], arec[:, 12:16], arec[:, 16], arec[:, 17],
                  arec[:, 18], types.SimpleNamespace(quad_img=quad_img), settings, height, 0)

    return jax.jit(run)


@pytest.mark.parametrize("cap", [0, -1, "exact"])
@pytest.mark.parametrize("case", MASKED_CASES)
def test_masked_raster_matches_reference(case, cap):
    size = 128
    setup, arec, atlas, aw = _case(case, size, n=60)
    n_valid = int(setup.valid.sum())
    cap = n_valid if cap == "exact" else cap
    filt = "bilinear" if case == "slivers" else "trilinear"
    settings = RenderSettings(width=size, height=size, masked_tri_cap=cap, texture_filter=filt)
    scene = types.SimpleNamespace(quad_img=atlas.reshape(-1, aw, atlas.shape[-1]))
    if cap != 0:
        key, ids, counts = tcommon._rasterize_alpha_binned(setup, arec, scene, settings, size,
                                                           stats=True)
    else:
        key, ids, counts = tcommon._rasterize_alpha(setup, arec, scene, settings, size,
                                                    stats=True)
    assert len(counts) == (1 if cap == 0 else 2)
    assert all(isinstance(v, torch.Tensor) for c in counts for v in c.values())
    quad = atlas.reshape(-1, aw, atlas.shape[-1])
    j_quad = jnp.asarray(quad.view(torch.int16).numpy()).view(jnp.bfloat16) if (
        quad.dtype == torch.bfloat16) else jnp.asarray(quad.numpy())
    want_depth, want_ids = _reference(cap, size, filt)(
        j_quad, setup.coef.numpy(), setup.valid.numpy(), setup.bbox.numpy(), arec.numpy())
    np.testing.assert_array_equal(torch.where(key >= 0.0, key, 0.0).numpy(),
                                  np.asarray(want_depth))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    assert int((ids >= 0).sum()) > (10 if case == "slivers" else 300)


@pytest.mark.parametrize("bad", ["u8_quad4", "arec_cols", "tile_ranges", "one_range"])
def test_wrapper_refuses_what_m1_does_not_take(bad):
    setup, arec, atlas, aw = _case("random")
    args = list(masked_raster_args(setup, arec, atlas, aw, W, H, "binned"))
    if bad == "u8_quad4":
        args[7] = torch.zeros((aw * 64, 16), dtype=torch.uint8)
    elif bad == "arec_cols":
        args[6] = arec[:, :18]
    elif bad == "tile_ranges":
        args[4], args[5] = args[4][:-1], args[5][:-1]
    else:
        args[5] = None
    with pytest.raises(ValueError, match="masked_raster"):
        rk.masked_raster(*args)


def test_frame_settings_reach_m1_with_every_block_slot():
    """The frame's binned level hands M1 every block slot (no nonzero of the
    live blocks) and the scene's atlas at its filter."""
    setup, arec, atlas, aw = _case("random", 128, n=60)
    seen = []

    wrapper = rk.masked_raster

    def record(*a, **k):
        seen.append(a)
        return wrapper(*a, **k)

    settings = RenderSettings(width=128, height=128, masked_tri_cap=-1,
                              texture_filter="bilinear")
    scene = types.SimpleNamespace(quad_img=atlas.reshape(-1, aw, atlas.shape[-1]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rk, "masked_raster", record)
        tcommon._rasterize_alpha_binned(setup, arec, scene, settings, 128)
    assert len(seen) == 2  # level 1 and level 2
    for a in seen:
        assert a[4] is not None and a[15] is True and a[7].shape == atlas.shape
