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
