"""K1's debug print (``RenderSettings.kernel_debug_print``): the port's
plain version prints the lines the reference's ``_binned_kernel`` prints
through ``pl.debug_print`` in interpret mode -- ``binned raster: block <b>
-> tile <t>``, one per live bin block of the fine level (the reference
passes the flag to no other level) -- compared as multisets (the reference prints in grid order, the CUDA kernel in none),
on the reference tests' random setups (depth with ids, depth-only
orthographic).  Over a whole 64x64 deferred frame the setting prints the
lines of the frame's K1 calls (shadow and camera fine levels) and changes
no output."""

import collections

import jax
import numpy as np
import pytest
import torch
from test_pallas_kernels import _setup as _random_setup  # the reference tests' random triangles

from unclerenderer_tpu.ops import raster as jr
from unclerenderer_tpu.ops.pallas_raster import rasterize_binned as j_binned
from unclerenderer_tpu.render.testing import synthetic_device_scene as j_scene
from unclerenderer_tpu.render.testing import synthetic_frame_params as j_frame_params
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.ops import raster as tr
from unclerenderer_tpu_torch.ops import raster_kernels as rk
from unclerenderer_tpu_torch.render.deferred import deferred_frame
from unclerenderer_tpu_torch.render.params import DeviceScene, FrameParams, FrameState, RenderSettings
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

PREFIX = "binned raster: block "


def _lines(text: str) -> collections.Counter:
    return collections.Counter(ln.strip() for ln in text.splitlines() if ln.startswith(PREFIX))


def _port_setup(s):
    return tr.RasterSetup(coef=torch.from_numpy(np.array(s.coef)),
                          valid=torch.from_numpy(np.array(s.valid)),
                          bbox=torch.from_numpy(np.array(s.bbox)))


@pytest.mark.parametrize("n,seed,size,want_ids,ortho", [
    (150, 0, 0.04, True, False),
    (60, 2, 0.2, False, True),
])
def test_binned_debug_lines_match_reference(capfd, n, seed, size, want_ids, ortho):
    s = _random_setup(n, seed, 256, 256, size)
    if ortho:
        s = jr.normalize_ortho_setup(s)
    kw = dict(tile_h=16, tile_w=64, chunk=32, want_ids=want_ids, ortho=ortho)
    capfd.readouterr()
    j_out = j_binned(s, 256, 256, interpret=True, debug_print=True, **kw)
    jax.block_until_ready(j_out)
    want = _lines(capfd.readouterr().out)
    t_out = rk.rasterize_binned(_port_setup(s), 256, 256, debug_print=True, **kw)
    got = _lines(capfd.readouterr().out)
    assert got == want and sum(want.values()) > 20
    np.testing.assert_array_equal(t_out[0].numpy(), np.asarray(j_out[0]))
    # the lines are the live blocks, one each
    assert max(want.values()) == 1
    # without the flag nothing is printed
    rk.rasterize_binned(_port_setup(s), 256, 256, **kw)
    assert not _lines(capfd.readouterr().out)


def test_debug_lines_name_each_live_block_of_its_tile():
    start = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    count = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    assert rk.debug_lines(start, count) == [
        "binned raster: block 0 -> tile 0", "binned raster: block 1 -> tile 0",
        "binned raster: block 2 -> tile 2", "binned raster: block 3 -> tile 2",
        "binned raster: block 4 -> tile 2", "binned raster: block 5 -> tile 3"]


def test_frame_debug_lines_are_its_k1_blocks(capfd):
    """A 64x64 deferred frame with ``kernel_debug_print``: one line per live
    block of the fine level of its shadow and camera rasters (the K1 calls
    given ``debug``), and the frame's outputs those without the flag."""
    size = 64
    scene, data = j_scene(4, rich_materials=True, atlas_u8=True)
    common = dict(width=size, height=size, shadow_map_size=size, has_masked_models=False,
                  combined_material=True)
    t_scene = interop.to_port(scene, DeviceScene, "cpu")
    t_params = interop.to_port(j_frame_params(data, size, size), FrameParams, "cpu")
    calls = []
    orig = rk.binned_raster

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    capfd.readouterr()
    rk.binned_raster = record
    try:
        outs = [deferred_frame(t_scene, t_params, FrameState.initial(size, size, "cpu"),
                               RenderSettings(kernel_debug_print=flag, **common))[0]
                for flag in (True, False)]
    finally:
        rk.binned_raster = orig
    got = _lines(capfd.readouterr().out)
    debug_calls = [a for a, kw in calls if kw.get("debug")]
    assert len(debug_calls) == 2  # the shadow map's and the camera's fine levels
    want = collections.Counter(ln for a in debug_calls for ln in rk.debug_lines(a[3], a[4]))
    assert got == want and sum(want.values()) > 4
    for k in ("color", "depth", "tri_id"):
        assert torch.equal(outs[0][k], outs[1][k]), k
