"""The in-frame debug-print overlay and the frame's cached-shadow-map input
against the reference.

``ops/overlay.py device_stats_overlay`` bit-equal to the reference's on
random frames and counters (the glyph alphas are 0 or 1, so every blend is
exact).  ``deferred_frame(shadow_map=)`` with the map the frame would
render itself: every output bit-equal to the frame that renders it; and
with one map given to both, the port against the reference's
``deferred_frame(..., shadow_map=)`` at the frame tests' bars
(``tests/test_torch_frame.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unclerenderer_tpu.ops import overlay as j_overlay
from unclerenderer_tpu.render.deferred import deferred_frame as j_frame
from unclerenderer_tpu.render.params import FrameState as JState
from unclerenderer_tpu.render.params import RenderSettings as JSettings
from unclerenderer_tpu.render.testing import synthetic_device_scene as j_scene
from unclerenderer_tpu.render.testing import synthetic_frame_params as j_frame_params
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.ops import overlay as t_overlay
from unclerenderer_tpu_torch.render import common
from unclerenderer_tpu_torch.render.deferred import deferred_frame
from unclerenderer_tpu_torch.render.params import DeviceScene, FrameParams, FrameState, RenderSettings
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

SIZE = 128
EXACT = ("depth", "tri_id", "object_id", "model_visible", "frustum_culled", "hzb_occluded")


def _counters(seed):
    rng = np.random.default_rng(seed)
    total = int(rng.choice([4, 342, 12345]))
    return dict(models_visible=int(rng.integers(0, total + 1)), models_total=total,
                frustum_culled=int(rng.integers(0, total + 1)),
                hzb_occluded=int(rng.integers(0, 10 ** len(str(total)))),
                exposure_ev=np.float32(rng.choice([rng.normal(0, 4), -0.004, 0.005, 99.999,
                                                   -12.345])))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("shape", [(96, 200), (1080, 1920), (40, 120)])
def test_device_stats_overlay_matches_reference(seed, shape):
    c = _counters(seed)
    color = np.random.default_rng(seed).random((*shape, 3), dtype=np.float32)
    want = j_overlay.device_stats_overlay(
        jnp.asarray(color), models_visible=jnp.int32(c["models_visible"]),
        models_total=c["models_total"], frustum_culled=jnp.int32(c["frustum_culled"]),
        hzb_occluded=jnp.int32(c["hzb_occluded"]), exposure_ev=jnp.float32(c["exposure_ev"]))
    got = t_overlay.device_stats_overlay(
        torch.from_numpy(color), models_visible=torch.tensor(c["models_visible"]),
        models_total=c["models_total"],
        frustum_culled=torch.tensor(c["frustum_culled"], dtype=torch.int32),
        hzb_occluded=torch.tensor(c["hzb_occluded"], dtype=torch.int32),
        exposure_ev=torch.tensor(c["exposure_ev"]))
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert (want != color).any() == (shape != (40, 120))  # lines that do not fit are dropped


@pytest.mark.parametrize("value", [0, 7, 10, 99, 100, 12345, -3])
def test_int_and_fixed_indices_match_reference(value):
    _, cmap = t_overlay.bake_overlay_font(2)
    got = t_overlay.int_indices(torch.tensor(value), 5, cmap)
    want = j_overlay.int_indices(jnp.int32(value), 5, cmap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ev = np.float32(value / 8.0)
    got = t_overlay.fixed_indices(torch.tensor(ev), 2, 2, cmap)
    want = j_overlay.fixed_indices(jnp.float32(ev), 2, 2, cmap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_overlay_font_matches_reference():
    got, got_map = t_overlay.bake_overlay_font(2)
    want, want_map = j_overlay.bake_overlay_font(2)
    np.testing.assert_array_equal(got, want)
    assert got_map == want_map


@pytest.fixture(scope="module")
def scenes():
    scene, data = j_scene(6, rich_materials=True, atlas_u8=True)
    return scene, data, interop.to_port(scene, DeviceScene, "cpu")


def _settings(cls, **kw):
    return cls(width=SIZE, height=SIZE, shadow_map_size=SIZE, has_masked_models=False,
               combined_material=True, gpu_debug_print=True, **kw)


@pytest.mark.parametrize("frames", [1, 2])
def test_frame_with_its_own_shadow_map_is_bit_equal(scenes, frames):
    """The map the frame renders, given back as ``shadow_map=``: every
    output and the carried state bit-equal (carried frames included)."""
    _, data, t_scene = scenes
    settings = _settings(RenderSettings)
    s_own = s_given = FrameState.initial(SIZE, SIZE, "cpu")
    for i in range(frames):
        a = 0.05 * i
        params = interop.to_port(
            j_frame_params(data, SIZE, SIZE, camera_pos=(4 * np.sin(a), 1.5, -4 * np.cos(a))),
            FrameParams, "cpu")
        opaque, masked = common.tri_draw_masks(t_scene, params.model_visible)
        shadow_map, overflow = common.raster_shadow(t_scene, params.light_view_proj,
                                                    opaque | masked, settings)
        assert int(overflow) == 0
        own, s_own = deferred_frame(t_scene, params, s_own, settings)
        given, s_given = deferred_frame(t_scene, params, s_given, settings, shadow_map=shadow_map)
        for k, v in own.items():
            if k == "raster_stats":
                assert {n: int(x) for n, x in v.items()} == \
                    {n: int(x) for n, x in given[k].items()}
            else:
                assert torch.equal(v, given[k]), (i, k)
        for f in ("taa_history", "exposure_ev", "hzb", "frame_index"):
            assert torch.equal(getattr(s_own, f), getattr(s_given, f)), f


def test_frame_with_a_given_shadow_map_matches_reference(scenes):
    """One map (the port's raster of the light view) into both frames:
    depth, ids and counters bit-equal, hdr and colour within 1e-4."""
    scene, data, t_scene = scenes
    settings = _settings(RenderSettings)
    params = j_frame_params(data, SIZE, SIZE, camera_pos=(1.0, 2.0, -4.5))
    t_params = interop.to_port(params, FrameParams, "cpu")
    opaque, masked = common.tri_draw_masks(t_scene, t_params.model_visible)
    shadow_map, _ = common.raster_shadow(t_scene, t_params.light_view_proj, opaque | masked,
                                         settings)
    j_settings = _settings(JSettings, raster_backend="pallas", pallas_interpret=True)
    step = jax.jit(functools.partial(j_frame, settings=j_settings))
    j_out, _ = step(scene, params, JState.initial(SIZE, SIZE),
                    shadow_map=jnp.asarray(shadow_map.numpy()))
    t_out, _ = deferred_frame(t_scene, t_params, FrameState.initial(SIZE, SIZE, "cpu"), settings,
                              shadow_map=shadow_map)
    got = interop.to_numpy(t_out)
    for k in EXACT:
        np.testing.assert_array_equal(got[k], np.asarray(j_out[k]), err_msg=k)
    for k, v in j_out["raster_stats"].items():
        assert int(got["raster_stats"][k]) == int(v), k
    assert int(got["raster_stats"]["shadow_compact_overflow"]) == 0
    for k in ("hdr", "color"):
        np.testing.assert_allclose(got[k], np.asarray(j_out[k]), rtol=0, atol=1e-4, err_msg=k)
    # the stats block (glyph colour (1, 1, 0.2)) is in both frames
    glyph = np.array([1.0, 1.0, 0.2], np.float32)
    assert (np.asarray(j_out["color"])[8:80, 8:120] == glyph).all(-1).sum() > 50
