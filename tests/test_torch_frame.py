"""The whole slice: the port's deferred frame against the reference's, over
3 carried frames with camera motion, at 128x128 with a 128^2 shadow map on
the rich-material u8 scene (the default frame's material path).

The reference runs its Pallas path in interpret mode (raster_backend=
"pallas"): the port follows the Pallas path's u16 PCF table, which the
reference's XLA path does not use.

Bit-equal: depth, tri_id (compact ids when compaction is on, and the remap),
object_id, model_visible, the culling counters, every raster_stats counter
and the carried HZB.  Within tolerance: hdr and color (1e-4 absolute; the
transcendentals in GGX, sky and tonemap -- pow, exp, log2, rsqrt -- differ
by ulps between XLA:CPU and PyTorch, measured <= 1.2e-5) and exposure_ev
(1e-5: auto-exposure reduces the whole HDR image to one log-average, so
those ulps accumulate into the one scalar that then scales every pixel)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from unclerenderer_tpu.render.deferred import deferred_frame as j_frame
from unclerenderer_tpu.render.params import FrameState as JState
from unclerenderer_tpu.render.params import RenderSettings as JSettings
from unclerenderer_tpu.render.testing import synthetic_device_scene as j_scene
from unclerenderer_tpu.render.testing import synthetic_frame_params as j_frame_params
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.render.deferred import deferred_frame
from unclerenderer_tpu_torch.render.params import DeviceScene, FrameParams, FrameState, RenderSettings

SIZE = 128
EXACT = ("depth", "tri_id", "object_id", "model_visible", "frustum_culled", "hzb_occluded")
ATOL_IMAGE = 1e-4
ATOL_EV = 1e-5


@pytest.mark.parametrize("compact_cap", [-1, 256])
def test_deferred_frame_matches_reference(compact_cap):
    common = dict(width=SIZE, height=SIZE, shadow_map_size=SIZE, has_masked_models=False,
                  combined_material=True, compact_cap=compact_cap)
    j_settings = JSettings(raster_backend="pallas", pallas_interpret=True, **common)
    t_settings = RenderSettings(**common)
    scene, data = j_scene(6, rich_materials=True, atlas_u8=True)
    t_scene = interop.to_port(scene, DeviceScene, "cpu")
    j_state = JState.initial(SIZE, SIZE)
    t_state = interop.to_port(j_state, FrameState, "cpu")
    step = jax.jit(functools.partial(j_frame, settings=j_settings))
    overflow = []

    for i in range(3):
        a = 0.05 * i
        params = j_frame_params(data, SIZE, SIZE, camera_pos=(4.0 * np.sin(a), 1.5, -4.0 * np.cos(a)))
        j_out, j_state = step(scene, params, j_state)
        t_out, t_state = deferred_frame(t_scene, interop.to_port(params, FrameParams, "cpu"),
                                        t_state, t_settings)
        assert t_out["object_id"].dtype == torch.uint32  # the reference's dtype
        got = interop.to_numpy(t_out)
        for k in EXACT:
            np.testing.assert_array_equal(got[k], np.asarray(j_out[k]), err_msg=f"frame {i} {k}")
        assert set(got["raster_stats"]) == set(j_out["raster_stats"])
        for k, v in j_out["raster_stats"].items():
            assert int(got["raster_stats"][k]) == int(v), f"frame {i} {k}"
        assert ("tri_remap" in got) == ("tri_remap" in j_out)
        if "tri_remap" in got:
            np.testing.assert_array_equal(got["tri_remap"], np.asarray(j_out["tri_remap"]))
        for k in ("hdr", "color"):
            np.testing.assert_allclose(got[k], np.asarray(j_out[k]), rtol=0, atol=ATOL_IMAGE,
                                       err_msg=f"frame {i} {k}")
        got_state = interop.to_numpy(t_state)
        for f in dataclasses.fields(JState):
            want = np.asarray(getattr(j_state, f.name))
            if f.name in ("taa_history", "exposure_ev"):
                tol = ATOL_IMAGE if f.name == "taa_history" else ATOL_EV
                np.testing.assert_allclose(got_state[f.name], want, rtol=0, atol=tol)
            else:
                np.testing.assert_array_equal(got_state[f.name], want, err_msg=f.name)
        assert (got["tri_id"] >= 0).sum() > 1000
        overflow.append(int(got["raster_stats"]["compact_overflow"]))
    # the small cap really compacts, and drops (counted) past it
    assert (max(overflow) > 0) == (compact_cap == 256)
