"""The deferred frame with alpha-masked models against the reference's, at
the reference's own default material settings (``has_masked_models=True``,
``combined_material=False``: per-slot taps on the per-map quad atlas), on
its masked scene (``synthetic_device_scene(8, with_masked=True)``), over 3
carried 128x128 frames near masked model 1, at ``masked_tri_cap`` 0
(exhaustive), -1 (binned, whole table) and the scene's exact masked count
(binned, compacted: the Renderer's choice).

The reference runs its Pallas path in interpret mode (its masked raster is
plain XLA on every path).  Bit-equal: depth, tri_id, object_id,
model_visible, the culling counters, every raster_stats counter and the
carried HZB.  Within tolerance, as ``tests/test_torch_frame.py``: hdr,
color and the TAA history 1e-4, exposure_ev 1e-5."""

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
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

SIZE = 128
EXACT = ("depth", "tri_id", "object_id", "model_visible", "frustum_culled", "hzb_occluded")
ATOL_IMAGE = 1e-4
ATOL_EV = 1e-5


@pytest.fixture(scope="module")
def masked_scene():
    scene, data = j_scene(8, with_masked=True)
    return scene, data, interop.to_port(scene, DeviceScene, "cpu")


@pytest.mark.parametrize("cap", [0, -1, "exact"])
def test_masked_frame_matches_reference(masked_scene, cap):
    scene, data, t_scene = masked_scene
    masked_model = np.asarray(data.alpha_mode) == 1
    n_masked = int(masked_model[data.tri_model].sum())
    cap = -(-n_masked // 64) * 64 if cap == "exact" else cap  # the Renderer's rule
    common = dict(width=SIZE, height=SIZE, shadow_map_size=SIZE, masked_tri_cap=cap)
    j_settings = JSettings(raster_backend="pallas", pallas_interpret=True, **common)
    t_settings = RenderSettings(**common)
    assert t_settings.has_masked_models and not t_settings.combined_material
    j_state = JState.initial(SIZE, SIZE)
    t_state = interop.to_port(j_state, FrameState, "cpu")
    step = jax.jit(functools.partial(j_frame, settings=j_settings))
    center = np.asarray(data.models[1].center)
    for i in range(3):
        params = j_frame_params(data, SIZE, SIZE, camera_pos=tuple(center + [0.1 * i, 0.3, -1.1]))
        j_out, j_state = step(scene, params, j_state)
        t_out, t_state = deferred_frame(t_scene, interop.to_port(params, FrameParams, "cpu"),
                                        t_state, t_settings)
        assert t_out["object_id"].dtype == torch.uint32
        got = interop.to_numpy(t_out)
        for k in EXACT:
            np.testing.assert_array_equal(got[k], np.asarray(j_out[k]), err_msg=f"frame {i} {k}")
        assert set(got["raster_stats"]) == set(j_out["raster_stats"])
        for k, v in j_out["raster_stats"].items():
            assert int(got["raster_stats"][k]) == int(v), f"frame {i} {k}"
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
        tri = got["tri_id"]
        won = (tri >= 0) & masked_model[np.asarray(data.tri_model)[np.maximum(tri, 0)]]
        assert won.sum() > 1000, f"frame {i}: {won.sum()} pixels won by masked models"
