"""The non-default sampling and storage settings over whole frames, against
the reference's: ``lod_derivatives="forward"`` (forward-difference LOD),
``soa_vertex=False`` (the AoS vertex stage) and ``shadow_table_u16=False``
(the f32 PCF table, K4 on f32 rows), each alone in one 128x128 deferred
frame on the rich-material u8 scene (the three together run 2 carried
frames with camera motion, ``tests/test_torch_sampling_combined.py``).
The reference runs its Pallas path in interpret mode.

The bar of ``tests/test_torch_frame.py``: depth, tri_id, object_id,
model_visible, the culling counters, every raster_stats counter and the
carried HZB bit-equal; hdr, colour and the TAA history within 1e-4,
exposure_ev within 1e-5.  ``frame_case`` is shared with
``tests/test_torch_sampling_combined.py``."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from unclerenderer_tpu.render.deferred import deferred_frame as j_deferred
from unclerenderer_tpu.render.forward import forward_frame as j_forward
from unclerenderer_tpu.render.params import FrameState as JState
from unclerenderer_tpu.render.params import RenderSettings as JSettings
from unclerenderer_tpu.render.testing import synthetic_device_scene as j_scene
from unclerenderer_tpu.render.testing import synthetic_frame_params as j_frame_params
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.render.deferred import deferred_frame
from unclerenderer_tpu_torch.render.forward import forward_frame
from unclerenderer_tpu_torch.render.params import DeviceScene, FrameParams, FrameState, RenderSettings
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

SIZE = 128
EXACT = ("depth", "tri_id", "object_id", "model_visible", "frustum_culled", "hzb_occluded")
ATOL_IMAGE = 1e-4
ATOL_EV = 1e-5
RICH = dict(has_masked_models=False, combined_material=True)
ALL_THREE = dict(lod_derivatives="forward", soa_vertex=False, shadow_table_u16=False)


@functools.lru_cache(maxsize=None)
def scenes(kind: str):
    """The reference's scene, its data and the port's copy: "rich" (6
    rich-material u8 models) or "masked" (8 per-slot models, every 4th
    masked)."""
    if kind == "rich":
        scene, data = j_scene(6, rich_materials=True, atlas_u8=True)
    else:
        scene, data = j_scene(8, with_masked=True)
    return scene, data, interop.to_port(scene, DeviceScene, "cpu")


def _camera(kind, data, i):
    if kind == "rich":
        a = 0.05 * i
        return (4.0 * np.sin(a), 1.5, -4.0 * np.cos(a))
    return tuple(np.asarray(data.models[1].center) + [0.1 * i, 0.3, -1.1])


def _check_images(got, want, keys, label):
    for k in keys:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=ATOL_IMAGE,
                                   err_msg=label + k)


def frame_case(kind: str, frame: str, frames: int = 1, **overrides):
    """``frames`` carried frames of the port and of the reference (Pallas,
    interpret mode) at ``overrides``, held to the bar above; returns the
    port's last output."""
    scene, data, t_scene = scenes(kind)
    common = dict(width=SIZE, height=SIZE, shadow_map_size=SIZE,
                  **(RICH if kind == "rich" else {}), **overrides)
    j_settings = JSettings(raster_backend="pallas", pallas_interpret=True, **common)
    t_settings = RenderSettings(**common)
    if frame == "forward":
        step = jax.jit(functools.partial(j_forward, settings=j_settings))
    else:
        step = jax.jit(functools.partial(j_deferred, settings=j_settings))
    j_state = JState.initial(SIZE, SIZE)
    t_state = interop.to_port(j_state, FrameState, "cpu")
    for i in range(frames):
        params = j_frame_params(data, SIZE, SIZE, camera_pos=_camera(kind, data, i))
        t_params = interop.to_port(params, FrameParams, "cpu")
        label = f"frame {i} "
        if frame == "forward":
            j_out = step(scene, params)
            t_out = forward_frame(t_scene, t_params, t_settings)
        else:
            j_out, j_state = step(scene, params, j_state)
            t_out, t_state = deferred_frame(t_scene, t_params, t_state, t_settings)
        assert t_out["object_id"].dtype == torch.uint32
        got = interop.to_numpy(t_out)
        for k in (EXACT if frame == "deferred" else ("depth", "tri_id", "object_id")):
            np.testing.assert_array_equal(got[k], np.asarray(j_out[k]), err_msg=label + k)
        assert set(got["raster_stats"]) == set(j_out["raster_stats"])
        for k, v in j_out["raster_stats"].items():
            assert int(got["raster_stats"][k]) == int(v), label + k
        _check_images(got, j_out, ("hdr", "color") if frame == "deferred" else ("color",), label)
        if frame == "deferred":
            got_state = interop.to_numpy(t_state)
            for f in dataclasses.fields(JState):
                want = np.asarray(getattr(j_state, f.name))
                if f.name in ("taa_history", "exposure_ev"):
                    tol = ATOL_IMAGE if f.name == "taa_history" else ATOL_EV
                    np.testing.assert_allclose(got_state[f.name], want, rtol=0, atol=tol)
                else:
                    np.testing.assert_array_equal(got_state[f.name], want, err_msg=f.name)
        assert (got["tri_id"] >= 0).sum() > 1000
    return t_out


@pytest.mark.parametrize("override", [{"lod_derivatives": "forward"}, {"soa_vertex": False},
                                      {"shadow_table_u16": False}],
                         ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_deferred_setting_alone_matches_reference(override):
    frame_case("rich", "deferred", **override)
