"""The AoS vertex stage on the masked scene (the masked raster's setup from
the AoS rows), and the anisotropic filter with compacted line taps under
forward-difference LOD, against the reference's frames (Pallas, interpret
mode), one 128x128 frame each, at the bar of
``tests/test_torch_sampling_frame.py``; and, port only, fused resolve on the
AoS rows equal to the unfused frame bit for bit."""

import torch
from test_torch_sampling_frame import SIZE, frame_case, scenes

from unclerenderer_tpu.render.testing import synthetic_frame_params as j_frame_params
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.render.deferred import deferred_frame
from unclerenderer_tpu_torch.render.params import FrameParams, FrameState, RenderSettings
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module


def test_masked_scene_aos_matches_reference():
    frame_case("masked", "deferred", soa_vertex=False)


def test_forward_lod_anisotropic_compacted_matches_reference():
    out = frame_case("rich", "deferred", lod_derivatives="forward",
                     texture_filter="anisotropic", aniso_compact_frac=0.25)
    assert "aniso_tap_overflow" in out["raster_stats"]


def test_aos_fused_resolve_equals_unfused():
    """The raster kernels' records built from the AoS rows
    (``VertexAoS.pix9``) give the unfused frame, masked pixels included."""
    _scene, data, t_scene = scenes("masked")
    params = interop.to_port(
        j_frame_params(data, SIZE, SIZE, camera_pos=tuple(data.models[1].center + [0, 0.3, -1.1])),
        FrameParams, "cpu")
    outs = []
    for fused in ("on", "auto"):
        settings = RenderSettings(width=SIZE, height=SIZE, shadow_map_size=SIZE,
                                  soa_vertex=False, fused_resolve=fused)
        outs.append(deferred_frame(t_scene, params, FrameState.initial(SIZE, SIZE, "cpu"),
                                   settings)[0])
    for k in ("color", "hdr", "depth", "tri_id", "object_id"):
        assert torch.equal(outs[0][k], outs[1][k]), k
    assert int((outs[0]["tri_id"] >= 0).sum()) > 1000
