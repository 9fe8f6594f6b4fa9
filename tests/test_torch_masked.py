"""The alpha-masked raster of the port (``render/common.py``) against the
reference's, on the per-slot masked scene (every 4th model from 1 a MASK
material with a 32^2 alpha checker), at 128x128:

* ``_alpha_lod`` and ``_alpha_tap`` within the tap tolerance (rtol 1e-6,
  atol 1e-6 for the LOD: the two log2s differ by an ulp now and then; the
  tap's blends are uncontracted in the port);
* ``raster_masked_combine`` on the same inputs at ``masked_tri_cap`` 0
  (exhaustive), -1 (binned over the whole table) and the exact masked
  count (binned over the compacted list): depth and ids bit-equal, with
  opaque depths that tie masked ones;
* the alpha test is live (cutoff 0.5 removes pixels that cutoff 0 covers),
  and the reference's ``RenderSettings()`` renders on the port.

The whole frame over carried frames is ``tests/test_torch_masked_frame.py``."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from unclerenderer_tpu.render import common as jcommon
from unclerenderer_tpu.render.params import RenderSettings as JSettings
from unclerenderer_tpu.render.testing import synthetic_device_scene as j_scene
from unclerenderer_tpu.render.testing import synthetic_frame_params as j_frame_params
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.render import common as tcommon
from unclerenderer_tpu_torch.render.deferred import deferred_frame
from unclerenderer_tpu_torch.render.params import DeviceScene, FrameParams, FrameState, RenderSettings
from unclerenderer_tpu_torch.render.testing import synthetic_device_scene, synthetic_frame_params
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

SIZE = 128
RTOL, ATOL = 1e-6, 1e-7
LOD_ATOL = 1e-6


def T(x):
    return interop.array_to_tensor(x, "cpu")


@pytest.fixture(scope="module")
def masked():
    """The reference's masked scene, the port's copy of it, and frame
    parameters near masked model 1 (its triangles span many tiles)."""
    scene, data = j_scene(8, with_masked=True)
    cam = tuple(np.asarray(data.models[1].center) + [0.0, 0.3, -1.1])
    params = j_frame_params(data, SIZE, SIZE, camera_pos=cam)
    n_masked = int((np.asarray(data.alpha_mode)[data.tri_model] == 1).sum())
    return scene, data, interop.to_port(scene, DeviceScene, "cpu"), params, n_masked


def test_alpha_lod_within_tolerance():
    rng = np.random.default_rng(0)
    args = [rng.standard_normal(50_000).astype(np.float32) for _ in range(11)]
    args[8] = np.abs(args[8]) + 0.1  # denominators
    args[9], args[10] = np.abs(args[9]) * 64, np.abs(args[10]) * 64  # texel sizes
    want = np.asarray(jax.jit(jcommon._alpha_lod)(*args))
    got = tcommon._alpha_lod(*[T(a) for a in args]).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=LOD_ATOL)


@pytest.mark.parametrize("texture_filter", ["trilinear", "bilinear"])
def test_alpha_tap_within_tolerance(masked, texture_filter):
    scene, _, t_scene, _, _ = masked
    rng = np.random.default_rng(1)
    n = 20_000
    rects = np.asarray(scene.tri_mrec)[:, 40:44]  # the base slot's rect
    rect0 = rects[rng.integers(0, rects.shape[0], n)]
    uv = rng.uniform(-0.5, 1.5, (n, 2)).astype(np.float32)
    lod = rng.uniform(-1.0, 7.0, n).astype(np.float32)
    quad = scene.quad_img.reshape(-1, scene.quad_img.shape[-1])
    j_settings = JSettings(texture_filter=texture_filter)
    want = np.asarray(jax.jit(functools.partial(
        jcommon._alpha_tap, quad, scene.quad_img.shape[1], settings=j_settings))(
            rect0=rect0, uv=uv, lod=lod))
    got = tcommon._alpha_tap(t_scene.quad_img.reshape(-1, t_scene.quad_img.shape[-1]),
                             t_scene.quad_img.shape[1], T(rect0), T(uv), T(lod),
                             RenderSettings(texture_filter=texture_filter))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert 0.0 < float((want[:, 3] == 0.0).mean()) < 1.0  # the checker's cut-outs are tapped


def _inputs(masked, settings):
    """The camera's vertex stage and draw masks of the masked scene (the
    port's, bit-equal to the reference's), and an opaque visibility buffer
    from the port's opaque raster, with some of its depths moved onto
    masked ones to make ties."""
    _, _, t_scene, params, _ = masked
    p = interop.to_port(params, FrameParams, "cpu")
    vsoa = tcommon.vertex_stage_soa(t_scene.pos_soa, p.view_proj, SIZE, SIZE)
    opaque, masked_mask = tcommon.tri_draw_masks(t_scene, p.model_visible)
    depth, tri_id = tcommon.raster_opaque(t_scene, opaque, settings, vsoa)[:2]
    m_depth, _, _ = tcommon.raster_masked_combine(
        t_scene, masked_mask, torch.zeros_like(depth), torch.full_like(tri_id, -1), settings, vsoa)
    tie = (m_depth > 0.0) & (torch.arange(SIZE * SIZE).reshape(SIZE, SIZE) % 7 == 0)
    depth = torch.where(tie, m_depth, depth)
    tri_id = torch.where(tie, torch.full_like(tri_id, 3), tri_id)
    return vsoa, masked_mask, depth, tri_id, tie


@pytest.mark.parametrize("cap", [0, -1, "exact"])
def test_raster_masked_combine_matches_reference(masked, cap):
    scene, _, t_scene, _, n_masked = masked
    cap = n_masked if cap == "exact" else cap
    common = dict(width=SIZE, height=SIZE, masked_tri_cap=cap)
    vsoa, masked_mask, depth, tri_id, tie = _inputs(masked, RenderSettings(**common))
    j_vsoa = jcommon.VertexSoA(*[tuple(x.numpy() for x in getattr(vsoa, f))
                                 for f in ("px", "py", "pw", "z")])
    j_settings = JSettings(raster_backend="pallas", pallas_interpret=True, **common)
    want = jax.jit(lambda sc, vs, mm, d, t: jcommon.raster_masked_combine(
        sc, None, None, mm, d, t, j_settings, vsoa=vs))(
            scene, j_vsoa, masked_mask.numpy(), depth.numpy(), tri_id.numpy())
    got_depth, got_tri, counts = tcommon.raster_masked_combine(
        t_scene, masked_mask, depth, tri_id, RenderSettings(**common), vsoa, stats=True)
    np.testing.assert_array_equal(got_depth.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got_tri.numpy(), np.asarray(want[1]))
    # the frame's call builds no counts, and its images are the same
    plain = tcommon.raster_masked_combine(t_scene, masked_mask, depth, tri_id,
                                          RenderSettings(**common), vsoa)
    assert plain[2] is None
    assert torch.equal(plain[0], got_depth) and torch.equal(plain[1], got_tri)
    am = t_scene.alpha_mode[t_scene.tri_model.long()]
    won = (got_tri >= 0) & (am[got_tri.clamp(min=0).long()] == 1)
    assert int(won.sum()) > 500  # masked geometry wins pixels
    assert bool((got_tri[tie] == 3).all())  # opaque wins ties
    assert len(counts) == (1 if cap == 0 else 2)
    assert counts[0]["covered"] > 0 and counts[0]["candidates"] >= counts[0]["covered"]
    if cap != 0:  # the binned levels' drops, which the reference does not count
        assert int(counts[0]["bin_overflow"]) >= 0 and int(counts[1]["big_dropped"]) >= 0


def test_alpha_test_is_live(masked):
    """Cutoff 0.5 cuts the checker's holes that cutoff 0 keeps."""
    _, _, t_scene, _, _ = masked
    settings = RenderSettings(width=SIZE, height=SIZE)
    vsoa, masked_mask, _, _, _ = _inputs(masked, settings)
    empty = (torch.zeros((SIZE, SIZE)), torch.full((SIZE, SIZE), -1, dtype=torch.int32))
    cut = tcommon.raster_masked_combine(t_scene, masked_mask, *empty, settings, vsoa)[1] >= 0
    keep_all = dataclasses.replace(t_scene, alpha_cutoff=torch.zeros_like(t_scene.alpha_cutoff))
    full = tcommon.raster_masked_combine(keep_all, masked_mask, *empty, settings, vsoa)[1] >= 0
    assert not bool((cut & ~full).any())
    assert int((full & ~cut).sum()) > 200


def test_reference_default_settings_render(masked):
    """``RenderSettings()`` with only the size changed -- masked models on,
    per-slot taps, ``masked_tri_cap=-1`` -- renders the masked scene."""
    _, data, _, _, _ = masked
    settings = RenderSettings(width=64, height=64, shadow_map_size=64)
    defaults = RenderSettings()
    assert settings.has_masked_models and not settings.combined_material
    assert settings.masked_tri_cap == defaults.masked_tri_cap == -1
    t_scene, t_data = synthetic_device_scene(8, with_masked=True, device="cpu")
    out, state = deferred_frame(t_scene, synthetic_frame_params(t_data, 64, 64, device="cpu"),
                                FrameState.initial(64, 64, "cpu"), settings)
    assert bool(torch.isfinite(out["color"]).all()) and bool(torch.isfinite(state.hzb).all())
    assert int((out["tri_id"] >= 0).sum()) > 100
    assert t_data.num_triangles == data.num_triangles
