"""The anisotropic material tap (D3D12_FILTER_ANISOTROPIC, the D3D12
renderer's shipped sampler) against the benchmark's float64 reference
(``renderbench/reference/``, plain torch, independent of the port), and
what the port records of it: the ``AnisoFootprint`` and ``AnisoTaps``
spans of a captured frame and the tap's device counters, which stay out of
the drop counters (``raster_stats``).

* ``_sample_aniso`` with the footprint of ``tex.footprint_lod_aniso``, on
  the dense path and under ``aniso_compact_frac``, against
  ``sample_materials_aniso`` on the same seeded scene's packed u8 atlas and
  material chains, at seeded uvs and derivatives;
* three 96x64 frames of an anisotropic ``Renderer`` against the reference's
  under the deferred configuration's limits;
* ``aniso_counters`` against a plain count of the same footprints, and the
  counters of a frame through ``Renderer.stats()`` and ``passes.COUNTERS``;
* the spans a captured frame records, by frame kind and material layout:
  the trilinear programs' counts as before, the anisotropic ones with the
  two spans once per material slot tapped, all within ``MAX_EVENTS``."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from renderbench import check, scenegen
from renderbench.reference import frame as ref_frame
from renderbench.reference.frames import ReferenceScene
from renderbench.reference.scene import Scene
from renderbench.traffic import Traffic
from unclerenderer_tpu_torch.core import passes
from unclerenderer_tpu_torch.ops import texture as tex
from unclerenderer_tpu_torch.render import common
from unclerenderer_tpu_torch.render.deferred import deferred_frame
from unclerenderer_tpu_torch.render.packing import M_RECT, M_UVOS, M_UVROT
from unclerenderer_tpu_torch.render.params import RenderSettings
from unclerenderer_tpu_torch.render.renderer import Renderer
from test_torch_observability import _Clock
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "renderbench/configs/sponza263k_aniso4_1080p.json").read_text())
SCENE = dict(n_objects=8, seed=2**33 + 5, sphere_res=(8, 6), n_materials=8, tex_size=32)
SMALL = dict(width=32, height=32, shadow_map_size=64)
ANISO = dict(texture_filter="anisotropic", max_anisotropy=4)
# The port taps in float32 and the reference in float64, on the same bytes:
# a texel coordinate uv * size - 0.5 carries about size * 2^-24 of rounding
# (2e-6 texel at 32), and the blend weights and the level's fraction an ulp
# or two of f32 each, on texels in [0, 1]; every tap is continuous in them,
# so the taps differ by a few 1e-6.  1e-4 leaves that room many times over
# and is a tenth of a byte step (1 / 255), so a texel or a level taken
# wrongly shows.
ATOL = 1e-4


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The seeded scene as the port builds it and as the reference does."""
    path = scenegen.write_scene(tmp_path_factory.mktemp("aniso"), **SCENE)
    r = Renderer(path, RenderSettings(**SMALL, **ANISO), device="cpu")
    return r, Scene(scenegen.scene_content(**SCENE), "cpu")


def _footprints(n, seed, size):
    """``n`` seeded (uv, d/dx, d/dy) and which are stretched: a quarter
    stretched along a random axis up to 8:1, the rest isotropic (d/dy is
    d/dx turned a right angle, at the same length; on the axes for half of
    them, where ``extent`` is exactly 0 and the N taps coincide); from a
    twentieth of a texel to 20 texels a pixel."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-1.5, 2.5, (n, 2))
    length = 10.0 ** rng.uniform(-1.3, 1.3, n) / size
    theta = rng.uniform(0.0, 2 * np.pi, n)
    axis = np.stack([np.cos(theta), np.sin(theta)], -1)
    dx = axis * length[:, None]
    dy = np.stack([-dx[:, 1], dx[:, 0]], -1)
    stretched = rng.random(n) < 0.25
    dy[stretched] *= rng.uniform(1.5, 8.0, stretched.sum())[:, None]
    # the isotropic quarter-turns on the axes, where the two squared
    # lengths are the same sum in float32
    iso = ~stretched & (rng.random(n) < 0.5)
    dx[iso] = np.stack([length[iso], np.zeros(iso.sum())], -1)
    dy[iso] = np.stack([np.zeros(iso.sum()), length[iso]], -1)
    return [a.astype(np.float32) for a in (uv, dx, dy)], stretched


@pytest.mark.parametrize("frac", [0.0, 0.25], ids=["dense", "compacted"])
def test_aniso_tap_matches_the_reference(scenes, frac):
    r, ref = scenes
    scene = r.device_scene
    assert r.settings.combined_material and tex.atlas_is_packed_tri(
        scene.quad_img.reshape(-1, scene.quad_img.shape[-1]))
    n = 8192  # the compacted taps' cap is 2048 of them, past the stretched quarter
    tri_model = ref.tri_model.numpy()
    models = np.random.default_rng(1).integers(0, ref.n_models, n)
    first_tri = np.searchsorted(tri_model, models)
    assert (tri_model[first_tri] == models).all()
    rec = scene.tri_mrec[torch.from_numpy(first_tri)]
    rect0 = rec[:, M_RECT:M_RECT + 4]  # the combined chain's rect, slot 0
    assert torch.equal(rec[:, M_UVOS:M_UVOS + 4], torch.tensor([0.0, 0.0, 1.0, 1.0]).expand(n, 4))
    assert torch.equal(rec[:, M_UVROT:M_UVROT + 2], torch.tensor([1.0, 0.0]).expand(n, 2))
    mat = ref.model_material[torch.from_numpy(models)]
    size = ref_frame.material_size(ref, mat)
    assert torch.equal(rect0[:, 2].double(), size) and torch.equal(rect0[:, 3].double(), size)
    (uv, dx, dy), stretched = _footprints(n, 7, SCENE["tex_size"])
    settings = RenderSettings(**SMALL, **ANISO, aniso_compact_frac=frac)
    T = torch.from_numpy
    footprint = tex.footprint_lod_aniso(T(dx), T(dy), rect0[:, 2], rect0[:, 3], 4)
    valid = torch.ones(n, dtype=torch.bool)
    quad_flat = scene.quad_img.reshape(-1, scene.quad_img.shape[-1])
    got, overflow = common._sample_aniso(quad_flat, scene.quad_img.shape[1], rect0, T(uv),
                                         footprint, valid, settings)
    want = ref_frame.sample_materials_aniso(ref, mat, T(uv).double(), T(dx).double(),
                                            T(dy).double(), size[:, None], 4)
    assert int(overflow) == 0
    assert (footprint[2][T(stretched)] > 0).all()
    np.testing.assert_allclose(got[:, :8].double().numpy(), want.numpy(), rtol=0, atol=ATOL)
    # the taps tell the samplers apart where the footprints stretch
    tri = ref_frame.sample_materials(ref, mat, T(uv).double(),
                                     ref_frame.footprint_lod(T(dx).double(), T(dy).double(),
                                                             size[:, None]))
    assert (want - tri).abs().max() > 100 * ATOL


def test_renderer_frames_match_the_reference(tmp_path):
    """Three carried 96x64 frames of the orbit (set-up's two, then one)
    against the reference's at the configuration's sampler and limits."""
    kw = dict(n_objects=8, seed=2**31 + 24, sphere_res=(8, 6), n_materials=8, tex_size=32)
    settings = {**CONFIG["render_settings"], "width": 96, "height": 64, "shadow_map_size": 128}
    scene_json = scenegen.write_scene(tmp_path, **kw)
    prog = Renderer(scene_json, settings=RenderSettings(**settings), device="cpu")
    ref = ReferenceScene(scenegen.scene_content(**kw), settings, {}, "cpu")
    spec = {"mode": "present", "orbit": {"radius": 4.0, "height": 1.5, "step_rad": 0.05,
                                         "start_rad": [-0.6, -0.3]},
            "sun": None, "warmup_frames": 2,
            "check": {"start_frames": 2, "carry_within": 1, "samples": 1, "run_frames": 1}}
    traffic = Traffic(spec, scene_json, 7)
    state, pairs = ref.initial_state(), []
    for k in range(3):
        traffic.apply(prog, k)
        got = prog.render_to_u8()
        img, state = ref.frame(k, traffic.view(k), state, traffic.settings(k),
                               traffic.visible(k, ref.scene.n_models),
                               traffic.settings_changed(k))
        pairs.append((got, img))
    values = check.readings(pairs, ref.scene.n_models)
    assert all(values[k] <= lim for k, lim in CONFIG["check"].items() if k in values), values
    stats = prog.stats()
    assert stats["aniso_taps"] == 4 * stats["aniso_pixels"] > 0


@pytest.mark.parametrize("frac", [0.0, 0.25, 0.5], ids=["dense", "compacted", "half"])
def test_counters_are_a_plain_count_of_the_footprints(frac):
    (uv, dx, dy), _stretched = _footprints(6000, 3, 64)
    T = torch.from_numpy
    side = torch.full((6000,), 64.0)
    _lod, _dmaj, extent = tex.footprint_lod_aniso(T(dx), T(dy), side, side, 4)
    valid = T(np.random.default_rng(4).random(6000) < 0.7)
    settings = RenderSettings(**ANISO, aniso_compact_frac=frac)
    got = {k: int(v) for k, v in common.aniso_counters(extent, valid, settings).items()}
    e, v = extent.numpy(), valid.numpy()
    pixels, line = int(v.sum()), int(((e > 0) & v).sum())
    taps = 4 * pixels if frac == 0.0 else pixels + 4 * min(line, 1024 if frac == 0.25 else 3072)
    assert got == {"aniso_pixels": pixels, "aniso_line_pixels": line, "aniso_taps": taps}
    assert 0 < line < pixels and (frac != 0.25 or line > 1024)  # the cap binds at 0.25


def test_counters_stay_out_of_the_drop_counters(scenes):
    """An anisotropic frame carries its counts beside ``raster_stats``,
    never in them (a set drop counter fails the frame); ``stats()`` reads
    them, and ``passes.COUNTERS`` sums them over the frames rendered while
    a profiler records, and only then.  A trilinear frame has none."""
    r, _ref = scenes
    passes.COUNTERS.reset()
    try:
        out = r.render_frame()
        assert set(out["aniso_counts"]) == {"aniso_pixels", "aniso_line_pixels", "aniso_taps"}
        assert not set(out["aniso_counts"]) & set(out["raster_stats"])
        assert all(int(v) == 0 for v in out["raster_stats"].values())
        assert passes.COUNTERS.totals() == {}
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            outs = [r.render_frame() for _ in range(2)]
        want = {k: sum(int(o[key][k]) for o in outs) for key in ("aniso_counts", "tap_counts")
                for k in out[key]}
        assert passes.COUNTERS.totals() == want
        stats = r.stats()
        assert stats["aniso_pixels"] == int((outs[-1]["tri_id"] >= 0).sum()) > 0
        assert stats["aniso_taps"] == 4 * stats["aniso_pixels"]
        assert 0 <= stats["aniso_line_pixels"] <= stats["aniso_pixels"]
        tri = Renderer(r.scene_path, RenderSettings(**SMALL), device="cpu")
        assert "aniso_counts" not in tri.render_frame() and "aniso_pixels" not in tri.stats()
    finally:
        passes.COUNTERS.reset()


# (combined material, masked, filter, all four slots) -> the captured frame's
# spans; the generator's materials share one transform, so its scenes take
# the combined tap (one MaterialTap); per slot, the scene has no emissive map
SPANS = {
    (True, False, "trilinear", False): 14,
    (True, True, "trilinear", False): 15,
    (True, False, "anisotropic", False): 16,
    (True, True, "anisotropic", False): 17,
    (False, False, "trilinear", False): 16,
    (False, True, "trilinear", False): 17,
    (False, False, "anisotropic", False): 22,
    (False, True, "anisotropic", False): 23,
    (False, True, "anisotropic", True): 26,
}


@pytest.mark.parametrize("kind", list(SPANS), ids=lambda k: "-".join(map(str, k)))
def test_captured_frame_spans_by_kind(tmp_path, kind):
    combined, masked, filt, four = kind
    path = scenegen.write_scene(tmp_path, n_objects=8, seed=3, sphere_res=(8, 6), n_materials=4,
                                tex_size=32, masked=masked)
    r = Renderer(path, RenderSettings(**SMALL, texture_filter=filt,
                                      enable_combined_material=combined), device="cpu")
    settings = dataclasses.replace(r.settings, slot_enabled=(True,) * 4) if four else r.settings
    params = r.frame_params()
    shadow_map = r._shadow_map(params)
    spans = passes.DeviceSpans("FrameProgram", event=_Clock().Event)
    with spans.capturing():
        deferred_frame(r.device_scene, params, r.frame_state, settings, shadow_map)
    names = [m[0] for m in spans._marks]
    assert len(names) == SPANS[kind] and spans.events() == 2 * SPANS[kind] + 2
    assert spans.events() <= passes.MAX_EVENTS and all(m[2] is not None for m in spans._marks)
    taps = names.count("MaterialTap")
    assert taps == (1 if combined else 4 if four else 3)
    aniso = filt == "anisotropic"
    assert names.count("AnisoFootprint") == names.count("AnisoTaps") == taps * aniso
    assert ("MaskedRaster" in names) == masked
    if four:
        assert spans.events() == passes.MAX_EVENTS  # the most a frame opens
