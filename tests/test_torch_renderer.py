"""The port's Renderer (``device="cpu"``) against the reference's Renderer
on a scene written to files (``render/testing.py write_scene``: a textured
cube with an emissive map and a KHR texture transform, a sphere with an
alpha-checker MASK material, the two ground boxes, PNG maps, the RGBA16F
env cube and the RG16 BRDF LUT), both at 160x128 with a 128^2 shadow map;
the reference runs its Pallas path in interpret mode.

At the default ``RendererConfig`` (the stats overlay on) over 3 carried
frames: ``frame_params`` byte-equal (TAA jitter from the second frame);
depth, tri_id, object_id, model_visible, the culling counters, every
raster_stats counter, the carried HZB and the flags bit-equal; hdr, color
and the TAA history within 1e-4 and exposure within 1e-5 (the frame tests'
bars, ``tests/test_torch_frame.py``).  Then ``stats()``, ``pick``, the host
overlays, and the frame state saved by one Renderer and loaded by the other.

The reference's Renderer loses its GpuDebugPrint flag when it syncs the
scene's settings (``renderer.py:404`` and ``:497`` replace the local
``settings``, which predates ``_apply_config_side_effects``), so its frames
carry no stats block although its config asks for one; the port keeps the
flag.  The reference is compared with the flag restored, which is the frame
its config asks for."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from unclerenderer_tpu.render.params import RenderSettings as JSettings
from unclerenderer_tpu.render.renderer import Renderer as JRenderer
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.render.params import RenderSettings
from unclerenderer_tpu_torch.render.renderer import Renderer
from unclerenderer_tpu_torch.render.testing import write_scene
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

W, H, SHADOW = 160, 128, 128
EXACT = ("depth", "tri_id", "object_id", "model_visible", "frustum_culled", "hzb_occluded")
ATOL_IMAGE = 1e-4
ATOL_EV = 1e-5


def write_test_scene(root):
    return write_scene(root, 2, masked=True, emissive=True, texture_transform=True,
                       n_materials=2, tex_size=64)


def renderer_pair(scene, config=None, **settings):
    """(reference, port) Renderers of ``scene`` at the test size; the
    reference's GpuDebugPrint flag restored (module docstring)."""
    common = dict(width=W, height=H, shadow_map_size=SHADOW, **settings)
    j = JRenderer(scene, settings=JSettings(raster_backend="pallas", pallas_interpret=True,
                                            **common), config=config)
    t = Renderer(scene, settings=RenderSettings(**common), config=config, device="cpu")
    if j.debug_print_enabled and not j.settings.gpu_debug_print:
        j.settings = dataclasses.replace(j.settings, gpu_debug_print=True)
    return j, t


def assert_frames_match(j_out, t_out, label):
    got = interop.to_numpy(t_out)
    for k in EXACT:
        np.testing.assert_array_equal(got[k], np.asarray(j_out[k]), err_msg=f"{label} {k}")
    assert set(got["raster_stats"]) == set(j_out["raster_stats"]), label
    for k, v in j_out["raster_stats"].items():
        assert int(got["raster_stats"][k]) == int(v), f"{label} {k}"
    for k in ("hdr", "color"):
        np.testing.assert_allclose(got[k], np.asarray(j_out[k]), rtol=0, atol=ATOL_IMAGE,
                                   err_msg=f"{label} {k}")


def assert_states_match(j_state, t_state, label):
    got = interop.to_numpy(t_state)
    for f in dataclasses.fields(j_state):
        want = np.asarray(getattr(j_state, f.name))
        if f.name in ("taa_history", "exposure_ev"):
            tol = ATOL_IMAGE if f.name == "taa_history" else ATOL_EV
            np.testing.assert_allclose(got[f.name], want, rtol=0, atol=tol, err_msg=label)
        else:
            assert got[f.name].dtype == want.dtype, (label, f.name)
            np.testing.assert_array_equal(got[f.name], want, err_msg=f"{label} {f.name}")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both Renderers through 3 carried frames at the default config, with
    everything the tests below compare recorded along the way."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UNCLERENDERER_SCENE_CACHE", "")  # the reference writes no scene cache
    root = tmp_path_factory.mktemp("renderer")
    scene = write_test_scene(root)
    j, t = renderer_pair(scene)
    rec = {"j": j, "t": t, "frames": [], "params": [], "states": []}
    for _ in range(3):
        rec["params"].append((j.frame_params(), t.frame_params()))
        j_out, t_out = j.render_frame(), t.render_frame()
        rec["frames"].append((jax.device_get(j_out), t_out))
        rec["states"].append((j.frame_state, t.frame_state))
    rec["stats"] = (j.stats(), t.stats())
    color = np.asarray(rec["frames"][-1][0]["color"])
    ids = np.asarray(rec["frames"][-1][0]["object_id"])
    covered = np.argwhere(ids > 0)
    y, x = covered[len(covered) // 2]
    bg = np.argwhere(ids == 0)[0]
    rec["pick"] = [(j.pick(int(x), int(y)), t.pick(int(x), int(y))),
                   (j.pick(int(bg[1]), int(bg[0])), t.pick(int(bg[1]), int(bg[0])))]
    j.pick(int(x), int(y))
    t.pick(int(x), int(y))  # the selection the overlays draw
    rec["composite"] = (j.composite_overlays(color.copy()), t.composite_overlays(color.copy()))
    rec["overlay_u8"] = (j.render_overlay_u8(), t.render_overlay_u8(),
                         t._last_out["color"].numpy())
    # the reference's saved state loaded by a fresh port Renderer, and the
    # port's by the reference: the next frames equal
    j.save_state(root / "ref_state.npz")
    t2 = Renderer(scene, settings=t.settings, device="cpu")
    t2.load_state(root / "ref_state.npz")
    rec["after_ref_state"] = (j.render_frame(), t2.render_frame(), j.frame_state, t2.frame_state)
    t2.save_state(root / "port_state.npz")
    j.load_state(root / "port_state.npz")
    rec["after_port_state"] = (j.render_frame(), t2.render_frame(), j.frame_state,
                               t2.frame_state)
    yield rec
    mp.undo()


def test_renderer_settings_match_reference(run, tmp_path, monkeypatch):
    j, t = run["j"], run["t"]
    backend = {"raster_backend": "auto", "pallas_interpret": False}  # the reference's oracle
    assert dataclasses.asdict(t.settings) == {**dataclasses.asdict(j.settings), **backend}
    assert t.settings.gpu_debug_print and t.settings.has_masked_models
    assert t.settings.combined_material and t.settings.material_atlas_u8
    assert t.env_mip_count == j.env_mip_count == 6.0
    assert t.texture_substitutions == j.texture_substitutions == []
    assert (t.scene_cache_hit, j.scene_cache_hit) == (False, False)  # the cache is off here
    # with the scene cache on, a second port Renderer of the scene is a warm
    # hit: the same settings and the same device arrays
    monkeypatch.setenv("UNCLERENDERER_SCENE_CACHE", str(tmp_path / "scene_cache"))
    settings = RenderSettings(width=W, height=H, shadow_map_size=SHADOW)
    cold = Renderer(t.scene_path, settings=settings, device="cpu")
    warm = Renderer(t.scene_path, settings=settings, device="cpu")
    assert (cold.scene_cache_hit, warm.scene_cache_hit) == (False, True)
    assert warm.settings == cold.settings == t.settings
    for f in dataclasses.fields(warm.device_scene):
        a, b = getattr(t.device_scene, f.name), getattr(warm.device_scene, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name


def test_frame_params_match_reference(run):
    for i, (jp, tp) in enumerate(run["params"]):
        got = interop.to_numpy(tp)
        for f in dataclasses.fields(jp):
            want = np.asarray(getattr(jp, f.name))
            assert got[f.name].dtype == want.dtype, (i, f.name)
            np.testing.assert_array_equal(got[f.name], want, err_msg=f"frame {i} {f.name}")
    # TAA jitter from the second frame
    p0, p1 = run["params"][0][1], run["params"][1][1]
    assert bool((p0.proj == p0.proj_unjittered).all())
    assert not bool((p1.proj == p1.proj_unjittered).all())


@pytest.mark.parametrize("i", range(3))
def test_carried_frames_match_reference(run, i):
    j_out, t_out = run["frames"][i]
    assert_frames_match(j_out, t_out, f"frame {i}")
    assert_states_match(*run["states"][i], f"state after frame {i}")
    tri = np.asarray(j_out["tri_id"])
    alpha = np.asarray(run["j"].scene_data.alpha_mode)[np.asarray(run["j"].scene_data.tri_model)]
    assert (alpha[np.maximum(tri, 0)][tri >= 0] == 1).sum() > 100, "masked model in view"


def test_stats_match_reference(run):
    j_stats, t_stats = run["stats"]
    assert set(t_stats) == set(j_stats)
    for k, v in j_stats.items():
        if k == "exposure_ev":
            assert abs(t_stats[k] - v) <= ATOL_EV
        else:
            assert t_stats[k] == v, k
    assert t_stats["models_visible"] > 0
    assert run["t"].memory_stats() == {}


def test_pick_matches_reference(run):
    (j_hit, t_hit), (j_bg, t_bg) = run["pick"]
    assert t_hit == j_hit and t_hit[0] > 0 and t_hit[1]
    assert t_bg == j_bg == (0, "")
    sel = run["t"].selected_bounds()
    want = run["j"].selected_bounds()
    for g, w in zip(sel, want):
        np.testing.assert_array_equal(g, w)


def test_overlays_match_reference(run):
    j_img, t_img = run["composite"]
    np.testing.assert_array_equal(t_img, j_img)
    j_u8, t_u8, t_color = run["overlay_u8"]
    # the port's own frame through its host overlays, exactly; the
    # reference's frame within one u8 step (the colours agree to 1e-4)
    own = run["t"].composite_overlays(np.clip(t_color, 0, 1).copy())
    np.testing.assert_array_equal(t_u8, np.clip(np.rint(own * 255.0), 0, 255).astype(np.uint8))
    assert np.abs(t_u8.astype(int) - j_u8.astype(int)).max() <= 1


@pytest.mark.parametrize("which", ["after_ref_state", "after_port_state"])
def test_saved_state_loads_across(run, which):
    j_out, t_out, j_state, t_state = run[which]
    assert_frames_match(jax.device_get(j_out), t_out, which)
    assert_states_match(j_state, t_state, which)
