"""The port's Renderer against the reference's, around the frame: the
device-scene build from files (every host array byte-equal, bfloat16 bits
included, for each atlas layout and without the env cube and BRDF LUT),
carried frames with the config's GpuDebugPrint off, ``render_frames``,
``update_settings``, scene reloads, the fallback scene, the branches
that once raised (GpuTiming, GraphDump, the profilers: they run now), and
the forward renderer built from settings, from the config and by
``update_settings``.
Scene, sizes and tolerances as ``tests/test_torch_renderer.py``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from unclerenderer_tpu.core.config import RendererConfig as JConfig
from unclerenderer_tpu.render.params import RenderSettings as JSettings
from unclerenderer_tpu.render.renderer import Renderer as JRenderer
from unclerenderer_tpu.render.renderer import _build_device_scene as j_build
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.core.config import RendererConfig
from unclerenderer_tpu_torch.render.params import DeviceScene, RenderSettings
from unclerenderer_tpu_torch.render.renderer import Renderer
from unclerenderer_tpu_torch.render.renderer import _build_device_scene as t_build
from unclerenderer_tpu_torch.render.testing import synthetic_scene_data, write_scene
from unclerenderer_tpu_torch.scene.build import build_scene

from test_torch_renderer import (
    ATOL_IMAGE,
    SHADOW,
    H,
    W,
    assert_frames_match,
    assert_states_match,
    renderer_pair,
    write_test_scene,
)
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module



@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("UNCLERENDERER_SCENE_CACHE", "")  # the reference writes no scene cache
    yield write_test_scene(tmp_path_factory.mktemp("renderer_setup"))
    mp.undo()


def _host_bytes(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


BUILDS = {
    "u8_quad": dict(packed_trilinear="auto", atlas_u8=True),
    "u8_packed": dict(packed_trilinear=True, atlas_u8=True),
    "bf16_quad": dict(packed_trilinear=False, atlas_u8=False),
    "per_slot": dict(allow_combined=False, atlas_u8=True),
    "no_env_no_lut": dict(atlas_u8=True),
}


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_build_device_scene_host_arrays_match_reference(scene, tmp_path, case):
    """Every host array byte-equal (bf16 as its bits, cast by torch in the
    port and by ml_dtypes in the reference), the env mip count, the
    combined flag, the substitutions and the files read; the uploaded scene
    holds the same bytes."""
    kw = dict(BUILDS[case])
    assets = scene.parent.parent
    if case == "no_env_no_lut":
        assets = tmp_path  # no Textures/*.dds there
    data = build_scene(scene, scene.parent.parent)
    j_host, t_host, j_files, t_files, j_subs, t_subs = {}, {}, [], [], [], []
    allow = kw.pop("allow_combined", True)
    j_dev, j_mips, j_comb = j_build(data, assets, allow, host_out=j_host, files_out=j_files,
                                    substitutions_out=j_subs, **kw)
    t_dev, t_mips, t_comb = t_build(data, assets, allow, host_out=t_host, files_out=t_files,
                                    substitutions_out=t_subs, device="cpu", **kw)
    assert (t_mips, t_comb) == (j_mips, j_comb)
    assert (t_files, t_subs) == (j_files, j_subs)
    assert set(t_host) == set(j_host) == {f.name for f in dataclasses.fields(DeviceScene)}
    for k, v in j_host.items():
        want, got = _host_bytes(v), np.ascontiguousarray(t_host[k])
        assert got.dtype == want.dtype and got.shape == want.shape, (k, got.dtype, want.dtype)
        assert got.tobytes() == want.tobytes(), k
    on_dev = interop.to_numpy(t_dev)
    for f in dataclasses.fields(DeviceScene):
        want = _host_bytes(getattr(j_dev, f.name))
        got = on_dev[f.name]
        got = got.view(np.uint16) if got.dtype.name == "bfloat16" else got
        assert got.tobytes() == want.tobytes(), f.name
    if case == "u8_quad":
        assert t_dev.quad_img.dtype == torch.uint8 and t_dev.quad_img.shape[-1] == 64
    if case in ("bf16_quad", "per_slot"):
        assert t_dev.quad_img.dtype == torch.bfloat16
    assert t_dev.env_quad.dtype == torch.bfloat16


def test_frames_with_gpu_debug_print_off_match_reference(scene):
    """3 carried frames with the config's GpuDebugPrint off: no stats block
    in either."""
    cfg_kw = dict(enable_gpu_debug_print=False)
    j, t = renderer_pair(scene, JConfig(**cfg_kw))
    t_on = Renderer(scene, settings=t.settings, device="cpu")
    t_on.update_settings(gpu_debug_print=True)
    assert not j.settings.gpu_debug_print and not t.settings.gpu_debug_print
    for i in range(3):
        j_out, t_out = jax.device_get(j.render_frame()), t.render_frame()
        assert_frames_match(j_out, t_out, f"frame {i}")
        assert_states_match(j.frame_state, t.frame_state, f"state {i}")
        on = t_on.render_frame()
        differ = (on["color"] != t_out["color"]).any(-1)
        assert int(differ[8:80].sum()) > 100 and not bool(differ[80:].any())


def test_render_frames_match_reference(scene):
    """``render_frames(3)`` on an orbit: the stacked colours within the
    frame tolerance, the carried state, and the worst frame's counters,
    which ``stats()`` reports."""
    j, t = renderer_pair(scene)
    center = np.asarray(j.scene_data.scene_center)

    def orbit(r, i):
        a = 0.2 * r._frame_counter
        r.camera.position = (center[0] + 4 * np.sin(a), center[1] + 1.5, center[2] - 4 * np.cos(a))
        r.camera.set_look_at(center)

    j_colors = np.asarray(j.render_frames(3, mutate=orbit))
    t_colors = t.render_frames(3, mutate=orbit)
    assert t_colors.shape == (3, H, W, 3)
    np.testing.assert_allclose(t_colors.numpy(), j_colors, rtol=0, atol=ATOL_IMAGE)
    assert_states_match(j.frame_state, t.frame_state, "after render_frames")
    assert {k: int(v) for k, v in t._chain_drop_counters.items()} == \
        {k: int(v) for k, v in j._chain_drop_counters.items()}
    assert all(v.device.type == "cpu" for v in t._chain_drop_counters.values())
    assert t._frame_counter == j._frame_counter == 3 and t._last_out is None
    j_stats, t_stats = j.stats(), t.stats()  # re-renders the current view
    assert {k: v for k, v in t_stats.items() if k != "exposure_ev"} == \
        {k: v for k, v in j_stats.items() if k != "exposure_ev"}


def test_update_settings_matches_reference(scene):
    """A resolution change resets the frame state; an atlas change rebuilds
    the device scene (byte-equal to the reference's) and resyncs the atlas
    flags; an unchanged value does nothing."""
    j = JRenderer(scene, settings=JSettings(width=W, height=H, shadow_map_size=SHADOW))
    t = Renderer(scene, settings=RenderSettings(width=W, height=H, shadow_map_size=SHADOW),
                 device="cpu")
    t.render_frame()
    state = t.frame_state
    t.update_settings(width=W)
    assert t.frame_state is state
    for changes in ({"width": 96, "height": 64}, {"material_packed_trilinear": True},
                    {"enable_combined_material": False}, {"enable_cas": False}):
        j.update_settings(**changes)
        t.update_settings(**changes)
        jd, td = dataclasses.asdict(j.settings), dataclasses.asdict(t.settings)
        jd["gpu_debug_print"] = td["gpu_debug_print"]  # the reference's lost flag
        assert td == jd, changes
        assert (t._shadow_cache, t._last_out, t._taa_history_ready) == (None, None, False)
        assert not bool(t.frame_state.taa_valid)
        assert tuple(t.frame_state.taa_history.shape) == (t.settings.height, t.settings.width, 3)
        got = interop.to_numpy(t.device_scene)
        for f in ("quad_img", "tri_mrec"):
            want = _host_bytes(getattr(j.device_scene, f))
            g = got[f].view(np.uint16) if got[f].dtype.name == "bfloat16" else got[f]
            assert g.tobytes() == want.tobytes(), (changes, f)
    out = t.render_frame()
    assert tuple(out["color"].shape) == (64, 96, 3)


def test_reload_scene_in_place_and_in_the_background(scene):
    """A reload builds the other scene's device arrays and settings as a
    fresh Renderer of it does (the atlas settings kept, the masked and slot
    settings synced); in the background it is swapped in by
    ``poll_reload``."""
    # beside the first scene: a reload resolves assets against the
    # Renderer's assets root, as the reference's does
    other = write_scene(scene.parent.parent, 3, n_materials=1, tex_size=32, name="other")
    settings = RenderSettings(width=W, height=H, shadow_map_size=SHADOW)
    t = Renderer(scene, settings=settings, device="cpu")
    t.render_frame()
    fresh = Renderer(other, settings=settings, device="cpu")

    def assert_like_fresh(r):
        assert dataclasses.asdict(r.settings) == dataclasses.asdict(fresh.settings)
        got, want = interop.to_numpy(r.device_scene), interop.to_numpy(fresh.device_scene)
        for f in dataclasses.fields(DeviceScene):
            assert got[f.name].tobytes() == want[f.name].tobytes(), f.name
        assert r.scene_data.num_triangles == fresh.scene_data.num_triangles
        np.testing.assert_array_equal(r.camera.position, fresh.camera.position)
        out = r.render_frame()
        ref = fresh.render_frame()
        for k in ("depth", "tri_id", "object_id"):
            assert torch.equal(out[k], ref[k]), k

    assert t.reload_scene(other, background=False) is None
    assert not t.settings.has_masked_models and t.settings.masked_tri_cap == 0
    assert_like_fresh(t)

    t2 = Renderer(scene, settings=settings, device="cpu")
    fresh = Renderer(other, settings=settings, device="cpu")
    future = t2.reload_scene(other)
    future.result(timeout=120)
    assert t2.scene_data.num_models == 4  # not swapped before the poll
    assert t2.poll_reload() and not t2.poll_reload()
    assert_like_fresh(t2)

    t3 = Renderer(scene, settings=settings, device="cpu")
    t3.reload_scene(scene.parent / "missing.json")
    assert isinstance(t3._pending_reload.exception(timeout=120), ValueError)
    with pytest.raises(ValueError, match="failed to load scene"):
        t3.poll_reload()


def test_missing_scene_falls_back_to_the_procedural_scene(tmp_path):
    """A scene that does not load falls back to ``synthetic_scene_data(4)``
    (the reference's ladder), built and rendered as the reference builds it."""
    missing = tmp_path / "Scenes" / "missing.json"
    j = JRenderer(missing, settings=JSettings(width=W, height=H, shadow_map_size=SHADOW))
    t = Renderer(missing, settings=RenderSettings(width=W, height=H, shadow_map_size=SHADOW),
                 device="cpu")
    src = synthetic_scene_data(4)
    assert t.scene_data.num_triangles == src.num_triangles == j.scene_data.num_triangles
    np.testing.assert_array_equal(t.scene_data.position, j.scene_data.position)
    got = interop.to_numpy(t.device_scene)
    for f in dataclasses.fields(DeviceScene):
        want = _host_bytes(getattr(j.device_scene, f.name))
        g = got[f.name].view(np.uint16) if got[f.name].dtype.name == "bfloat16" else got[f.name]
        assert g.tobytes() == want.tobytes(), f.name
    td, jd = dataclasses.asdict(t.settings), dataclasses.asdict(j.settings)
    jd["gpu_debug_print"] = td["gpu_debug_print"]  # the reference's lost flag
    assert td == jd
    out = t.render_frame()
    assert int((out["tri_id"] >= 0).sum()) > 0 and bool(torch.isfinite(out["color"]).all())


def _renders_forward(r):
    """A forward Renderer renders: a forward frame (no hdr, no frame state
    carried), finite colour in [0, 1], pixels covered."""
    assert r.settings.renderer_type == "forward"
    state = r.frame_state
    out = r.render_frame()
    assert "hdr" not in out and r.frame_state is state
    assert tuple(out["color"].shape) == (r.settings.height, r.settings.width, 3)
    assert bool(torch.isfinite(out["color"]).all())
    assert 0.0 <= float(out["color"].min()) and float(out["color"].max()) <= 1.0
    assert int((out["tri_id"] >= 0).sum()) > 100


@pytest.mark.parametrize("case", ["settings_forward", "config_forward", "gpu_timing",
                                  "graph_dump", "update_forward", "profile_passes",
                                  "profile_trace", "profile_trace_passes"])
def test_unported_renderer_branches_raise(scene, case, tmp_path, monkeypatch):
    """Every branch that once raised runs: the forward renderer from
    settings, from the config and after ``update_settings``; GpuTiming (a
    "Frame" sample per frame in ``stats()["frame_timing"]``); GraphDump
    (``render_graph_dump.txt``, written once, naming the kernels' plain
    versions on the CPU); ``profile_passes`` (the ten deferred stages);
    ``profile_trace`` (a Chrome trace) and ``profile_trace_passes`` (empty
    on the CPU: no device rows, as the reference's CPU backend)."""
    small = dict(width=W, height=H, shadow_map_size=SHADOW)
    if case == "settings_forward":
        _renders_forward(Renderer(scene, RenderSettings(renderer_type="forward", **small),
                                  device="cpu"))
        return
    if case == "config_forward":
        r = Renderer(scene, config=RendererConfig(renderer_type="forward", window_width=W,
                                                  window_height=H), device="cpu")
        assert not r.settings.gpu_debug_print  # the stats block is the deferred frame's
        r.update_settings(shadow_map_size=SHADOW)
        _renders_forward(r)
        return
    if case in ("gpu_timing", "graph_dump"):
        monkeypatch.chdir(tmp_path)
        cfg = RendererConfig(window_width=W, window_height=H,
                             **{f"enable_{case}": True})
        r = Renderer(scene, config=cfg, device="cpu")
        r.update_settings(shadow_map_size=SHADOW)
        for _ in range(2 if case == "gpu_timing" else 1):
            r.render_frame()
        timing = r.stats().get("frame_timing")
        dump = tmp_path / "render_graph_dump.txt"
        if case == "gpu_timing":
            # the window is 1 s: a slow frame may have aged out
            assert [row["name"] for row in timing] == ["Frame"] and timing[0]["samples"] >= 1
            assert not dump.exists()
            return
        assert timing is None
        text = dump.read_text()
        assert len(text) > 1000 and "\tplain version binned_raster" in text
        assert "VisibilityRaster" in text and "op aten." in text
        dump.unlink()
        r.render_frame()
        assert not dump.exists()  # once
        return
    r = Renderer(scene, RenderSettings(**small), device="cpu")
    if case == "update_forward":
        r.render_frame()
        r.update_settings(renderer_type="forward")
        _renders_forward(r)
        return
    if case == "profile_passes":
        rows = r.profile_passes(iterations=1).stats()
        assert {row["name"] for row in rows} == {
            "GPU Culling", "ShadowMap", "VertexStage", "GBuffer(Visibility)", "Build HZB",
            "MaterialResolve", "Lighting", "TemporalAA", "Tonemap", "CAS"}
        assert all(row["samples"] == 1 and row["avg_ms"] > 0 for row in rows)
    elif case == "profile_trace":
        assert r.profile_trace(tmp_path / "x", frames=1) == str(tmp_path / "x")
        assert len(list((tmp_path / "x").glob("*.pt.trace.json"))) == 1
    else:
        assert r.profile_trace_passes(frames=1, trace_dir=tmp_path / "y").stats() == []


def test_renderer_runs_on_the_card_by_default(scene):
    """``device`` defaults to the card; with no CUDA device the constructor
    fails instead of rendering on the CPU."""
    import inspect

    assert inspect.signature(Renderer).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        Renderer(scene, RenderSettings(width=W, height=H, shadow_map_size=SHADOW))
