"""The forward renderer (``unclerenderer_tpu_torch/render/forward.py``)
against the reference's (``unclerenderer_tpu/render/forward.py``, Pallas in
interpret mode) on the CPU:

* the forward PCF blend (``_pcf_blend(pcf="forward")``, the 2x2 corners)
  on random pass planes, and ``shadow_factor_blocks`` with either blend on
  a u16 superblock table: bit-equal;
* ``forward_frame`` at 128x128 on the masked scene with the settings of the
  reference's ``test_full_pallas_forward_matches_xla`` (IBL and sky off,
  64^2 shadow map, tile 16x64, chunk 32), fused resolve off and on, and
  with IBL, sky and the K7/K8 flags on the packed atlas: depth, tri_id,
  object_id (uint32) and every counter bit-equal, colour within 1e-4 (the
  frame tests' bar, ``tests/test_torch_frame.py``);
* the Renderer at ``renderer_type="forward"`` against the reference's
  Renderer on a scene written to files (2 frames, no TAA jitter), its
  ``render_frames`` chain (colours only, the frame state untouched, no
  drop counters, as the reference's), ``stats``, ``pick`` and the host
  overlays;
* ``python -m unclerenderer_tpu_torch --renderer forward`` writes exactly
  the forward Renderer's ``render_to_u8``."""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from unclerenderer_tpu.ops import shadow as jshadow
from unclerenderer_tpu.render.forward import forward_frame as j_forward
from unclerenderer_tpu.render.params import RenderSettings as JSettings
from unclerenderer_tpu.render.renderer import Renderer as JRenderer
from unclerenderer_tpu.render.testing import synthetic_device_scene as j_scene
from unclerenderer_tpu.render.testing import synthetic_frame_params as j_frame_params
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.ops import shadow as tshadow
from unclerenderer_tpu_torch.render.forward import forward_frame
from unclerenderer_tpu_torch.render.params import DeviceScene, FrameParams, RenderSettings
from unclerenderer_tpu_torch.render.renderer import Renderer
from unclerenderer_tpu_torch.render.testing import write_scene
from unclerenderer_tpu_torch.textures.png import load_png
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

ROOT = Path(__file__).resolve().parents[1]
SIZE = 128
EXACT = ("depth", "tri_id", "object_id")
ATOL_IMAGE = 1e-4
# tests/test_pallas_kernels.py test_full_pallas_forward_matches_xla
BASE = dict(renderer_type="forward", enable_ibl=False, enable_sky=False, has_masked_models=True,
            width=SIZE, height=SIZE, shadow_map_size=64, tile_h=16, tile_w=64, chunk=32,
            shadow_chunk=32, enable_taa=False, enable_cas=False, enable_auto_exposure=False)


LVP = np.array([[0.15, 0.0, 0.0, 0.0],
                [0.0, -0.15, 0.02, 0.0],
                [0.01, 0.02, 0.08, 0.0],
                [0.0, 0.0, 0.55, 1.0]], np.float32)


def test_pcf_blend_forward_matches_reference():
    """The forward blend alone: the 2x2 corners' average, lerp(1, s,
    strength), 1 outside the map or at strength 0."""
    rng = np.random.default_rng(3)
    n = 4096
    passed = [(rng.random(n) < 0.6).astype(np.float32) for _ in range(9)]
    fx, fy = rng.random(n).astype(np.float32), rng.random(n).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (n, 2)).astype(np.float32)
    t_args = [torch.from_numpy(p) for p in passed], *map(torch.from_numpy, (fx, fy, uv))
    for strength in (np.float32(0.7), np.float32(0.0)):
        want = jax.jit(lambda p, a, b, u, s: jshadow._pcf_blend(p, a, b, u, s, "forward"))(
            passed, fx, fy, uv, strength)
        got = tshadow._pcf_blend(*t_args, torch.tensor(strength), "forward")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="pcf"):
        tshadow._pcf_blend(*t_args, torch.tensor(1.0), "x")


@pytest.mark.parametrize("pcf", ["forward", "deferred"])
def test_shadow_factor_blocks_pcf_matches_reference(pcf):
    """The whole receiver with either blend, on the u16 superblock table,
    receivers over and beyond the map (as tests/test_torch_shadow.py)."""
    rng = np.random.default_rng(4)
    size = 256
    sm = rng.uniform(0.3, 1.0, (size, size)).astype(np.float32)
    world = rng.uniform(-8.0, 8.0, (64, 96, 3)).astype(np.float32)
    table = jax.jit(jshadow.pack_shadow_blocks_u16)(sm)
    want = np.asarray(jax.jit(lambda t, w, l: jshadow.shadow_factor_blocks(
        t, size, w, l, np.float32(0.9), np.float32(2e-3), pcf=pcf, interpret=True))(
            table, world, LVP))
    got = tshadow.shadow_factor_blocks(
        torch.from_numpy(np.asarray(table).view(np.int16).copy()), size, torch.from_numpy(world),
        torch.from_numpy(LVP), torch.tensor(0.9), torch.tensor(2e-3), pcf=pcf)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.0 < float(got.mean()) < 1.0


@pytest.fixture(scope="module")
def masked():
    scene, data = j_scene(6, with_masked=True)
    return scene, data, interop.to_port(scene, DeviceScene, "cpu")


def _assert_frame(j_out, t_out, label):
    assert t_out["object_id"].dtype == torch.uint32
    got = interop.to_numpy(t_out)
    # the port's one output of its own: the material tap's counters
    assert set(got) == set(j_out) | {"tap_counts"}, label
    for k in EXACT:
        np.testing.assert_array_equal(got[k], np.asarray(j_out[k]), err_msg=f"{label} {k}")
    assert set(got["raster_stats"]) == set(j_out["raster_stats"]), label
    for k, v in j_out["raster_stats"].items():
        assert int(got["raster_stats"][k]) == int(v), f"{label} {k}"
    np.testing.assert_allclose(got["color"], np.asarray(j_out["color"]), rtol=0, atol=ATOL_IMAGE,
                               err_msg=f"{label} color")
    assert (got["tri_id"] >= 0).sum() > 300, label


FRAME_CASES = {
    "unfused": dict(),
    "fused": dict(fused_resolve="on"),
    # IBL (K7 on the packed env rows), sky and K8 on the packed atlas
    "packed_ibl_sky": dict(enable_ibl=True, enable_sky=True, env_select_kernel=True,
                           mat_select_kernel=True, has_masked_models=False,
                           combined_material=True, fused_resolve="on"),
}


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_forward_frame_matches_reference(case, masked):
    common = {**BASE, **FRAME_CASES[case]}
    if case == "packed_ibl_sky":
        scene, data = j_scene(6, rich_materials=True, atlas_u8=True, packed_trilinear=True)
        t_scene = interop.to_port(scene, DeviceScene, "cpu")
    else:
        scene, data, t_scene = masked
    params = j_frame_params(data, SIZE, SIZE)
    j_settings = JSettings(raster_backend="pallas", pallas_interpret=True, **common)
    want = jax.jit(functools.partial(j_forward, settings=j_settings))(scene, params)
    got = forward_frame(t_scene, interop.to_port(params, FrameParams, "cpu"),
                        RenderSettings(**common))
    _assert_frame(want, got, case)
    if case != "packed_ibl_sky":  # masked models win pixels
        am = t_scene.alpha_mode[t_scene.tri_model.long()]
        tri = got["tri_id"]
        assert int(((tri >= 0) & (am[tri.clamp(min=0).long()] == 1)).sum()) > 50


# -- the Renderer, render_frames and the CLI on a scene written to files --

W, H, SHADOW = 160, 128, 128


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("UNCLERENDERER_SCENE_CACHE", "")  # the reference writes no scene cache
    scene = write_scene(tmp_path_factory.mktemp("forward"), 2, masked=True, emissive=True,
                        texture_transform=True, n_materials=2, tex_size=64)
    yield scene
    mp.undo()


@pytest.fixture(scope="module")
def renderers(scene_files):
    common = dict(width=W, height=H, shadow_map_size=SHADOW, renderer_type="forward")
    j = JRenderer(scene_files, settings=JSettings(raster_backend="pallas", pallas_interpret=True,
                                                  **common))
    t = Renderer(scene_files, settings=RenderSettings(**common), device="cpu")
    return j, t


def test_forward_renderer_matches_reference(renderers):
    j, t = renderers
    assert t.settings.renderer_type == "forward" and t.settings.has_masked_models
    for i in range(2):
        jp, tp = j.frame_params(), t.frame_params()
        np.testing.assert_array_equal(tp.proj.numpy(), np.asarray(jp.proj))  # no jitter
        j_out, t_out = j.render_frame(), t.render_frame()
        _assert_frame(jax.device_get(j_out), t_out, f"frame {i}")
    assert not t._taa_history_ready and int(t.frame_state.frame_index) == 0
    stats = t.stats()
    assert stats["models_visible"] == stats["models_total"] == j.stats()["models_visible"]
    assert stats["frustum_culled"] == stats["hzb_occluded"] == 0
    ids = t._last_out["object_id"].view(torch.int32).numpy()
    y, x = np.argwhere(ids > 0)[0]
    assert t.pick(int(x), int(y)) == j.pick(int(x), int(y)) and t.selected_object_id > 0
    img = t.render_overlay_u8()
    assert img.shape == (H, W, 3) and img.dtype == np.uint8


def test_forward_render_frames(renderers):
    """The forward chain: each colour the frame ``render_frame`` gives on the
    same camera (held to the reference's Renderer above), the frame state
    untouched and no chain drop counters (the reference's forward chain
    keeps none either: ``renderer.py:741-757`` returns ``{}``)."""
    _, t = renderers
    state = dataclasses.replace(t.frame_state)
    start = t._frame_counter
    colors = t.render_frames(2)
    assert tuple(colors.shape) == (2, H, W, 3)
    assert t._chain_drop_counters == {} and t._frame_counter == start + 2
    for f in dataclasses.fields(state):
        assert getattr(t.frame_state, f.name) is getattr(state, f.name)
    np.testing.assert_array_equal(colors[1].numpy(), t.render_frame()["color"].numpy())


def test_cli_forward_png_equals_render_to_u8(scene_files, tmp_path):
    out = tmp_path / "forward.png"
    res = subprocess.run([sys.executable, "-m", "unclerenderer_tpu_torch", "--scene",
                          str(scene_files), "--renderer", "forward", "--width", "64", "--height",
                          "64", "--shadow-size", "64", "--device", "cpu", "--output", str(out)],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    r = Renderer(scene_files, settings=RenderSettings(width=64, height=64, shadow_map_size=64,
                                                      renderer_type="forward"), device="cpu")
    want = r.render_to_u8()
    got = load_png(out)
    np.testing.assert_array_equal(got[..., :3], want)
    assert len(np.unique(want.reshape(-1, 3), axis=0)) > 10
