"""The port's ``raster_backend="xla"`` path against the JAX package's XLA
path (``unclerenderer_tpu/render/common.py _use_pallas`` false), on the CPU:

* the per-texel f16 PCF table ``pack_shadow9`` bit-equal; its receiver
  ``shadow_factor_packed`` and the unpacked ``shadow_factor`` (comparison
  samplers on the map) bit-equal for both PCF patterns, receivers in and
  beyond the map, at a power-of-two and an odd map size;
* the quad-atlas env samplers ``sample_cube_pyramid`` and
  ``sample_cube_pyramid_level`` bit-equal (the fixtures of
  ``tests/test_texture_sampling.py``), and the shelf atlas ``build_atlas``
  byte-equal (``tests/test_textures.py``'s chains);
* the exhaustive raster's wrapper (X1's plain version on the CPU) equal to
  the reference's ``rasterize`` at y_offset 0 and 48, both depth modes;
* deferred frames (2 carried) and a forward frame at 128^2 with shadows,
  IBL and masked models on, and a deferred frame with camera compaction
  (compact ids): ids, depth,
  object ids, compact ids and every counter bit-equal, hdr/colour within
  1e-4 (the bar of ``tests/test_torch_frame.py``); the frames dispatch to
  no plain version of K1-K9, only to X1's; the kernel path's frame differs
  from the reference's XLA frame (its PCF table), so the comparison sees the
  backend;
* a 2-rank gloo sharded frame at ``tests/test_render.py``'s multi-device
  settings (64 x 32, ``tile_h=8``, 2 frames) equal to the port's
  single-device ``"xla"`` frame: ids bit-equal, colour within 1e-5;
* the JAX ``Renderer`` at ``"auto"`` on the CPU (its XLA branch) against
  the port's ``Renderer`` at ``"xla"`` on a ``write_scene`` scene at 64^2:
  ``render_to_u8`` within 1 level;
* ``check_supported`` refusing an unknown backend."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_kernels import _setup as _random_setup  # the reference tests' random triangles

from unclerenderer_tpu.ops import raster as jr
from unclerenderer_tpu.ops import shadow as js
from unclerenderer_tpu.ops import texture as jt
from unclerenderer_tpu.render import common as jcommon
from unclerenderer_tpu.render.deferred import deferred_frame as j_deferred
from unclerenderer_tpu.render.forward import forward_frame as j_forward
from unclerenderer_tpu.render.params import FrameState as JState
from unclerenderer_tpu.render.params import RenderSettings as JSettings
from unclerenderer_tpu.render.renderer import Renderer as JRenderer
from unclerenderer_tpu.render.testing import synthetic_device_scene as j_scene
from unclerenderer_tpu.render.testing import synthetic_frame_params as j_frame_params
from unclerenderer_tpu.textures.atlas import build_atlas as j_build_atlas
from unclerenderer_tpu.textures.atlas import build_pyramid_quad_atlas
from unclerenderer_tpu.textures.image import generate_mips
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.ops import _cuda
from unclerenderer_tpu_torch.ops import raster as tr
from unclerenderer_tpu_torch.ops import raster_kernels as rk
from unclerenderer_tpu_torch.ops import shadow as ts
from unclerenderer_tpu_torch.ops import texture as tt
from unclerenderer_tpu_torch.parallel.multichip import run_ranks
from unclerenderer_tpu_torch.render import common as tcommon
from unclerenderer_tpu_torch.render.deferred import deferred_frame
from unclerenderer_tpu_torch.render.forward import forward_frame
from unclerenderer_tpu_torch.render.params import (
    DeviceScene,
    FrameParams,
    FrameState,
    RenderSettings,
    check_supported,
)
from unclerenderer_tpu_torch.render.renderer import Renderer
from unclerenderer_tpu_torch.render.testing import (
    sharded_frames,
    synthetic_device_scene,
    synthetic_frame_params,
    write_scene,
)
from unclerenderer_tpu_torch.textures.atlas import build_atlas

LVP = np.array([[0.15, 0.0, 0.0, 0.0],
                [0.0, -0.15, 0.02, 0.0],
                [0.01, 0.02, 0.08, 0.0],
                [0.0, 0.0, 0.55, 1.0]], np.float32)
SIZE = 128
EXACT = ("depth", "tri_id", "object_id")
ATOL_IMAGE = 1e-4


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops: the suite runs several
    workers on one host, and the frames' many small ops slow down several
    times over when each worker's thread pool spans every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _map(size, seed):
    return np.random.default_rng(seed).uniform(0.3, 1.0, (size, size)).astype(np.float32)


# ---------------------------------------------------------------- PCF


@pytest.mark.parametrize("size", [64, 100, 256])
def test_pack_shadow9_bit_equal(size):
    sm = _map(size, size)
    sm[::7, ::5] = 1.0  # the far plane: lifted past 1
    want = np.asarray(jax.jit(js.pack_shadow9)(sm))
    got = ts.pack_shadow9(T(sm))
    assert got.dtype == torch.float16 and tuple(got.shape) == want.shape == (size, size, 12)
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want.view(np.uint16))


@pytest.mark.parametrize("size", [64, 100])
@pytest.mark.parametrize("pcf", ["deferred", "forward"])
def test_shadow_receivers_bit_equal(size, pcf):
    """Both receivers of the XLA path over receivers inside the map and
    beyond its edges; strength and bias traced, as the frame passes them."""
    rng = np.random.default_rng(size)
    sm = _map(size, 3)
    wp = rng.uniform(-9.0, 9.0, (48, 64, 3)).astype(np.float32)
    table = np.asarray(js.pack_shadow9(sm)).reshape(-1, 12)

    def jfn(fn, x, w, st, bi):  # every input traced: no constant folding
        return fn(x, w, jnp.asarray(LVP), st, bi, pcf=pcf)

    for strength, bias in ((0.8, 0.002), (1.0, -0.01), (0.0, 0.002)):
        st, bi = jnp.float32(strength), jnp.float32(bias)
        want = np.asarray(jax.jit(functools.partial(jfn, js.shadow_factor))(sm, wp, st, bi))
        packed = functools.partial(jfn, lambda t, *a, pcf: js.shadow_factor_packed(
            t, size, *a, pcf=pcf))
        want_p = np.asarray(jax.jit(packed)(table, wp, st, bi))
        got = ts.shadow_factor(T(sm), T(wp), T(LVP), T(np.float32(strength)),
                               T(np.float32(bias)), pcf=pcf)
        got_p = ts.shadow_factor_packed(T(table), size, T(wp), T(LVP), T(np.float32(strength)),
                                        T(np.float32(bias)), pcf=pcf)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"shadow_factor {strength}")
        np.testing.assert_array_equal(got_p.numpy(), want_p,
                                      err_msg=f"shadow_factor_packed {strength}")
        if strength > 0:
            partial = (want > 0) & (want < 1)
            assert partial.sum() > 100 and (want == 1.0).sum() > 100  # edges; lit and outside
    uv = ts._shadow_project(T(wp), T(LVP), size, 0.0)[0].numpy()
    outside = (uv < 0.0) | (uv > 1.0)
    assert outside.any(-1).sum() > 100 and (~outside.any(-1)).sum() > 100


# ---------------------------------------------------------------- samplers and atlas


def test_sample_cube_pyramid_bit_equal():
    """The fixtures of tests/test_texture_sampling.py: six flat faces at lod
    0, then random 16^2 faces at random lods (below 0 and past the chain)."""
    chains = [generate_mips(np.full((4, 4, 4), (f + 1) / 6.0, np.float32)) for f in range(6)]
    data, rect0 = build_pyramid_quad_atlas(chains, wrap=False)
    dirs = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                    np.float32)
    cases = [(data, rect0, dirs, np.zeros(6, np.float32))]
    rng = np.random.default_rng(11)
    chains = [generate_mips(rng.random((16, 16, 4), np.float32)) for _ in range(6)]
    data, rect0 = build_pyramid_quad_atlas(chains, wrap=False)
    lods = np.concatenate([rng.uniform(-1.0, 6.0, 248), [0, 1, 2, 3, 4, 3.5, 7, -1]])
    cases.append((data, rect0, rng.normal(size=(256, 3)).astype(np.float32),
                  lods.astype(np.float32)))
    for data, rect0, d, lod in cases:
        flat = data.reshape(-1, 16)
        args = (flat, data.shape[1], rect0.astype(np.float32), d, lod)
        want = np.asarray(jax.jit(jt.sample_cube_pyramid, static_argnums=1)(*args))
        got = tt.sample_cube_pyramid(T(flat), data.shape[1], *map(T, args[2:]))
        np.testing.assert_array_equal(got.numpy(), want)


def test_sample_cube_pyramid_level_bit_equal():
    """tests/test_texture_sampling.py's tail fixture (level 0), and every
    level of random 16^2 faces, clamped past the chain."""
    rng = np.random.default_rng(11)
    tail = rng.random((6, 4, 4, 4), np.float32)
    cases = [([[tail[f]] for f in range(6)], np.zeros(128, np.int32))]
    chains = [generate_mips(rng.random((16, 16, 4), np.float32)) for _ in range(6)]
    cases.append((chains, rng.integers(-1, 7, 128).astype(np.int32)))
    for chains, level in cases:
        data, rect0 = build_pyramid_quad_atlas(chains, wrap=False)
        flat = data.reshape(-1, 16)
        d = rng.normal(size=(128, 3)).astype(np.float32)
        args = (flat, data.shape[1], rect0.astype(np.float32), d, level)
        want = np.asarray(jax.jit(jt.sample_cube_pyramid_level, static_argnums=1)(*args))
        got = tt.sample_cube_pyramid_level(T(flat), data.shape[1], *map(T, args[2:]))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pad", [0, 1])
def test_build_atlas_byte_equal(pad):
    rng = np.random.default_rng(0)
    chains = [generate_mips(rng.random((64, 64, 4), np.float32)),
              generate_mips(rng.random((32, 16, 4), np.float32)),
              generate_mips(np.full((4, 4, 4), 0.25, np.float32))]
    for c in (chains, []):
        want, got = j_build_atlas(c, pad=pad), build_atlas(c, pad=pad)
        assert got.num_textures == want.num_textures
        for f in dataclasses.fields(want):
            a, b = getattr(want, f.name), getattr(got, f.name)
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), f.name


# ---------------------------------------------------------------- exhaustive raster


@pytest.mark.parametrize("y_offset", [0, 48])
@pytest.mark.parametrize("depth_mode", [jr.DEPTH_MAX, jr.DEPTH_MIN])
def test_rasterize_exhaustive_matches_reference(y_offset, depth_mode):
    """X1's wrapper on CPU tensors (its plain version) against the
    reference's XLA raster; without ids the depth is the same, and on an
    ortho-normalized setup ``ortho`` (no divide) changes nothing."""
    s = _random_setup(120, seed=4, size=0.1)
    port = tr.RasterSetup(coef=T(s.coef), valid=T(s.valid), bbox=T(s.bbox))
    jd, ji = jr.rasterize(s, 192, 96, tile_h=16, tile_w=64, chunk=32, depth_mode=depth_mode,
                          y_offset=y_offset)
    td, ti = rk.rasterize_exhaustive(port, 192, 96, tile_h=16, tile_w=64, chunk=32,
                                     depth_mode=depth_mode, y_offset=y_offset)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti.numpy() >= 0).sum() > 2000
    d_only, none = rk.rasterize_exhaustive(port, 192, 96, tile_h=16, tile_w=64, chunk=64,
                                           depth_mode=depth_mode, y_offset=y_offset,
                                           want_ids=False)
    assert none is None
    np.testing.assert_array_equal(d_only.numpy(), np.asarray(jd))
    ortho_s = jr.normalize_ortho_setup(s)
    jd, _ = jr.rasterize(ortho_s, 192, 96, tile_h=32, tile_w=128, chunk=32,
                         depth_mode=depth_mode, y_offset=y_offset)
    ortho_t = tr.normalize_ortho_setup(port)
    for ortho in (False, True):
        td, _ = rk.rasterize_exhaustive(ortho_t, 192, 96, tile_h=32, tile_w=128,
                                        depth_mode=depth_mode, y_offset=y_offset,
                                        want_ids=False, ortho=ortho)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=f"ortho={ortho}")


# ---------------------------------------------------------------- frames

FRAME_CASES = {
    # shadows, IBL and masked models on (compaction is off with masked
    # models): two carried frames and the forward frame
    "masked": (dict(), dict(with_masked=True), 2),
    # the rich-material u8 scene with the camera compaction on: compact ids,
    # which one frame shows
    "compact": (dict(has_masked_models=False, combined_material=True, compact_cap=256),
                dict(rich_materials=True, atlas_u8=True), 1),
}


@pytest.fixture
def dispatches(monkeypatch):
    """The kernel wrappers a block dispatched to (on the CPU: their plain
    versions)."""
    seen = set()
    monkeypatch.setattr(_cuda, "LAUNCH_LOG", lambda name, _what: seen.add(name))
    return seen


def _assert_frame(got, want, label):
    got = interop.to_numpy(got)
    for k in EXACT:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{label} {k}")
    assert {k: int(v) for k, v in got["raster_stats"].items()} == {
        k: int(v) for k, v in want["raster_stats"].items()}, label
    assert ("tri_remap" in got) == ("tri_remap" in want), label
    if "tri_remap" in got:
        np.testing.assert_array_equal(got["tri_remap"], np.asarray(want["tri_remap"]))
    for k in ("hdr", "color"):
        if k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=ATOL_IMAGE,
                                       err_msg=f"{label} {k}")
    return got


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_frames_match_reference_xla_path(case, dispatches):
    st, scene_kw, n_frames = FRAME_CASES[case]
    common = dict(width=SIZE, height=SIZE, shadow_map_size=SIZE, raster_backend="xla", **st)
    j_settings, t_settings = JSettings(**common), RenderSettings(**common)
    assert not jcommon._use_pallas(j_settings) and not tcommon.use_kernel_path(t_settings)
    scene, data = j_scene(6, **scene_kw)
    t_scene = interop.to_port(scene, DeviceScene, "cpu")
    j_state = JState.initial(SIZE, SIZE)
    t_state = interop.to_port(j_state, FrameState, "cpu")
    step = jax.jit(functools.partial(j_deferred, settings=j_settings))
    for i in range(n_frames):
        a = 0.05 * i
        params = j_frame_params(data, SIZE, SIZE, camera_pos=(4.0 * np.sin(a), 1.5,
                                                              -4.0 * np.cos(a)))
        t_params = interop.to_port(params, FrameParams, "cpu")
        j_out, j_state = step(scene, params, j_state)
        t_out, t_next = deferred_frame(t_scene, t_params, t_state, t_settings)
        got = _assert_frame(t_out, j_out, f"{case} deferred frame {i}")
        np.testing.assert_array_equal(t_next.hzb.numpy(), np.asarray(j_state.hzb))
        assert (got["tri_id"] >= 0).sum() > 1000
        assert dispatches == {"exhaustive_raster"}
        if case == "masked" and i == 1:
            # the kernel path's frame from the same state differs at shadow
            # edges by more than the tolerance: the comparison tells them apart
            kernel_out, _ = deferred_frame(t_scene, t_params, t_state,
                                           dataclasses.replace(t_settings, raster_backend="auto"))
            assert dispatches >= {"binned_raster", "giant_raster", "shadow_select9",
                                  "gather_rows"}
            dispatches.clear()
            diff = np.abs(kernel_out["hdr"].numpy() - got["hdr"]).max()
            assert diff > ATOL_IMAGE, diff
        t_state = t_next
    if case == "masked":  # the forward frame once: the masked scene's
        j_out = jax.jit(functools.partial(j_forward, settings=j_settings))(scene, params)
        _assert_frame(forward_frame(t_scene, t_params, t_settings), j_out, "forward")
        assert dispatches == {"exhaustive_raster"}


def test_sharded_xla_frames_match_single_device(tmp_path, monkeypatch):
    """tests/test_render.py's multi-device settings at 2 ranks: 16-row slabs
    over 8-row camera tiles and one 32-row map tile."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' thread pools
    st = dict(renderer_type="deferred", enable_ibl=True, enable_hzb=True, enable_cas=True,
              has_masked_models=True, width=64, height=32, shadow_map_size=32, tile_h=8,
              tile_w=64, chunk=32, shadow_chunk=32, raster_backend="xla")
    cams = [(4.0 * np.sin(0.12 * i), 1.5, -4.0 * np.cos(0.12 * i)) for i in range(2)]
    spec = dict(device="cpu", settings=st, scene=dict(n_objects=8, with_masked=True),
                cameras=cams)
    frames = run_ranks(sharded_frames, 2, f"file://{tmp_path}/rendezvous", args=(spec,),
                       device="cpu", timeout=240.0)[0]
    settings = RenderSettings(**st)
    scene, data = synthetic_device_scene(8, with_masked=True, device="cpu")
    state = FrameState.initial(settings.width, settings.height, "cpu")
    for i, cam in enumerate(cams):
        params = synthetic_frame_params(data, settings.width, settings.height, camera_pos=cam,
                                        device="cpu")
        out, state = deferred_frame(scene, params, state, settings)
        want, got = interop.to_numpy(out), frames[i]
        for k in EXACT:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"frame {i} {k}")
        assert {k: int(v) for k, v in got["raster_stats"].items()} == {
            k: int(v) for k, v in want["raster_stats"].items()}
        np.testing.assert_array_equal(got["hzb"], state.hzb.numpy())
        np.testing.assert_allclose(got["color"], want["color"], rtol=0, atol=1e-5)
        assert (want["tri_id"] >= 0).sum() > 50


def test_renderer_auto_on_cpu_matches_port_xla(tmp_path, monkeypatch):
    """The reference's Renderer at its default backend on the CPU takes its
    XLA branch: what its CLI renders there.  The port's Renderer at "xla"
    gives the same u8 frames (the reference's lost GpuDebugPrint flag
    restored, as in tests/test_torch_renderer.py)."""
    monkeypatch.setenv("UNCLERENDERER_SCENE_CACHE", "")
    scene = write_scene(tmp_path, 2, masked=True, n_materials=2, tex_size=32)
    common = dict(width=64, height=64, shadow_map_size=64)
    j = JRenderer(scene, settings=JSettings(**common))
    assert j.settings.raster_backend == "auto" and not jcommon._use_pallas(j.settings)
    if j.debug_print_enabled and not j.settings.gpu_debug_print:
        j.settings = dataclasses.replace(j.settings, gpu_debug_print=True)
    t = Renderer(scene, settings=RenderSettings(raster_backend="xla", **common), device="cpu")
    for i in range(2):
        want, got = j.render_to_u8(), t.render_to_u8()
        assert got.shape == want.shape == (64, 64, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, f"frame {i}"
        assert (got != got[0, 0]).any(-1).sum() > 500


def test_check_supported_refuses_an_unknown_backend():
    for backend in ("auto", "xla", "pallas"):
        check_supported(RenderSettings(raster_backend=backend))
    with pytest.raises(ValueError, match="raster_backend"):
        check_supported(RenderSettings(raster_backend="mosaic"))
