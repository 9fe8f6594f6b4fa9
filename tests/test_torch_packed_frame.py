"""The packed-trilinear slice: the port's deferred frame against the
reference's on the rich-material scene with the u8 PACKED-trilinear atlas
(256 lanes), a seamless procedural env cube, and the four kernel flags
(K6 ``hzb_pallas_tail``, K7 ``env_select_kernel``, K8 ``mat_select_kernel``,
K9 ``bin_mat_idx``), at 128x128 with a 128^2 shadow map over carried frames.

The reference runs its Pallas path in interpret mode (raster_backend=
"pallas"): on its default "auto" backend the CPU ignores all four flags.
Tolerances are those of tests/test_torch_frame.py: depth, tri_id,
object_id, HZB, culling and every raster counter (``aniso_tap_overflow``
included) bit-equal; hdr/color within 1e-4 and exposure_ev within 1e-5.

Also the port's counterpart of the reference's packed-vs-quad frame check
(tests/test_render.py::test_packed_trilinear_material_frame_bit_exact):
both atlas layouts give the same frame under all three filters."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unclerenderer_tpu.render import testing as j_testing
from unclerenderer_tpu.render.deferred import deferred_frame as j_frame
from unclerenderer_tpu.render.params import FrameState as JState
from unclerenderer_tpu.render.params import RenderSettings as JSettings
from unclerenderer_tpu.textures.atlas import build_pyramid_tri_atlas
from unclerenderer_tpu.textures.image import generate_mips
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.ops import hzb as thzb
from unclerenderer_tpu_torch.ops import raster_kernels as rk
from unclerenderer_tpu_torch.ops import texture as tt
from unclerenderer_tpu_torch.render import testing as t_testing
from unclerenderer_tpu_torch.render.deferred import deferred_frame
from unclerenderer_tpu_torch.render.params import DeviceScene, FrameParams, FrameState, RenderSettings

SIZE = 128
EXACT = ("depth", "tri_id", "object_id", "model_visible", "frustum_culled", "hzb_occluded")
ATOL_IMAGE = 1e-4
ATOL_EV = 1e-5
FLAGS = dict(hzb_pallas_tail=True, env_select_kernel=True, mat_select_kernel=True,
             bin_mat_idx=True)
# wrapper (module, attribute) of each flag's kernel
WRAPPERS = {"hzb_tail": thzb, "env_select": tt, "mat_select": tt, "materialize_rows": rk}


def seamless_env_cube(size=32, seed=3):
    """A seamless env cube from 6 seeded random HDR faces, packed like the
    reference's Renderer does (cube=True, bf16): (atlas, rect0, tail,
    mip count)."""
    rng = np.random.default_rng(seed)
    chains = [generate_mips(rng.uniform(0.0, 2.0, (size, size, 4)).astype(np.float32))
              for _ in range(6)]
    env, rect0 = build_pyramid_tri_atlas(chains, dtype=jnp.bfloat16, cube=True)
    tail = np.stack([chain[-1][..., :4] for chain in chains])
    return env, rect0.astype(np.float32), tail, len(chains[0])


@pytest.fixture(scope="module")
def packed_scene():
    scene, data = j_testing.synthetic_device_scene(6, rich_materials=True, atlas_u8=True,
                                                   packed_trilinear=True)
    env, rect0, tail, mips = seamless_env_cube()
    scene = dataclasses.replace(scene, env_quad=jnp.asarray(env), env_rect0=jnp.asarray(rect0),
                                env_tail=jnp.asarray(tail))
    return scene, interop.to_port(scene, DeviceScene, "cpu"), data, mips


def _record_wrappers(monkeypatch):
    calls = {name: 0 for name in WRAPPERS}
    for name, mod in WRAPPERS.items():
        orig = getattr(mod, name)

        def rec(*a, _name=name, _orig=orig, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, name, rec)
    return calls


CASES = {
    "trilinear_flags_on": (FLAGS, 3),
    "anisotropic_flags_on": (dict(FLAGS, texture_filter="anisotropic",
                                  aniso_compact_frac=0.05), 2),
    "trilinear_flags_off": ({}, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_packed_frame_matches_reference(case, packed_scene, monkeypatch):
    flags, frames = CASES[case]
    scene, t_scene, data, mips = packed_scene
    assert t_scene.quad_img.shape[-1] == 256 and t_scene.env_quad.shape[-1] == 128
    common = dict(width=SIZE, height=SIZE, shadow_map_size=SIZE, has_masked_models=False,
                  combined_material=True, material_packed_trilinear=True, **flags)
    j_settings = JSettings(raster_backend="pallas", pallas_interpret=True, **common)
    t_settings = RenderSettings(**common)
    j_state = JState.initial(SIZE, SIZE)
    t_state = interop.to_port(j_state, FrameState, "cpu")
    step = jax.jit(functools.partial(j_frame, settings=j_settings))
    calls = _record_wrappers(monkeypatch)
    overflow = []

    for i in range(frames):
        a = 0.05 * i
        params = j_testing.synthetic_frame_params(
            data, SIZE, SIZE, camera_pos=(4.0 * np.sin(a), 1.5, -4.0 * np.cos(a)))
        params = dataclasses.replace(params, env_mip_count=jnp.float32(mips))
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
        overflow.append(int(got["raster_stats"].get("aniso_tap_overflow", 0)))

    # the flags route the frame through each kernel's wrapper, and only them
    for name, n in calls.items():
        assert (n > 0) == bool(flags), (name, n)
    if "aniso_compact_frac" in flags:
        assert max(overflow) > 0  # the 1024-pixel cap really overflows (counted)


def test_packed_and_quad_atlases_agree_under_every_filter(monkeypatch):
    """The port's frame on the packed and on the quad atlas agrees to the
    reference test's 1e-5 under trilinear, bilinear and anisotropic (64^2
    material textures, as there), and the three filters really differ."""
    orig_chains = t_testing._rich_material_chains
    monkeypatch.setattr(t_testing, "_rich_material_chains", lambda n, tex_size: orig_chains(n, 64))
    small = dict(width=64, height=64, shadow_map_size=64, tile_h=16, tile_w=64, chunk=32,
                 shadow_chunk=32, has_masked_models=False, combined_material=True)
    outs = {}
    for packed in (False, True):
        scene, data = t_testing.synthetic_device_scene(6, sphere_res=(10, 8), ground=True,
                                                       rich_materials=True,
                                                       packed_trilinear=packed, device="cpu")
        assert scene.quad_img.shape[-1] == (256 if packed else 64)
        params = t_testing.synthetic_frame_params(data, 64, 64, device="cpu")
        for filt in ("trilinear", "bilinear", "anisotropic"):
            settings = RenderSettings(texture_filter=filt, material_packed_trilinear=packed,
                                      **small)
            out, _ = deferred_frame(scene, params, FrameState.initial(64, 64, "cpu"), settings)
            outs[(packed, filt)] = out["color"].numpy()
    for filt in ("trilinear", "bilinear", "anisotropic"):
        np.testing.assert_allclose(outs[(True, filt)], outs[(False, filt)], rtol=0, atol=1e-5,
                                   err_msg=filt)
    assert np.abs(outs[(True, "trilinear")] - outs[(True, "bilinear")]).max() > 1e-3
    assert np.abs(outs[(True, "trilinear")] - outs[(True, "anisotropic")]).max() > 1e-3
