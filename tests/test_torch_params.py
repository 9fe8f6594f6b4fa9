"""The port's parameter structures, interop and synthetic scene against the
reference package (unclerenderer_tpu_torch vs unclerenderer_tpu)."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from unclerenderer_tpu.render import params as jparams
from unclerenderer_tpu.render.testing import synthetic_device_scene as j_scene
from unclerenderer_tpu.render.testing import synthetic_frame_params as j_frame_params
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.render import params as tparams
from unclerenderer_tpu_torch.render.deferred import deferred_frame
from unclerenderer_tpu_torch.render.testing import synthetic_device_scene, synthetic_frame_params

ROOT = Path(__file__).resolve().parents[1]


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_render_settings_fields_and_defaults():
    assert _fields(tparams.RenderSettings) == _fields(jparams.RenderSettings)


@pytest.mark.parametrize("name", ["FrameParams", "DeviceScene", "FrameState"])
def test_tensor_dataclass_fields(name):
    got = [f.name for f in dataclasses.fields(getattr(tparams, name))]
    want = [f.name for f in dataclasses.fields(getattr(jparams, name))]
    assert got == want


def test_frame_state_initial_matches():
    want = jparams.FrameState.initial(96, 64)
    got = interop.to_numpy(tparams.FrameState.initial(96, 64, "cpu"))
    for f in dataclasses.fields(jparams.FrameState):
        w = np.asarray(getattr(want, f.name))
        assert got[f.name].dtype == w.dtype, f.name
        np.testing.assert_array_equal(got[f.name], w, err_msg=f.name)


@pytest.fixture(scope="module")
def rich_scenes():
    """The reference's and the port's rich-material u8 scene (6 models)."""
    j, jdata = j_scene(6, rich_materials=True, atlas_u8=True)
    t, tdata = synthetic_device_scene(6, rich_materials=True, atlas_u8=True)
    return j, jdata, t, tdata


def test_interop_round_trip_is_bit_exact(rich_scenes):
    j, _, _, _ = rich_scenes
    # bf16 leaves (env_quad) and a bf16 atlas exercise the 16-bit path
    bf16_atlas = np.asarray(j.quad_img.astype(jax.numpy.bfloat16))
    src = {f.name: getattr(j, f.name) for f in dataclasses.fields(jparams.DeviceScene)}
    for quad in (np.asarray(j.quad_img), bf16_atlas):
        src["quad_img"] = quad
        port = interop.to_port(src, tparams.DeviceScene, "cpu")
        assert port.env_quad.dtype == torch.bfloat16
        assert port.tri_model.dtype == torch.int32
        back = interop.to_numpy(port)
        for name, v in src.items():
            v = np.asarray(v)
            assert back[name].dtype == v.dtype, name
            np.testing.assert_array_equal(back[name].view(np.uint8), v.view(np.uint8), err_msg=name)


def test_synthetic_scene_equals_reference(rich_scenes):
    j, jdata, t, tdata = rich_scenes
    got = interop.to_numpy(t)
    for f in dataclasses.fields(jparams.DeviceScene):
        w = np.asarray(getattr(j, f.name))
        assert got[f.name].dtype == w.dtype, f.name
        assert got[f.name].shape == w.shape, f.name
        np.testing.assert_array_equal(got[f.name].view(np.uint8), w.view(np.uint8), err_msg=f.name)
    assert tdata.num_triangles == jdata.num_triangles


def test_synthetic_frame_params_equal_reference(rich_scenes):
    _, jdata, _, tdata = rich_scenes
    kw = dict(camera_pos=(1.0, 2.0, -5.0))
    want = j_frame_params(jdata, 160, 96, **kw)
    got = interop.to_numpy(synthetic_frame_params(tdata, 160, 96, **kw))
    for f in dataclasses.fields(jparams.FrameParams):
        w = np.asarray(getattr(want, f.name))
        np.testing.assert_array_equal(got[f.name], w, err_msg=f.name)
        assert got[f.name].dtype == w.dtype, f.name


def test_port_imports_no_jax():
    code = (
        "import sys; import unclerenderer_tpu_torch.render.deferred, "
        "unclerenderer_tpu_torch.render.testing, unclerenderer_tpu_torch.interop; "
        "print('jax' in sys.modules)"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "False"


UNPORTED = [
    {"renderer_type": "forward"},
    {"has_masked_models": True},
    {"texture_filter": "bilinear"},
    {"texture_filter": "anisotropic"},
    {"lod_derivatives": "forward"},
    {"combined_material": False},
    {"soa_vertex": False},
    {"fused_resolve": "on"},
    {"shadow_table_u16": False},
    {"gpu_debug_print": True},
    {"kernel_debug_print": True},
    {"hzb_pallas_tail": True},
    {"env_select_kernel": True},
    {"mat_select_kernel": True},
]


@pytest.mark.parametrize("override", UNPORTED, ids=lambda o: next(iter(o)))
def test_unported_settings_raise(override, rich_scenes):
    _, _, t, tdata = rich_scenes
    base = dict(width=64, height=64, shadow_map_size=64, has_masked_models=False,
                combined_material=True)
    settings = tparams.RenderSettings(**{**base, **override})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deferred_frame(t, synthetic_frame_params(tdata, 64, 64),
                       tparams.FrameState.initial(64, 64, "cpu"), settings)


def test_packed_trilinear_atlas_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        synthetic_device_scene(2, rich_materials=True, packed_trilinear=True)
