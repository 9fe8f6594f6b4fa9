"""The port's parameter structures, interop and synthetic scene against the
reference package (unclerenderer_tpu_torch vs unclerenderer_tpu)."""

import dataclasses
import re
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
    t, tdata = synthetic_device_scene(6, rich_materials=True, atlas_u8=True, device="cpu")
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


def test_synthetic_packed_scene_equals_reference(packed_scene):
    t, tdata = packed_scene
    j, jdata = j_scene(6, rich_materials=True, atlas_u8=True, packed_trilinear=True)
    got = interop.to_numpy(t)
    for name in ("quad_img", "tri_mrec", "tri_geo", "tex_ids", "has_map"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(j, name)), err_msg=name)
    assert tdata.num_triangles == jdata.num_triangles


def test_synthetic_frame_params_equal_reference(rich_scenes):
    _, jdata, _, tdata = rich_scenes
    kw = dict(camera_pos=(1.0, 2.0, -5.0))
    want = j_frame_params(jdata, 160, 96, **kw)
    got = interop.to_numpy(synthetic_frame_params(tdata, 160, 96, device="cpu", **kw))
    for f in dataclasses.fields(jparams.FrameParams):
        w = np.asarray(getattr(want, f.name))
        np.testing.assert_array_equal(got[f.name], w, err_msg=f.name)
        assert got[f.name].dtype == w.dtype, f.name


def test_port_imports_no_jax():
    """Every module of the port (``pkgutil.walk_packages``) and
    ``chip_smoke``, imported in a fresh process, load neither JAX nor any
    module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import unclerenderer_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in mods + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(len(mods), sorted(t for t in top if t.startswith('jax') "
        "or t == 'unclerenderer_tpu'))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n_mods, loaded = res.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n_mods) >= 25  # every module of the port was imported
    assert loaded == "[]"


UNPORTED = [
    {"renderer_type": "forward"},
    {"lod_derivatives": "forward"},
    {"soa_vertex": False},
    {"fused_resolve": "on"},
    {"shadow_table_u16": False},
    {"gpu_debug_print": True},
    {"kernel_debug_print": True},
]
BASE = dict(width=64, height=64, shadow_map_size=64, has_masked_models=False,
            combined_material=True)


def _render(scene, data, **override):
    settings = tparams.RenderSettings(**{**BASE, **override})
    return deferred_frame(scene, synthetic_frame_params(data, 64, 64, device="cpu"),
                          tparams.FrameState.initial(64, 64, "cpu"), settings)


@pytest.mark.parametrize("override", UNPORTED, ids=lambda o: next(iter(o)))
def test_unported_settings_raise(override, rich_scenes):
    _, _, t, tdata = rich_scenes
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _render(t, tdata, **override)


def _roadmap_queue_titles():
    """Bold titles of ROADMAP.md's modules queue ("1. **Masked raster**")."""
    text = (ROOT / "ROADMAP.md").read_text()
    queue = text.split("**Queue, in order:**", 1)[1].split("\n\n**", 1)[0]
    return {t.lower() for t in re.findall(r"^\d+\. \*\*([^*]+)\*\*", queue, re.M)}


def test_not_ported_messages_name_a_roadmap_queue_entry(rich_scenes):
    """Every remaining raise names its ROADMAP queue entry by title (a
    number would go stale at the next re-anchor)."""
    _, _, t, tdata = rich_scenes
    titles = _roadmap_queue_titles()
    assert len(titles) >= 5
    msgs = []
    for override in UNPORTED:
        with pytest.raises(NotImplementedError) as exc:
            _render(t, tdata, **override)
        msgs.append(str(exc.value))
    for msg in msgs:
        m = re.search(r"\(ROADMAP\.md, modules queue: ([^)]+)\)$", msg)
        assert m and m.group(1) in titles, msg


@pytest.fixture(scope="module")
def packed_scene():
    """The port's rich-material u8 scene on the packed-trilinear atlas."""
    return synthetic_device_scene(6, rich_materials=True, atlas_u8=True, packed_trilinear=True,
                                  device="cpu")


# the settings that raised before the packed-trilinear slice, each now
# rendered on the packed atlas
NOW_PORTED = [
    {"texture_filter": "bilinear"},
    {"texture_filter": "anisotropic"},
    {"hzb_pallas_tail": True},
    {"env_select_kernel": True},
    {"mat_select_kernel": True},
    {"material_packed_trilinear": True},
]


@pytest.mark.parametrize("override", NOW_PORTED, ids=lambda o: "-".join(map(str, *o.items())))
def test_formerly_unported_settings_render(override, packed_scene):
    t, tdata = packed_scene
    assert t.quad_img.shape[-1] == 256 and t.quad_img.dtype == torch.uint8
    out, state = _render(t, tdata, **override)
    assert tuple(out["color"].shape) == (64, 64, 3)
    assert bool(torch.isfinite(out["color"]).all()) and bool(torch.isfinite(state.hzb).all())
    assert int((out["tri_id"] >= 0).sum()) > 100
    assert ("aniso_tap_overflow" in out["raster_stats"]) == (
        override.get("texture_filter") == "anisotropic")


@pytest.fixture(scope="module")
def per_slot_scene():
    """The port's per-slot masked scene (rich_materials=False, with_masked)."""
    return synthetic_device_scene(8, with_masked=True, device="cpu")


# the settings that raised before the masked-raster slice, each now rendered:
# masked models on the rich scene (none of its models is masked) and on the
# per-slot masked scene; per-slot taps on the per-slot scene
MASKED_NOW_PORTED = [
    ({"has_masked_models": True}, "rich"),
    ({"has_masked_models": True, "combined_material": False}, "per_slot"),
    ({"combined_material": False}, "per_slot"),
]


@pytest.mark.parametrize("override,scene", MASKED_NOW_PORTED,
                         ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items())
                         if isinstance(o, dict) else o)
def test_masked_and_per_slot_settings_render(override, scene, rich_scenes, per_slot_scene):
    t, tdata = per_slot_scene if scene == "per_slot" else rich_scenes[2:]
    out, state = _render(t, tdata, **override)
    assert tuple(out["color"].shape) == (64, 64, 3)
    assert bool(torch.isfinite(out["color"]).all()) and bool(torch.isfinite(state.hzb).all())
    assert int((out["tri_id"] >= 0).sum()) > 100
    if scene == "per_slot":
        assert t.quad_img.shape[-1] == 16 and int((t.alpha_mode == 1).sum()) == 2


def test_per_slot_scene_builds_and_refuses_masked_rich_materials(per_slot_scene):
    """rich_materials=False builds the per-slot atlas (it raised before);
    rich materials model no MASK material, as the reference asserts."""
    t, _ = per_slot_scene
    assert t.quad_img.dtype == torch.bfloat16 and t.has_map[1::4, 0].all()
    with pytest.raises(ValueError, match="MASK"):
        synthetic_device_scene(2, rich_materials=True, with_masked=True, device="cpu")


def test_unknown_texture_filter_is_refused(rich_scenes):
    _, _, t, tdata = rich_scenes
    with pytest.raises(ValueError, match="texture_filter"):
        _render(t, tdata, texture_filter="nearest")
