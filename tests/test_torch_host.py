"""The port's own host layer against the JAX package's: every copied numpy
function gives byte-equal outputs on seeded inputs (``mathlib``,
``scene/mesh.py``, ``scene/build.py``, ``textures/image.py``,
``textures/atlas.py``), and the port's entry points put their tensors on
the card unless the caller names another device."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from unclerenderer_tpu import mathlib as jm
from unclerenderer_tpu.scene import build as jbuild
from unclerenderer_tpu.scene import gltf as jgltf
from unclerenderer_tpu.scene import mesh as jmesh
from unclerenderer_tpu.textures import atlas as jatlas
from unclerenderer_tpu.textures import image as jimage
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch import mathlib as tm
from unclerenderer_tpu_torch.render import params as tparams
from unclerenderer_tpu_torch.render import testing as ttesting
from unclerenderer_tpu_torch.scene import build as tbuild
from unclerenderer_tpu_torch.scene import mesh as tmesh
from unclerenderer_tpu_torch.textures import atlas as tatlas
from unclerenderer_tpu_torch.textures import image as timage


def _same(got, want, msg=""):
    """Byte-equal arrays (or tuples/lists of them), same dtype and shape."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), msg
        for k, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{msg}[{k}]")
        return
    if not isinstance(want, np.ndarray):
        assert got == want and type(got) is type(want), msg
        return
    assert got.dtype == want.dtype and got.shape == want.shape, msg
    np.testing.assert_array_equal(np.ascontiguousarray(got).view(np.uint8),
                                  np.ascontiguousarray(want).view(np.uint8), err_msg=msg)


# ------------------------------------------------------------------ mathlib


def _math_cases():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((6, 3)).astype(np.float32)
    w = tm.rotation_y(0.7) @ tm.translation([1.5, -2.0, 3.0])
    return {
        "normalize": [(v[0],), ([0.0, 0.0, 0.0],), ([3, 4, 0],)],
        "translation": [(v[1],), ([1, 2, 3],)],
        "rotation_y": [(0.0,), (1.234,), (float(rng.uniform(0, 6.3)),)],
        "look_to_lh": [(v[2], v[3], [0, 1, 0])],
        "look_at_lh": [((0.0, 1.5, -4.0), v[4], [0, 1, 0]), (v[5], (0.0, 0.0, 0.0), [0, 1, 0])],
        "perspective_reverse_z_infinite": [(np.radians(60.0), 16 / 9, 0.1), (1.1, 1.0, 0.5)],
        "orthographic_lh": [(10.0, 8.0, 0.1, 50.0)],
        "transform_aabb": [(v[0], v[0] + 1.0, w)],
        "build_directional_light_view_proj": [(v[1], 7.5, [-0.4, 0.8, -0.3])],
        "srgb_to_linear": [(rng.uniform(0, 1, (64, 3)).astype(np.float32),)],
    }


@pytest.mark.parametrize("name", sorted(_math_cases()))
def test_mathlib_copy_is_byte_equal(name):
    for args in _math_cases()[name]:
        _same(getattr(tm, name)(*args), getattr(jm, name)(*args), name)


# -------------------------------------------------------------------- meshes


@pytest.mark.parametrize("make,args", [("create_cube", (1.0,)), ("create_cube", (2.5,)),
                                       ("create_sphere", (0.6, 12, 8)),
                                       ("create_sphere", (0.6, 32, 24)),
                                       ("create_sphere", (1.0, 2, 1))])
def test_mesh_copy_is_byte_equal(make, args):
    got, want = getattr(tmesh, make)(*args), getattr(jmesh, make)(*args)
    for f in ("position", "normal", "uv", "tangent", "color", "indices", "name"):
        _same(getattr(got, f), getattr(want, f), f)
    _same(tmesh.compute_mesh_bounds(got), jmesh.compute_mesh_bounds(want), "bounds")


@pytest.mark.parametrize("port,ref", [(tbuild.SceneData, jbuild.SceneData),
                                      (tbuild.SceneModel, jbuild.SceneModel),
                                      (tbuild.GltfMaterial, jgltf.GltfMaterial),
                                      (tbuild.TextureTransform, jgltf.TextureTransform)])
def test_scene_records_match(port, ref):
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    got, want = port(), ref()
    for f in dataclasses.fields(ref):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(w):
            assert dataclasses.asdict(g) == dataclasses.asdict(w), f.name
        else:
            _same(g, w, f.name)
    if ref is jgltf.TextureTransform:
        tt = port(offset=(0.25, -1.0), scale=(2.0, 0.5), rotation=0.3)
        jt = ref(offset=(0.25, -1.0), scale=(2.0, 0.5), rotation=0.3)
        _same(tt.offset_scale(), jt.offset_scale())
        _same(tt.rotation_vec(), jt.rotation_vec())


# ------------------------------------------------------------------ textures


def _img(shape, seed, hi=1.0):
    return np.random.default_rng(seed).uniform(0.0, hi, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 64, 4), (32, 8, 4), (8, 32, 16), (5, 7, 4), (1, 1, 4)])
def test_generate_mips_copy_is_byte_equal(shape):
    img = _img(shape, sum(shape))
    _same(timage.generate_mips(img), jimage.generate_mips(img))


def test_image_helpers_copy_is_byte_equal():
    for size, cells in ((256, 8), (64, 4), (30, 3)):
        _same(timage.default_grid_texture(size, cells), jimage.default_grid_texture(size, cells))
    for shape, hi in (((16, 16, 16), 1.0), ((8, 4, 16), 1.0), ((8, 8, 16), 1.5)):
        img = _img(shape, 3, hi)
        _same(timage.encode_combined_u8(img), jimage.encode_combined_u8(img))
    img = _img((16, 8, 4), 4)
    for th, tw in ((16, 8), (32, 16), (4, 4), (24, 5)):
        _same(timage.resize_bilinear(img, th, tw), jimage.resize_bilinear(img, th, tw))
    for rgba, size in (([1.0, 1.0, 1.0, 1.0], 1), ([0.2, 0.4, 0.6, 0.8], 4), ((0, 1, 0, 1), 3)):
        _same(timage.solid_color_texture(rgba, size), jimage.solid_color_texture(rgba, size))
    _same(timage.solid_color_texture([0.5] * 4), jimage.solid_color_texture([0.5] * 4))
    _same(timage.COMBINED_NEUTRAL, jimage.COMBINED_NEUTRAL)
    assert timage.COMBINED_C == jimage.COMBINED_C
    assert timage.COMBINED_SLOT_CH == jimage.COMBINED_SLOT_CH


def test_combined_chain_copy_is_byte_equal():
    base = jimage.generate_mips(_img((32, 32, 4), 5))
    mr = jimage.generate_mips(_img((16, 16, 4), 6))
    nm = jimage.generate_mips(_img((32, 32, 4), 7))
    em = jimage.generate_mips(_img((8, 8, 4), 8))
    for slots in ([base, mr, nm, em], [base, None, nm, None], [None, mr, None, None]):
        _same(timage.combined_chain(slots), jimage.combined_chain(slots))


def _chains(sizes, c, seed, u8=False):
    out = []
    for k, (h, w) in enumerate(sizes):
        chain = jimage.generate_mips(_img((h, w, c), seed + k))
        out.append([jimage.encode_combined_u8(lv) for lv in chain] if u8 else chain)
    return out


@pytest.mark.parametrize("case", ["wrap_f32", "clamp_f32", "mixed_u8", "tall"])
def test_pyramid_quad_atlas_copy_is_byte_equal(case):
    chains, kw = {
        "wrap_f32": (_chains([(32, 32), (16, 16), (64, 64)], 4, 1), dict(wrap=True)),
        "clamp_f32": (_chains([(32, 32), (8, 8)], 4, 2), dict(wrap=False)),
        "mixed_u8": (_chains([(32, 32), (32, 32), (16, 16)], 16, 3, u8=True),
                     dict(wrap=[True, False, True], dtype=np.uint8)),
        "tall": (_chains([(64, 16), (32, 32)], 4, 4), dict(wrap=True)),
    }[case]
    _same(tatlas.build_pyramid_quad_atlas(chains, **kw),
          jatlas.build_pyramid_quad_atlas(chains, **kw))


@pytest.mark.parametrize("case", ["material_u8", "wrap_f32", "tall_clamp", "cube", "cube_short"])
def test_pyramid_tri_atlas_copy_is_byte_equal(case):
    if case == "material_u8":
        chains, kw = _chains([(32, 32), (16, 16), (32, 32)], 16, 5, u8=True), dict(
            wrap=True, dtype=np.uint8)
    elif case == "wrap_f32":
        chains, kw = _chains([(16, 16), (8, 8)], 4, 6), dict(wrap=[True, False])
    elif case == "tall_clamp":
        chains, kw = _chains([(32, 8), (16, 16)], 4, 7), dict(wrap=False)
    else:
        chains = _chains([(16, 16)] * 6, 4, 8)
        if case == "cube_short":  # chains stopping short of 1x1
            chains = [ch[:3] for ch in chains]
        kw = dict(cube=True, dtype=np.float32)
    _same(tatlas.build_pyramid_tri_atlas(chains, **kw), jatlas.build_pyramid_tri_atlas(chains, **kw))


def test_cube_extend_copy_is_byte_equal():
    faces = [_img((8, 8, 4), 20 + f) for f in range(6)]
    _same(tatlas._cube_extend(faces), jatlas._cube_extend(faces))


# ----------------------------------------------------------- per-slot scene


@pytest.mark.parametrize("kw", [dict(with_masked=True), dict(), dict(with_texture=False),
                                dict(with_masked=True, sphere_res=(6, 4), ground=True)])
def test_per_slot_scene_equals_reference(kw):
    """The per-slot scene (quad atlas of the solid, grid and alpha-checker
    chains; MASK models with masked): every record byte-equal."""
    from unclerenderer_tpu.render.testing import synthetic_device_scene as j_scene

    j, jdata = j_scene(9, **kw)
    t, tdata = ttesting.synthetic_device_scene(9, device="cpu", **kw)
    got = interop.to_numpy(t)
    for f in dataclasses.fields(tparams.DeviceScene):
        w = np.asarray(getattr(j, f.name))
        assert got[f.name].dtype == w.dtype and got[f.name].shape == w.shape, f.name
        np.testing.assert_array_equal(got[f.name].view(np.uint8), w.view(np.uint8), err_msg=f.name)
    _same(tdata.alpha_mode, jdata.alpha_mode)
    assert ((tdata.alpha_mode == 1).sum() > 0) == bool(kw.get("with_masked"))


# ------------------------------------------------------- the card by default


ENTRY_POINTS = [
    (ttesting.synthetic_device_scene, "device"),
    (ttesting.synthetic_frame_params, "device"),
    (tparams.FrameState.initial, "device"),
    (interop.to_port, "device"),
    (interop.array_to_tensor, "device"),
]


@pytest.mark.parametrize("fn,arg", ENTRY_POINTS, ids=lambda x: getattr(x, "__qualname__", x))
def test_entry_points_default_to_the_card(fn, arg):
    assert inspect.signature(fn).parameters[arg].default == "cuda"


def test_entry_points_do_not_fall_back_to_the_cpu():
    """Without a device argument the tensors go to CUDA: where there is none
    the call fails as torch does, and never quietly lands on the CPU."""
    data = ttesting.synthetic_scene_data(2)
    if torch.cuda.is_available():
        assert ttesting.synthetic_frame_params(data, 8, 8).view.device.type == "cuda"
        assert tparams.FrameState.initial(8, 8).hzb.device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        ttesting.synthetic_frame_params(data, 8, 8)
    with pytest.raises((RuntimeError, AssertionError)):
        tparams.FrameState.initial(8, 8)
    with pytest.raises((RuntimeError, AssertionError)):
        interop.array_to_tensor(np.zeros(3, np.float32))
