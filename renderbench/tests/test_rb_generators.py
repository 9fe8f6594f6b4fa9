"""The benchmark's frozen generators against the port's originals, and
their determinism per seed."""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from renderbench import scenegen
from unclerenderer_tpu_torch.render import testing as port
from unclerenderer_tpu_torch.scene.build import build_scene

torch.set_num_threads(1)

SCENE_FIELDS = ("position", "normal", "tangent", "uv", "color", "tri_indices", "tri_model",
                "scene_center", "base_color_factor", "metallic_factor", "roughness_factor",
                "alpha_mode", "uv_transform", "bounds_min_arr", "bounds_max_arr", "object_ids")


@pytest.mark.parametrize("n, seed, ground", [(4, 0, False), (9, 7, True), (12, 2**33 + 1, True)])
def test_scene_data_is_the_ports(n, seed, ground):
    a = scenegen.synthetic_scene_data(n, seed, sphere_res=(8, 6), ground=ground)
    b = port.synthetic_scene_data(n, seed, sphere_res=(8, 6), ground=ground)
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.scene_radius == b.scene_radius


@pytest.mark.parametrize("ci", [0, 1, 5])
def test_material_maps_are_the_ports(ci):
    ours = scenegen.material_maps(ci, 64, 1000 + ci)
    theirs = port._material_maps(ci, 64)
    for x, y in zip(ours, theirs):
        if y is None:
            assert x is None
        else:
            np.testing.assert_array_equal(x, y)


def test_dds_and_env_cube_are_the_ports():
    faces = scenegen.env_cube_faces(8, 3)
    for x, y in zip(faces, port.env_cube_faces(8, 3)):
        for lx, ly in zip(x, y):
            np.testing.assert_array_equal(lx, ly)
    items = [[lv.astype(np.float16) for lv in ch] for ch in faces]
    assert scenegen.encode_dds(items, 10, 8, 8, cube=True) == port.encode_dds(items, 10, 8, 8,
                                                                               cube=True)
    lut = [[np.arange(64, dtype=np.uint16).reshape(4, 8, 2)]]
    assert scenegen.encode_dds(lut, 35, 8, 4, legacy=True) == port.encode_dds(lut, 35, 8, 4,
                                                                             legacy=True)


def _digest(root: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file():
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def test_scene_files_are_deterministic_per_seed(tmp_path):
    kw = dict(n_objects=6, sphere_res=(8, 6), n_materials=3, tex_size=16, masked=True)
    a = scenegen.write_scene(tmp_path / "a", seed=2**32 + 9, **kw)
    b = scenegen.write_scene(tmp_path / "b", seed=2**32 + 9, **kw)
    c = scenegen.write_scene(tmp_path / "c", seed=2**32 + 10, **kw)
    assert _digest(a.parent.parent) == _digest(b.parent.parent)
    assert _digest(a.parent.parent) != _digest(c.parent.parent)


@pytest.mark.parametrize("masked", [False, True])
def test_written_scene_loads_as_the_ports_writer(tmp_path, masked):
    """The DDS scene loads into the same geometry, materials and model
    table as the port's PNG writer's, and its maps keep their baked chains."""
    kw = dict(n_objects=6, seed=4, sphere_res=(8, 6), n_materials=3, tex_size=16,
              masked=masked)
    ours = scenegen.write_scene(tmp_path / "ours", **kw)
    theirs = port.write_scene(tmp_path / "theirs", **kw)
    a = build_scene(ours, ours.parent.parent)
    b = build_scene(theirs, theirs.parent.parent)
    for f in SCENE_FIELDS + ("alpha_cutoff",):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert [Path(p).suffix for slots in a.texture_paths for p in slots if p] == \
        [".dds"] * sum(1 for slots in a.texture_paths for p in slots if p)
    from unclerenderer_tpu_torch.textures.image import load_image

    base = next(p for slots in a.texture_paths for p in slots[:1] if p)
    chain = load_image(base, srgb=False)
    assert [lv.shape[0] for lv in chain] == [16, 8, 4, 2, 1]


@pytest.mark.parametrize("masked", [False, True])
def test_scene_content_is_what_the_renderer_loads(tmp_path, masked):
    """The data the reference renders (``scene_content``) is what the port
    loads from the written files: the world-space geometry, each model's
    material, and every map chain byte for byte."""
    from unclerenderer_tpu_torch.textures.dds import load_dds

    kw = dict(n_objects=6, seed=2**33 + 11, sphere_res=(8, 6), n_materials=3, tex_size=16,
              masked=masked)
    path = scenegen.write_scene(tmp_path, **kw)
    content = scenegen.scene_content(**kw)
    loaded = build_scene(path, path.parent.parent)
    for f in ("position", "uv", "tri_model"):
        np.testing.assert_allclose(getattr(loaded, f), getattr(content["data"], f), atol=1e-6,
                                   err_msg=f)

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    # directions: the loader keeps a scaled model's normals at their length
    # (the frame normalises them)
    for f, n in (("normal", 3), ("tangent", 3)):
        np.testing.assert_allclose(unit(getattr(loaded, f)[:, :n]),
                                   unit(getattr(content["data"], f)[:, :n]), atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(loaded.tangent[:, 3], content["data"].tangent[:, 3])
    mats = content["materials"]
    for mi, slots in enumerate(loaded.texture_paths):
        mat = mats[content["model_material"][mi]]
        assert bool(loaded.alpha_mode[mi]) == mat["alpha_mask"]
        for slot, p in zip(("base", "mr", "normal"), slots):
            assert bool(p) == (slot in mat["maps"])
            if p:
                chain = load_dds(p).mips[0]
                assert len(chain) == len(mat["maps"][slot])
                for x, y in zip(chain, mat["maps"][slot]):
                    np.testing.assert_array_equal(x, y)
