"""The Sponza tiers of ``render/testing.py`` against the reference's, on a
small glTF and DDS set written here (the reference checkout's Sponza assets
are not in the repository).

The set: 3 materials (one without a baseColor texture, skipped by the
chains), 64^2 RGBA8 DDS baseColor and normal images with their mips, and 4
primitives that carry only accessor counts and AABBs (no buffers) -- an
atrium-sized shell round the bench's faithful camera, and a wall-sized slab
(3,000 units) of 91 triangles, so that the cell cap shrinks its faces --,
with counts that leave a shortfall for the top-up strip.  Both packages'
``_SPONZA_GLTF`` point at it, and both caches start empty.

Bit-equal: every ``SceneData`` field and ``sponza_chain_of_model`` of the
faithful tier, the material chains (factors equal), and every
``DeviceScene`` array of ``synthetic_device_scene(texture_source="sponza",
geometry_source="sponza")`` on the quad and the packed atlas; one carried
128^2 deferred frame of that scene against the reference's Pallas path in
interpret mode: depth, ids and counters bit-equal, colour within 1e-4 (the
transcendentals' ulps, as ``tests/test_torch_frame.py``)."""

import dataclasses
import json

import jax
import numpy as np
import pytest

from unclerenderer_tpu.render import testing as jtesting
from unclerenderer_tpu.render.deferred import deferred_frame as j_frame
from unclerenderer_tpu.render.params import FrameState as JState
from unclerenderer_tpu.render.params import RenderSettings as JSettings
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.render import testing as ttesting
from unclerenderer_tpu_torch.render.deferred import deferred_frame
from unclerenderer_tpu_torch.render.params import (
    DeviceScene,
    FrameParams,
    FrameState,
    RenderSettings,
)
from unclerenderer_tpu_torch.scene.build import SceneData
from test_torch_bench import SMALL, hold_chain, load_reference_bench
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

SIZE = 128
ATOL_IMAGE = 1e-4
# (count, POSITION min, POSITION max, material, indexed)
PRIMS = [
    (12000, [-1900.0, -120.0, -1100.0], [1800.0, 1430.0, 1100.0], 0, True),  # the atrium
    (3001, [400.0, 0.0, 200.0], [700.0, 900.0, 520.0], 2, True),
    (999, [-600.0, 300.0, -450.0], [-350.0, 700.0, -300.0], 1, False),
    (91, [-1500.0, 0.0, -900.0], [1500.0, 20.0, 900.0], None, True),  # a wall-sized slab
]


def _dds_chain(seed: int, size: int = 64) -> bytes:
    rng = np.random.default_rng(seed)
    mips, s = [], size
    while s >= 1:
        mips.append(rng.integers(0, 256, (s, s, 4), dtype=np.uint8))
        s //= 2
    return ttesting.encode_dds([mips], 28, size, size)  # R8G8B8A8_UNORM


def write_sponza_set(root, prims=PRIMS) -> str:
    """A glTF with 3 materials and buffer-less primitives (``PRIMS``), and
    its DDS images, under ``root``; returns the glTF's path."""
    (root / "textures").mkdir()
    names = ["base0", "normal0", "base2", "normal1"]
    for i, name in enumerate(names):
        (root / "textures" / f"{name}.dds").write_bytes(_dds_chain(i))
    accessors, primitives = [], []
    for count, lo, hi, mat, indexed in prims:
        prim = {"attributes": {"POSITION": len(accessors)}}
        accessors.append({"count": count * 3 if not indexed else count + 2, "min": lo, "max": hi,
                          "type": "VEC3", "componentType": 5126})
        if indexed:
            prim["indices"] = len(accessors)
            accessors.append({"count": count * 3, "type": "SCALAR", "componentType": 5125})
        if mat is not None:
            prim["material"] = mat
        primitives.append(prim)
    gltf = {
        "asset": {"version": "2.0"},
        "images": [{"uri": f"textures/{n}.dds"} for n in names],
        "textures": [{"source": i} for i in range(len(names))],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                      "baseColorFactor": [0.9, 0.8, 0.7, 1.0],
                                      "metallicFactor": 0.25, "roughnessFactor": 0.75},
             "normalTexture": {"index": 1}},
            {"pbrMetallicRoughness": {"metallicFactor": 0.0}, "normalTexture": {"index": 3}},
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 2}}},
        ],
        "meshes": [{"primitives": primitives[:2]}, {"primitives": primitives[2:]}],
        "accessors": accessors,
    }
    path = root / "untitled.gltf"
    path.write_text(json.dumps(gltf))
    return str(path)


@pytest.fixture()
def sponza_set(tmp_path, monkeypatch):
    """Both packages' ``_SPONZA_GLTF`` at the written set, caches empty."""
    path = write_sponza_set(tmp_path)
    for mod in (jtesting, ttesting):
        monkeypatch.setattr(mod, "_SPONZA_GLTF", path)
        monkeypatch.setattr(mod, "_sponza_chain_cache", {})
        monkeypatch.setattr(mod, "_atlas_memo", {})
    return path


def _same(got, want, what):
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if want.dtype.kind in "OUS":
        assert got.tolist() == want.tolist(), what
    else:  # bit patterns: signed zeros and NaN payloads count
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=what)


def test_faithful_scene_data_bit_equal(sponza_set, monkeypatch):
    sheets = []
    sheet = ttesting._sponza_sheet
    monkeypatch.setattr(ttesting, "_sponza_sheet", lambda *a: sheets.append(a) or sheet(*a))
    got, want = ttesting.sponza_faithful_scene_data(), jtesting.sponza_faithful_scene_data()
    # more sheets than the primitives' 24 faces: a shortfall was topped up
    assert len(sheets) > 6 * len(PRIMS)
    assert got.num_triangles == want.num_triangles == sum(p[0] for p in PRIMS)
    for f in dataclasses.fields(SceneData):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "models":
            assert len(g) == len(w) == len(PRIMS)
            for gm, wm in zip(g, w):
                for mf in dataclasses.fields(wm):
                    a, b = getattr(gm, mf.name), getattr(wm, mf.name)
                    if dataclasses.is_dataclass(b):
                        for k in dataclasses.fields(b):
                            x, y = getattr(a, k.name), getattr(b, k.name)
                            if dataclasses.is_dataclass(y):
                                assert dataclasses.asdict(x) == dataclasses.asdict(y), k.name
                            else:
                                _same(x, y, f"{gm.name}.material.{k.name}")
                    else:
                        _same(a, b, f"{gm.name}.{mf.name}")
        elif isinstance(w, list):
            assert g == w, f.name
        else:
            _same(g, w, f.name)
    _same(got.sponza_chain_of_model, want.sponza_chain_of_model, "sponza_chain_of_model")
    # material 1 has no baseColor map: its primitive takes pi % 2 (index 2 -> 0)
    np.testing.assert_array_equal(got.sponza_chain_of_model, [0, 1, 0, 0])
    # the cell cap: the slab's 91 triangles over its 30 m x 18 m AABB lie in
    # cells of at most 1 m (uncapped, its top face's cells would be 5 m)
    slab = got.position[-91 * 3:].reshape(-1, 3, 3)
    assert float(np.ptp(slab, axis=1).max()) <= 1.0 + 1e-5


@pytest.mark.parametrize("max_combos, max_dim", [(None, 512), (None, 32), (1, 16)])
def test_material_chains_bit_equal(sponza_set, max_combos, max_dim):
    got = ttesting.sponza_material_chains(max_combos, max_dim)
    want = jtesting.sponza_material_chains(max_combos, max_dim)
    assert len(got[0]) == len(want[0]) == (1 if max_combos == 1 else 2)  # material 1 skipped
    for gc, wc in zip(got[0], want[0]):
        assert len(gc) == len(wc) and gc[0].shape[0] == min(64, max_dim)
        for i, (a, b) in enumerate(zip(gc, wc)):
            _same(a, b, f"level {i}")
    for gf, wf in zip(got[1], want[1]):
        assert gf.keys() == wf.keys()
        for k in wf:
            _same(gf[k], wf[k], k)
    # cached by (max_combos, max_dim), as the reference caches it
    assert ttesting.sponza_material_chains(max_combos, max_dim) is got


@pytest.mark.parametrize("packed", [False, True], ids=["quad", "packed"])
def test_sponza_device_scene_bit_equal(sponza_set, packed):
    kw = dict(rich_materials=True, atlas_u8=True, packed_trilinear=packed,
              texture_source="sponza", geometry_source="sponza")
    j, jdata = jtesting.synthetic_device_scene(4, **kw)
    t, tdata = ttesting.synthetic_device_scene(4, device="cpu", **kw)
    assert int(t.quad_img.shape[-1]) == (256 if packed else 64)
    got = interop.to_numpy(t)
    for f in dataclasses.fields(DeviceScene):
        _same(got[f.name], getattr(j, f.name), f.name)
    for k in ("base_color_factor", "metallic_factor", "roughness_factor", "emissive_factor"):
        _same(getattr(tdata, k), getattr(jdata, k), k)
    assert not got["has_map"][:, 3].any()  # no emissive map in the real set
    # the second build takes the memoized atlas
    assert len(ttesting._atlas_memo) == 1
    t2, _d = ttesting.synthetic_device_scene(4, device="cpu", **kw)
    assert len(ttesting._atlas_memo) == 1
    _same(interop.to_numpy(t2)["quad_img"], got["quad_img"], "memoized atlas")


def test_sponza_frame_matches_reference(sponza_set):
    kw = dict(rich_materials=True, atlas_u8=True, texture_source="sponza",
              geometry_source="sponza")
    common = dict(width=SIZE, height=SIZE, shadow_map_size=SIZE, has_masked_models=False,
                  combined_material=True)
    scene, data = jtesting.synthetic_device_scene(4, **kw)
    t_scene, _d = ttesting.synthetic_device_scene(4, device="cpu", **kw)
    c = np.asarray(data.scene_center)
    # the bench's faithful camera: inside the atrium, down its long axis
    params = jtesting.synthetic_frame_params(data, SIZE, SIZE, camera_pos=(14.327, 0.762, 0.571),
                                             look_at=(c[0] - 10.0, c[1] + 1.0, c[2]))
    j_out, _s = jax.jit(lambda sc, p, st: j_frame(
        sc, p, st, JSettings(raster_backend="pallas", pallas_interpret=True, **common)))(
        scene, params, JState.initial(SIZE, SIZE))
    t_out, _s = deferred_frame(t_scene, interop.to_port(params, FrameParams, "cpu"),
                               FrameState.initial(SIZE, SIZE, "cpu"), RenderSettings(**common))
    got = interop.to_numpy(t_out)
    for k in ("depth", "tri_id", "object_id"):
        np.testing.assert_array_equal(got[k], np.asarray(j_out[k]), err_msg=k)
    for k, v in j_out["raster_stats"].items():
        assert int(got["raster_stats"][k]) == int(v), k
    np.testing.assert_allclose(got["color"], np.asarray(j_out["color"]), rtol=0, atol=ATOL_IMAGE)
    assert (got["tri_id"] >= 0).sum() > SIZE * SIZE // 4  # the shells fill the view


def test_bench_faithful_chain_matches_reference(tmp_path, monkeypatch):
    """The bench's faithful row chain (``bench.py _synthetic_runner`` with
    ``geometry="sponza"``: the real chains, the atrium camera panning) on a
    smaller written set, against the reference's: each frame's colour mean
    within 1e-4, drop counters equal (``tests/test_torch_bench.py
    hold_chain``)."""
    # the atrium at 2,000 triangles and the slab: the reference's
    # interpret-mode chain costs with the triangles
    path = write_sponza_set(tmp_path, prims=[(2000,) + PRIMS[0][1:], PRIMS[3]])
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    for mod in (jtesting, ttesting):
        monkeypatch.setattr(mod, "_SPONZA_GLTF", path)
        monkeypatch.setattr(mod, "_sponza_chain_cache", {})
        monkeypatch.setattr(mod, "_atlas_memo", {})
    info = hold_chain(load_reference_bench(), "sponza")
    assert info["geometry_source"] == "sponza_gltf_aabb_sheets"
    assert info["texture_source"] == "sponza_dds_2_materials_512cap"


def test_absent_gltf_falls_back(tmp_path, monkeypatch):
    """Without the glTF both packages return None and build the sphere
    tier with the procedural materials."""
    for mod in (jtesting, ttesting):
        monkeypatch.setattr(mod, "_SPONZA_GLTF", str(tmp_path / "missing.gltf"))
        monkeypatch.setattr(mod, "_sponza_chain_cache", {})
        monkeypatch.setattr(mod, "_atlas_memo", {})
        assert mod.sponza_faithful_scene_data() is None
        assert mod.sponza_material_chains() is None
    kw = dict(rich_materials=True, atlas_u8=True, texture_source="sponza",
              geometry_source="sponza")
    j, jdata = jtesting.synthetic_device_scene(4, **kw)
    t, tdata = ttesting.synthetic_device_scene(4, device="cpu", **kw)
    assert getattr(tdata, "sponza_chain_of_model", None) is None
    got = interop.to_numpy(t)
    for f in dataclasses.fields(DeviceScene):
        _same(got[f.name], getattr(j, f.name), f.name)
    # the same arrays as the procedural defaults
    p, _d = ttesting.synthetic_device_scene(4, device="cpu", rich_materials=True, atlas_u8=True)
    for k, v in interop.to_numpy(p).items():
        _same(got[k], v, k)


def test_assets_variable_is_read_when_a_tier_is_built(tmp_path, monkeypatch):
    """With ``_SPONZA_GLTF`` unset the tiers find Sponza's glTF under
    ``UNCLERENDERER_ASSETS`` as the variable stands at the call, set after
    the package was imported, as the bench's pica row does."""
    (tmp_path / "sponza").mkdir()
    path = write_sponza_set(tmp_path / "sponza")
    monkeypatch.setattr(ttesting, "_SPONZA_GLTF", "")
    monkeypatch.setattr(ttesting, "_sponza_chain_cache", {})
    monkeypatch.delenv("UNCLERENDERER_ASSETS", raising=False)
    assert ttesting.sponza_material_chains() is None
    assert ttesting.sponza_faithful_scene_data() is None
    monkeypatch.setenv("UNCLERENDERER_ASSETS", str(tmp_path))
    chains, _factors = ttesting.sponza_material_chains()
    assert len(chains) == 2  # the material without a baseColor texture is skipped
    data = ttesting.sponza_faithful_scene_data()
    monkeypatch.setattr(ttesting, "_SPONZA_GLTF", path)
    want = ttesting.sponza_faithful_scene_data()
    assert [m.name for m in data.models] == [m.name for m in want.models]
    for f in dataclasses.fields(want):
        if isinstance(getattr(want, f.name), np.ndarray):
            _same(getattr(data, f.name), getattr(want, f.name), f.name)
    _same(data.sponza_chain_of_model, want.sponza_chain_of_model, "sponza_chain_of_model")


def test_sources_are_checked():
    with pytest.raises(ValueError, match="texture_source"):
        ttesting.synthetic_device_scene(4, device="cpu", texture_source="dds")
    with pytest.raises(ValueError, match="geometry_source"):
        ttesting.synthetic_device_scene(4, device="cpu", geometry_source="gltf")
