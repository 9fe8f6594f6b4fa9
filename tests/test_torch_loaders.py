"""The port's asset loaders against the reference's, on the same files:
``load_config``, ``load_scene_json``, ``load_gltf``, ``build_scene``,
``load_png``, ``load_dds``, ``load_image`` and ``TextureCache``, and the
mathlib functions the Renderer adds.  Every output byte-equal (arrays: same
dtype, shape and bytes; records field by field).  Also: the port's native
library (``native/*.cpp`` built into ``_build/``) against the numpy
decoders, ``save_png`` through ``load_png``, and the TrueType atlas bake."""

import base64
import dataclasses
import json
import struct
import sys
import zlib

import numpy as np
import pytest

from unclerenderer_tpu import mathlib as jm
from unclerenderer_tpu.core import config as jconfig
from unclerenderer_tpu.core import fontbake as jfont
from unclerenderer_tpu.scene import build as jbuild
from unclerenderer_tpu.scene import gltf as jgltf
from unclerenderer_tpu.scene import scene_json as jscene_json
from unclerenderer_tpu.textures import dds as jdds
from unclerenderer_tpu.textures import image as jimage
from unclerenderer_tpu.textures import png as jpng
from unclerenderer_tpu_torch import mathlib as tm
from unclerenderer_tpu_torch.core import config as tconfig
from unclerenderer_tpu_torch.core import fontbake as tfont
from unclerenderer_tpu_torch.render.testing import encode_dds, write_scene
from unclerenderer_tpu_torch.scene import build as tbuild
from unclerenderer_tpu_torch.scene import gltf as tgltf
from unclerenderer_tpu_torch.scene import scene_json as tscene_json
from unclerenderer_tpu_torch.textures import dds as tdds
from unclerenderer_tpu_torch.textures import image as timage
from unclerenderer_tpu_torch.textures import native as tnative
from unclerenderer_tpu_torch.textures import png as tpng
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module


def same(got, want, path="value"):
    """Byte-equal arrays, equal scalars, and records / sequences / dicts of
    them field by field."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
        for f in dataclasses.fields(want):
            same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        assert np.ascontiguousarray(got).tobytes() == np.ascontiguousarray(want).tobytes(), path
    else:
        assert got == want and type(got) is type(want), (path, got, want)


# ------------------------------------------------------------------- config

# every key and alias of RendererConfig.cpp's ApplyKeyValue, with a value
ALIASES = [
    ("Type", "forward"), ("Renderer", "Deferred"), ("Scene", "Assets/Scenes/Duck.json"),
    ("SceneFile", "x.json"), ("UseDepthPrepass", "0"), ("DepthPrepass", "yes"),
    ("FrameOverlap", "false"), ("UseFrameOverlap", "1"), ("FramesInFlight", "12"),
    ("InFlightFrames", "0"), ("SwapchainBufferCount", "2.7"), ("EnableShadows", "no"),
    ("Shadows", "TRUE"), ("ShadowBias", "0.005"), ("EnableTonemap", "0"), ("Tonemap", "1"),
    ("TonemapExposure", "1.5"), ("TonemapGamma", "2.4"), ("EnableCAS", "0"), ("CAS", "true"),
    ("CASSharpness", "0.8"), ("EnableAutoExposure", "0"), ("AutoExposure", "1"),
    ("AutoExposureKey", "0.18"), ("AutoExposureMin", "0.05"), ("AutoExposureMax", "8"),
    ("AutoExposureSpeedUp", "2"), ("AutoExposureSpeedDown", "0.5"), ("EnableTAA", "0"),
    ("TAA", "yes"), ("TemporalAA", "1"), ("TAAHistoryWeight", "1.7"), ("TAAWeight", "-0.2"),
    ("UseTaskSystem", "0"), ("EnableTaskSystem", "1"), ("TaskSystem", "false"),
    ("LogResourceBarriers", "1"), ("LogBarriers", "0"), ("BarrierLogging", "yes"),
    ("GraphDump", "1"), ("EnableGraphDump", "0"), ("DumpGraph", "true"), ("GpuTiming", "1"),
    ("EnableGpuTiming", "0"), ("RecordGpuTiming", "yes"), ("GpuDebugPrint", "0"),
    ("EnableGpuDebugPrint", "1"), ("IndirectDraw", "0"), ("EnableIndirectDraw", "1"),
    ("Width", "1920"), ("WindowWidth", "-5"), ("Height", "1080"), ("WindowHeight", "0"),
    ("Resolution", "640x480"), ("Resolution", "800 600"), ("Resolution", "bad"),
    ("Unknown", "1"), ("ShadowBias", "abc"), ("FramesInFlight", "many"), ("Width", "wide"),
]


@pytest.mark.parametrize("key,value", ALIASES, ids=[f"{k}={v}" for k, v in ALIASES])
def test_apply_key_value_matches_reference(key, value):
    got, want = tconfig.RendererConfig(), jconfig.RendererConfig()
    tconfig.apply_key_value(got, f"  {key} ", f" {value} ")
    jconfig.apply_key_value(want, f"  {key} ", f" {value} ")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("body", ["all", "aliases_and_bad_values", "missing"])
def test_load_config_matches_reference(tmp_path, body):
    """Every key (canonical names), then every alias with bad values mixed
    in (section headers, comments, lines without '='), and a missing file
    (the defaults)."""
    path = tmp_path / "RendererConfig.ini"
    if body == "all":
        keys = {k: v for k, v in ALIASES[::2]}
        path.write_text("\n".join(f"{k}={v}" for k, v in keys.items()))
    elif body == "aliases_and_bad_values":
        path.write_text("[Renderer]\n# comment\n; other\nno equals sign\n\n"
                        + "\n".join(f"{k} = {v}" for k, v in ALIASES))
    assert dataclasses.asdict(tconfig.load_config(path)) == \
        dataclasses.asdict(jconfig.load_config(path))
    assert dataclasses.asdict(tconfig.load_config(None)) == \
        dataclasses.asdict(jconfig.RendererConfig())


# --------------------------------------------------------------- scene JSON

SCENE_JSONS = {
    "full": {
        "models": [
            {"path": "Models/a.gltf", "id": "a", "translate": [1, 2, 3],
             "rotate_euler": [10, 20, 30], "scale": [2, 2, 2], "visible": False,
             "texture": "Textures/t.png"},
            {"path": "Models/b.gltf", "name": "b", "scale": [0.5], "base_color_texture": "x.png"},
            {"id": "no path"},
        ],
        "lights": [{"rotation": [30, 45, 0], "intensity": 2.5, "color": [1, 0.5]},
                   {"direction": [0, -1, 0]}],
        "camera": {"position": [0, 1, -5], "look_at": [0, 0, 0], "fov_y": 50},
        "environment": {"background": [0.2, 0.3, 0.4]},
    },
    "direction_and_camera_euler": {
        "models": [{"path": "m.gltf"}],
        "lights": [{"direction": [0.3, -0.9, 0.1]}],
        "camera": {"position": [1, 2], "rotation_euler": [5, 15, 0]},
    },
    "no_light_no_camera": {"models": [{"path": "m.gltf", "translate": [1, 2, 3, 4]}]},
}


@pytest.mark.parametrize("name", sorted(SCENE_JSONS) + ["not_json"])
def test_load_scene_json_matches_reference(tmp_path, name):
    path = tmp_path / "scene.json"
    path.write_text("{not json" if name == "not_json" else json.dumps(SCENE_JSONS[name]))
    same(tscene_json.load_scene_json(path), jscene_json.load_scene_json(path))


# -------------------------------------------------------------------- glTF


def _gltf(tmp_path, embed: bool, with_scene: bool = True):
    """A glTF exercising the loader: an interleaved (byte-stride) triangle
    list with u8 indices and u8 COLOR_0; a triangle strip (u16 indices, no
    normals or tangents, float RGB COLOR_0); a fan without indices and u16
    COLOR_0; a two-primitive mesh (one MASK material with
    KHR_texture_transform on every map); nodes with TRS, a matrix, children
    and one without a mesh."""
    rng = np.random.default_rng(7)
    blob, views, accessors = bytearray(), [], []

    def add(arr, gltf_type, component, stride=None, raw=None):
        while len(blob) % 4:
            blob.append(0)
        data = raw if raw is not None else np.ascontiguousarray(arr).tobytes()
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(data),
                      **({"byteStride": stride} if stride else {})})
        blob.extend(data)
        accessors.append({"bufferView": len(views) - 1, "componentType": component,
                          "count": int(arr.shape[0]), "type": gltf_type})
        return len(accessors) - 1

    def vec(n, k):
        return rng.uniform(-1, 1, (n, k)).astype(np.float32)

    # interleaved position + normal (stride 24), both accessors in one view
    n0 = 6
    inter = np.concatenate([vec(n0, 3), vec(n0, 3)], 1)
    pos0 = add(inter, "VEC3", 5126, stride=24, raw=inter.tobytes())
    nrm0 = dict(accessors[pos0], byteOffset=12)
    accessors.append(nrm0)
    nrm0 = len(accessors) - 1
    prim0 = {"attributes": {"POSITION": pos0, "NORMAL": nrm0,
                            "TEXCOORD_0": add(vec(n0, 2), "VEC2", 5126),
                            "TANGENT": add(np.concatenate([vec(n0, 3), np.ones((n0, 1), np.float32)], 1),
                                           "VEC4", 5126),
                            "COLOR_0": add(rng.integers(0, 256, (n0, 4), dtype=np.uint8),
                                           "VEC4", 5121)},
             "indices": add(np.array([0, 1, 2, 3, 4, 5, 5, 4, 3], np.uint8), "SCALAR", 5121),
             "material": 0}
    n1 = 7
    prim1 = {"attributes": {"POSITION": add(vec(n1, 3), "VEC3", 5126),
                            "TEXCOORD_0": add(vec(n1, 2), "VEC2", 5126),
                            "COLOR_0": add(vec(n1, 3) * 0.5 + 0.5, "VEC3", 5126)},
             "indices": add(np.arange(n1, dtype=np.uint16)[::-1].copy(), "SCALAR", 5123),
             "mode": 5, "material": 1}
    n2 = 6
    prim2 = {"attributes": {"POSITION": add(vec(n2, 3), "VEC3", 5126),
                            "COLOR_0": add(rng.integers(0, 65536, (n2, 4), dtype=np.uint16),
                                           "VEC4", 5123)},
             "mode": 6}
    n3 = 4
    quad = {"POSITION": add(vec(n3, 3), "VEC3", 5126), "NORMAL": add(vec(n3, 3), "VEC3", 5126),
            "TEXCOORD_0": add(vec(n3, 2), "VEC2", 5126)}
    prims3 = [{"attributes": quad, "indices": add(np.array([0, 1, 2], np.uint32), "SCALAR", 5125),
               "material": 2},
              {"attributes": quad, "indices": add(np.array([0, 2, 3], np.uint32), "SCALAR", 5125),
               "material": 0}]
    khr = {"KHR_texture_transform": {"offset": [0.1, 0.2], "scale": [3, 4], "rotation": 0.5}}
    materials = [
        {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                  "baseColorFactor": [0.5, 0.6, 0.7, 0.8],
                                  "metallicFactor": 0.3, "roughnessFactor": 0.4,
                                  "metallicRoughnessTexture": {"index": 1}},
         "normalTexture": {"index": 2}, "emissiveTexture": {"index": 3},
         "emissiveFactor": [1, 0.5, 0.25]},
        {"pbrMetallicRoughness": {"baseColorFactor": [0.2, 0.3, 0.4]}},
        {"alphaMode": "MASK", "alphaCutoff": 0.25,
         "pbrMetallicRoughness": {"baseColorTexture": {"index": 0, "extensions": khr},
                                  "metallicRoughnessTexture": {"index": 1, "extensions": khr}},
         "normalTexture": {"index": 2, "extensions": khr}},
    ]
    images = [{"uri": f"../Textures/t{i}%20x.png"} for i in range(4)]
    nodes = [
        {"name": "root", "translation": [1, 2, 3], "rotation": [0.1, 0.2, 0.3, 0.927],
         "scale": [1, 2, 0.5], "mesh": 0, "children": [1, 3]},
        {"name": "child", "matrix": [1, 0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 0, 4, 5, 6, 1],
         "mesh": 1, "children": [2]},
        {"mesh": 2},
        {"name": "empty", "children": [4]},
        {"name": "two_prims", "mesh": 3, "scale": [2, 2, 2]},
    ]
    doc = {"asset": {"version": "2.0"}, "nodes": nodes,
           "meshes": [{"name": "m0", "primitives": [prim0]}, {"name": "m1", "primitives": [prim1]},
                      {"primitives": [prim2]}, {"name": "m3", "primitives": prims3}],
           "materials": materials, "textures": [{"source": i} for i in range(4)],
           "images": images, "bufferViews": views, "accessors": accessors}
    if with_scene:
        doc.update(scene=0, scenes=[{"nodes": [0]}])
    (tmp_path / "Models").mkdir(exist_ok=True)
    if embed:
        uri = "data:application/octet-stream;base64," + base64.b64encode(bytes(blob)).decode()
    else:
        (tmp_path / "Models" / "buf 0.bin").write_bytes(bytes(blob))
        uri = "buf%200.bin"
    doc["buffers"] = [{"uri": uri, "byteLength": len(blob)}]
    path = tmp_path / "Models" / "test.gltf"
    path.write_text(json.dumps(doc))
    return path


@pytest.mark.parametrize("embed", [False, True], ids=["external_bin", "data_uri"])
@pytest.mark.parametrize("with_scene", [True, False], ids=["scene", "roots"])
def test_load_gltf_matches_reference(tmp_path, embed, with_scene):
    path = _gltf(tmp_path, embed, with_scene)
    got, want = tgltf.load_gltf(path), jgltf.load_gltf(path)
    same(got, want)
    assert len(want.meshes) == 4 and len(want.nodes) == 4
    assert [p.index_count for p in want.meshes[1].primitives] == [15]  # strip: 5 triangles


@pytest.mark.parametrize("embed", [False, True], ids=["external_bin", "data_uri"])
def test_build_scene_matches_reference(tmp_path, embed):
    """Two scene models over the test glTF (one moved, rotated, scaled,
    hidden, with a base-colour override), missing attributes generated."""
    _gltf(tmp_path, embed)
    (tmp_path / "Scenes").mkdir()
    scene = tmp_path / "Scenes" / "s.json"
    scene.write_text(json.dumps({"models": [
        {"path": "Models/test.gltf"},
        {"path": "models/TEST.gltf", "translate": [1, 0, 2], "rotate_euler": [10, 80, 5],
         "scale": [1, 3, 1], "visible": False, "texture": "Textures/over.png"},
        {"path": "Models/missing.gltf"}]}))
    got, want = tbuild.build_scene(scene), jbuild.build_scene(scene)
    same(got, want)
    assert want.num_models == 10  # 4 nodes with meshes, one of two primitives, twice


@pytest.mark.parametrize("kw", [dict(masked=True, emissive=True, texture_transform=True),
                                dict(embed_buffer=True), dict(n_materials=1, ground=False)],
                         ids=["masked_emissive_khr", "embedded", "one_material"])
def test_written_scene_builds_as_reference(tmp_path, kw):
    """The scene writer's files (``render/testing.py write_scene``) through
    both ``build_scene``s, and the reference's SceneData equal to the
    synthetic scene's geometry they were written from."""
    path = write_scene(tmp_path, 6, tex_size=32, **kw)
    got, want = tbuild.build_scene(path), jbuild.build_scene(path)
    same(got, want)
    from unclerenderer_tpu_torch.render.testing import synthetic_scene_data

    src = synthetic_scene_data(6, ground=kw.get("ground", True))
    assert want.num_triangles == src.num_triangles
    np.testing.assert_allclose(want.position, src.position, rtol=0, atol=1e-5)
    assert ((want.alpha_mode == 1).sum() > 0) == bool(kw.get("masked"))


def test_headline_scene_counts(tmp_path):
    """The headline's geometry written as glTF: 342 models, 263,184
    triangles (the synthetic headline scene's counts)."""
    path = write_scene(tmp_path, 340, sphere_res=(32, 24), tex_size=8, env_size=4)
    data = tbuild.build_scene(path)
    assert (data.num_models, data.num_triangles) == (342, 263184)


# ---------------------------------------------------------------------- PNG


def _filter_row(f, row, prev, bpp):
    out = np.zeros_like(row, dtype=np.int64)
    r, p = row.astype(np.int64), prev.astype(np.int64)
    for x in range(len(r)):
        a = r[x - bpp] if x >= bpp else 0
        b = p[x]
        c = p[x - bpp] if x >= bpp else 0
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) >> 1
        else:
            pp = a + b - c
            pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[x] = (r[x] - pred) & 0xFF
    return out.astype(np.uint8)


def _png(width, height, depth, ctype, filt, seed, trns=False):
    """PNG bytes of random samples; ``filt`` a filter type for every row, or
    "mixed" to cycle 0-4 row by row."""
    rng = np.random.default_rng(seed)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bits = width * ch * depth
    stride = (bits + 7) // 8
    bpp = max(1, ch * depth // 8)
    hi = (1 << depth) if ctype != 3 else min(1 << depth, 5)
    if depth < 8:
        samples = rng.integers(0, hi, (height, width * ch))
        raw = np.zeros((height, stride), np.uint8)
        for y in range(height):
            acc = 0
            for s in samples[y]:
                acc = (acc << depth) | int(s)
            acc <<= stride * 8 - bits
            raw[y] = np.frombuffer(acc.to_bytes(stride, "big"), np.uint8)
    else:
        top = 256 if ctype != 3 else 5
        raw = rng.integers(0, top, (height, stride)).astype(np.uint8)
    rows, prev = [], np.zeros(stride, np.uint8)
    for y in range(height):
        f = y % 5 if filt == "mixed" else filt
        rows.append(bytes([f]) + _filter_row(f, raw[y], prev, bpp).tobytes())
        prev = raw[y]

    def chunk(t, p):
        return struct.pack(">I", len(p)) + t + p + struct.pack(">I", zlib.crc32(t + p))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                                          ctype, 0, 0, 0))
    if ctype == 3:
        out += chunk(b"PLTE", rng.integers(0, 256, 15, dtype=np.uint8).tobytes())
        if trns:
            out += chunk(b"tRNS", bytes([0, 128, 255]))
    data = zlib.compress(b"".join(rows))
    out += chunk(b"IDAT", data[:7]) + chunk(b"IDAT", data[7:]) + chunk(b"IEND", b"")
    return out


PNG_CASES = ([(8, ct, f, False) for ct in (0, 2, 3, 4, 6) for f in (0, 1, 2, 3, 4, "mixed")]
             + [(16, ct, "mixed", False) for ct in (0, 2, 4, 6)]
             + [(d, ct, "mixed", False) for d in (1, 2, 4) for ct in (0, 3)]
             + [(8, 3, "mixed", True), (4, 3, "mixed", True)])


@pytest.mark.parametrize("depth,ctype,filt,trns", PNG_CASES,
                         ids=[f"d{d}-c{c}-f{f}" + ("-trns" if t else "") for d, c, f, t in PNG_CASES])
def test_load_png_matches_reference(tmp_path, depth, ctype, filt, trns):
    path = tmp_path / "t.png"
    path.write_bytes(_png(7, 5, depth, ctype, filt, seed=depth * 31 + ctype, trns=trns))
    got, want = tpng.load_png(path), jpng.load_png(path)
    assert want is not None and want.shape == (5, 7, 4)
    same(got, want)


@pytest.mark.parametrize("bpp,stride", [(1, 7), (3, 21), (4, 28), (8, 56), (2, 3)])
def test_png_unfilter_native_matches_numpy(bpp, stride):
    rng = np.random.default_rng(bpp)
    rows = [bytes([y % 5]) + rng.integers(0, 256, stride, dtype=np.uint8).tobytes()
            for y in range(9)]
    raw = b"".join(rows)
    native = tnative.png_unfilter(raw, 9, stride, bpp)
    assert native is not None, tnative.build_info
    same(native, tpng._unfilter_python(raw, 9, stride, bpp))


@pytest.mark.parametrize("shape", [(5, 7, 3), (1, 1, 3), (16, 9, 4)])
def test_save_png_round_trips_through_load_png(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "o.png"
    if shape[2] == 3:
        tpng.save_png(path, img)
    else:
        path.write_bytes(tpng.encode_png(img))
    back = tpng.load_png(path)
    same(back[..., :shape[2]], img)
    if shape[2] == 3:
        assert (back[..., 3] == 255).all()
    same(jpng.load_png(path), back)


def test_native_library_is_built_from_the_sources_into_the_build_dir():
    assert tnative.get_native() is not None, tnative.build_info
    assert tnative.build_info["path"] == str(tnative.library_path())
    assert tnative.library_path().parent.name == "_build"
    assert tnative.library_path().parent.parent.name == "unclerenderer_tpu_torch"


# ---------------------------------------------------------------------- DDS


def _dds_case(kind, rng):
    """(bytes) of a DDS file in format ``kind``."""
    def mips(w, h, make):
        out = []
        while True:
            out.append(make(w, h))
            if w == 1 and h == 1:
                return out
            w, h = max(1, w // 2), max(1, h // 2)

    def blocks(kind_bytes):
        return lambda w, h: rng.integers(0, 256, ((w + 3) // 4) * ((h + 3) // 4) * kind_bytes,
                                         dtype=np.uint8).tobytes()

    u8 = lambda w, h: rng.integers(0, 256, (h, w, 4), dtype=np.uint8)  # noqa: E731
    if kind == "rgba8":
        return encode_dds([mips(8, 4, u8)], 28, 8, 4, legacy=True)
    if kind == "rgba8_dx10":
        return encode_dds([mips(4, 4, u8)], 29, 4, 4)
    if kind == "bgra8":
        return encode_dds([mips(4, 8, u8)], 87, 4, 8, legacy=True)
    if kind == "rgba16f_cube":
        return encode_dds([mips(8, 8, lambda w, h: rng.normal(0, 4, (h, w, 4)).astype(np.float16))
                           for _ in range(6)], 10, 8, 8, cube=True)
    if kind == "rgba32f":
        return encode_dds([mips(4, 2, lambda w, h: rng.normal(0, 4, (h, w, 4)).astype(np.float32))],
                          2, 4, 2)
    if kind == "r32f":
        return encode_dds([[rng.normal(0, 1, (3, 5)).astype(np.float32)]], 41, 5, 3)
    if kind == "rg16":
        return encode_dds([[rng.integers(0, 65536, (4, 6, 2), dtype=np.uint16)]], 35, 6, 4,
                          legacy=True)
    if kind == "bc1":
        return encode_dds([mips(6, 5, blocks(8))], 71, 6, 5, legacy=True)
    if kind == "bc3":
        return encode_dds([mips(8, 8, blocks(16))], 77, 8, 8)
    if kind == "bc4":
        return encode_dds([mips(4, 4, blocks(8))], 80, 4, 4, legacy=True)
    if kind == "bc5":
        return encode_dds([mips(12, 4, blocks(16))], 83, 12, 4)
    if kind == "truncated":
        return encode_dds([mips(8, 4, u8)], 28, 8, 4)[:-10]
    raise ValueError(kind)


DDS_KINDS = ["rgba8", "rgba8_dx10", "bgra8", "rgba16f_cube", "rgba32f", "r32f", "rg16", "bc1",
             "bc3", "bc4", "bc5", "truncated"]


@pytest.mark.parametrize("kind", DDS_KINDS)
def test_load_dds_matches_reference(tmp_path, kind):
    path = tmp_path / "t.dds"
    path.write_bytes(_dds_case(kind, np.random.default_rng(len(kind))))
    got, want = tdds.load_dds(path), jdds.load_dds(path)
    same(got, want)
    assert (want is None) == (kind == "truncated")


@pytest.mark.parametrize("kind", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("size", [(8, 8), (6, 5), (1, 1), (13, 7)])
def test_bc_native_matches_numpy(kind, size):
    """BC1-5: the native decoder and the numpy fallback byte-equal (the
    reference's ladder: native first, numpy without the library)."""
    w, h = size
    rng = np.random.default_rng(kind * 100 + w)
    data = rng.integers(0, 256, ((w + 3) // 4) * ((h + 3) // 4) * tdds._BLOCK_BYTES[kind],
                        dtype=np.uint8).tobytes()
    native = tnative.bc_decode(data, w, h, kind)
    assert native is not None, tnative.build_info
    same(native, tdds._decode_bc_numpy(data, w, h, kind))
    same(native, jdds._decode_bc_numpy(data, w, h, kind))


# ------------------------------------------------------ images and the cache


def _image_files(tmp_path):
    rng = np.random.default_rng(3)
    (tmp_path / "a.png").write_bytes(tpng.encode_png(rng.integers(0, 256, (8, 16, 4), np.uint8)))
    (tmp_path / "b.dds").write_bytes(_dds_case("rgba8", rng))
    (tmp_path / "c.dds").write_bytes(_dds_case("rgba32f", rng))
    (tmp_path / "d.dds").write_bytes(encode_dds([[rng.integers(0, 256, (4, 4, 4), np.uint8)]],
                                                28, 4, 4))  # one mip: the chain is extended
    from PIL import Image

    Image.fromarray(rng.integers(0, 256, (8, 8, 3), np.uint8)).save(tmp_path / "e.jpg")
    (tmp_path / "f.tga").write_bytes(b"")
    return ["a.png", "b.dds", "c.dds", "d.dds", "e.jpg", "f.tga", "missing.png"]


@pytest.mark.parametrize("srgb", [False, True])
def test_load_image_matches_reference(tmp_path, srgb):
    for name in _image_files(tmp_path):
        same(timage.load_image(tmp_path / name, srgb=srgb),
             jimage.load_image(tmp_path / name, srgb=srgb), name)


def test_texture_cache_matches_reference(tmp_path):
    names = _image_files(tmp_path)
    got, want = timage.TextureCache(), jimage.TextureCache()
    for name in names + names[:2]:
        for srgb in (False, True):
            p = str(tmp_path / name)
            same(got.load_or_default(p, srgb), want.load_or_default(p, srgb), name)
            same(got.load_or_solid(p, [0.1, 0.2, 0.3, 1.0], srgb),
                 want.load_or_solid(p, [0.1, 0.2, 0.3, 1.0], srgb), name)
    same(got.load_or_default(""), want.load_or_default(""))
    assert got.substitutions == want.substitutions == [str(tmp_path / "f.tga"),
                                                       str(tmp_path / "missing.png")]


def test_jpeg_without_pil_is_substituted(tmp_path, monkeypatch):
    """Without PIL (the card's machine has none) a JPEG falls back to the
    default grid and is recorded in ``substitutions``, as the reference's
    ladder does."""
    _image_files(tmp_path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    cache = timage.TextureCache()
    mips = cache.load_or_default(str(tmp_path / "e.jpg"), srgb=True)
    same(mips, jimage.TextureCache().load_or_default("", srgb=True))
    assert cache.substitutions == [str(tmp_path / "e.jpg")]


# ----------------------------------------------------------- font and maths


def test_ttf_bake_matches_reference():
    got, want = tfont.bake_font(18.0), jfont.bake_font(18.0)
    assert (got is None) == (want is None)
    if want is not None:
        same(got.atlas, want.atlas)
        same(got.glyphs, want.glyphs)
        assert (got.pixel_height, got.ascent_px) == (want.pixel_height, want.ascent_px)


def _math_cases():
    rng = np.random.default_rng(1)
    v = rng.standard_normal((4, 3)).astype(np.float32)
    vp = (tm.look_at_lh([0, 1.5, -4], [0, 0, 3], [0, 1, 0])
          @ tm.perspective_reverse_z_infinite(np.radians(60.0), 16 / 9, 0.1))
    planes = tm.frustum_planes_from_view_proj(vp)
    return {
        "identity": [()],
        "scaling": [(2.0,), ([1.0, 2.0, 3.0],)],
        "rotation_x": [(0.3,), (-2.0,)],
        "rotation_z": [(1.1,)],
        "rotation_roll_pitch_yaw": [(0.1, 0.2, 0.3), (np.float32(1.5), 0.0, -0.7)],
        "quaternion_to_matrix": [((0.1, 0.2, 0.3, 0.927),), (v[0].tolist() + [0.5],)],
        "frustum_planes_from_view_proj": [(vp,)],
        "aabb_vs_frustum": [(planes, [-1, -1, 2], [1, 1, 4]), (planes, [50, 50, 50], [51, 51, 51]),
                            (planes, [-1, -1, -9], [1, 1, -8])],
        "halton": [(0, 2), (1, 2), (7, 3), (123, 5)],
        "taa_jitter": [(0,), (5,), (17,)],
        "jittered_projection": [(vp, tm.taa_jitter(3), 1920, 1080)],
        "direction_from_euler_degrees": [([30, 45, 0],), (v[1],)],
        "forward_from_pitch_yaw": [(0.3, 1.2), (-1.0, 0.0)],
        "light_vector_from_scene_direction": [([0.4, -0.8, 0.3],), (v[2],)],
        "linear_to_srgb": [(rng.uniform(-0.2, 1.2, (64, 3)).astype(np.float32),)],
    }


@pytest.mark.parametrize("name", sorted(_math_cases()))
def test_added_mathlib_functions_match_reference(name):
    for args in _math_cases()[name]:
        same(getattr(tm, name)(*args), getattr(jm, name)(*args), name)
