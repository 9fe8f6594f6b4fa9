"""glTF 2.0 loader (``unclerenderer_tpu/scene/gltf.py``) producing SoA
numpy vertex and index arrays, with the D3D12 renderer's semantics
(``GltfLoader.cpp``):

* attributes POSITION / NORMAL / TEXCOORD_0 / TANGENT / COLOR_0 with byte
  strides; u8/u16/u32 indices; TRIANGLES / STRIP / FAN modes;
* pbrMetallicRoughness materials (baseColor / metallicRoughness / normal /
  emissive textures and factors, alphaMode MASK and its cutoff,
  KHR_texture_transform);
* right- to left-handed conversion: position and normal z negated, tangent
  z and w negated, node matrices conjugated by mirror-Z;
* node hierarchy TRS -> world matrices, scene traversal;
* base64 ``data:`` URI and external buffers.

Matrices returned are row-vector convention (see ``mathlib``).
"""

from __future__ import annotations

import base64
import dataclasses
import json
import urllib.parse
from pathlib import Path

import numpy as np

from ..core.logging import log_error, log_warning

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


@dataclasses.dataclass
class TextureTransform:
    offset: tuple = (0.0, 0.0)
    scale: tuple = (1.0, 1.0)
    rotation: float = 0.0

    def offset_scale(self) -> np.ndarray:
        return np.array([*self.offset, *self.scale], dtype=np.float32)

    def rotation_vec(self) -> np.ndarray:
        return np.array(
            [np.cos(self.rotation), np.sin(self.rotation), 0.0, 0.0], dtype=np.float32
        )


@dataclasses.dataclass
class GltfMaterial:
    base_color_texture: str = ""
    metallic_roughness_texture: str = ""
    normal_texture: str = ""
    emissive_texture: str = ""
    base_color_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )
    base_color_alpha: float = 1.0
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    emissive_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    alpha_mask: bool = False
    alpha_cutoff: float = 0.5
    base_color_transform: TextureTransform = dataclasses.field(default_factory=TextureTransform)
    metallic_roughness_transform: TextureTransform = dataclasses.field(default_factory=TextureTransform)
    normal_transform: TextureTransform = dataclasses.field(default_factory=TextureTransform)
    emissive_transform: TextureTransform = dataclasses.field(default_factory=TextureTransform)


@dataclasses.dataclass
class GltfPrimitive:
    index_start: int = 0
    index_count: int = 0
    material: GltfMaterial = dataclasses.field(default_factory=GltfMaterial)


@dataclasses.dataclass
class GltfMesh:
    position: np.ndarray = None  # (N, 3) f32
    normal: np.ndarray = None    # (N, 3) f32
    uv: np.ndarray = None        # (N, 2) f32
    tangent: np.ndarray = None   # (N, 4) f32, w = handedness
    color: np.ndarray = None     # (N, 4) f32
    indices: np.ndarray = None   # (M,) u32, M % 3 == 0
    primitives: list = dataclasses.field(default_factory=list)
    name: str = ""


@dataclasses.dataclass
class GltfNode:
    mesh_index: int = -1
    world: np.ndarray = None  # (4, 4) f32, row-vector convention
    name: str = ""


@dataclasses.dataclass
class GltfScene:
    meshes: list = dataclasses.field(default_factory=list)
    nodes: list = dataclasses.field(default_factory=list)


def _decode_uri(uri: str, base_dir: Path) -> bytes | None:
    if uri.startswith("data:"):
        comma = uri.find(",")
        if comma < 0:
            return None
        meta, payload = uri[5:comma], uri[comma + 1 :]
        if meta.endswith(";base64"):
            return base64.b64decode(payload)
        return urllib.parse.unquote_to_bytes(payload)
    path = base_dir / urllib.parse.unquote(uri)
    try:
        return path.read_bytes()
    except OSError as e:
        log_error(f"Failed to read glTF buffer {path}: {e}")
        return None


def _read_accessor(doc: dict, buffers: list, accessor_index: int) -> np.ndarray | None:
    """Decode one accessor into a dense (count, ncomp) array (native dtype)."""
    if accessor_index is None or accessor_index < 0:
        return None
    acc = doc["accessors"][accessor_index]
    count = int(acc.get("count", 0))
    if count <= 0:
        return None
    dtype = np.dtype(_COMPONENT_DTYPES[acc.get("componentType", 5126)])
    ncomp = _TYPE_COUNTS[acc.get("type", "SCALAR")]
    bv_index = acc.get("bufferView")
    if bv_index is None:
        return np.zeros((count, ncomp), dtype=dtype)
    bv = doc["bufferViews"][bv_index]
    data = buffers[bv.get("buffer", 0)]
    offset = int(acc.get("byteOffset", 0)) + int(bv.get("byteOffset", 0))
    tight = dtype.itemsize * ncomp
    stride = int(bv.get("byteStride", tight) or tight)
    if stride == tight:
        if offset + count * ncomp * dtype.itemsize > len(data):
            log_warning("glTF accessor out of buffer range; skipping")
            return None
        out = np.frombuffer(data, dtype=dtype, count=count * ncomp, offset=offset)
        return out.reshape(count, ncomp)
    if offset + (count - 1) * stride + tight > len(data):
        log_warning("glTF strided accessor out of buffer range; skipping")
        return None
    raw = np.frombuffer(data, dtype=np.uint8)
    view = np.lib.stride_tricks.as_strided(
        raw[offset:], shape=(count, tight), strides=(stride, 1), writeable=False
    )
    return view.copy().view(dtype).reshape(count, ncomp)


def _to_float_color(arr: np.ndarray) -> np.ndarray:
    if arr.dtype == np.float32:
        return arr
    if arr.dtype == np.uint8:
        return (arr.astype(np.float32) / 255.0).astype(np.float32)
    if arr.dtype == np.uint16:
        return (arr.astype(np.float32) / 65535.0).astype(np.float32)
    return arr.astype(np.float32)


def _texture_transform(tex_info: dict | None) -> TextureTransform:
    t = TextureTransform()
    if not tex_info:
        return t
    src = tex_info.get("extensions", {}).get("KHR_texture_transform", tex_info)
    off = src.get("offset")
    if off:
        t.offset = (float(off[0]), float(off[1]))
    sc = src.get("scale")
    if sc:
        t.scale = (float(sc[0]), float(sc[1]))
    t.rotation = float(src.get("rotation", 0.0))
    return t


def _texture_path(doc: dict, base_dir: Path, tex_info: dict | None) -> str:
    if not tex_info:
        return ""
    tex_index = tex_info.get("index", -1)
    if tex_index < 0:
        return ""
    textures = doc.get("textures", [])
    images = doc.get("images", [])
    if tex_index >= len(textures):
        return ""
    img_index = textures[tex_index].get("source", -1)
    if img_index < 0 or img_index >= len(images):
        return ""
    uri = images[img_index].get("uri", "")
    if not uri:
        return ""
    return str(base_dir / urllib.parse.unquote(uri))


def _parse_material(doc: dict, base_dir: Path, mat_index: int) -> GltfMaterial:
    mat = GltfMaterial()
    materials = doc.get("materials", [])
    if mat_index is None or mat_index < 0 or mat_index >= len(materials):
        return mat
    src = materials[mat_index]
    pbr = src.get("pbrMetallicRoughness", {})
    bct = pbr.get("baseColorTexture")
    mat.base_color_texture = _texture_path(doc, base_dir, bct)
    mat.base_color_transform = _texture_transform(bct)
    bcf = pbr.get("baseColorFactor")
    if bcf:
        mat.base_color_factor = np.asarray(bcf[:3], np.float32)
        if len(bcf) > 3:
            mat.base_color_alpha = float(bcf[3])
    mat.metallic_factor = float(pbr.get("metallicFactor", 1.0))
    mat.roughness_factor = float(pbr.get("roughnessFactor", 1.0))
    mrt = pbr.get("metallicRoughnessTexture")
    mat.metallic_roughness_texture = _texture_path(doc, base_dir, mrt)
    mat.metallic_roughness_transform = _texture_transform(mrt)
    nt = src.get("normalTexture")
    mat.normal_texture = _texture_path(doc, base_dir, nt)
    mat.normal_transform = _texture_transform(nt)
    et = src.get("emissiveTexture")
    mat.emissive_texture = _texture_path(doc, base_dir, et)
    mat.emissive_transform = _texture_transform(et)
    ef = src.get("emissiveFactor")
    if ef:
        mat.emissive_factor = np.asarray(ef[:3], np.float32)
    if src.get("alphaMode") == "MASK":
        mat.alpha_mask = True
        mat.alpha_cutoff = float(src.get("alphaCutoff", 0.5))
    return mat


def _strip_fan_to_triangles(idx: np.ndarray, mode: int) -> np.ndarray:
    """TRIANGLE_STRIP / TRIANGLE_FAN expansion (``GltfLoader.cpp:947-987``)."""
    if mode == 4:
        return idx[: (idx.size // 3) * 3]
    if idx.size < 3:
        return np.zeros(0, np.uint32)
    n = idx.size - 2
    tris = np.empty((n, 3), np.uint32)
    if mode == 5:  # strip; odd triangles swap first two indices
        i = np.arange(n)
        even = (i % 2) == 0
        tris[:, 0] = np.where(even, idx[i], idx[i + 1])
        tris[:, 1] = np.where(even, idx[i + 1], idx[i])
        tris[:, 2] = idx[i + 2]
    elif mode == 6:  # fan
        tris[:, 0] = idx[0]
        tris[:, 1] = idx[1:-1]
        tris[:, 2] = idx[2:]
    else:
        return np.zeros(0, np.uint32)
    return tris.reshape(-1)


# --- node transform helpers (column-vector internally, like the reference's
# FMatrix4; transposed to row-vector at the end, like ToFloat4x4) ---

_MIRROR_Z = np.diag([1.0, 1.0, -1.0, 1.0]).astype(np.float32)


def _quat_matrix_cv(x, y, z, w) -> np.ndarray:
    """Column-vector rotation matrix for quaternion (x,y,z,w)."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 1 - 2 * (y * y + z * z)
    m[0, 1] = 2 * (x * y - z * w)
    m[0, 2] = 2 * (x * z + y * w)
    m[1, 0] = 2 * (x * y + z * w)
    m[1, 1] = 1 - 2 * (x * x + z * z)
    m[1, 2] = 2 * (y * z - x * w)
    m[2, 0] = 2 * (x * z - y * w)
    m[2, 1] = 2 * (y * z + x * w)
    m[2, 2] = 1 - 2 * (x * x + y * y)
    return m


def _node_local_matrix_cv(node: dict) -> np.ndarray:
    if "matrix" in node:
        # glTF stores column-major with column vectors.
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T.copy()
    t = node.get("translation", (0.0, 0.0, 0.0))
    r = node.get("rotation", (0.0, 0.0, 0.0, 1.0))
    s = node.get("scale", (1.0, 1.0, 1.0))
    tm = np.eye(4, dtype=np.float32)
    tm[:3, 3] = t
    sm = np.diag([s[0], s[1], s[2], 1.0]).astype(np.float32)
    rm = _quat_matrix_cv(*[float(v) for v in r])
    return tm @ rm @ sm  # T * R * S, column-vector (GltfLoader.cpp:495)


def load_gltf(path: str | Path) -> GltfScene | None:
    """Load a .gltf (JSON + external/base64 buffers) into a GltfScene."""
    p = Path(path)
    try:
        doc = json.loads(p.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        log_error(f"Failed to parse glTF {p}: {e}")
        return None
    base_dir = p.parent

    buffers: list[bytes] = []
    for buf in doc.get("buffers", []):
        data = _decode_uri(buf.get("uri", ""), base_dir) or b""
        buffers.append(data)
    if not buffers:
        log_error(f"glTF has no buffers: {p}")
        return None

    scene = GltfScene()
    for mesh_src in doc.get("meshes", []):
        mesh = GltfMesh(name=mesh_src.get("name", ""))
        pos_parts, nrm_parts, uv_parts, tan_parts, col_parts = [], [], [], [], []
        idx_parts: list[np.ndarray] = []
        vertex_offset = 0
        index_offset = 0
        for prim in mesh_src.get("primitives", []):
            attrs = prim.get("attributes", {})
            pos = _read_accessor(doc, buffers, attrs.get("POSITION", -1))
            idx = _read_accessor(doc, buffers, prim.get("indices", -1))
            if pos is None:
                continue
            pos = pos.astype(np.float32)
            n = pos.shape[0]
            if idx is None:
                idx = np.arange(n, dtype=np.uint32).reshape(-1, 1)
            idx = idx.reshape(-1).astype(np.uint32)
            idx = _strip_fan_to_triangles(idx, int(prim.get("mode", 4)))
            if idx.size == 0:
                continue

            nrm = _read_accessor(doc, buffers, attrs.get("NORMAL", -1))
            nrm = (
                nrm.astype(np.float32)
                if nrm is not None
                else np.tile(np.array([[0, 0, 1]], np.float32), (n, 1))
            )
            uv = _read_accessor(doc, buffers, attrs.get("TEXCOORD_0", -1))
            uv = uv.astype(np.float32)[:, :2] if uv is not None else np.zeros((n, 2), np.float32)
            tan = _read_accessor(doc, buffers, attrs.get("TANGENT", -1))
            tan = (
                tan.astype(np.float32)
                if tan is not None
                else np.tile(np.array([[0, 0, 0, 1]], np.float32), (n, 1))
            )
            col = _read_accessor(doc, buffers, attrs.get("COLOR_0", -1))
            if col is not None:
                col = _to_float_color(col)
                if col.shape[1] == 3:
                    col = np.concatenate([col, np.ones((n, 1), np.float32)], axis=1)
            else:
                col = np.ones((n, 4), np.float32)

            # RH -> LH (GltfLoader.cpp:823,840,857-858)
            pos = pos.copy()
            pos[:, 2] = -pos[:, 2]
            nrm = nrm.copy()
            nrm[:, 2] = -nrm[:, 2]
            tan = tan.copy()
            tan[:, 2] = -tan[:, 2]
            tan[:, 3] = -tan[:, 3]

            pos_parts.append(pos)
            nrm_parts.append(nrm)
            uv_parts.append(uv)
            tan_parts.append(tan)
            col_parts.append(col)
            idx_parts.append(idx + np.uint32(vertex_offset))

            material = _parse_material(doc, base_dir, prim.get("material", -1))
            mesh.primitives.append(
                GltfPrimitive(index_start=index_offset, index_count=int(idx.size), material=material)
            )
            vertex_offset += n
            index_offset += int(idx.size)

        if not pos_parts:
            log_warning(f"glTF mesh with no usable primitives in {p}")
            continue
        mesh.position = np.concatenate(pos_parts, axis=0)
        mesh.normal = np.concatenate(nrm_parts, axis=0)
        mesh.uv = np.concatenate(uv_parts, axis=0)
        mesh.tangent = np.concatenate(tan_parts, axis=0)
        mesh.color = np.concatenate(col_parts, axis=0)
        mesh.indices = np.concatenate(idx_parts, axis=0)
        scene.meshes.append(mesh)

    # Node traversal (GltfLoader.cpp:557-593): world = parent @ (Mz @ local @ Mz)
    nodes_src = doc.get("nodes", [])

    def visit(node_index: int, parent_cv: np.ndarray) -> None:
        if node_index < 0 or node_index >= len(nodes_src):
            return
        node = nodes_src[node_index]
        local_lh = _MIRROR_Z @ _node_local_matrix_cv(node) @ _MIRROR_Z
        world_cv = parent_cv @ local_lh
        mesh_index = node.get("mesh", -1)
        if 0 <= mesh_index < len(scene.meshes):
            scene.nodes.append(
                GltfNode(
                    mesh_index=mesh_index,
                    world=world_cv.T.copy(),  # -> row-vector convention
                    name=node.get("name", ""),
                )
            )
        for child in node.get("children", []):
            visit(int(child), world_cv)

    scenes_src = doc.get("scenes", [])
    scene_index = int(doc.get("scene", 0)) if scenes_src else -1
    roots: list[int] = []
    if 0 <= scene_index < len(scenes_src):
        roots = [int(i) for i in scenes_src[scene_index].get("nodes", [])]
    elif nodes_src:
        referenced = {c for nd in nodes_src for c in nd.get("children", [])}
        roots = [i for i in range(len(nodes_src)) if i not in referenced]
    for root in roots:
        visit(root, np.eye(4, dtype=np.float32))

    return scene
