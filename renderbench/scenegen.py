"""The benchmark's scene generator: a Sponza-class scene made from the seed,
as data (``scene_content``: what the reference renders) and as the files
the Renderer loads (``write_scene``: scene JSON, glTF with its ``.bin``,
DDS maps with their mip chains, the env cube and the BRDF LUT).

Frozen copies of the port's generators (``unclerenderer_tpu_torch/render/
testing.py``: ``synthetic_scene_data``, ``_material_maps``, ``encode_dds``,
``env_cube_faces``, ``write_scene``; the meshes of ``scene/mesh.py`` and the
matrices of ``mathlib.py`` they use), with two departures: the material
maps take their random numbers from the run's seed (the port's seed each
material by its index alone), and the maps are written as RGBA8 DDS files
with their mip chains baked in, as Sponza's own texture set ships (the
glTF loader takes a ``.dds`` image; the port's writer writes PNG, whose
chains the loader generates).  ``tests/test_rb_generators.py`` holds the
copies to the port's.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from pathlib import Path

import numpy as np

DXGI_RGBA8 = 28


# ---------------------------------------------------------------------------
# meshes and matrices (row vectors, as the D3D12 renderer's)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Mesh:
    position: np.ndarray
    normal: np.ndarray
    uv: np.ndarray
    tangent: np.ndarray
    color: np.ndarray
    indices: np.ndarray


def create_cube(size: float = 1.0) -> Mesh:
    """24-vertex cube (``FMesh::CreateCube``)."""
    h = size * 0.5
    faces = [
        ([[h, -h, -h], [h, -h, h], [h, h, h], [h, h, -h]], [1, 0, 0], [0, 0, 1, 1]),
        ([[-h, -h, h], [-h, -h, -h], [-h, h, -h], [-h, h, h]], [-1, 0, 0], [0, 0, -1, 1]),
        ([[-h, h, -h], [h, h, -h], [h, h, h], [-h, h, h]], [0, 1, 0], [1, 0, 0, 1]),
        ([[-h, -h, h], [h, -h, h], [h, -h, -h], [-h, -h, -h]], [0, -1, 0], [1, 0, 0, 1]),
        ([[-h, -h, h], [-h, h, h], [h, h, h], [h, -h, h]], [0, 0, 1], [1, 0, 0, 1]),
        ([[h, -h, -h], [h, h, -h], [-h, h, -h], [-h, -h, -h]], [0, 0, -1], [-1, 0, 0, 1]),
    ]
    uvs_std = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    uvs_z = np.array([[0, 1], [0, 0], [1, 0], [1, 1]], np.float32)
    positions, normals, uvs, tangents = [], [], [], []
    for i, (pts, n, t) in enumerate(faces):
        positions.append(np.asarray(pts, np.float32))
        normals.append(np.tile(np.asarray(n, np.float32), (4, 1)))
        uvs.append(uvs_z if i >= 4 else uvs_std)
        tangents.append(np.tile(np.asarray(t, np.float32), (4, 1)))
    indices = []
    for f in range(6):
        b = f * 4
        indices += [b, b + 1, b + 2, b, b + 2, b + 3]
    return Mesh(np.concatenate(positions), np.concatenate(normals), np.concatenate(uvs),
                np.concatenate(tangents), np.ones((24, 4), np.float32),
                np.asarray(indices, np.uint32))


def create_sphere(radius: float = 1.0, slice_count: int = 32, stack_count: int = 16) -> Mesh:
    """UV sphere (``FMesh::CreateSphere``)."""
    slice_count = max(3, slice_count)
    stack_count = max(2, stack_count)
    v = np.arange(stack_count + 1, dtype=np.float32)[:, None] / stack_count
    u = np.arange(slice_count + 1, dtype=np.float32)[None, :] / slice_count
    phi = v * np.pi
    theta = u * 2.0 * np.pi
    sp, cp = np.sin(phi), np.cos(phi)
    st, ct = np.sin(theta), np.cos(theta)
    pos = np.stack([radius * sp * ct, radius * cp * np.ones_like(ct), radius * sp * st],
                   axis=-1).reshape(-1, 3).astype(np.float32)
    nrm = np.stack([sp * ct, cp * np.ones_like(ct), sp * st], axis=-1).reshape(-1, 3)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    tx = np.where(np.abs(sp) > 1e-4, -st * sp, 1.0) * np.ones_like(ct)
    tz = np.where(np.abs(sp) > 1e-4, ct * sp, 0.0)
    tan3 = np.stack([tx, np.zeros_like(tx), tz], axis=-1).reshape(-1, 3)
    tan3 /= np.maximum(np.linalg.norm(tan3, axis=1, keepdims=True), 1e-20)
    tan = np.concatenate([tan3, np.ones((tan3.shape[0], 1), np.float32)], axis=1)
    uv = np.stack([np.tile(u, (stack_count + 1, 1)), np.tile(v, (1, slice_count + 1))],
                  axis=-1).reshape(-1, 2)
    stacks = np.arange(stack_count, dtype=np.uint32)[:, None]
    slices = np.arange(slice_count, dtype=np.uint32)[None, :]
    a = stacks * (slice_count + 1) + slices
    b = a + slice_count + 1
    tris = np.stack([a, b, a + 1, a + 1, b, b + 1], axis=-1).reshape(-1).astype(np.uint32)
    return Mesh(pos, nrm.astype(np.float32), uv.astype(np.float32), tan.astype(np.float32),
                np.ones((pos.shape[0], 4), np.float32), tris)


def compute_mesh_bounds(mesh: Mesh):
    """(center, radius, bounds_min, bounds_max) (``RendererUtils::ComputeMeshBounds``)."""
    bmin = mesh.position.min(axis=0).astype(np.float32)
    bmax = mesh.position.max(axis=0).astype(np.float32)
    center = (bmin + bmax) * 0.5
    radius = float(np.max(np.linalg.norm(mesh.position - center, axis=1)))
    return center, max(radius, 1e-6), bmin, bmax


def translation(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = np.asarray(t, np.float32)
    return m


def rotation_y(a: float) -> np.ndarray:
    c, s = np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = c, -s
    m[2, 0], m[2, 2] = s, c
    return m


def transform_aabb(bounds_min, bounds_max, world: np.ndarray):
    """World-space AABB of a local AABB's 8 transformed corners."""
    bmin, bmax = np.asarray(bounds_min, np.float32), np.asarray(bounds_max, np.float32)
    corners = np.array([[x, y, z] for x in (bmin[0], bmax[0]) for y in (bmin[1], bmax[1])
                        for z in (bmin[2], bmax[2])], dtype=np.float32)
    pts = (np.concatenate([corners, np.ones((8, 1), np.float32)], axis=1) @ world)[:, :3]
    return pts.min(axis=0).astype(np.float32), pts.max(axis=0).astype(np.float32)


def default_grid_texture(size: int = 256, cells: int = 8) -> np.ndarray:
    """Checkerboard (``FTextureLoader::CreateDefaultGridTexture``)."""
    yy, xx = np.mgrid[0:size, 0:size]
    cell = size // cells
    checker = ((xx // cell) + (yy // cell)) % 2
    light = np.array([200, 200, 200, 255], np.float32) / 255.0
    dark = np.array([80, 80, 80, 255], np.float32) / 255.0
    return np.where(checker[..., None] == 0, light, dark).astype(np.float32)


def generate_mips(base: np.ndarray) -> list:
    """Full mip chain of a square power-of-two image by 2x2 box filter."""
    mips = [base.astype(np.float32)]
    cur = mips[0]
    while cur.shape[0] > 1:
        h, w = cur.shape[:2]
        cur = cur.reshape(h // 2, 2, w // 2, 2, -1).mean(axis=(1, 3)).astype(np.float32)
        mips.append(cur)
    return mips


@dataclasses.dataclass
class Material:
    base_color_factor: np.ndarray
    metallic_factor: float
    roughness_factor: float
    base_color_alpha: float = 1.0
    emissive_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))


@dataclasses.dataclass
class Model:
    name: str
    object_id: int
    world: np.ndarray
    center: np.ndarray
    radius: float
    bounds_min: np.ndarray
    bounds_max: np.ndarray
    visible: bool
    material: Material
    tri_start: int
    tri_count: int


class SceneData:
    """The generated scene's flat arrays, de-indexed (vertex i of triangle t
    at row 3t + i), in world space; ``_finish`` fills them."""

    def __init__(self):
        self.models: list = []
        self.texture_paths: list = []


def _append_mesh(parts, mesh, world, normalize_normals):
    pos_parts, nrm_parts, tan_parts, uv_parts, col_parts = parts
    hom = np.concatenate([mesh.position, np.ones((mesh.position.shape[0], 1), np.float32)], 1)
    pos_parts.append((hom @ world)[:, :3].astype(np.float32))
    nrm = mesh.normal @ world[:3, :3]
    if normalize_normals:
        nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    nrm_parts.append(nrm.astype(np.float32))
    t3 = mesh.tangent[:, :3] @ world[:3, :3]
    t3 /= np.maximum(np.linalg.norm(t3, axis=1, keepdims=True), 1e-20)
    tan_parts.append(np.concatenate([t3, mesh.tangent[:, 3:4]], 1).astype(np.float32))
    uv_parts.append(mesh.uv)
    col_parts.append(mesh.color)


def synthetic_scene_data(n_objects: int = 4, seed: int = 0, sphere_res: tuple = (12, 8),
                         ground: bool = False) -> SceneData:
    """Cubes and UV spheres in turn on a square grid, each turned about y by
    a seeded angle and given seeded material factors; ``ground`` adds a
    floor and a back wall of giant triangles."""
    rng = np.random.default_rng(seed)
    data = SceneData()
    parts = ([], [], [], [], [])
    tri_parts, tri_model_parts = [], []
    v_off = 0
    t_off = 0
    scene_min = np.full(3, np.inf, np.float32)
    scene_max = np.full(3, -np.inf, np.float32)
    side = max(1, int(np.ceil(np.sqrt(n_objects))))
    for i in range(n_objects):
        mesh = create_cube(1.0) if i % 2 == 0 else create_sphere(0.6, *sphere_res)
        gx, gz = i % side, i // side
        world = rotation_y(rng.uniform(0, 2 * np.pi)) @ translation(
            [gx * 2.0 - side, 0.0, gz * 2.0 + 2.0]
        )
        center_l, radius_l, bmin_l, bmax_l = compute_mesh_bounds(mesh)
        bmin_w, bmax_w = transform_aabb(bmin_l, bmax_l, world)
        _append_mesh(parts, mesh, world, normalize_normals=False)
        tris = mesh.indices.reshape(-1, 3).astype(np.uint32) + np.uint32(v_off)
        tri_parts.append(tris)
        tri_model_parts.append(np.full(tris.shape[0], i, np.uint32))

        base = rng.uniform(0.2, 1.0, 3).astype(np.float32)
        metal = float(rng.uniform(0, 1))
        mat = Material(base, metal, float(rng.uniform(0.2, 1)))
        data.models.append(Model(
            name=f"obj_{i}", object_id=i + 1, world=world.astype(np.float32),
            center=((np.append(center_l, 1.0) @ world)[:3]).astype(np.float32),
            radius=float(radius_l), bounds_min=bmin_w, bounds_max=bmax_w,
            visible=True, material=mat, tri_start=t_off,
            tri_count=int(tris.shape[0]),
        ))
        data.texture_paths.append(("", "", "", ""))
        scene_min = np.minimum(scene_min, bmin_w)
        scene_max = np.maximum(scene_max, bmax_w)
        v_off += mesh.position.shape[0]
        t_off += tris.shape[0]

    if ground:
        ext = side * 2.5
        for j, (scale, offset) in enumerate(
            [((ext, 0.05, ext), (0.0, -1.0, ext * 0.4)),
             ((ext, ext * 0.5, 0.05), (0.0, 0.0, ext * 0.9))]
        ):
            mesh = create_cube(1.0)
            world = np.diag(list(scale) + [1.0]).astype(np.float32) @ translation(offset)
            center_l, radius_l, bmin_l, bmax_l = compute_mesh_bounds(mesh)
            bmin_w, bmax_w = transform_aabb(bmin_l, bmax_l, world)
            _append_mesh(parts, mesh, world, normalize_normals=True)
            tris = mesh.indices.reshape(-1, 3).astype(np.uint32) + np.uint32(v_off)
            tri_parts.append(tris)
            idx = n_objects + j
            tri_model_parts.append(np.full(tris.shape[0], idx, np.uint32))
            mat = Material(np.array([0.6, 0.55, 0.5], np.float32), 1.0, 0.9)
            data.models.append(Model(
                name=f"ground_{j}", object_id=idx + 1, world=world.astype(np.float32),
                center=((np.append(center_l, 1.0) @ world)[:3]).astype(np.float32),
                radius=float(radius_l * max(scale)), bounds_min=bmin_w, bounds_max=bmax_w,
                visible=True, material=mat, tri_start=t_off, tri_count=int(tris.shape[0]),
            ))
            data.texture_paths.append(("", "", "", ""))
            scene_min = np.minimum(scene_min, bmin_w)
            scene_max = np.maximum(scene_max, bmax_w)
            v_off += mesh.position.shape[0]
            t_off += tris.shape[0]

    _finish(data, parts, tri_parts, tri_model_parts, scene_min, scene_max)
    return data


def _finish(data, parts, tri_parts, tri_model_parts, scene_min, scene_max) -> None:
    """Fill ``data`` from its models' vertex parts and triangles: the
    de-indexed layout, the scene's centre and radius, and the per-model
    tables."""
    position, normal, tangent, uv, color = (np.concatenate(p) for p in parts)
    data.tri_model = np.concatenate(tri_model_parts)
    flat = np.concatenate(tri_parts).reshape(-1)
    data.position = position[flat]
    data.normal = normal[flat]
    data.tangent = tangent[flat]
    data.uv = uv[flat]
    data.color = color[flat]
    data.tri_indices = np.arange(flat.size, dtype=np.uint32).reshape(-1, 3)
    data.scene_center = ((scene_min + scene_max) * 0.5).astype(np.float32)
    data.scene_radius = max(float(np.linalg.norm(scene_max - scene_min) * 0.5), 1.0)
    n = len(data.models)
    data.base_color_factor = np.stack([mm.material.base_color_factor for mm in data.models])
    data.base_color_alpha = np.array([mm.material.base_color_alpha for mm in data.models],
                                     np.float32)
    data.metallic_factor = np.array([mm.material.metallic_factor for mm in data.models],
                                    np.float32)
    data.roughness_factor = np.array([mm.material.roughness_factor for mm in data.models],
                                     np.float32)
    data.emissive_factor = np.stack([mm.material.emissive_factor for mm in data.models])
    data.alpha_mode = np.zeros(n, np.uint32)
    data.alpha_cutoff = np.full(n, 0.5, np.float32)
    uv_t = np.zeros((n, 4, 4), np.float32)
    uv_t[:, :, 2:] = 1.0
    uv_r = np.zeros((n, 4, 2), np.float32)
    uv_r[:, :, 0] = 1.0
    data.uv_transform = uv_t
    data.uv_rotation = uv_r
    data.bounds_min_arr = np.stack([mm.bounds_min for mm in data.models])
    data.bounds_max_arr = np.stack([mm.bounds_max for mm in data.models])
    data.object_ids = np.array([mm.object_id for mm in data.models], np.uint32)
    data.visible_mask = np.ones(n, bool)


def material_maps(ci: int, tex_size: int, rng_seed):
    """The source maps of procedural material ``ci``: float32 RGBA base
    colour (a tinted grid), metallic-roughness (G rough, B metal) and
    normal maps, and on material 0 an emissive map a quarter the size
    (None on the others).  The port's ``_material_maps(ci, n)`` is
    ``material_maps(ci, n, 1000 + ci)``."""
    rng = np.random.default_rng(rng_seed)
    base = default_grid_texture(tex_size, cells=4 + 2 * (ci % 3))
    tint = rng.uniform(0.4, 1.0, 3).astype(np.float32)
    base[..., :3] *= tint
    yy, xx = np.mgrid[0:tex_size, 0:tex_size].astype(np.float32) / tex_size
    mr = np.zeros((tex_size, tex_size, 4), np.float32)
    mr[..., 1] = 0.3 + 0.6 * (0.5 + 0.5 * np.sin(6.28 * (xx * (1 + ci) + yy)))
    mr[..., 2] = (np.sin(12.56 * yy * (1 + ci % 2)) > 0.3).astype(np.float32)
    mr[..., 3] = 1.0
    freq = 8.0 + 4.0 * ci
    nx = 0.25 * np.sin(freq * 6.28 * xx) * np.cos(freq * 3.14 * yy)
    ny = 0.25 * np.cos(freq * 6.28 * yy)
    nz = np.sqrt(np.maximum(1.0 - nx * nx - ny * ny, 0.0))
    nm = np.stack([nx, ny, nz, np.ones_like(nx)], axis=-1) * 0.5 + 0.5
    nm[..., 3] = 1.0
    emis = None
    if ci == 0:
        emis = np.zeros((tex_size // 4, tex_size // 4, 4), np.float32)
        ys, xs = np.mgrid[0 : tex_size // 4, 0 : tex_size // 4]
        glow = ((ys // 8 + xs // 8) % 4 == 0).astype(np.float32)
        emis[..., 0] = glow * 1.0
        emis[..., 1] = glow * 0.8
        emis[..., 2] = glow * 0.4
    return base, mr, nm.astype(np.float32), emis


def encode_dds(items, dxgi: int, width: int, height: int, cube: bool = False,
               legacy: bool = False) -> bytes:
    """DDS file bytes: ``items`` holds one list of mips per cube face (or
    the one 2D image), each mip an array in the format's memory layout.  A
    DX10 header unless ``legacy``."""
    mips = len(items[0])
    fourcc = {71: b"DXT1", 77: b"DXT5", 80: b"ATI1", 83: b"ATI2"}
    masks = {28: (0xFF, 0xFF00, 0xFF0000, 0xFF000000), 87: (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
             35: (0xFFFF, 0xFFFF0000, 0, 0)}
    if not legacy:
        pf = struct.pack("<II4s5I", 32, 0x4, b"DX10", 0, 0, 0, 0, 0)
    elif dxgi in fourcc:
        pf = struct.pack("<II4s5I", 32, 0x4, fourcc[dxgi], 0, 0, 0, 0, 0)
    elif dxgi in masks:
        pf = struct.pack("<II4s5I", 32, 0x41 if dxgi != 35 else 0x40, b"\0\0\0\0", 32,
                         *masks[dxgi])
    else:
        raise ValueError(f"encode_dds: no legacy header for dxgi {dxgi}")
    caps2 = 0xFE00 if cube else 0
    header = (b"DDS " + struct.pack("<7I", 124, 0x1 | 0x2 | 0x4 | 0x1000 | 0x20000, height,
                                    width, 0, 0, mips)
              + bytes(44) + pf + struct.pack("<4I", 0x1000 | 0x8 | 0x400000, caps2, 0, 0)
              + bytes(4))
    if not legacy:
        header += struct.pack("<5I", dxgi, 3, 0x4 if cube else 0, 1, 0)
    payload = b"".join(mm if isinstance(mm, bytes) else np.ascontiguousarray(mm).tobytes()
                       for item in items for mm in item)
    return header + payload


def env_cube_faces(size: int, seed: int) -> list:
    """Six seeded env-cube faces with their mips (HDR, float32 RGBA): a
    sky-to-ground gradient, a bright sun lobe and texel noise."""
    rng = np.random.default_rng(seed)
    t = (np.arange(size, dtype=np.float32) + 0.5) / size
    yy, xx = np.meshgrid(t, t, indexing="ij")
    faces = []
    for f in range(6):
        sky = np.stack([0.3 + 0.4 * (1 - yy), 0.4 + 0.4 * (1 - yy), 0.6 + 0.6 * (1 - yy)], -1)
        sun = 4.0 * np.exp(-((xx - 0.3 - 0.1 * f) ** 2 + (yy - 0.35) ** 2) * 60.0)[..., None]
        rgb = sky * (0.6 + 0.1 * f) + sun + rng.uniform(0.0, 0.2, (size, size, 3))
        faces.append(generate_mips(np.concatenate([rgb, np.ones((size, size, 1))], -1)))
    return faces


def u8_chain(img: np.ndarray) -> list:
    """An RGBA8 mip chain of a float [0, 1] square power-of-two image:
    level 0 rounded to bytes, each level below the rounded mean of the 2x2
    bytes above it."""
    level = np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint16)
    chain = [level.astype(np.uint8)]
    while level.shape[0] > 1:
        level = (level[0::2, 0::2] + level[1::2, 0::2] + level[0::2, 1::2]
                 + level[1::2, 1::2] + 2) // 4
        chain.append(level.astype(np.uint8))
    return chain


def scene_content(n_objects: int = 4, seed: int = 0, sphere_res: tuple = (12, 8),
                  ground: bool = True, n_materials: int = 6, tex_size: int = 256,
                  masked: bool = False, env_size: int = 32) -> dict:
    """Everything the scene of ``seed`` is made of, as data: ``data``
    (``synthetic_scene_data``: world-space geometry), ``model_material``
    (the material of each model), ``materials`` (each with its RGBA8 map
    chains, base colour sRGB, and its glTF factors), the env cube's face
    chains (float32, written as float16), the BRDF LUT (uint16 RG), the
    light, the camera and the background.  ``write_scene`` writes exactly
    this; the reference renders it.

    Model i takes material ``i % n_materials`` (base colour,
    metallic-roughness and normal maps of ``material_maps(k, tex_size,
    [seed, k])``); with ``masked`` every 4th object from 1 takes an
    alpha-checker MASK material instead."""
    data = synthetic_scene_data(n_objects, seed, sphere_res=sphere_res, ground=ground)

    def rgba(img):
        out = img.copy()
        out[..., 3] = 1.0
        return out

    materials = []
    for k in range(n_materials):
        base, mr, nm, _emis = material_maps(k, tex_size, [seed, k])
        materials.append({"name": f"mat_{k}", "maps": {"base": u8_chain(base),
                                                      "mr": u8_chain(rgba(mr)),
                                                      "normal": u8_chain(rgba(nm))},
                          "base_color_factor": [1.0, 1.0, 1.0, 1.0], "metallic": 1.0,
                          "roughness": 1.0, "alpha_mask": False, "alpha_cutoff": 0.5})
    if masked:
        cut = np.ones((32, 32, 4), np.float32)
        yy, xx = np.mgrid[0:32, 0:32]
        cut[..., :3] = np.where(((yy // 4 + xx // 4) % 2 == 0)[..., None], 220, 90) / 255.0
        cut[..., 3] = np.where(((yy // 8) + (xx // 8)) % 2 == 0, 0.0, 1.0)
        materials.append({"name": "masked", "maps": {"base": u8_chain(cut)},
                          "base_color_factor": [1.0, 1.0, 1.0, 1.0], "metallic": 0.0,
                          "roughness": 0.7, "alpha_mask": True, "alpha_cutoff": 0.5})
    model_material = [n_materials if (masked and i < n_objects and i % 4 == 1)
                      else i % n_materials for i in range(len(data.models))]
    nv = np.linspace(0.0, 1.0, 128, dtype=np.float32)[None, :]
    a = np.linspace(0.0, 1.0, 32, dtype=np.float32)[:, None] ** 2
    lut = np.stack([1.0 - a * 0.5 - 0.25 * (1.0 - nv), a * 0.25 * nv], -1)
    return {
        "data": data, "n_objects": n_objects, "sphere_res": sphere_res,
        "model_material": model_material, "materials": materials,
        "env_faces": env_cube_faces(env_size, seed),
        "lut": np.round(np.clip(lut, 0.0, 1.0) * 65535.0).astype(np.uint16),
        "light": {"direction": [0.4, -0.8, 0.3], "intensity": 3.0, "color": [1.0, 0.95, 0.9]},
        "camera": {"position": [0.0, 1.5, -4.0],
                   "look_at": [float(v) for v in data.scene_center], "fov_y": 60.0},
        "background": [0.05, 0.05, 0.07],
    }


def write_scene(root, n_objects: int = 4, seed: int = 0, sphere_res: tuple = (12, 8),
                ground: bool = True, n_materials: int = 6, tex_size: int = 256,
                masked: bool = False, env_size: int = 32, name: str = "scene") -> Path:
    """Write ``scene_content(...)`` under ``root``: ``Scenes/<name>.json``,
    ``Models/<name>.gltf`` and ``.bin``, the maps as RGBA8 DDS files with
    their mip chains under ``Textures/``, the env cube
    ``Textures/output_pmrem.dds`` (RGBA16F, every mip) and the BRDF LUT
    ``Textures/PreintegratedGF.dds`` (RG16).  Returns the scene JSON path.

    One glTF node a model, written right-handed so the loader's mirror-Z
    gives back the same worlds (340 objects at (32, 24) with the ground:
    342 models, 263,184 triangles)."""
    root = Path(root)
    for sub in ("Scenes", "Models", "Textures"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    content = scene_content(n_objects, seed, sphere_res, ground, n_materials, tex_size, masked,
                            env_size)
    data = content["data"]
    flip = np.array([1.0, 1.0, -1.0], np.float32)
    mirror = np.diag([1.0, 1.0, -1.0, 1.0]).astype(np.float32)

    blob, views, accessors = bytearray(), [], []

    def add(arr, gltf_type, component, target=None):
        arr = np.ascontiguousarray(arr)
        while len(blob) % 4:
            blob.append(0)
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": arr.nbytes,
                      **({"target": target} if target else {})})
        blob.extend(arr.tobytes())
        acc = {"bufferView": len(views) - 1, "componentType": component,
               "count": int(arr.shape[0]), "type": gltf_type}
        if gltf_type == "VEC3" and component == 5126:
            acc["min"], acc["max"] = arr.min(0).tolist(), arr.max(0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    geoms = []
    for mesh, idx_dtype, comp in ((create_cube(1.0), np.uint16, 5123),
                                  (create_sphere(0.6, *sphere_res), np.uint32, 5125)):
        tan = mesh.tangent.copy()
        tan[:, 2:] = -tan[:, 2:]
        geoms.append({
            "attributes": {"POSITION": add(mesh.position * flip, "VEC3", 5126, 34962),
                           "NORMAL": add(mesh.normal * flip, "VEC3", 5126, 34962),
                           "TEXCOORD_0": add(mesh.uv, "VEC2", 5126, 34962),
                           "TANGENT": add(tan, "VEC4", 5126, 34962)},
            "indices": add(mesh.indices.astype(idx_dtype), "SCALAR", comp, 34963)})

    images, materials = [], []

    def texture(chain, stem):
        h, w = chain[0].shape[:2]
        (root / "Textures" / f"{stem}.dds").write_bytes(encode_dds([chain], DXGI_RGBA8, w, h))
        images.append({"uri": f"../Textures/{stem}.dds"})
        return {"index": len(images) - 1}

    for k, mat in enumerate(content["materials"]):
        maps = mat["maps"]
        if not mat["alpha_mask"]:
            materials.append({
                "name": mat["name"],
                "pbrMetallicRoughness": {
                    "baseColorTexture": texture(maps["base"], f"{name}_mat{k}_base"),
                    "metallicRoughnessTexture": texture(maps["mr"], f"{name}_mat{k}_mr"),
                    "baseColorFactor": mat["base_color_factor"],
                    "metallicFactor": mat["metallic"], "roughnessFactor": mat["roughness"]},
                "normalTexture": texture(maps["normal"], f"{name}_mat{k}_normal")})
        else:
            materials.append({"name": mat["name"], "alphaMode": "MASK",
                              "alphaCutoff": mat["alpha_cutoff"],
                              "pbrMetallicRoughness": {
                                  "baseColorTexture": texture(maps["base"],
                                                              f"{name}_masked_base"),
                                  "metallicFactor": mat["metallic"],
                                  "roughnessFactor": mat["roughness"]}})

    meshes, mesh_of, nodes = [], {}, []
    for i, model in enumerate(data.models):
        geom = 1 if (i < n_objects and i % 2 == 1) else 0
        mat = content["model_material"][i]
        if (geom, mat) not in mesh_of:
            mesh_of[(geom, mat)] = len(meshes)
            meshes.append({"name": f"{('cube', 'sphere')[geom]}_{mat}",
                           "primitives": [{**geoms[geom], "material": mat}]})
        local = mirror @ model.world @ mirror  # column-major column-vector matrix
        nodes.append({"name": model.name, "mesh": mesh_of[(geom, mat)],
                      "matrix": [float(v) for v in local.reshape(-1)]})

    (root / "Models" / f"{name}.bin").write_bytes(bytes(blob))
    gltf = {"asset": {"version": "2.0"}, "scene": 0,
            "scenes": [{"nodes": list(range(len(nodes)))}], "nodes": nodes, "meshes": meshes,
            "materials": materials, "textures": [{"source": i} for i in range(len(images))],
            "images": images, "buffers": [{"uri": f"{name}.bin", "byteLength": len(blob)}],
            "bufferViews": views, "accessors": accessors}
    (root / "Models" / f"{name}.gltf").write_text(json.dumps(gltf))

    faces = content["env_faces"]
    (root / "Textures" / "output_pmrem.dds").write_bytes(encode_dds(
        [[lv.astype(np.float16) for lv in chain] for chain in faces], 10, env_size, env_size,
        cube=True))
    (root / "Textures" / "PreintegratedGF.dds").write_bytes(encode_dds(
        [[content["lut"]]], 35, 128, 32, legacy=True))

    scene = {
        "models": [{"path": f"Models/{name}.gltf", "id": name}],
        "lights": [content["light"]],
        "camera": content["camera"],
        "environment": {"background": content["background"]},
    }
    path = root / "Scenes" / f"{name}.json"
    path.write_text(json.dumps(scene, indent=1))
    return path
