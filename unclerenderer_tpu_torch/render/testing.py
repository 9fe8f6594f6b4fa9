"""Synthetic scenes for tests, smoke runs and benchmarks.

The port of ``unclerenderer_tpu/render/testing.py``, JAX-free: a grid of
cubes/spheres (plus an optional floor and back wall of giant triangles)
with procedural materials, or the Sponza tiers built from Sponza's glTF
and DDS set where ``UNCLERENDERER_ASSETS`` names the reference's assets
(its real material chains; box-shell geometry from its accessor
metadata), assembled into the port's ``DeviceScene`` on the card (or on
the device the caller names) through the Renderer's upload
(``params.upload_scene``).  The host-side geometry
and texture building is the port's own copy of the reference's numpy
modules (``mathlib``, ``scene``, ``textures``).  ``write_scene`` writes the
same geometry as scene files (scene JSON, glTF, PNG, DDS) for the
Renderer's loaders.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from pathlib import Path

import numpy as np
import torch

from .. import mathlib as m
from ..core.paths import reference_asset
from ..scene.build import GltfMaterial, SceneData, SceneModel
from ..scene.mesh import compute_mesh_bounds, create_cube, create_sphere
from ..textures.atlas import build_pyramid_quad_atlas, build_pyramid_tri_atlas
from ..textures.image import (
    combined_chain,
    default_grid_texture,
    encode_combined_u8,
    generate_mips,
    load_image,
    solid_color_texture,
)
from ..textures.png import encode_png
from .packing import pack_model_record, pack_tri_geo, pack_tri_mrec, scene_host_arrays
from .params import DeviceScene, FrameParams, resolve_packed_trilinear, upload_scene


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


def synthetic_scene_data(
    n_objects: int = 4, seed: int = 0, sphere_res: tuple = (12, 8), ground: bool = False
) -> SceneData:
    """sphere_res scales per-object triangle count; ground adds a floor and a
    back wall made of a handful of GIANT triangles (the raster's third
    level).  Same numbers as the reference's ``synthetic_scene_data``."""
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
        world = m.rotation_y(rng.uniform(0, 2 * np.pi)) @ m.translation(
            [gx * 2.0 - side, 0.0, gz * 2.0 + 2.0]
        )
        center_l, radius_l, bmin_l, bmax_l = compute_mesh_bounds(mesh)
        bmin_w, bmax_w = m.transform_aabb(bmin_l, bmax_l, world)
        _append_mesh(parts, mesh, world, normalize_normals=False)
        tris = mesh.indices.reshape(-1, 3).astype(np.uint32) + np.uint32(v_off)
        tri_parts.append(tris)
        tri_model_parts.append(np.full(tris.shape[0], i, np.uint32))

        mat = GltfMaterial()
        mat.base_color_factor = rng.uniform(0.2, 1.0, 3).astype(np.float32)
        mat.metallic_factor = float(rng.uniform(0, 1))
        mat.roughness_factor = float(rng.uniform(0.2, 1))
        data.models.append(SceneModel(
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
            world = np.diag(list(scale) + [1.0]).astype(np.float32) @ m.translation(offset)
            center_l, radius_l, bmin_l, bmax_l = compute_mesh_bounds(mesh)
            bmin_w, bmax_w = m.transform_aabb(bmin_l, bmax_l, world)
            _append_mesh(parts, mesh, world, normalize_normals=True)
            tris = mesh.indices.reshape(-1, 3).astype(np.uint32) + np.uint32(v_off)
            tri_parts.append(tris)
            idx = n_objects + j
            tri_model_parts.append(np.full(tris.shape[0], idx, np.uint32))
            mat = GltfMaterial()
            mat.base_color_factor = np.array([0.6, 0.55, 0.5], np.float32)
            mat.roughness_factor = 0.9
            data.models.append(SceneModel(
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
    """Fill ``data`` from its models' vertex parts (positions, normals,
    tangents, uvs, colours) and triangles: the de-indexed layout (vertex i
    of triangle t at row 3t + i), the scene's centre and radius, and the
    per-model constant tables (factors from the materials, opaque, cutoff
    0.5, identity UV transforms, AABBs, object ids, all visible)."""
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


def _material_maps(ci: int, tex_size: int):
    """The source maps of procedural material ``ci`` (same numbers as the
    reference): float32 RGBA base colour (a tinted grid), metallic-roughness
    (G rough, B metal) and normal maps, and on material 0 an emissive map a
    quarter the size (None on the others)."""
    rng = np.random.default_rng(1000 + ci)
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


def _rich_material_chains(n_combos: int, tex_size: int):
    """Procedural Sponza-like material set: baseColor + metallic-roughness +
    normal maps (emissive on combo 0) fused into combined 16-channel chains
    (same numbers as the reference)."""
    combos = []
    for ci in range(n_combos):
        base, mr, nm, emis = _material_maps(ci, tex_size)
        combos.append(combined_chain([generate_mips(base), generate_mips(mr), generate_mips(nm),
                                      None if emis is None else generate_mips(emis)]))
    return combos


# ------------------------------------------------------------ the Sponza tiers

# the packed atlas of the real Sponza chains, per process: a bench run builds
# several scenes over the same chains, and packing the 512-cap atlas is slow
_atlas_memo: dict = {}
# Sponza's glTF in the reference checkout (its geometry .bin is not needed):
# "" takes it from UNCLERENDERER_ASSETS when a tier is built; tests patch it
_SPONZA_GLTF = ""
# keyed by (max_combos, max_dim), as the reference keys it (not by path)
_sponza_chain_cache: dict = {}


def _sponza_gltf() -> Path:
    """``_SPONZA_GLTF``, else Sponza's glTF under ``UNCLERENDERER_ASSETS`` as
    the variable stands now (no file when it is unset)."""
    return Path(_SPONZA_GLTF or reference_asset("sponza/untitled.gltf"))


def sponza_material_chains(max_combos: int | None = None, max_dim: int = 512):
    """Combined 16-channel chains of Sponza's real material table
    (``_SPONZA_GLTF``): the glTF's materials, textures and images tables
    only (no buffers); each material's baseColor (sRGB) and normal DDS
    chains (``textures/image.py load_image``), leading mips dropped down to
    ``max_dim``, fused as the Renderer fuses them (``combined_chain([base,
    None, normal, None])``).  Materials without a baseColor texture are
    skipped.  Returns ``(chains, factors)``, factors a dict a material
    (``base_color_factor``, ``metallic``, ``roughness``), or None when the
    glTF or every chain is absent (callers take the procedural set)."""
    key = (max_combos, max_dim)
    if key in _sponza_chain_cache:
        return _sponza_chain_cache[key]
    gltf_path = _sponza_gltf()
    if not gltf_path.is_file():
        return None
    g = json.loads(gltf_path.read_text())
    imgs = [i.get("uri", "") for i in g.get("images", [])]
    texs = g.get("textures", [])
    root = gltf_path.parent

    def chain_for(tex_index, srgb):
        if tex_index is None:
            return None
        chain = load_image(root / imgs[texs[tex_index]["source"]], srgb=srgb)
        if chain is None:
            return None
        while chain and max(chain[0].shape[:2]) > max_dim and len(chain) > 1:
            chain = chain[1:]
        return chain

    chains, factors = [], []
    mats = g.get("materials", [])
    if max_combos is not None:
        mats = mats[:max_combos]
    for mt in mats:
        pbr = mt.get("pbrMetallicRoughness", {})
        base = chain_for(pbr.get("baseColorTexture", {}).get("index"), True)
        normal = chain_for(mt.get("normalTexture", {}).get("index"), False)
        if base is None:
            continue
        chains.append(combined_chain([base, None, normal, None]))
        factors.append({
            "base_color_factor": np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1])[:3],
                                            np.float32),
            "metallic": np.float32(pbr.get("metallicFactor", 1.0)),
            "roughness": np.float32(pbr.get("roughnessFactor", 1.0)),
        })
    if not chains:
        return None
    # the cached tuple itself: its id keys the atlas memo (the reference
    # returns a new tuple at the first call, whose id the memo keeps)
    out = _sponza_chain_cache[key] = (chains, factors)
    return out


def _sponza_sheet(g_u, g_v, origin, du, dv, normal, urep, vrep):
    """One grid-meshed quad sheet, (g_u x g_v) quads = 2 g_u g_v triangles:
    (positions, normals, tangents, uvs, triangles)."""
    uu, vv = np.meshgrid(
        np.linspace(0.0, 1.0, g_u + 1, dtype=np.float32),
        np.linspace(0.0, 1.0, g_v + 1, dtype=np.float32), indexing="ij")
    pts = (origin[None, None]
           + uu[..., None] * du[None, None]
           + vv[..., None] * dv[None, None]).reshape(-1, 3)
    uvs = np.stack([uu * urep, vv * vrep], -1).reshape(-1, 2)
    iu, iv = np.meshgrid(np.arange(g_u), np.arange(g_v), indexing="ij")
    q00 = (iu * (g_v + 1) + iv).reshape(-1)
    q01, q10 = q00 + 1, q00 + (g_v + 1)
    q11 = q10 + 1
    tris = np.stack(
        [np.stack([q00, q10, q11], -1), np.stack([q00, q11, q01], -1)],
        1).reshape(-1, 3).astype(np.uint32)
    nrm = np.broadcast_to(normal, (pts.shape[0], 3)).astype(np.float32)
    tanu = du / max(float(np.linalg.norm(du)), 1e-20)
    tan = np.concatenate(
        [np.broadcast_to(tanu, (pts.shape[0], 3)),
         np.ones((pts.shape[0], 1), np.float32)], 1).astype(np.float32)
    return pts.astype(np.float32), nrm, tan, uvs.astype(np.float32), tris


def _sponza_patch(ext, bmin, bmax, ax, sign, ua_, va_, g_u, g_v, cell_cap):
    """(origin, du, dv, inward normal) of a face's (g_u x g_v)-cell patch,
    shrunk to cells of at most ``cell_cap`` and centred on the face."""
    patch_u = min(float(ext[ua_]), g_u * cell_cap)
    patch_v = min(float(ext[va_]), g_v * cell_cap)
    origin = bmin.copy()
    origin[ua_] += (ext[ua_] - patch_u) * 0.5
    origin[va_] += (ext[va_] - patch_v) * 0.5
    origin[ax] = bmax[ax] if sign else bmin[ax]
    du = np.zeros(3, np.float32)
    dv = np.zeros(3, np.float32)
    du[ua_] = patch_u
    dv[va_] = patch_v
    normal = np.zeros(3, np.float32)
    # inward-facing: the +axis face looks toward -axis and vice versa
    normal[ax] = -1.0 if sign else 1.0
    return origin, du, dv, normal


def sponza_faithful_scene_data(seed: int = 0) -> SceneData | None:
    """The geometry-faithful Sponza tier, from ``_SPONZA_GLTF``'s accessor
    metadata alone: each primitive's real triangle count, POSITION AABB and
    material binding, as box-shell sheets inside the AABB (the glTF's z
    mirrored for the left-handed world, scaled 0.01 and moved +5 in x, as
    the reference's sponza.json places it).  Triangles go to the six faces
    by area with inward normals and UV repeats of 1-16; a face whose cells
    would pass 1.0 m shrinks to a centred patch (``_CELL_CAP``), a shortfall
    is topped up by a strip on the largest face, and the sheets are trimmed
    to the accessor's exact count.  ``sponza_chain_of_model`` is each
    model's chain in ``sponza_material_chains``' skip order.  Pure numpy,
    bit-equal to the reference's; None without the glTF (callers take the
    sphere tier)."""
    gltf_path = _sponza_gltf()
    if not gltf_path.is_file():
        return None
    g = json.loads(gltf_path.read_text())
    mats = g.get("materials", [])
    # chain index per glTF material, in sponza_material_chains' order
    chain_of_mat: dict[int, int] = {}
    for mi, mt in enumerate(mats):
        if mt.get("pbrMetallicRoughness", {}).get(
                "baseColorTexture", {}).get("index") is not None:
            chain_of_mat[mi] = len(chain_of_mat)

    prims = []
    for mesh in g.get("meshes", []):
        for p in mesh.get("primitives", []):
            acc_p = g["accessors"][p["attributes"]["POSITION"]]
            n_tris = (g["accessors"][p["indices"]]["count"] // 3
                      if "indices" in p else acc_p["count"] // 3)
            prims.append((n_tris, np.asarray(acc_p["min"], np.float32),
                          np.asarray(acc_p["max"], np.float32), p.get("material", 0)))
    if not prims:
        return None

    data = SceneData()
    parts = ([], [], [], [], [])  # positions, normals, tangents, uvs, colours
    tri_parts, tri_model_parts = [], []
    v_off = t_off = 0
    scene_min = np.full(3, np.inf, np.float32)
    scene_max = np.full(3, -np.inf, np.float32)
    scale = np.float32(0.01)
    trans = np.array([5.0, 0.0, 0.0], np.float32)
    cell_cap = 1.0  # _CELL_CAP: world metres a grid cell at most

    for pi, (n_tris, bmin, bmax, mat_i) in enumerate(prims):
        # RH -> LH: negate z, swapping the z bounds so min <= max holds
        zmin, zmax = -bmax[2], -bmin[2]
        bmin = np.array([bmin[0], bmin[1], zmin], np.float32) * scale + trans
        bmax = np.array([bmax[0], bmax[1], zmax], np.float32) * scale + trans
        ext = np.maximum(bmax - bmin, 1e-3)

        faces, areas = [], []  # (axis, sign, ua, va) and each face's area
        for ax in range(3):
            ua_, va_ = [(1, 2), (0, 2), (0, 1)][ax]
            area = float(ext[ua_] * ext[va_])
            for sign in (0, 1):
                faces.append((ax, sign, ua_, va_))
                areas.append(area)
        areas = np.asarray(areas)
        quota = np.maximum((areas / areas.sum() * (n_tris / 2.0)), 1.0)
        sheets, made = [], 0
        for f_i, (ax, sign, ua_, va_) in enumerate(faces):
            if made >= n_tris:
                break
            want = int(quota[f_i]) if f_i < len(faces) - 1 else max((n_tris - made + 1) // 2, 1)
            aspect = max(float(ext[ua_] / max(ext[va_], 1e-3)), 1e-3)
            g_u = max(1, int(np.sqrt(want * aspect)))
            g_v = max(1, want // g_u)
            origin, du, dv, normal = _sponza_patch(ext, bmin, bmax, ax, sign, ua_, va_, g_u, g_v,
                                                   cell_cap)
            urep = float(np.clip(round(ext[ua_] / 1.5), 1, 16))
            vrep = float(np.clip(round(ext[va_] / 1.5), 1, 16))
            sheets.append(_sponza_sheet(g_u, g_v, origin, du, dv, normal, urep, vrep))
            made += 2 * g_u * g_v
        # top up a shortfall with a strip on the largest face
        while made < n_tris:
            ax, sign, ua_, va_ = faces[int(np.argmax(areas))]
            need = n_tris - made
            g_u = max(1, int(np.sqrt(need / 2)))
            g_v = max(1, -(-need // (2 * g_u)))
            origin, du, dv, normal = _sponza_patch(ext, bmin, bmax, ax, sign, ua_, va_, g_u, g_v,
                                                   cell_cap)
            sheets.append(_sponza_sheet(g_u, g_v, origin, du, dv, normal, 1.0, 1.0))
            made += 2 * g_u * g_v
        # the sheets, trimmed to the accessor's exact count (the layout is
        # de-indexed below, so trimming triangles is a slice)
        pts = np.concatenate([sh[0] for sh in sheets])
        offs = np.cumsum([0] + [sh[0].shape[0] for sh in sheets])[:-1]
        tris = np.concatenate([sh[4] + np.uint32(o) for sh, o in zip(sheets, offs)])[:n_tris]
        parts[0].append(pts)
        for k in (1, 2, 3):  # normals, tangents, uvs
            parts[k].append(np.concatenate([sh[k] for sh in sheets]))
        parts[4].append(np.ones((pts.shape[0], 4), np.float32))
        tri_parts.append(tris + np.uint32(v_off))
        tri_model_parts.append(np.full(tris.shape[0], pi, np.uint32))

        mat = GltfMaterial()
        pbr = mats[mat_i].get("pbrMetallicRoughness", {}) if mat_i < len(mats) else {}
        mat.base_color_factor = np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1])[:3],
                                           np.float32)
        mat.metallic_factor = float(pbr.get("metallicFactor", 1.0))
        mat.roughness_factor = float(pbr.get("roughnessFactor", 1.0))
        data.models.append(SceneModel(
            name=f"sponza_prim_{pi}", object_id=pi + 1, world=np.eye(4, dtype=np.float32),
            center=(bmin + bmax) * 0.5, radius=float(np.linalg.norm(bmax - bmin) * 0.5),
            bounds_min=bmin, bounds_max=bmax, visible=True, material=mat,
            tri_start=t_off, tri_count=int(tris.shape[0]),
        ))
        data.texture_paths.append(("", "", "", ""))
        scene_min = np.minimum(scene_min, bmin)
        scene_max = np.maximum(scene_max, bmax)
        v_off += pts.shape[0]
        t_off += tris.shape[0]

    _finish(data, parts, tri_parts, tri_model_parts, scene_min, scene_max)
    # the material chain of each model: its primitive's real glTF binding
    data.sponza_chain_of_model = np.asarray(
        [chain_of_mat.get(p[3], pi % max(len(chain_of_mat), 1)) for pi, p in enumerate(prims)],
        np.int32)
    return data


SOURCES = ("procedural", "sponza")


def synthetic_device_scene(
    n_objects: int = 4,
    seed: int = 0,
    with_texture: bool = True,
    with_masked: bool = False,
    sphere_res: tuple = (12, 8),
    ground: bool = False,
    rich_materials: bool = False,
    packed_trilinear: bool | str = False,
    atlas_u8: bool = False,
    texture_source: str = "procedural",
    geometry_source: str = "procedural",
    device="cuda",
):
    """Returns ``(DeviceScene, SceneData)``, the scene on ``device`` (the
    card unless the caller names another).

    Without rich_materials: the per-slot quad atlas (16 lanes, f32 chains
    stored as bf16) of a solid white map, the grid map as every 2nd model's
    base colour (with_texture) and, with_masked, a 32^2 alpha-checker map as
    every 4th model's base colour from model 1, in MASK alpha mode (render
    with ``combined_material=False``).  rich_materials gives every model
    fused baseColor+MR+normal(+emissive) maps in one combined 16-channel
    chain (render with ``combined_material=True``); it models no MASK
    material.  packed_trilinear (True, False or "auto", resolved against the
    material count) builds the 256-lane packed-trilinear atlas instead of the
    64-lane quad atlas.

    ``geometry_source="sponza"`` takes the geometry-faithful Sponza tier
    (``sponza_faithful_scene_data``) and falls back to the sphere grid when
    its glTF is absent.  Under rich_materials, ``texture_source="sponza"``
    takes Sponza's real chains (``sponza_material_chains``, capped at
    ``UNCLE_SPONZA_CAP`` texels, 512 by default) with the glTF's base
    colour, metallic and roughness factors, no emissive map and each
    model's chain ``sponza_chain_of_model`` (or its index) modulo the
    material count; without the assets the 6 procedural materials.  The
    defaults are the procedural tiers."""
    for name, value in (("texture_source", texture_source), ("geometry_source", geometry_source)):
        if value not in SOURCES:
            raise ValueError(f"synthetic_device_scene: {name} must be one of {SOURCES}, "
                             f"got {value!r}")
    data = sponza_faithful_scene_data(seed) if geometry_source == "sponza" else None
    if data is None:
        data = synthetic_scene_data(n_objects, seed, sphere_res=sphere_res, ground=ground)
    if rich_materials:
        if with_masked:
            raise ValueError("rich_materials does not model MASK materials")
        tex_ids, has_map, quad_img, slot_rect0 = _rich_materials(data, packed_trilinear, atlas_u8,
                                                                 texture_source)
    else:
        tex_ids, has_map, quad_img, slot_rect0 = _per_slot_materials(data, with_texture,
                                                                     with_masked)
    model_rec = pack_model_record(data, has_map, slot_rect0)
    scene = _assemble_device_scene(data, tex_ids, has_map, quad_img, pack_tri_geo(data),
                                   pack_tri_mrec(data, model_rec), device)
    return scene, data


def _per_slot_materials(data, with_texture: bool, with_masked: bool):
    """(tex_ids, has_map, atlas, per-slot rects) of the per-map quad atlas;
    sets the MASK models' alpha mode."""
    n = data.num_models
    chains = [generate_mips(solid_color_texture([1.0, 1.0, 1.0, 1.0], 1))]
    tex_ids = np.zeros((n, 4), np.int32)
    has_map = np.zeros((n, 4), bool)
    if with_texture:
        chains.append(generate_mips(default_grid_texture(64)))
        tex_ids[::2, 0] = 1
        has_map[::2, 0] = True
    if with_masked and n > 1:
        cut = default_grid_texture(32)
        yy, xx = np.mgrid[0:32, 0:32]
        cut[..., 3] = (((yy // 8) + (xx // 8)) % 2).astype(np.float32)
        chains.append(generate_mips(cut))
        tex_ids[1::4, 0] = len(chains) - 1
        has_map[1::4, 0] = True
        data.alpha_mode[1::4] = 1
    quad_img, rect0 = build_pyramid_quad_atlas(chains)
    return tex_ids, has_map, quad_img, rect0[tex_ids].astype(np.float32)


def _rich_materials(data, packed_trilinear, atlas_u8: bool, texture_source: str):
    """(tex_ids, has_map, atlas, per-slot rects) of the combined materials:
    Sponza's real chains (``texture_source="sponza"`` with the assets) or
    the 6 procedural ones; sets the models' factors."""
    n = data.num_models
    sponza = None
    if texture_source == "sponza":
        sponza = sponza_material_chains(max_dim=int(os.environ.get("UNCLE_SPONZA_CAP", "512")))
    if sponza is not None:
        combo_chains, sp_factors = sponza
    else:
        combo_chains, sp_factors = _rich_material_chains(6, tex_size=256), None
    n_combos = len(combo_chains)
    packed = resolve_packed_trilinear(packed_trilinear, n_combos)
    memo_key = (id(sponza), n_combos, bool(atlas_u8), packed)
    cached = _atlas_memo.get(memo_key) if sponza is not None else None
    if cached is not None:
        quad_img, rect0 = cached
    else:
        mat_dtype = np.float32
        if atlas_u8:
            combo_chains = [[encode_combined_u8(lv) for lv in ch] for ch in combo_chains]
            mat_dtype = np.uint8
        build = build_pyramid_tri_atlas if packed else build_pyramid_quad_atlas
        quad_img, rect0 = build(combo_chains, wrap=True, dtype=mat_dtype)
        if sponza is not None:
            _atlas_memo[memo_key] = (quad_img, rect0)
    chain_of_model = getattr(data, "sponza_chain_of_model", None)
    if chain_of_model is not None:  # the faithful tier's real material bindings
        model_combo = np.asarray(chain_of_model, np.int32) % n_combos
    else:
        model_combo = np.arange(n, dtype=np.int32) % n_combos
    tex_ids = np.repeat(model_combo[:, None], 4, axis=1).astype(np.int32)
    has_map = np.ones((n, 4), bool)
    if sp_factors is not None:
        # the glTF's constants ride with their textures; the set has no
        # emissive or MR maps
        has_map[:, 3] = False
        data.emissive_factor = np.zeros((n, 3), np.float32)
        data.base_color_factor = np.stack([sp_factors[c]["base_color_factor"]
                                           for c in model_combo])
        data.metallic_factor = np.asarray([sp_factors[c]["metallic"] for c in model_combo],
                                          np.float32)
        data.roughness_factor = np.asarray([sp_factors[c]["roughness"] for c in model_combo],
                                           np.float32)
    else:
        has_map[:, 3] = model_combo == 0  # emissive map on combo 0 only
        data.emissive_factor = np.where(
            (model_combo == 0)[:, None], np.float32(1.0), np.float32(0.0)
        ) * np.ones((n, 3), np.float32)
    slot_rect0 = np.repeat(rect0[model_combo].astype(np.float32)[:, None, :], 4, axis=1)
    return tex_ids, has_map, quad_img, slot_rect0


def _assemble_device_scene(data, tex_ids, has_map, quad_img, tri_geo, tri_mrec, device) -> DeviceScene:
    """The scene on ``device`` through the Renderer's upload
    (``params.upload_scene``), with the reference's synthetic stand-ins for
    the BRDF LUT and the flat env cube."""
    env_rect0 = np.zeros((6, 4), np.float32)
    env_rect0[:, 2:] = 1.0
    host = scene_host_arrays(
        data, tex_ids, has_map, quad_img, tri_geo, tri_mrec,
        brdf_lut=np.full((32, 128, 2), 0.5, np.float32),
        env_quad=np.full((8, 128, 128), 0.1, np.float32), env_rect0=env_rect0,
        env_tail=np.full((6, 1, 1, 4), 0.1, np.float32))
    return upload_scene(host, device)


def synthetic_frame_params(
    data, width: int, height: int, camera_pos=(0.0, 1.5, -4.0), look_at=None,
    device="cuda",
) -> FrameParams:
    """The reference's synthetic camera, light and post parameters for
    ``data``, as tensors on ``device`` (the card unless the caller names
    another)."""
    cam_pos = np.asarray(camera_pos, np.float32)
    target = data.scene_center if look_at is None else np.asarray(look_at, np.float32)
    view = m.look_at_lh(cam_pos, target, [0, 1, 0])
    proj = m.perspective_reverse_z_infinite(np.radians(60.0), width / height, 0.1)
    light = m.normalize(np.array([-0.4, 0.8, -0.3], np.float32))
    light_vp = m.build_directional_light_view_proj(data.scene_center, data.scene_radius, light)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return FrameParams(
        view=t(view),
        proj=t(proj),
        proj_unjittered=t(proj),
        view_proj=t(view @ proj),
        camera_pos=t(cam_pos),
        light_dir=t(light),
        light_intensity=t(3.0),
        light_color=t([1.0, 0.95, 0.9]),
        light_view_proj=t(light_vp),
        shadow_strength=t(1.0),
        shadow_bias=t(0.002),
        background=t([0.05, 0.05, 0.07]),
        model_visible=t(data.visible_mask, torch.bool),
        env_mip_count=t(1.0),
        tonemap_exposure=t(1.0),
        tonemap_gamma=t(2.2),
        cas_sharpness=t(0.5),
        taa_history_weight=t(0.9),
        auto_exposure_key=t(0.3),
        auto_exposure_min=t(0.1),
        auto_exposure_max=t(5.0),
        auto_exposure_speed_up=t(3.0),
        auto_exposure_speed_down=t(1.0),
        delta_time=t(np.float32(1 / 60)),
    )


def sharded_frames(rank: int, group, spec: dict):
    """A rank of ``parallel/multichip.py run_ranks``: carried deferred frames
    of ``synthetic_device_scene(**spec["scene"])`` at
    ``RenderSettings(**spec["settings"])`` on ``spec["device"]``, one per
    camera position of ``spec["cameras"]``, each rendered by
    ``render_frame_multichip``.  Rank 0 returns, per frame, the whole-frame
    outputs as numpy (``interop.to_numpy``: the image outputs and the TAA
    history gathered from the slabs, the counters, exposure and HZB as they
    are); the other ranks None."""
    from .. import interop
    from ..parallel.multichip import SLAB_KEYS, gather_frame, render_frame_multichip, slab_state
    from .params import FrameState, RenderSettings

    dev = torch.device(spec["device"])
    settings = RenderSettings(**spec["settings"])
    scene, data = synthetic_device_scene(**spec["scene"], device=dev)
    state = slab_state(FrameState.initial(settings.width, settings.height, dev), settings, group)
    frames = []
    for cam in spec["cameras"]:
        params = synthetic_frame_params(data, settings.width, settings.height, camera_pos=cam,
                                        device=dev)
        out, state = render_frame_multichip(scene, params, state, settings, group)
        full = gather_frame({**out, "taa_history": state.taa_history,
                             "exposure_ev": state.exposure_ev, "hzb": state.hzb}, settings,
                            group, keys=SLAB_KEYS + ("taa_history",))
        if full is not None:
            frames.append(interop.to_numpy(full))
    return frames if rank == 0 else None


# ------------------------------------------------------------ scene files


def encode_dds(items, dxgi: int, width: int, height: int, cube: bool = False,
               legacy: bool = False) -> bytes:
    """DDS file bytes for ``textures/dds.py``: ``items`` holds one list of
    mips per cube face (or the one 2D image), each mip an array in the
    format's memory layout (RGBA16F float16 (h, w, 4), RG16 uint16 (h, w,
    2), R32F float32 (h, w), BGRA8 uint8 in B, G, R, A order, ...) or raw
    block bytes for BC formats.  A DX10 header unless ``legacy``: a FOURCC
    for BC1/BC3/BC4/BC5, RGB masks for RGBA8/BGRA8/RG16."""
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
    payload = b"".join(m if isinstance(m, bytes) else np.ascontiguousarray(m).tobytes()
                       for item in items for m in item)
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


def write_scene(root, n_objects: int = 4, seed: int = 0, sphere_res: tuple = (12, 8),
                ground: bool = True, n_materials: int = 6, tex_size: int = 256,
                masked: bool = False, emissive: bool = False, texture_transform: bool = False,
                env_size: int = 32, embed_buffer: bool = False, name: str = "scene"):
    """Write a scene the Renderer loads from files, under ``root``:
    ``Scenes/<name>.json`` (one glTF model, camera, light, background),
    ``Models/<name>.gltf`` with its ``.bin`` buffer (or a base64 data URI
    with ``embed_buffer``), PNG maps under ``Textures/``, the env cube
    ``Textures/output_pmrem.dds`` (RGBA16F, every mip) and the BRDF LUT
    ``Textures/PreintegratedGF.dds`` (RG16).  Returns the scene JSON path.

    The geometry is ``synthetic_scene_data(n_objects, seed, sphere_res,
    ground)``: cubes and UV spheres in turn and the two giant ground boxes,
    one glTF node each, written right-handed so the loader's mirror-Z gives
    back the same worlds (340 objects at (32, 24) with the ground are the
    headline's 342 models and 263,184 triangles).  Model i takes material
    ``i % n_materials``: the procedural maps of ``rich_materials`` as u8
    PNGs (base colour, metallic-roughness and normal; material 0 also its
    emissive map with ``emissive``, and a KHR_texture_transform shared by
    its maps with ``texture_transform``); with ``masked`` every 4th object
    from 1 takes an alpha-checker MASK material instead.  The env cube is
    ``env_cube_faces(env_size, seed)``."""
    root = Path(root)
    for sub in ("Scenes", "Models", "Textures"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    data = synthetic_scene_data(n_objects, seed, sphere_res=sphere_res, ground=ground)
    flip = np.array([1.0, 1.0, -1.0], np.float32)
    mirror = np.diag([1.0, 1.0, -1.0, 1.0]).astype(np.float32)

    # ---- buffer: the cube (u16 indices) and the sphere (u32), right-handed
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

    # ---- materials and their maps
    images, materials = [], []

    def texture(img, stem, transform):
        (root / "Textures" / f"{stem}.png").write_bytes(encode_png(img))
        images.append({"uri": f"../Textures/{stem}.png"})
        info = {"index": len(images) - 1}
        if transform:
            info["extensions"] = {"KHR_texture_transform": {
                "offset": [0.25, 0.5], "scale": [2.0, 1.5], "rotation": 0.3}}
        return info

    def u8(img, channels):
        return np.round(np.clip(img[..., :channels], 0.0, 1.0) * 255.0).astype(np.uint8)

    for k in range(n_materials):
        base, mr, nm, emis = (u8(m, 4 if i == 0 else 3) if m is not None else None
                              for i, m in enumerate(_material_maps(k, tex_size)))
        tt = texture_transform and k == 0
        mat = {"name": f"mat_{k}",
               "pbrMetallicRoughness": {
                   "baseColorTexture": texture(base, f"{name}_mat{k}_base", tt),
                   "metallicRoughnessTexture": texture(mr, f"{name}_mat{k}_mr", tt),
                   "baseColorFactor": [1.0, 1.0, 1.0, 1.0],
                   "metallicFactor": 1.0, "roughnessFactor": 1.0},
               "normalTexture": texture(nm, f"{name}_mat{k}_normal", tt)}
        if emissive and emis is not None:
            mat["emissiveTexture"] = texture(emis, f"{name}_mat0_emissive", tt)
            mat["emissiveFactor"] = [1.0, 1.0, 1.0]
        materials.append(mat)
    if masked:
        cut = np.full((32, 32, 4), 255, np.uint8)
        yy, xx = np.mgrid[0:32, 0:32]
        cut[..., :3] = np.where(((yy // 4 + xx // 4) % 2 == 0)[..., None], 220, 90)
        cut[..., 3] = np.where(((yy // 8) + (xx // 8)) % 2 == 0, 0, 255)
        materials.append({"name": "masked", "alphaMode": "MASK", "alphaCutoff": 0.5,
                          "pbrMetallicRoughness": {
                              "baseColorTexture": texture(cut, f"{name}_masked_base", False),
                              "metallicFactor": 0.0, "roughnessFactor": 0.7}})

    # ---- one mesh per (geometry, material), one node per model
    meshes, mesh_of, nodes = [], {}, []
    for i, model in enumerate(data.models):
        geom = 1 if (i < n_objects and i % 2 == 1) else 0
        mat = n_materials if (masked and i < n_objects and i % 4 == 1) else i % n_materials
        if (geom, mat) not in mesh_of:
            mesh_of[(geom, mat)] = len(meshes)
            meshes.append({"name": f"{('cube', 'sphere')[geom]}_{mat}",
                           "primitives": [{**geoms[geom], "material": mat}]})
        local = mirror @ model.world @ mirror  # column-major column-vector matrix
        nodes.append({"name": model.name, "mesh": mesh_of[(geom, mat)],
                      "matrix": [float(v) for v in local.reshape(-1)]})

    bin_name = f"{name}.bin"
    if embed_buffer:
        uri = "data:application/octet-stream;base64," + base64.b64encode(bytes(blob)).decode()
    else:
        (root / "Models" / bin_name).write_bytes(bytes(blob))
        uri = bin_name
    gltf = {"asset": {"version": "2.0"}, "scene": 0,
            "scenes": [{"nodes": list(range(len(nodes)))}], "nodes": nodes, "meshes": meshes,
            "materials": materials, "textures": [{"source": i} for i in range(len(images))],
            "images": images, "buffers": [{"uri": uri, "byteLength": len(blob)}],
            "bufferViews": views, "accessors": accessors}
    (root / "Models" / f"{name}.gltf").write_text(json.dumps(gltf))

    # ---- the env cube and the BRDF LUT
    faces = env_cube_faces(env_size, seed)
    (root / "Textures" / "output_pmrem.dds").write_bytes(encode_dds(
        [[lv.astype(np.float16) for lv in chain] for chain in faces], 10, env_size, env_size,
        cube=True))
    nv = np.linspace(0.0, 1.0, 128, dtype=np.float32)[None, :]
    a = np.linspace(0.0, 1.0, 32, dtype=np.float32)[:, None] ** 2
    lut = np.stack([1.0 - a * 0.5 - 0.25 * (1.0 - nv), a * 0.25 * nv], -1)
    (root / "Textures" / "PreintegratedGF.dds").write_bytes(encode_dds(
        [[np.round(np.clip(lut, 0.0, 1.0) * 65535.0).astype(np.uint16)]], 35, 128, 32,
        legacy=True))

    center = data.scene_center
    scene = {
        "models": [{"path": f"Models/{name}.gltf", "id": name}],
        "lights": [{"direction": [0.4, -0.8, 0.3], "intensity": 3.0,
                    "color": [1.0, 0.95, 0.9]}],
        "camera": {"position": [0.0, 1.5, -4.0], "look_at": [float(v) for v in center],
                   "fov_y": 60.0},
        "environment": {"background": [0.05, 0.05, 0.07]},
    }
    path = root / "Scenes" / f"{name}.json"
    path.write_text(json.dumps(scene, indent=1))
    return path


# ---------------------------------------------------------------------------
# M1's inputs on synthetic setups (ops/raster_kernels.py masked_raster)
# ---------------------------------------------------------------------------

# the special setups of the masked raster: random triangles; coplanar copies
# (equal keys: the min id wins); depth planes of +0 and -0 (keys of exactly 0
# that tie); slivers (a sliver's rounded edges cover pixels past its box);
# vertex alphas within ulps of the cutoff
MASKED_CASES = ("random", "ties", "zero", "slivers", "cutoff")
# (mip-0 rects of the synthetic atlas: (x0, y0, w0, h0), chains to the right)
MASKED_RECTS = ((0.0, 0.0, 32.0, 32.0), (64.0, 0.0, 16.0, 16.0), (64.0, 32.0, 8.0, 8.0),
                (0.0, 32.0, 32.0, 16.0))
MASKED_ATLAS_W, MASKED_ATLAS_H = 128, 64


def masked_raster_setup(case: str, seed: int, device, width: int = 256, height: int = 256,
                        n: int = 120):
    """A ``RasterSetup`` of ``n`` triangles over a ``width`` x ``height``
    image and its (T, 19) alpha records (``render/common.py
    _alpha_records``' columns) for one of ``MASKED_CASES``; one row in ten is
    invalid and holds NaN coefficients.  The slivers' boxes are shrunk, so
    that the binning places them in tiles where their edges cover pixels
    past the box.  Returns (setup, arec)."""
    from ..ops.fma import fdot
    from ..ops.raster import CULL_NONE, RasterSetup, triangle_setup_from_components

    if case not in MASKED_CASES:
        raise ValueError(f"masked_raster_setup: case must be one of {MASKED_CASES}")
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    ctr[:, 2] = rng.uniform(0.1, 0.9, n)
    size = 0.08
    d1 = rng.normal(0, size, (n, 3)).astype(np.float32)
    d2 = rng.normal(0, size, (n, 3)).astype(np.float32)
    if case == "slivers":  # d2 almost along d1: slivers 1e-3 to 3e-2 of their length wide
        d1 *= 3.0
        thin = size * np.exp(rng.uniform(np.log(1e-3), np.log(3e-2), (n, 1)))
        d2 = (d1 * rng.uniform(-1.0, 1.0, (n, 1)) + rng.normal(0, 1.0, (n, 3)) * thin
              ).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (n, 3)).astype(np.float32)  # perspective: keys nz / nw
    if case in ("ties", "zero"):  # every other row a copy of the one before
        for a in (ctr, d1, d2, w):
            a[1::2] = a[0::2][: n // 2]
    v = np.stack([ctr - d1, ctr + d2, ctr + d1], 1)
    t = {k: torch.from_numpy(np.ascontiguousarray(x)).to(device) for k, x in
         (("v", v), ("w", w))}
    px = [(t["v"][:, k, 0] * 0.5 + 0.5) * width * t["w"][:, k] for k in range(3)]
    py = [(0.5 - t["v"][:, k, 1] * 0.5) * height * t["w"][:, k] for k in range(3)]
    pw = [t["w"][:, k] for k in range(3)]
    zc = [t["v"][:, k, 2] * t["w"][:, k] for k in range(3)]
    s = triangle_setup_from_components(
        px[0], py[0], pw[0], px[1], py[1], pw[1], px[2], py[2], pw[2], *zc,
        torch.ones(n, dtype=torch.bool, device=device), CULL_NONE, width, height)
    coef, valid = s.coef.clone(), s.valid.clone()
    if case == "zero":  # depth planes of exactly +0 and -0: a tie at key 0
        coef[0::2, 9:12] = 0.0
        coef[1::2, 9:12] = -0.0
    bbox = s.bbox.clone()
    if case == "slivers":  # every other box shrunk to 2 px about its centre: the
        # raster must cover the pixels past it that the edges pass, as a
        # sliver's rounded edges do past its true box
        mid = torch.stack([bbox[0] + bbox[2], bbox[1] + bbox[3]]) * 0.5
        bbox[:, 1::2] = torch.cat([mid - 1.0, mid + 1.0])[:, 1::2]
    dead = torch.from_numpy(np.arange(n) % 10 == 7).to(device)
    valid &= ~dead
    coef[dead, :15] = float("nan")
    setup = RasterSetup(coef=coef, valid=valid, bbox=bbox)

    def interp(x):  # (T, 3) per-vertex values -> their (a, b, c) numerators
        return torch.stack([fdot([(coef[:, 3 * r + k], x[:, k]) for k in range(3)])
                            for r in range(3)], dim=1)

    uv = torch.from_numpy(rng.uniform(-0.5, 1.5, (n, 3, 2)).astype(np.float32)).to(device)
    if case == "cutoff":  # no map: the alpha is the vertex alpha, 0.5 within ulps
        alpha = np.full((n, 3), 0.5, np.float32)
        has = np.zeros(n, np.float32)
        cutoff = np.nextafter(np.float32(0.5), np.float32(rng.choice([-1, 1], n)) * np.inf,
                              dtype=np.float32)
        cutoff[::3] = 0.5
    else:
        alpha = rng.uniform(0.6, 1.0, (n, 3)).astype(np.float32)
        has = (rng.random(n) < 0.8).astype(np.float32)
        cutoff = rng.uniform(0.0, 0.6, n).astype(np.float32)
        if case in ("ties", "zero"):
            cutoff[:] = 0.0  # every copy passes: the tie decides
    rects = np.asarray(MASKED_RECTS, np.float32)[rng.integers(0, len(MASKED_RECTS), n)]
    host = [torch.from_numpy(x).to(device) for x in (alpha, rects, has[:, None],
                                                     rng.uniform(0.8, 1.2, (n, 1))
                                                     .astype(np.float32), cutoff[:, None])]
    arec = torch.cat([interp(uv[..., 0]), interp(uv[..., 1]), interp(host[0]),
                      interp(torch.ones_like(host[0])), *host[1:]], dim=1)
    return setup, arec


def masked_raster_atlas(layout: str, dtype, device, seed: int = 0):
    """A random material atlas the masked raster samples: ``layout`` "quad4"
    (4 channels a texel, 16 lanes: the per-slot atlas), "quad16" (the
    combined material's 64 lanes) or "packed" (the 256-lane
    packed-trilinear atlas), ``MASKED_ATLAS_W`` texels a row, in ``dtype``
    (u8 only at 16 channels).  Returns (flat (rows, lanes), atlas width)."""
    lanes = {"quad4": 16, "quad16": 64, "packed": 256}[layout]
    rng = np.random.default_rng(seed)
    shape = (MASKED_ATLAS_H * MASKED_ATLAS_W, lanes)
    if dtype == torch.uint8:
        flat = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
    else:
        flat = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dtype)
    return flat.to(device), MASKED_ATLAS_W


def masked_raster_args(setup, arec, atlas, atlas_width: int, width: int, height: int,
                       form: str = "binned", chunk: int = 64, tile=(16, 64), y_offset: int = 0,
                       full_height: int | None = None, bilinear: bool = False,
                       misaligned: bool = False):
    """The positional arguments of one ``masked_raster`` call on ``setup``:
    ``form`` "binned" (the masked level-1 binning of the frame,
    ``bin_triangles`` at span 4 and budget 4.0, every block slot passed
    with each tile's range) or "exhaustive" (the table in chunks,
    ``table_chunks``); ``misaligned`` passes
    the tables as views one element into a larger buffer."""
    from ..ops.binning import bin_triangles
    from ..ops.raster_kernels import table_chunks, tile_block_ranges

    th, tw = tile
    if form == "binned":
        bins = bin_triangles(setup, width, height, th, tw, chunk, max_span=4, budget_factor=4.0,
                             y_offset=y_offset, full_height=full_height)
        start, count = tile_block_ranges(bins, -(-width // tw) * -(-height // th))
        ids = bins.tri_id[:, 0]
        tables = [bins.coef, ids, bins.valid, ids, arec]
    elif form == "exhaustive":
        coef, rows, valid = table_chunks(setup, chunk)
        start = count = None
        tables = [coef, rows, valid, rows, arec]
    else:
        raise ValueError(f"masked_raster_args: form must be binned or exhaustive, got {form!r}")
    if misaligned:
        def shift(x):
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
            view = buf[1:].view(x.shape)
            view.copy_(x)
            return view
        tables = [shift(x) for x in tables]
    coef, ids, valid, rows, arec = tables
    return (coef, ids, valid, rows, start, count, arec, atlas, atlas_width, th, tw, width, height,
            y_offset, full_height, bilinear)
