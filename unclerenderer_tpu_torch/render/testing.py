"""Synthetic scenes for tests, smoke runs and benchmarks.

The procedural half of ``unclerenderer_tpu/render/testing.py``, JAX-free: a
grid of cubes/spheres (plus an optional floor and back wall of giant
triangles) with procedural materials, assembled into the port's
``DeviceScene`` on the card (or on the device the caller names) through
the Renderer's upload (``params.upload_scene``).  The host-side geometry
and texture building is the port's own copy of the reference's numpy
modules (``mathlib``, ``scene``, ``textures``).  ``write_scene`` writes the
same geometry as scene files (scene JSON, glTF, PNG, DDS) for the
Renderer's loaders.
"""

from __future__ import annotations

import base64
import json
import struct
from pathlib import Path

import numpy as np
import torch

from .. import mathlib as m
from ..scene.build import GltfMaterial, SceneData, SceneModel
from ..scene.mesh import compute_mesh_bounds, create_cube, create_sphere
from ..textures.atlas import build_pyramid_quad_atlas, build_pyramid_tri_atlas
from ..textures.image import (
    combined_chain,
    default_grid_texture,
    encode_combined_u8,
    generate_mips,
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

    position, normal, tangent, uv, color = (np.concatenate(p) for p in parts)
    tri_indices = np.concatenate(tri_parts)
    data.tri_model = np.concatenate(tri_model_parts)
    flat = tri_indices.reshape(-1)  # de-indexed layout
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
    data.base_color_alpha = np.array([mm.material.base_color_alpha for mm in data.models], np.float32)
    data.metallic_factor = np.array([mm.material.metallic_factor for mm in data.models], np.float32)
    data.roughness_factor = np.array([mm.material.roughness_factor for mm in data.models], np.float32)
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
    return data


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
    6 materials) builds the 256-lane packed-trilinear atlas instead of the
    64-lane quad atlas."""
    data = synthetic_scene_data(n_objects, seed, sphere_res=sphere_res, ground=ground)
    if rich_materials:
        if with_masked:
            raise ValueError("rich_materials does not model MASK materials")
        tex_ids, has_map, quad_img, slot_rect0 = _rich_materials(data, packed_trilinear, atlas_u8)
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


def _rich_materials(data, packed_trilinear, atlas_u8: bool):
    """(tex_ids, has_map, atlas, per-slot rects) of the 6 combined
    materials; sets the emissive factors."""
    n = data.num_models
    n_combos = 6
    combo_chains = _rich_material_chains(n_combos, tex_size=256)
    mat_dtype = np.float32
    if atlas_u8:
        combo_chains = [[encode_combined_u8(lv) for lv in ch] for ch in combo_chains]
        mat_dtype = np.uint8
    build = (build_pyramid_tri_atlas if resolve_packed_trilinear(packed_trilinear, n_combos)
             else build_pyramid_quad_atlas)
    quad_img, rect0 = build(combo_chains, wrap=True, dtype=mat_dtype)
    model_combo = np.arange(n, dtype=np.int32) % n_combos
    tex_ids = np.repeat(model_combo[:, None], 4, axis=1).astype(np.int32)
    has_map = np.ones((n, 4), bool)
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
