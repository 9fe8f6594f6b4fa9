"""Synthetic scenes for tests, smoke runs and benchmarks -- no asset files.

The procedural half of ``unclerenderer_tpu/render/testing.py``, JAX-free: a
grid of cubes/spheres (plus an optional floor and back wall of giant
triangles) with procedural materials, assembled into the port's
``DeviceScene`` on the card (or on the device the caller names).  The
host-side geometry and texture building is the port's own copy of the
reference's numpy modules (``mathlib``, ``scene``, ``textures``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import mathlib as m
from ..scene.build import GltfMaterial, SceneData, SceneModel
from ..scene.mesh import compute_mesh_bounds, create_cube, create_sphere
from ..textures.atlas import build_pyramid_quad_atlas, build_pyramid_tri_atlas
from ..textures.image import combined_chain, default_grid_texture, encode_combined_u8, generate_mips
from .packing import pack_model_record, pack_tri_geo, pack_tri_mrec
from .params import SAMPLING, DeviceScene, FrameParams, not_ported, resolve_packed_trilinear


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


def _rich_material_chains(n_combos: int, tex_size: int):
    """Procedural Sponza-like material set: baseColor + metallic-roughness +
    normal maps (emissive on combo 0) fused into combined 16-channel chains
    (same numbers as the reference)."""
    combos = []
    for ci in range(n_combos):
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
            e = np.zeros((tex_size // 4, tex_size // 4, 4), np.float32)
            ys, xs = np.mgrid[0 : tex_size // 4, 0 : tex_size // 4]
            glow = ((ys // 8 + xs // 8) % 4 == 0).astype(np.float32)
            e[..., 0] = glow * 1.0
            e[..., 1] = glow * 0.8
            e[..., 2] = glow * 0.4
            emis = generate_mips(e)
        combos.append(
            combined_chain(
                [generate_mips(base), generate_mips(mr), generate_mips(nm.astype(np.float32)), emis]
            )
        )
    return combos


def synthetic_device_scene(
    n_objects: int = 4,
    seed: int = 0,
    sphere_res: tuple = (12, 8),
    ground: bool = False,
    rich_materials: bool = False,
    packed_trilinear: bool | str = False,
    atlas_u8: bool = False,
    device="cuda",
):
    """Returns ``(DeviceScene, SceneData)``, the scene on ``device`` (the
    card unless the caller names another).  rich_materials gives every
    model fused baseColor+MR+normal(+emissive) maps in one combined
    16-channel chain (render with ``combined_material=True``, the only
    material branch the port runs).  packed_trilinear (True, False or
    "auto", resolved against the 6 materials) builds the 256-lane
    packed-trilinear atlas instead of the 64-lane quad atlas."""
    if not rich_materials:
        raise not_ported("per-slot material atlases (rich_materials=False)", SAMPLING)
    data = synthetic_scene_data(n_objects, seed, sphere_res=sphere_res, ground=ground)
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
    model_rec = pack_model_record(data, has_map, slot_rect0)
    tri_geo = pack_tri_geo(data)
    tri_mrec = pack_tri_mrec(data, model_rec)
    scene = _assemble_device_scene(data, tex_ids, has_map, quad_img, tri_geo, tri_mrec, device)
    return scene, data


def _assemble_device_scene(data, tex_ids, has_map, quad_img, tri_geo, tri_mrec, device) -> DeviceScene:
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    if quad_img.dtype == np.uint8:
        quad = t(quad_img)
    else:
        # f32 -> bf16 rounds to nearest even, like the reference's conversion
        quad = t(quad_img.astype(np.float32)).to(torch.bfloat16)
    env_rect0 = torch.zeros((6, 4), dtype=torch.float32, device=device)
    env_rect0[:, 2:] = 1.0
    return DeviceScene(
        position=t(data.position),
        pos_soa=t(data.position.reshape(-1, 3, 3).transpose(1, 2, 0)),
        normal=t(data.normal),
        tangent=t(data.tangent),
        uv=t(data.uv),
        color=t(data.color),
        tris=t(data.tri_indices.astype(np.int32)),
        tri_model=t(data.tri_model.astype(np.int32)),
        base_color_factor=t(data.base_color_factor),
        base_color_alpha=t(data.base_color_alpha),
        metallic_factor=t(data.metallic_factor),
        roughness_factor=t(data.roughness_factor),
        emissive_factor=t(data.emissive_factor),
        alpha_mode=t(data.alpha_mode.astype(np.int32)),
        alpha_cutoff=t(data.alpha_cutoff),
        uv_transform=t(data.uv_transform),
        uv_rotation=t(data.uv_rotation),
        tex_ids=t(tex_ids),
        has_map=t(has_map),
        object_ids=t(data.object_ids.astype(np.int64)),
        bounds_min=t(data.bounds_min_arr),
        bounds_max=t(data.bounds_max_arr),
        quad_img=quad,
        brdf_lut=torch.full((32, 128, 2), 0.5, dtype=torch.float32, device=device),
        env_quad=torch.full((8, 128, 128), 0.1, dtype=torch.bfloat16, device=device),
        env_rect0=env_rect0,
        env_tail=torch.full((6, 1, 1, 4), 0.1, dtype=torch.float32, device=device),
        tri_geo=t(tri_geo),
        tri_mrec=t(tri_mrec),
    )


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
