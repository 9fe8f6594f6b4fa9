"""Scene assembly (``unclerenderer_tpu/scene/build.py``): scene JSON + glTF
-> flat, device-ready numpy arrays, as the D3D12 renderer's
``RendererUtils::CreateSceneModelsFromJson`` (``RendererUtils.cpp:298-543``):
per (node, primitive section) model records with world matrices
``NodeWorld @ S @ R @ T``, whole-mesh world AABBs, material constants and
sequential object ids; the scene's centre and radius from the union of the
models' bounding spheres.

Node worlds are static, so positions, normals and tangents are
pre-transformed to world space here and de-indexed (the three vertices of
triangle t at rows 3t..3t+2).  Normals use the straight 3x3 world matrix
and stay unnormalized, as the reference's vertex shaders; tangents are
normalized.  ``GltfMaterial`` and ``TextureTransform`` live in
``scene/gltf.py`` and are re-exported here.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .. import mathlib as m
from ..core.logging import log_error
from ..core.paths import resolve_path_case_insensitive
from .gltf import GltfMaterial, GltfNode, TextureTransform, load_gltf  # noqa: F401 (re-exported)
from .mesh import compute_mesh_bounds, generate_normals_if_missing, generate_tangents_if_missing
from .scene_json import load_scene_json


@dataclasses.dataclass
class SceneModel:
    """Host-side record for one drawable (node x primitive section)."""

    name: str = ""
    object_id: int = 0
    world: np.ndarray = None  # (4,4) row-vector
    center: np.ndarray = None
    radius: float = 1.0
    bounds_min: np.ndarray = None
    bounds_max: np.ndarray = None
    visible: bool = True
    material: GltfMaterial = None
    tri_start: int = 0  # range into the global triangle list
    tri_count: int = 0


@dataclasses.dataclass
class SceneData:
    """Flat arrays feeding the device renderer."""

    # Geometry (world space, pre-transformed)
    position: np.ndarray = None  # (V, 3) f32
    normal: np.ndarray = None    # (V, 3) f32 unnormalized world normal
    tangent: np.ndarray = None   # (V, 4) f32 normalized xyz + handedness w
    uv: np.ndarray = None        # (V, 2) f32
    color: np.ndarray = None     # (V, 4) f32
    tri_indices: np.ndarray = None  # (T, 3) u32
    tri_model: np.ndarray = None    # (T,) u32

    models: list = dataclasses.field(default_factory=list)  # list[SceneModel]
    scene_center: np.ndarray = None
    scene_radius: float = 1.0

    # Per-model constant tables (M rows), the analog of FSceneConstants'
    # material section (SceneConstants.hlsl / RendererUtils.cpp:1029-1088).
    base_color_factor: np.ndarray = None  # (M, 3)
    base_color_alpha: np.ndarray = None   # (M,)
    metallic_factor: np.ndarray = None    # (M,)
    roughness_factor: np.ndarray = None   # (M,)
    emissive_factor: np.ndarray = None    # (M, 3)
    alpha_mode: np.ndarray = None         # (M,) u32: 0 opaque, 1 mask
    alpha_cutoff: np.ndarray = None       # (M,)
    uv_transform: np.ndarray = None       # (M, 4, 4): per slot (off.x, off.y, scale.x, scale.y) rows 0..3 = base/mr/normal/emissive offset-scale
    uv_rotation: np.ndarray = None        # (M, 4, 2): (cos, sin) per slot
    bounds_min_arr: np.ndarray = None     # (M, 3)
    bounds_max_arr: np.ndarray = None     # (M, 3)
    object_ids: np.ndarray = None         # (M,) u32
    visible_mask: np.ndarray = None       # (M,) bool (host-controlled visibility)

    # Texture paths per model per slot (host side; resolved to atlas ids later)
    texture_paths: list = dataclasses.field(default_factory=list)  # list[(base, mr, normal, emissive)]

    @property
    def num_models(self) -> int:
        return len(self.models)

    @property
    def num_triangles(self) -> int:
        return 0 if self.tri_indices is None else int(self.tri_indices.shape[0])


def _max_scale_of(world_rv: np.ndarray) -> float:
    """Max basis-vector length (``ComputeMaxScale``); rows are the basis in
    row-vector convention."""
    return float(np.max(np.linalg.norm(world_rv[:3, :3], axis=1)))


def build_scene(scene_path: str | Path, assets_root: str | Path | None = None) -> SceneData | None:
    scene_path = Path(scene_path)
    descs, _light, _camera = load_scene_json(scene_path)
    if not descs:
        log_error(f"Scene JSON did not provide any models: {scene_path}")
        return None
    if assets_root is None:
        # Scene files live in Assets/Scenes/, mesh paths are relative to Assets/
        # (RendererUtils.cpp:323-328).
        assets_root = scene_path.parent.parent

    data = SceneData()
    pos_parts, nrm_parts, tan_parts, uv_parts, col_parts = [], [], [], [], []
    tri_parts, tri_model_parts = [], []
    vertex_offset = 0
    tri_offset = 0
    next_object_id = 1
    scene_min = np.full(3, np.inf, np.float32)
    scene_max = np.full(3, -np.inf, np.float32)

    for desc in descs:
        mesh_path = Path(desc.mesh_path)
        if not mesh_path.is_absolute():
            mesh_path = Path(assets_root) / mesh_path
        mesh_path = resolve_path_case_insensitive(mesh_path)
        gltf = load_gltf(mesh_path)
        if gltf is None or not gltf.meshes:
            log_error(f"Failed to load mesh from scene: {mesh_path}")
            continue

        for mesh in gltf.meshes:
            generate_normals_if_missing(mesh)
            generate_tangents_if_missing(mesh)

        nodes = gltf.nodes
        if not nodes:
            nodes = [
                GltfNode(mesh_index=i, world=np.eye(4, dtype=np.float32), name=f"Mesh_{i}")
                for i in range(len(gltf.meshes))
            ]

        max_scale = float(np.max(np.abs(desc.scale)))
        model_xform = (
            m.scaling(desc.scale)
            @ m.rotation_roll_pitch_yaw(*np.radians(desc.rotation_euler))
            @ m.translation(desc.position)
        )

        for node in nodes:
            if node.mesh_index < 0 or node.mesh_index >= len(gltf.meshes):
                continue
            mesh = gltf.meshes[node.mesh_index]
            center_l, radius_l, bmin_l, bmax_l = compute_mesh_bounds(mesh)
            node_scale = _max_scale_of(node.world)
            world = node.world @ model_xform  # NodeWorld * S * R * T (row-vector)

            bmin_w, bmax_w = m.transform_aabb(bmin_l, bmax_l, world)
            center_w = (np.append(center_l, 1.0).astype(np.float32) @ world)[:3]
            radius_w = radius_l * max_scale * node_scale

            # Pre-transform geometry to world space.
            n_verts = mesh.position.shape[0]
            hom = np.concatenate([mesh.position, np.ones((n_verts, 1), np.float32)], axis=1)
            pos_ws = (hom @ world)[:, :3].astype(np.float32)
            nrm_ws = (mesh.normal @ world[:3, :3]).astype(np.float32)
            tan_ws = mesh.tangent[:, :3] @ world[:3, :3]
            tan_len = np.linalg.norm(tan_ws, axis=1, keepdims=True)
            tan_ws = tan_ws / np.maximum(tan_len, 1e-20)
            tan_ws = np.concatenate([tan_ws, mesh.tangent[:, 3:4]], axis=1).astype(np.float32)

            pos_parts.append(pos_ws)
            nrm_parts.append(nrm_ws)
            tan_parts.append(tan_ws)
            uv_parts.append(mesh.uv)
            col_parts.append(mesh.color)

            base_name = node.name if node.name else f"Mesh_{node.mesh_index}"
            sections = mesh.primitives
            for s_idx, section in enumerate(sections):
                mat = section.material or GltfMaterial()
                tris = mesh.indices[
                    section.index_start : section.index_start + section.index_count
                ].reshape(-1, 3).astype(np.uint32) + np.uint32(vertex_offset)
                model_index = len(data.models)
                tri_parts.append(tris)
                tri_model_parts.append(np.full(tris.shape[0], model_index, np.uint32))

                model = SceneModel(
                    name=base_name + (f"_Prim{s_idx}" if len(sections) > 1 else ""),
                    object_id=next_object_id,
                    world=world.astype(np.float32),
                    center=center_w.astype(np.float32),
                    radius=float(radius_w),
                    bounds_min=bmin_w,
                    bounds_max=bmax_w,
                    visible=desc.visible,
                    material=mat,
                    tri_start=tri_offset,
                    tri_count=int(tris.shape[0]),
                )
                next_object_id += 1
                tri_offset += int(tris.shape[0])
                data.models.append(model)

                base_override = desc.base_color_texture_override
                if base_override:
                    p = Path(base_override)
                    base_override = str(p if p.is_absolute() else Path(assets_root) / p)
                data.texture_paths.append(
                    (
                        base_override or mat.base_color_texture,
                        mat.metallic_roughness_texture,
                        mat.normal_texture,
                        mat.emissive_texture,
                    )
                )

                # Scene bounds from model bounding spheres (UpdateSceneBounds).
                scene_min = np.minimum(scene_min, center_w - radius_w)
                scene_max = np.maximum(scene_max, center_w + radius_w)

            vertex_offset += n_verts

    if not data.models:
        log_error(f"No renderable models could be created from scene JSON: {scene_path}")
        return None

    position = np.concatenate(pos_parts, axis=0)
    normal = np.concatenate(nrm_parts, axis=0)
    tangent = np.concatenate(tan_parts, axis=0)
    uv = np.concatenate(uv_parts, axis=0)
    color = np.concatenate(col_parts, axis=0)
    tri_indices = np.concatenate(tri_parts, axis=0)
    data.tri_model = np.concatenate(tri_model_parts, axis=0)

    # De-index: store the three vertices of triangle t at rows 3t..3t+2.
    # TPU per-triangle vertex gathers lower poorly; a de-indexed layout makes
    # the whole raster setup gather-free (reshape/slice only) at ~3x vertex
    # memory -- cheap next to the framebuffers.
    flat = tri_indices.reshape(-1)
    data.position = position[flat]
    data.normal = normal[flat]
    data.tangent = tangent[flat]
    data.uv = uv[flat]
    data.color = color[flat]
    data.tri_indices = np.arange(flat.size, dtype=np.uint32).reshape(-1, 3)

    data.scene_center = ((scene_min + scene_max) * 0.5).astype(np.float32)
    data.scene_radius = max(float(np.linalg.norm(scene_max - scene_min) * 0.5), 1.0)

    n_models = len(data.models)
    data.base_color_factor = np.stack([mm.material.base_color_factor for mm in data.models])
    data.base_color_alpha = np.array([mm.material.base_color_alpha for mm in data.models], np.float32)
    data.metallic_factor = np.array([mm.material.metallic_factor for mm in data.models], np.float32)
    data.roughness_factor = np.array([mm.material.roughness_factor for mm in data.models], np.float32)
    data.emissive_factor = np.stack([mm.material.emissive_factor for mm in data.models])
    data.alpha_mode = np.array(
        [1 if mm.material.alpha_mask else 0 for mm in data.models], np.uint32
    )
    data.alpha_cutoff = np.array([mm.material.alpha_cutoff for mm in data.models], np.float32)
    uv_t = np.zeros((n_models, 4, 4), np.float32)
    uv_r = np.zeros((n_models, 4, 2), np.float32)
    for i, mm in enumerate(data.models):
        mat = mm.material
        for s, t in enumerate(
            (
                mat.base_color_transform,
                mat.metallic_roughness_transform,
                mat.normal_transform,
                mat.emissive_transform,
            )
        ):
            uv_t[i, s] = t.offset_scale()
            uv_r[i, s] = t.rotation_vec()[:2]
    data.uv_transform = uv_t
    data.uv_rotation = uv_r
    data.bounds_min_arr = np.stack([mm.bounds_min for mm in data.models])
    data.bounds_max_arr = np.stack([mm.bounds_max for mm in data.models])
    data.object_ids = np.array([mm.object_id for mm in data.models], np.uint32)
    data.visible_mask = np.array([mm.visible for mm in data.models], bool)
    return data
