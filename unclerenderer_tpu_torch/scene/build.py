"""Host-side scene records (``unclerenderer_tpu/scene/build.py`` and the
material record of ``scene/gltf.py``): ``SceneModel`` per drawable,
``SceneData`` with the flat, world-space, de-indexed geometry and the
per-model constant tables, and ``GltfMaterial``.  The same fields and
defaults as the reference; the glTF and scene-JSON loaders that fill them
from asset files are not part of the port yet (ROADMAP.md, modules queue:
Renderer shell and CLI).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TextureTransform:
    """KHR_texture_transform of one material slot."""

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

    # Per-model constant tables (M rows)
    base_color_factor: np.ndarray = None  # (M, 3)
    base_color_alpha: np.ndarray = None   # (M,)
    metallic_factor: np.ndarray = None    # (M,)
    roughness_factor: np.ndarray = None   # (M,)
    emissive_factor: np.ndarray = None    # (M, 3)
    alpha_mode: np.ndarray = None         # (M,) u32: 0 opaque, 1 mask
    alpha_cutoff: np.ndarray = None       # (M,)
    uv_transform: np.ndarray = None       # (M, 4, 4): per slot (off.x, off.y, scale.x, scale.y)
    uv_rotation: np.ndarray = None        # (M, 4, 2): (cos, sin) per slot
    bounds_min_arr: np.ndarray = None     # (M, 3)
    bounds_max_arr: np.ndarray = None     # (M, 3)
    object_ids: np.ndarray = None         # (M,) u32
    visible_mask: np.ndarray = None       # (M,) bool (host-controlled visibility)

    # Texture paths per model per slot (base, mr, normal, emissive)
    texture_paths: list = dataclasses.field(default_factory=list)

    @property
    def num_models(self) -> int:
        return len(self.models)

    @property
    def num_triangles(self) -> int:
        return 0 if self.tri_indices is None else int(self.tri_indices.shape[0])
