"""Render parameter structures (``unclerenderer_tpu/render/params.py``).

* RenderSettings: static pipeline configuration.  Every field name and
  default of the reference is kept (a test checks them).  Fields that only
  chose between TPU implementations with identical output
  (``raster_backend``, ``pallas_interpret``, ``bin_align_scatter``,
  ``compact_mode``, ``env_matmul_gather``) are accepted and the port runs
  its one implementation.  The four kernel flags launch their kernel, as
  on the reference's Pallas path: ``hzb_pallas_tail`` K6,
  ``env_select_kernel`` K7 (not under ``env_matmul_gather``: the
  reference's precedence), ``mat_select_kernel`` K8 (packed-trilinear
  atlas) and ``bin_mat_idx`` K9.  Branches the port has not taken over yet
  raise ``NotImplementedError`` naming their ROADMAP queue entry
  (``check_supported``).
* FrameParams / DeviceScene / FrameState: dataclasses of tensors, all on one
  explicit device.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    width: int = 1280
    height: int = 720
    renderer_type: str = "deferred"  # "deferred" | "forward"
    enable_shadows: bool = True
    shadow_map_size: int = 4096
    enable_sky: bool = True
    enable_ibl: bool = True
    enable_tonemap: bool = True
    enable_auto_exposure: bool = True
    enable_taa: bool = True
    enable_cas: bool = True
    enable_gpu_culling: bool = True
    enable_hzb: bool = True
    has_masked_models: bool = True
    masked_tri_cap: int = -1
    slot_enabled: tuple = (True, True, True, True)
    texture_filter: str = "trilinear"
    max_anisotropy: int = 4
    aniso_compact_frac: float = 0.0
    lod_derivatives: str = "quad"
    enable_combined_material: bool = True
    material_packed_trilinear: bool | str = "auto"
    combined_material: bool = False
    compact_cap: int = -1
    soa_vertex: bool = True
    raster_backend: str = "auto"
    fused_resolve: str = "auto"
    pallas_interpret: bool = False
    tile_h: int = 16
    tile_w: int = 64
    chunk: int = 64
    shadow_chunk: int = 64
    shadow_tile_h: int = 32
    shadow_tile_w: int = 128
    shadow_big_tile_h: int = 32
    shadow_big_tile_w: int = 128
    shadow_giant_tile_h: int = 64
    shadow_giant_tile_w: int = 512
    shadow_bin_budget_factor: float = 1.5
    shadow_compact_cap: int = -1
    shadow_table_u16: bool = True
    material_atlas_u8: bool = True
    kernel_debug_print: bool = False
    gpu_debug_print: bool = False
    bin_max_span: int = 2
    bin_align_scatter: bool = True
    bin_budget_factor: float = 2.0
    hzb_pallas_tail: bool = False
    giant_tile_h: int = 64
    giant_tile_w: int = 256
    bin_mid_divisor: int = 16
    bin_giant_divisor: int = 128
    bin_giant_chunk: int = 8
    compact_mode: str = "sort"
    bin_mat_idx: bool = False
    env_matmul_gather: bool = False
    env_select_kernel: bool = False
    mat_select_kernel: bool = False


# material-count boundary for material_packed_trilinear="auto" (reference
# value)
PACKED_TRI_AUTO_MATERIALS = 6


def resolve_packed_trilinear(setting, n_materials: int) -> bool:
    """Resolve the packed-trilinear atlas choice at scene build."""
    if setting == "auto":
        return n_materials > PACKED_TRI_AUTO_MATERIALS
    if not isinstance(setting, bool):
        raise ValueError(
            "material_packed_trilinear must be True, False or 'auto'; "
            f"got {setting!r}"
        )
    return setting


# titles of the ROADMAP.md modules-queue entries that still raise
FORWARD_PATH = "forward path"
SAMPLING = "non-default sampling and storage"
FUSED_RESOLVE = "fused resolve"
OBSERVABILITY = "observability"


def not_ported(what: str, entry: str) -> NotImplementedError:
    """The error for a branch the port does not run yet; ``entry`` is the
    title of its ROADMAP.md modules-queue entry."""
    return NotImplementedError(
        f"{what} is not ported to unclerenderer_tpu_torch yet "
        f"(ROADMAP.md, modules queue: {entry})"
    )


def check_supported(settings: RenderSettings) -> None:
    """Raise for every setting whose branch the port does not run, instead
    of silently computing something else."""
    if settings.texture_filter not in ("trilinear", "bilinear", "anisotropic"):
        raise ValueError(f"unknown texture_filter {settings.texture_filter!r}")
    unsupported = [
        (settings.renderer_type != "deferred", "renderer_type='forward'", FORWARD_PATH),
        (settings.lod_derivatives != "quad", "lod_derivatives='forward'", SAMPLING),
        (not settings.soa_vertex, "soa_vertex=False (AoS vertex stage)", SAMPLING),
        (settings.fused_resolve == "on", "fused_resolve='on'", FUSED_RESOLVE),
        (not settings.shadow_table_u16, "shadow_table_u16=False", SAMPLING),
        (settings.gpu_debug_print, "gpu_debug_print", OBSERVABILITY),
        (settings.kernel_debug_print, "kernel_debug_print", OBSERVABILITY),
    ]
    for bad, what, entry in unsupported:
        if bad:
            raise not_ported(what, entry)


@dataclasses.dataclass
class FrameParams:
    view: torch.Tensor = None
    proj: torch.Tensor = None            # jittered when TAA active
    proj_unjittered: torch.Tensor = None  # for culling/frustum/sky rays
    view_proj: torch.Tensor = None
    camera_pos: torch.Tensor = None
    light_dir: torch.Tensor = None     # points toward the light (Y-flipped)
    light_intensity: torch.Tensor = None
    light_color: torch.Tensor = None
    light_view_proj: torch.Tensor = None
    shadow_strength: torch.Tensor = None
    shadow_bias: torch.Tensor = None
    background: torch.Tensor = None
    model_visible: torch.Tensor = None  # (M,) bool host-controlled visibility
    env_mip_count: torch.Tensor = None
    tonemap_exposure: torch.Tensor = None
    tonemap_gamma: torch.Tensor = None
    cas_sharpness: torch.Tensor = None
    taa_history_weight: torch.Tensor = None
    auto_exposure_key: torch.Tensor = None
    auto_exposure_min: torch.Tensor = None
    auto_exposure_max: torch.Tensor = None
    auto_exposure_speed_up: torch.Tensor = None
    auto_exposure_speed_down: torch.Tensor = None
    delta_time: torch.Tensor = None


@dataclasses.dataclass
class DeviceScene:
    # geometry (world space, de-indexed: vertex i of triangle t at row 3t+i)
    position: torch.Tensor = None   # (V, 3)
    normal: torch.Tensor = None     # (V, 3)
    tangent: torch.Tensor = None    # (V, 4)
    uv: torch.Tensor = None         # (V, 2)
    color: torch.Tensor = None      # (V, 4)
    tris: torch.Tensor = None       # (T, 3) i32
    tri_model: torch.Tensor = None  # (T,) i32
    # per-model tables (M rows)
    base_color_factor: torch.Tensor = None  # (M, 3)
    base_color_alpha: torch.Tensor = None   # (M,)
    metallic_factor: torch.Tensor = None
    roughness_factor: torch.Tensor = None
    emissive_factor: torch.Tensor = None    # (M, 3)
    alpha_mode: torch.Tensor = None         # (M,) i32
    alpha_cutoff: torch.Tensor = None
    uv_transform: torch.Tensor = None       # (M, 4, 4)
    uv_rotation: torch.Tensor = None        # (M, 4, 2)
    tex_ids: torch.Tensor = None            # (M, 4) i32
    has_map: torch.Tensor = None            # (M, 4) bool
    object_ids: torch.Tensor = None         # (M,) i64 (u32 in the reference)
    bounds_min: torch.Tensor = None         # (M, 3)
    bounds_max: torch.Tensor = None         # (M, 3)
    quad_img: torch.Tensor = None           # (AH, AW, 64) u8 | bf16 quad atlas
    brdf_lut: torch.Tensor = None           # (TH, TW, 2) f32
    env_quad: torch.Tensor = None           # (EH, EW, 128) bf16 packed-trilinear
    env_rect0: torch.Tensor = None          # (6, 4) f32
    env_tail: torch.Tensor = None           # (6, th, tw, 4) f32
    tri_geo: torch.Tensor = None            # (T, 48) f32 vertex attributes
    tri_mrec: torch.Tensor = None           # (T, 64) f32 model constants
    pos_soa: torch.Tensor = None            # (3, 3, T) f32 [slot][xyz][tri]


@dataclasses.dataclass
class FrameState:
    """Carried across frames."""

    taa_history: torch.Tensor = None      # (H, W, 3) f32
    taa_valid: torch.Tensor = None        # () bool
    exposure_ev: torch.Tensor = None      # () f32
    exposure_valid: torch.Tensor = None   # () bool
    hzb: torch.Tensor = None              # packed min-depth pyramid, f32
    hzb_valid: torch.Tensor = None        # () bool
    frame_index: torch.Tensor = None      # () i32

    @staticmethod
    def initial(width: int, height: int, device="cuda") -> "FrameState":
        from ..ops.hzb import hzb_layout

        _layout, total = hzb_layout(width // 2, height // 2)
        return FrameState(
            taa_history=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
            taa_valid=torch.tensor(False, device=device),
            exposure_ev=torch.tensor(0.0, dtype=torch.float32, device=device),
            exposure_valid=torch.tensor(False, device=device),
            hzb=torch.zeros(total, dtype=torch.float32, device=device),
            hzb_valid=torch.tensor(False, device=device),
            frame_index=torch.tensor(0, dtype=torch.int32, device=device),
        )
