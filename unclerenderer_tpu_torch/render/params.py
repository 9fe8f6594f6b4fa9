"""Render parameter structures (``unclerenderer_tpu/render/params.py``).

* RenderSettings: static pipeline configuration.  Every field name and
  default of the reference is kept (a test checks them).  Fields that only
  chose between TPU implementations with identical output
  (``pallas_interpret``, ``bin_align_scatter``, ``compact_mode``,
  ``env_matmul_gather``) are accepted and the port runs its one
  implementation.  ``raster_backend`` picks a different image:
  ``"xla"`` runs the reference's XLA path (the exhaustive raster X1, the
  per-texel f16 PCF table, plain gathers, none of K1-K9), whose PCF
  differs at shadow edges and which drops nothing at a bin budget;
  ``"pallas"`` and ``"auto"`` run the kernel path on either device
  (``render/common.py use_kernel_path``; the reference's ``"auto"`` is
  its XLA path on the CPU).  The four kernel flags launch their kernel on
  the kernel path, as on the reference's Pallas path: ``hzb_pallas_tail`` K6,
  ``env_select_kernel`` K7 (not under ``env_matmul_gather``: the
  reference's precedence), ``mat_select_kernel`` K8 (packed-trilinear
  atlas; where the taps run as ``material_tap``, T2 on the card, T2 takes
  K8's blends instead, ``render/common.py tap_kernels_engage``) and
  ``bin_mat_idx`` K9.  ``fused_resolve="on"`` makes K1 and K2
  emit each pixel's resolve record (``render/common.py
  use_fused_resolve``); ``renderer_type`` picks the Renderer's frame
  (``deferred_frame`` itself ignores it, as the reference's does).  The
  non-default sampling and storage branches run as the reference's:
  ``lod_derivatives="forward"`` (forward-difference LOD), ``soa_vertex=False``
  (the AoS vertex stage) and ``shadow_table_u16=False`` (the f32 PCF table,
  K4 on f32 rows); ``kernel_debug_print`` makes K1 print its live blocks.
  Every field's branch runs; ``check_supported`` refuses unknown values
  of ``texture_filter`` and ``raster_backend``.
* FrameParams / DeviceScene / FrameState: dataclasses of tensors, all on one
  explicit device; ``upload_scene`` puts a scene's host arrays there
  (bfloat16 carried as uint16 bits, ``bf16_bits``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
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


def check_supported(settings: RenderSettings) -> None:
    """Raise for a setting value no branch takes, instead of silently
    computing something else."""
    if settings.texture_filter not in ("trilinear", "bilinear", "anisotropic"):
        raise ValueError(f"unknown texture_filter {settings.texture_filter!r}")
    if settings.raster_backend not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown raster_backend {settings.raster_backend!r}")


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


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> the uint16 bit patterns of bfloat16, rounded to nearest
    even by torch (as ``ml_dtypes`` rounds the reference's casts)."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def upload_scene(host: dict, device) -> DeviceScene:
    """A scene's host arrays (every ``DeviceScene`` field, numpy) -> the
    ``DeviceScene`` on ``device``.  The one way a scene reaches the card:
    the Renderer's loaded scenes and ``render/testing.py``'s synthetic ones.
    uint16 arrays are bfloat16 bit patterns (``bf16_bits``); uint32
    (``object_ids``) widens to int64, as the port keeps ids."""
    def tensor(a):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint16:
            return torch.from_numpy(a.view(np.int16)).to(device).view(torch.bfloat16)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.from_numpy(a).to(device)

    missing = {f.name for f in dataclasses.fields(DeviceScene)} ^ set(host)
    if missing:
        raise ValueError(f"upload_scene: host arrays do not match DeviceScene: {sorted(missing)}")
    return DeviceScene(**{k: tensor(v) for k, v in host.items()})


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
