"""The forward frame (``unclerenderer_tpu/render/forward.py``), single
device: the port of the D3D12 renderer's ``FForwardRenderer``.  One shading
pass (GGX, forward 2x2 PCF, IBL, emissive) straight to the output, sky or
background on empty pixels, clipped to [0, 1] as the UNORM backbuffer
stores it.  No G-buffer, TAA, auto-exposure, tonemap, CAS or HZB, no
culling (the caller's ``model_visible`` is drawn as it is) and no frame
state; the stats block is the deferred frame's alone.

The vertex stage, visibility raster, masked raster, fused resolve, material
resolve and shadow table are the deferred frame's (``render/common.py``,
``render/deferred.py pack_table``): K1, K2/K3 (with records under
``fused_resolve="on"``), K4 (u16 or f32 rows) through the forward PCF blend,
K5, and K7 and K8 under their flags.
"""

from __future__ import annotations

import torch

from ..ops import pbr
from ..ops import texture as tex
from ..ops.shadow import shadow_factor_blocks
from ..ops.sky import apply_atmosphere, sky_view_directions
from . import common
from .deferred import pack_table
from .params import DeviceScene, FrameParams, RenderSettings, check_supported


def forward_frame(scene: DeviceScene, params: FrameParams, settings: RenderSettings,
                  shadow_map: torch.Tensor | None = None) -> dict:
    """One forward frame.  ``shadow_map``: a light-space depth map the
    caller rendered (the Renderer's cached map); without one the frame
    rasters its own.  Returns 'color' (H, W, 3) linear in [0, 1], 'depth',
    'tri_id' (compact ids under compaction, as the reference's), 'object_id'
    (uint32) and 'raster_stats'."""
    check_supported(settings)
    dev = scene.tri_geo.device
    width, height = settings.width, settings.height

    verts = common.frame_vertices(scene, params.view_proj, width, height, settings)
    pix9 = verts.pix9()
    opaque_mask, masked_mask = common.tri_draw_masks(scene, params.model_visible)
    depth, tri_id, raster_stats, attr, compact_ids = common.raster_opaque(
        scene, opaque_mask, settings, verts, fused=common.use_fused_resolve(settings))
    if settings.has_masked_models:
        masked = common.raster_masked_combine(scene, masked_mask, depth, tri_id, settings, verts,
                                              attr=attr)
        depth, tri_id = masked[0], masked[1]
        attr = masked[3] if attr is not None else None

    shadow_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if settings.enable_shadows:
        if shadow_map is None:
            shadow_map, shadow_overflow = common.raster_shadow(
                scene, params.light_view_proj, opaque_mask | masked_mask, settings)
        shadow9 = pack_table(shadow_map, settings)

    g = common.resolve_materials(scene, pix9, tri_id, settings, compact_ids=compact_ids,
                                 full_override=attr)
    if settings.texture_filter == "anisotropic":
        raster_stats["aniso_tap_overflow"] = g["aniso_tap_overflow"]

    # world-space shading (ForwardPS.hlsl)
    n = g["normal"]
    v = pbr.normalize(params.camera_pos - g["world_pos"])
    light = pbr.normalize(params.light_dir)
    f0 = 0.04 + (g["albedo"] - 0.04) * g["metallic"][..., None]  # lerp(0.04, albedo, metallic)

    if settings.enable_shadows:
        shadow = shadow_factor_blocks(shadow9, settings.shadow_map_size, g["world_pos"],
                                      params.light_view_proj, params.shadow_strength,
                                      params.shadow_bias, pcf="forward")
    else:
        shadow = torch.ones_like(g["metallic"])

    direct = (
        pbr.evaluate_pbr(g["albedo"], g["metallic"], g["roughness"], f0, n, v, light)
        * params.light_intensity * params.light_color * shadow[..., None]
    )

    if settings.enable_ibl:
        env_flat = scene.env_quad.reshape(-1, scene.env_quad.shape[-1])
        env_w = scene.env_quad.shape[1]

        # K7 decodes the packed env rows (the forward frame has no
        # env_matmul_gather branch in the reference)
        def env_sample(direction, lod):
            return tex.sample_cube_pyramid_tri(env_flat, env_w, scene.env_rect0, direction,
                                               lod, select_kernel=settings.env_select_kernel)[..., :3]

        def env_sample_level(direction, level):
            del level  # always the last mip: its texels live in env_tail
            return tex.sample_cube_tail_matmul(scene.env_tail, direction)[..., :3]

        def brdf_sample(uv):
            return tex.sample_table_bilinear_matmul(scene.brdf_lut, uv)

        ambient = pbr.ibl_ambient(g["albedo"], g["metallic"], f0, n, v, env_sample, brdf_sample,
                                  params.env_mip_count, g["roughness"],
                                  env_sample_level_fn=env_sample_level)
    else:
        ambient = torch.zeros_like(direct)

    color = direct + ambient + g["emissive"]

    if settings.enable_sky:
        view_dir = sky_view_directions(width, height, params.camera_pos, params.view,
                                       params.proj_unjittered)
        bg = apply_atmosphere(view_dir, params.camera_pos, params.light_dir, params.light_color)
    else:
        bg = torch.broadcast_to(params.background, (height, width, 3))
    # the UNORM backbuffer takes linear values: no tonemap, no gamma
    color = torch.clamp(torch.where(g["valid"][..., None], color, bg), 0.0, 1.0)

    # uint32 as in the reference (ids exact below 2^24; deferred.py)
    object_id = torch.where(g["valid"], g["object_id_f"].to(torch.int32),
                            torch.zeros_like(tri_id, dtype=torch.int32)).view(torch.uint32)
    raster_stats["shadow_compact_overflow"] = shadow_overflow
    return {
        "color": color,
        "depth": depth,
        "tri_id": tri_id,
        "object_id": object_id,
        "raster_stats": raster_stats,
    }
