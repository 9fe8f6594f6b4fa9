"""The deferred frame (``unclerenderer_tpu/render/deferred.py``): culling ->
shadow map -> visibility raster (opaque, then the alpha-masked models
merged in; with fused resolve the raster kernels emit each pixel's resolve
record) -> material resolve -> HZB -> lighting (GGX, superblock PCF, IBL)
-> sky -> TAA -> auto-exposure -> tonemap -> CAS -> the debug-print stats
block, on one device or, with ``dist`` (``parallel/dist.py``), on this
rank's row slab of a sharded frame (``parallel/multichip.py``).  The vertex
stage is SoA or AoS (``soa_vertex``, ``common.frame_vertices``) and the
shadow table u16 or f32 (``shadow_table_u16``), as the reference picks
them.  Frames are carried as in the reference: ``deferred_frame(scene,
params, state, settings, shadow_map=None, dist=None) -> (out,
new_state)``; the Renderer passes the shadow map it caches."""

from __future__ import annotations

import torch

from ..core.passes import scope
from ..ops import pbr
from ..ops import texture as tex
from ..ops.cull import frustum_cull, occlusion_cull
from ..ops.fma import fma
from ..ops.hzb import build_hzb, hzb_layout
from ..ops.overlay import device_stats_overlay
from ..ops.post import (
    auto_exposure_ev,
    cas_sharpen,
    ev_adapt,
    pooled_log_luminance_slab,
    temporal_aa,
    tonemap,
)
from ..ops.shadow import pack_shadow_blocks, pack_shadow_blocks_u16, shadow_factor_blocks
from ..ops.sky import apply_atmosphere, sky_view_directions
from . import common
from .params import DeviceScene, FrameParams, FrameState, RenderSettings, check_supported


def _matmul4(a, b):
    """(4, 4) @ (4, 4) in the reference's XLA:CPU dot order
    ``(a0*b0 + a1*b1) + (a2*b2 + a3*b3)``."""
    return (a[:, 0:1] * b[0:1, :] + a[:, 1:2] * b[1:2, :]) + (
        a[:, 2:3] * b[2:3, :] + a[:, 3:4] * b[3:4, :])


def frustum_planes(view_proj):
    """Normalized frustum planes (6, 4) from a row-vector view-projection."""
    c = [view_proj[:, i] for i in range(4)]
    planes = torch.stack([c[3] + c[0], c[3] - c[0], c[3] + c[1], c[3] - c[1], c[2], c[3] - c[2]], dim=0)
    p = planes[:, :3]
    norms = torch.sqrt(fma(p[:, 2], p[:, 2], fma(p[:, 1], p[:, 1], p[:, 0] * p[:, 0])))[:, None]
    return planes / torch.where(norms > 0, norms, torch.ones_like(norms))


def pack_table(shadow_map, settings: RenderSettings):
    """The superblock PCF table of a shadow map: u16 rows under
    ``shadow_table_u16`` (the default), else f32."""
    if settings.shadow_table_u16:
        return pack_shadow_blocks_u16(shadow_map)
    return pack_shadow_blocks(shadow_map)


def deferred_frame(scene: DeviceScene, params: FrameParams, state: FrameState,
                   settings: RenderSettings, shadow_map: torch.Tensor | None = None, dist=None):
    """One frame.  ``shadow_map``: a light-space depth map the caller
    rendered (``Renderer._shadow_map``: light and geometry are static); the
    frame then packs it and runs no shadow raster of its own, and its
    ``shadow_compact_overflow`` stays 0.

    ``dist`` supplies the collective hooks (``parallel/dist.py``): None (one
    device) renders the whole frame; a ``RowShards`` renders this rank's
    row slab with the same math -- the shadow map and the HZB's source depth
    all-gathered, the exposure grid and the counters summed over the ranks,
    the TAA/CAS neighbourhoods and the forward LOD's seam rows exchanged.
    ``state.taa_history`` and the image outputs are then the slab's rows;
    the scalars, the HZB and ``tri_remap`` are the same on every rank."""
    check_supported(settings)
    if dist is None:
        from ..parallel.dist import SingleChip

        dist = SingleChip(settings.height)
    sharded = dist.n_dev > 1
    dev = scene.tri_geo.device
    width, height = settings.width, settings.height
    slab_h = dist.slab_h
    layout, _total = hzb_layout(width // 2, height // 2)

    # --- 1. GPU culling (unjittered camera VP)
    model_visible = params.model_visible
    unjittered_vp = _matmul4(params.view, params.proj_unjittered)
    frustum_culled = torch.zeros((), dtype=torch.int32, device=dev)
    hzb_occluded = torch.zeros((), dtype=torch.int32, device=dev)
    if settings.enable_gpu_culling:
        in_frustum = frustum_cull(scene.bounds_min, scene.bounds_max, frustum_planes(unjittered_vp))
        frustum_culled = (model_visible & ~in_frustum).sum().to(torch.int32)
        model_visible = model_visible & in_frustum
        if settings.enable_hzb:
            occluded = occlusion_cull(scene.bounds_min, scene.bounds_max, unjittered_vp,
                                      state.hzb, layout, width // 2, height // 2)
            occluded = occluded & state.hzb_valid
            hzb_occluded = (model_visible & occluded).sum().to(torch.int32)
            model_visible = model_visible & ~occluded

    # --- 2. shadow map: casters are not camera-culled
    opaque_mask, masked_mask = common.tri_draw_masks(scene, model_visible)
    shadow_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    shadow9 = None
    if settings.enable_shadows:
        if shadow_map is None:
            cast_o, cast_m = common.tri_draw_masks(scene, params.model_visible)
            shadow_map, shadow_overflow = common.raster_shadow(
                scene, params.light_view_proj, cast_o | cast_m, settings, dist)
        with scope("ShadowPack"):
            shadow9 = pack_table(shadow_map, settings)

    # --- 3/4/5. visibility raster (fused resolve: the kernels also emit
    # each pixel's resolve record, attr, which the resolve takes as it is)
    with scope("VertexSetup"):
        verts = common.frame_vertices(scene, params.view_proj, width, height, settings)
        pix9 = verts.pix9()
    depth, tri_id, raster_stats, attr, compact_ids = common.raster_opaque(
        scene, opaque_mask, settings, verts, fused=common.use_fused_resolve(settings), dist=dist)
    if settings.has_masked_models:
        masked = common.raster_masked_combine(scene, masked_mask, depth, tri_id, settings, verts,
                                              attr=attr, dist=dist)
        depth, tri_id = masked[0], masked[1]
        attr = masked[3] if attr is not None else None
    # the binning counters are per slab: summed; the camera compaction runs
    # the same on every rank, so its count is not (nor the shadow one's)
    raster_stats = {k: (v if k == "compact_overflow" else dist.psum(v))
                    for k, v in raster_stats.items()}
    raster_stats["shadow_compact_overflow"] = shadow_overflow

    above, below = dist.row_halo(tri_id) if sharded else (None, None)
    g = common.resolve_materials(
        scene, pix9, tri_id, settings, compact_ids=compact_ids, full_override=attr,
        row0=dist.row0, next_tri_row=below, prev_tri_row=above,
        row_halo=dist.row_halo if sharded else None)
    if settings.texture_filter == "anisotropic":
        # each slab compacts its own pixels
        raster_stats["aniso_tap_overflow"] = dist.psum(g["aniso_tap_overflow"])

    # --- 6. HZB for next frame, from the whole frame's depth (hzb_pallas_tail:
    # levels past the first two by K6)
    new_hzb = (build_hzb(dist.all_gather_rows(depth), layout,
                         pallas_tail=settings.hzb_pallas_tail)
               if settings.enable_hzb else state.hzb)

    # --- 7. lighting (view space)
    view3 = params.view[:3, :3]
    normal_view = pbr.normalize(g["normal"] @ view3)
    l_view = pbr.normalize(params.light_dir @ view3)
    hom_w = torch.cat([g["world_pos"], torch.ones_like(g["world_pos"][..., :1])], dim=-1)
    view_pos = (hom_w @ params.view)[..., :3]
    v_view = pbr.normalize(-view_pos)
    f0 = 0.04 + (g["albedo"] - 0.04) * g["metallic"][..., None]

    if settings.enable_shadows:
        shadow = shadow_factor_blocks(shadow9, settings.shadow_map_size, g["world_pos"],
                                      params.light_view_proj, params.shadow_strength,
                                      params.shadow_bias)
    else:
        shadow = torch.ones_like(g["metallic"])

    with scope("DirectLighting"):
        direct = (
            pbr.evaluate_pbr(g["albedo"], g["metallic"], g["roughness"], f0, normal_view,
                             v_view, l_view)
            * params.light_intensity * params.light_color * shadow[..., None]
        )

    if settings.enable_ibl:
        env_flat = scene.env_quad.reshape(-1, scene.env_quad.shape[-1])
        env_w = scene.env_quad.shape[1]

        # K7 decodes the packed env rows; env_matmul_gather takes precedence
        # (the reference's order), and only changes how the row is gathered
        env_kernel = settings.env_select_kernel and not settings.env_matmul_gather

        def env_sample(direction, lod):
            return tex.sample_cube_pyramid_tri(env_flat, env_w, scene.env_rect0, direction,
                                               lod, select_kernel=env_kernel)[..., :3]

        def env_sample_level(direction, level):
            del level  # always the last mip: its texels live in env_tail
            return tex.sample_cube_tail_matmul(scene.env_tail, direction)[..., :3]

        def brdf_sample(uv):
            return tex.sample_table_bilinear_matmul(scene.brdf_lut, uv)

        n_world = pbr.normalize(g["normal"])
        v_world = pbr.normalize(params.camera_pos - g["world_pos"])
        ambient = pbr.ibl_ambient(g["albedo"], g["metallic"], f0, n_world, v_world,
                                  env_sample, brdf_sample, params.env_mip_count,
                                  g["roughness"], env_sample_level_fn=env_sample_level)
    else:
        ambient = torch.zeros_like(direct)

    lighting = g["emissive"] + direct + ambient

    # --- 8. sky on empty pixels
    if settings.enable_sky:
        view_dir = sky_view_directions(width, height, params.camera_pos, params.view,
                                       params.proj_unjittered, row0=dist.row0, out_h=slab_h)
        bg = apply_atmosphere(view_dir, params.camera_pos, params.light_dir, params.light_color)
    else:
        bg = torch.broadcast_to(params.background, (slab_h, width, 3))
    hdr = torch.where(g["valid"][..., None], lighting, bg)

    # --- 9. TAA (a slab's seams clamp against the neighbours' rows)
    pad_fn = dist.halo2d if sharded else None
    if settings.enable_taa:
        hdr = temporal_aa(hdr, state.taa_history, params.taa_history_weight, state.taa_valid,
                          pad_fn=pad_fn)
        new_history = hdr
        new_taa_valid = torch.tensor(True, device=dev)
    else:
        new_history = state.taa_history
        new_taa_valid = torch.tensor(False, device=dev)

    # --- 10. auto exposure (sharded: each slab's partial sums of the 16x16
    # grid, summed over the ranks)
    if settings.enable_auto_exposure:
        adapt = (state.exposure_ev, state.exposure_valid, params.auto_exposure_key,
                 params.auto_exposure_min, params.auto_exposure_max,
                 params.auto_exposure_speed_up, params.auto_exposure_speed_down,
                 params.delta_time)
        if sharded:
            new_ev = ev_adapt(pooled_log_luminance_slab(hdr, dist.row0, height, dist.psum),
                              *adapt)
        else:
            new_ev = auto_exposure_ev(hdr, *adapt)
        new_exposure_valid = torch.tensor(True, device=dev)
    else:
        new_ev = state.exposure_ev
        new_exposure_valid = torch.tensor(False, device=dev)

    # --- 11. tonemap, 12. CAS (the UNORM backbuffer clamps its overshoot)
    color = tonemap(hdr, params.tonemap_exposure, new_ev, settings.enable_tonemap,
                    settings.enable_auto_exposure, params.tonemap_gamma)
    if settings.enable_cas:
        color = torch.clamp(cas_sharpen(color, params.cas_sharpness, pad_fn=pad_fn), 0.0, 1.0)

    # --- 13. the debug-print stats block, drawn from device counters
    if settings.gpu_debug_print:
        with scope("GpuDebugPrint"):
            color = device_stats_overlay(
                color, models_visible=model_visible.sum().to(torch.int32),
                models_total=int(model_visible.shape[0]), frustum_culled=frustum_culled,
                hzb_occluded=hzb_occluded, exposure_ev=new_ev)

    # uint32 as in the reference; ids ride an f32 record column, so they are
    # exact integers below 2^24 and the int32 bits are the uint32 value
    object_id = torch.where(g["valid"], g["object_id_f"].to(torch.int32),
                            torch.zeros_like(tri_id, dtype=torch.int32)).view(torch.uint32)
    new_state = FrameState(
        taa_history=new_history,
        taa_valid=new_taa_valid,
        exposure_ev=new_ev,
        exposure_valid=new_exposure_valid,
        hzb=new_hzb,
        hzb_valid=torch.tensor(settings.enable_hzb, device=dev),
        frame_index=state.frame_index + 1,
    )
    out = {
        "color": color,
        "hdr": hdr,
        "depth": depth,
        "tri_id": tri_id,
        "object_id": object_id,
        "model_visible": model_visible,
        "raster_stats": raster_stats,
        "frustum_culled": frustum_culled,
        "hzb_occluded": hzb_occluded,
    }
    if compact_ids is not None:
        out["tri_remap"] = compact_ids
    return out, new_state
