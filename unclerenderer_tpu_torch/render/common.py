"""Frame building blocks (``unclerenderer_tpu/render/common.py``): vertex
stage, draw masks, the opaque and shadow visibility rasters, and the
material resolve (combined material on the quad or the packed-trilinear
atlas; trilinear, bilinear and anisotropic filters with quad-derivative
LOD; compact id space)."""

from __future__ import annotations

import torch

from ..ops import pbr
from ..ops import texture as tex
from ..ops.fma import fdiff, fdot, fma
from ..ops.raster import (
    CULL_BACK,
    CULL_FRONT,
    DEPTH_MAX,
    DEPTH_MIN,
    VertexSoA,
    compact_mask,
    compact_setup,
    normalize_ortho_setup,
    triangle_setup_from_soa,
)
from ..ops.raster_kernels import rasterize_binned
from . import packing as PK
from .params import SAMPLING, DeviceScene, RenderSettings, not_ported

SLOT_NORMAL = 2  # material slot of the normal map (has_map column)


def vertex_stage_soa(pos_soa, view_proj, width: int, height: int) -> VertexSoA:
    """World -> clip -> homogeneous pixel coords on (T,) component vectors
    (``pos_soa`` is (3, 3, T) = [vertex slot][x/y/z][tri])."""
    m = view_proj
    px, py, pw, z = [], [], [], []
    for i in range(3):
        x, y, zc = pos_soa[i, 0], pos_soa[i, 1], pos_soa[i, 2]

        def col(j):
            return fdot([(x, m[0, j]), (y, m[1, j]), (zc, m[2, j])], m[3, j])

        cy, cz, cw, cx = col(1), col(2), col(3), col(0)
        px.append((cx * 0.5 + cw * 0.5) * width)
        py.append((cw * 0.5 - cy * 0.5) * height)
        pw.append(cw)
        z.append(cz)
    return VertexSoA(px=tuple(px), py=tuple(py), pw=tuple(pw), z=tuple(z))


def tri_draw_masks(scene: DeviceScene, model_visible: torch.Tensor):
    """Per-triangle opaque / alpha-masked draw masks: the two per-model
    flags gathered per triangle by K5 (``ops/texture.py gather_rows``)."""
    table = torch.stack([model_visible, scene.alpha_mode == 1], dim=-1).to(torch.bfloat16)
    got = tex.gather_rows(table, scene.tri_model) > 0.5
    vis, masked = got[..., 0], got[..., 1]
    return vis & ~masked, vis & masked


def compaction_cap(settings: RenderSettings, t_count: int) -> int:
    """Static frame-visible compaction cap (0 = off); the reference's rule,
    which also fixes the id space of ``tri_id``."""
    if settings.has_masked_models:
        return 0
    cap = settings.compact_cap
    if cap == -1:
        if t_count <= 94208:
            return 0
        if t_count > 2 * 163840:
            return 0
        cap = 163840
    if cap <= 0 or cap >= t_count:
        return 0
    return cap


def shadow_compaction_cap(settings: RenderSettings, t_count: int) -> int:
    """Light-space compaction cap for the depth-only shadow raster."""
    cap = settings.shadow_compact_cap
    if cap == -1:
        cap = 0 if t_count <= 94208 else 163840
    if cap <= 0 or cap >= t_count:
        return 0
    return cap


def _raster(setup, width, height, tile_h, tile_w, chunk, depth_mode, settings,
            want_ids=True, ortho=False, budget_factor=None, giant_tile=(0, 0),
            big_tile=None):
    big = {} if big_tile is None else {"big_tile_h": big_tile[0], "big_tile_w": big_tile[1]}
    return rasterize_binned(
        setup, width, height, tile_h=tile_h, tile_w=tile_w, chunk=chunk,
        depth_mode=depth_mode, max_span=settings.bin_max_span, **big,
        budget_factor=(settings.bin_budget_factor if budget_factor is None else budget_factor),
        mid_divisor=settings.bin_mid_divisor, giant_divisor=settings.bin_giant_divisor,
        giant_tile_h=giant_tile[0], giant_tile_w=giant_tile[1],
        giant_chunk=settings.bin_giant_chunk, want_ids=want_ids, ortho=ortho,
        mat_idx=settings.bin_mat_idx,
    )


def raster_opaque(scene: DeviceScene, tri_mask, settings: RenderSettings, vsoa: VertexSoA):
    """Camera visibility raster.  Returns ``(depth, tri_id, stats,
    compact_ids)``; with a nonzero ``compaction_cap`` the raster runs over
    the frame-visible compacted list and ``tri_id`` holds COMPACT ids
    (``compact_ids`` maps them back; None when off)."""
    setup = triangle_setup_from_soa(vsoa, tri_mask, CULL_BACK, settings.width, settings.height)
    cap = compaction_cap(settings, setup.valid.shape[0])
    cids = None
    c_overflow = torch.zeros((), dtype=torch.int32, device=tri_mask.device)
    if cap:
        setup, cids, c_overflow = compact_setup(setup, cap)
    h = settings.height
    depth, tri_id, stats = _raster(
        setup, settings.width, h, min(settings.tile_h, h), settings.tile_w,
        settings.chunk, DEPTH_MAX, settings,
        giant_tile=(min(settings.giant_tile_h, h), settings.giant_tile_w),
    )
    stats = dict(stats)
    stats["compact_overflow"] = c_overflow
    return depth, tri_id, stats, cids


def raster_shadow(scene: DeviceScene, light_view_proj, tri_mask, settings: RenderSettings):
    """Depth-only shadow raster: CULL_FRONT + LESS_EQUAL over an ortho
    projection.  Returns ``(depth, compact_overflow)``."""
    size = settings.shadow_map_size
    vs = vertex_stage_soa(scene.pos_soa, light_view_proj, size, size)
    setup = triangle_setup_from_soa(vs, tri_mask, CULL_FRONT, size, size)
    cap = shadow_compaction_cap(settings, setup.valid.shape[0])
    overflow = torch.zeros((), dtype=torch.int32, device=tri_mask.device)
    if cap:
        setup, _ids, overflow = compact_setup(setup, cap)
    setup = normalize_ortho_setup(setup)
    depth, _, _stats = _raster(
        setup, size, size, min(settings.shadow_tile_h, size), settings.shadow_tile_w,
        settings.shadow_chunk, DEPTH_MIN, settings, want_ids=False, ortho=True,
        budget_factor=settings.shadow_bin_budget_factor,
        giant_tile=(settings.shadow_giant_tile_h, settings.shadow_giant_tile_w),
        big_tile=(min(settings.shadow_big_tile_h, size), settings.shadow_big_tile_w),
    )
    return depth, overflow


def build_resolve_records(scene: DeviceScene, pix9, ids=None):
    """(T or cap, 128) per-triangle resolve record
    [9 pix_h | 48 tri_geo | 64 tri_mrec | 7 pad]; ``ids`` builds it for the
    compact rows only."""
    parts = [pix9, scene.tri_geo, scene.tri_mrec]
    if ids is not None:
        li = ids.long()
        parts = [p[li] for p in parts]
    rows = parts[0].shape[0]
    parts.append(torch.zeros((rows, 7), dtype=torch.float32, device=pix9.device))
    return torch.cat(parts, dim=1)


def _edge_fn(pa, pb, X, Y):
    """Screen-space edge function of the pixel's triangle, contracted like
    the reference (near-degenerate triangles amplify any rounding
    difference through the barycentric divide)."""
    cx = fdiff(pa[..., 1], pb[..., 2], pa[..., 2], pb[..., 1])
    cy = fdiff(pa[..., 2], pb[..., 0], pa[..., 0], pb[..., 2])
    cz = fdiff(pa[..., 0], pb[..., 1], pa[..., 1], pb[..., 0])
    return fdot([(cx, X), (cy, Y)], cz)


def _interp3(w, av, offset, n):
    """sum_k w_k * attr_k over the three vertex blocks of the record."""
    a = [av[..., 9 + k * 16 + offset:9 + k * 16 + offset + n] for k in range(3)]
    return fdot([(w[0][..., None], a[0]), (w[1][..., None], a[1]), (w[2][..., None], a[2])])


def _atlas_is_packed_tri(quad_flat) -> bool:
    """The combined packed-trilinear atlas has 16 * 16 = 256 lanes, the
    combined quad atlas 64."""
    return quad_flat.shape[-1] == 256


def _sample_level_any(quad_flat, atlas_width, rect0, uv, level):
    """Bilinear tap at an integer mip on either atlas layout."""
    if _atlas_is_packed_tri(quad_flat):
        return tex.sample_pyramid_tri_level(quad_flat, atlas_width, rect0, uv, level)
    return tex.sample_pyramid_bilinear(quad_flat, atlas_width, rect0, uv, level)


def _sample_trilinear_any(quad_flat, atlas_width, rect0, uv, lod, select_kernel=False):
    """Trilinear tap on either layout: one row gather on the packed atlas
    (``select_kernel``: decoded by K8), two on the quad atlas."""
    if _atlas_is_packed_tri(quad_flat):
        return tex.sample_pyramid_tri(quad_flat, atlas_width, rect0, uv, lod,
                                      select_kernel=select_kernel)
    return tex.sample_pyramid_trilinear(quad_flat, atlas_width, rect0, uv, lod)


def _sample_aniso(quad_flat, atlas_width, rect0, suv, d_dx, d_dy, base_w, base_h, valid,
                  settings: RenderSettings):
    """D3D12_FILTER_ANISOTROPIC analog: ``max_anisotropy`` trilinear taps
    along the major-axis footprint at the minor-axis LOD.  Returns (sample,
    aniso_tap_overflow).

    With 0 < ``aniso_compact_frac`` < 1 the line taps run only over a
    compacted list of the anisotropic pixels (extent > 0; static cap =
    that fraction of the image, at least 1024) and every other pixel takes
    one centre tap, which equals its N coincident taps; pixels past the cap
    keep the centre tap and are counted.  With one combined material slot
    the count is written once, so the reference's per-slot overwrite of it
    (render/common.py:1219) cannot arise here."""
    n = settings.max_anisotropy
    sk = settings.mat_select_kernel
    lod, dmaj, extent = tex.footprint_lod_aniso(d_dx, d_dy, base_w, base_h, n)

    def line_taps(rect, uv, lod, dmaj, extent):
        acc = 0.0
        for k in range(n):
            t = ((k + 0.5) / n - 0.5) * extent
            # the reference's uv + dmaj * t contracts to one FMA on XLA:CPU
            acc = acc + _sample_trilinear_any(quad_flat, atlas_width, rect,
                                              fma(dmaj, t[..., None], uv), lod, select_kernel=sk)
        return acc / n

    frac = settings.aniso_compact_frac
    if not 0.0 < frac < 1.0:
        return line_taps(rect0, suv, lod, dmaj, extent), torch.zeros((), dtype=torch.int32,
                                                                     device=suv.device)
    lead = suv.shape[:-1]
    n_pix = lead.numel()
    cap = max(1024, (int(n_pix * frac) // 1024) * 1024)
    amask = ((extent > 0.0) & valid).reshape(n_pix)
    ids, ok = compact_mask(amask, cap)
    safe = torch.where(ok, ids, torch.zeros_like(ids)).long()

    def flat(x):
        return x.reshape((n_pix,) + x.shape[len(lead):])[safe]

    acc = line_taps(flat(rect0), flat(suv), flat(lod), flat(dmaj), flat(extent))
    center = _sample_trilinear_any(quad_flat, atlas_width, rect0, suv, lod, select_kernel=sk)
    img = center.reshape((n_pix,) + center.shape[len(lead):]).clone()
    img[ids[ok].long()] = acc[ok]
    overflow = (amask.sum() - ok.sum()).to(torch.int32)
    return img.reshape(center.shape), overflow


def resolve_materials(scene: DeviceScene, pix9, tri_id, settings: RenderSettings,
                      compact_ids=None):
    """Visibility buffer -> interpolated attributes + sampled materials:
    ONE per-pixel gather of the 128-wide record, then the combined-material
    tap (``settings.texture_filter``) at the quad-derivative LOD.  The
    result carries ``aniso_tap_overflow`` (0 unless the compacted
    anisotropic taps overflowed their cap)."""
    if settings.lod_derivatives != "quad" or not settings.combined_material:
        raise not_ported("this material resolve branch", SAMPLING)
    width, height = settings.width, tri_id.shape[0]
    dev = tri_id.device
    rec = build_resolve_records(scene, pix9, ids=compact_ids)
    safe_id = torch.clamp(tri_id, min=0).long()
    full = rec[safe_id]  # (H, W, 128)
    av = full[..., 0:57]
    mrec = full[..., 57:121]
    valid = tri_id >= 0
    p0, p1, p2 = av[..., 0:3], av[..., 3:6], av[..., 6:9]

    yy = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    qx, qy = xx + 0.5, yy + 0.5

    e0 = _edge_fn(p1, p2, qx, qy)
    e1 = _edge_fn(p2, p0, qx, qy)
    e2 = _edge_fn(p0, p1, qx, qy)
    ssum = e0 + e1 + e2
    ssum = torch.where(ssum != 0.0, ssum, torch.ones_like(ssum))
    bary = (e0 / ssum, e1 / ssum, e2 / ssum)
    world_pos = _interp3(bary, av, 0, 3)
    v_normal = _interp3(bary, av, 3, 3)
    tangent4 = _interp3(bary, av, 6, 4)
    uv = _interp3(bary, av, 10, 2)
    v_color = _interp3(bary, av, 12, 4)

    def M(c, n=1):
        return mrec[..., c:c + n] if n > 1 else mrec[..., c]

    model_id = M(PK.M_ID).to(torch.int32)
    has = M(PK.M_HAS, 4) > 0.5
    uv_os = M(PK.M_UVOS, 16)
    uv_rot = M(PK.M_UVROT, 8)
    rects = M(PK.M_RECT, 16)

    # D3D 2x2-quad derivatives with helper-lane semantics, evaluated
    # analytically from the pixel's own triangle at the quad corners
    xi = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    yi = torch.arange(height, dtype=torch.int32, device=dev)[:, None]
    bx = (xi & ~1).to(torch.float32)
    by = (yi & ~1).to(torch.float32)

    def uv_at(X, Y):
        f0 = _edge_fn(p1, p2, X, Y)
        f1 = _edge_fn(p2, p0, X, Y)
        f2 = _edge_fn(p0, p1, X, Y)
        fs = f0 + f1 + f2
        fs = torch.where(fs != 0.0, fs, torch.ones_like(fs))
        return _interp3((f0 / fs, f1 / fs, f2 / fs), av, 10, 2)

    uv_tl = uv_at(bx + 0.5, by + 0.5)
    uv_tr = uv_at(bx + 1.5, by + 0.5)
    uv_bl = uv_at(bx + 0.5, by + 1.5)

    quad_flat = scene.quad_img.reshape(-1, scene.quad_img.shape[-1])
    atlas_width = scene.quad_img.shape[1]

    # combined material: all maps fused into one 16-channel texture; the
    # shared rect + transform live in slot 0
    slot = 0
    t_os = uv_os[..., slot * 4:slot * 4 + 4]
    t_rot = uv_rot[..., slot * 2:slot * 2 + 2]
    suv = tex.apply_texture_transform(uv, t_os, t_rot)
    rect0 = rects[..., slot * 4:slot * 4 + 4]
    scale = uv_os[..., slot * 4 + 2:slot * 4 + 4]
    base_w = rect0[..., 2] * scale[..., 0].abs()
    base_h = rect0[..., 3] * scale[..., 1].abs()
    s_tl = tex.apply_texture_transform(uv_tl, t_os, t_rot)
    d_dx = tex.apply_texture_transform(uv_tr, t_os, t_rot) - s_tl
    d_dy = tex.apply_texture_transform(uv_bl, t_os, t_rot) - s_tl
    aniso_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if settings.texture_filter == "anisotropic":
        s, aniso_overflow = _sample_aniso(quad_flat, atlas_width, rect0, suv, d_dx, d_dy,
                                          base_w, base_h, valid, settings)
    elif settings.texture_filter == "bilinear":
        lod = tex.footprint_lod(d_dx, d_dy, base_w, base_h)
        level = tex._to_int(torch.round(torch.clamp(lod, min=0.0)))
        s = _sample_level_any(quad_flat, atlas_width, rect0, suv, level)
    else:
        lod = tex.footprint_lod(d_dx, d_dy, base_w, base_h)
        s = _sample_trilinear_any(quad_flat, atlas_width, rect0, suv, lod,
                                  select_kernel=settings.mat_select_kernel)

    albedo = M(PK.M_BCF, 3) * v_color[..., :3] * s[..., 0:3]
    alpha = M(PK.M_ALPHA) * v_color[..., 3] * s[..., 3]
    roughness = M(PK.M_ROUGH) * s[..., 4]
    metallic = M(PK.M_METAL) * s[..., 5]
    emissive = M(PK.M_EMISSIVE, 3) * s[..., 8:11]
    nm_rg = s[..., 6:8]

    rg = nm_rg * 2.0 - 1.0
    tangent_normal = torch.cat([rg, pbr.reconstruct_normal_z(rg)[..., None]], dim=-1)
    mapped = pbr.apply_normal_map(v_normal, tangent4, tangent_normal)
    shading_normal = torch.where(has[..., SLOT_NORMAL:SLOT_NORMAL + 1], mapped,
                                 pbr.normalize(v_normal))
    return {
        "valid": valid,
        "aniso_tap_overflow": aniso_overflow,
        "model_id": model_id,
        "object_id_f": M(PK.M_OBJID),
        "world_pos": world_pos,
        "albedo": albedo,
        "alpha": alpha,
        "metallic": metallic,
        "roughness": roughness,
        "emissive": emissive,
        "normal": shading_normal,
        "vertex_normal": v_normal,
    }
