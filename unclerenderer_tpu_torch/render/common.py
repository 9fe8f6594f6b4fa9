"""Frame building blocks (``unclerenderer_tpu/render/common.py``): the vertex
stage (SoA, or AoS under ``soa_vertex=False``), draw masks, the opaque,
alpha-masked and shadow visibility rasters, and the material resolve (the
combined material on the quad or the packed-trilinear atlas, or per-slot
taps on the per-map quad atlas; trilinear, bilinear and anisotropic filters
with quad-derivative or forward-difference LOD; compact id space; fused
resolve, where the raster kernels emit each pixel's resolve record).  The
passes and their sub-scopes carry the reference's names as profiler ranges
(``core/passes.py``).

Two backends, as in the reference (``use_kernel_path``): the kernel path
(the binned raster K1/K2 and the kernels K4-K9 under their flags), and
``raster_backend="xla"``, the reference's XLA path: the exhaustive raster
X1, plain draw-mask gathers, and no K4-K9 (the frames pack the per-texel
f16 PCF table instead, ``ops/shadow.py pack_shadow9``).  The masked raster
is M1 (``ops/raster_kernels.py masked_raster``) on both, as the reference
runs its one XLA masked raster under every backend."""

from __future__ import annotations

import contextlib
import math

import torch

from ..core.passes import named_pass, scope
from ..ops import pbr
from ..ops import texture as tex
from ..ops.fma import fdot
from ..ops.binning import bin_triangles
from ..ops.raster import (
    CULL_BACK,
    CULL_FRONT,
    DEPTH_MAX,
    DEPTH_MIN,
    RasterSetup,
    VertexAoS,
    VertexSoA,
    compact_mask,
    compact_setup,
    normalize_ortho_setup,
    triangle_setup_any,
    viewport_homogeneous,
)
from ..ops import raster_kernels
from ..ops.raster_kernels import (
    BIG_TILE_H,
    merge_levels,
    rasterize_binned,
    rasterize_exhaustive,
    tile_block_ranges,
)
from ..ops.shadow import hom_dot4
from . import packing as PK
from .params import DeviceScene, RenderSettings

# material texture slots (has_map columns)
SLOT_BASE, SLOT_MR, SLOT_NORMAL, SLOT_EMISSIVE = 0, 1, 2, 3


def vertex_stage(scene: DeviceScene, view_proj, width: int, height: int):
    """AoS vertex stage: world -> clip -> homogeneous pixel coordinates of
    every de-indexed vertex; returns (clip (V, 4), pix_h (V, 3)).  The
    reference's ``[p, 1] @ view_proj`` is one (V, 4) x (4, 4) dot, whose
    XLA:CPU sum is pairwise and uncontracted (``hom_dot4``), not the SoA
    stage's multiply-add chain."""
    clip = torch.stack(hom_dot4(scene.position, view_proj), dim=-1)
    return clip, viewport_homogeneous(clip, width, height)


def frame_vertices(scene: DeviceScene, view_proj, width: int, height: int,
                   settings: RenderSettings):
    """The frame's vertex stage, by the reference's rule: the SoA stage
    (``VertexSoA``) under ``soa_vertex`` when the scene carries ``pos_soa``,
    else the AoS one (``VertexAoS``)."""
    if settings.soa_vertex and scene.pos_soa is not None:
        return vertex_stage_soa(scene.pos_soa, view_proj, width, height)
    return VertexAoS(*vertex_stage(scene, view_proj, width, height))


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


def use_kernel_path(settings: RenderSettings) -> bool:
    """Which backend a frame takes: the counterpart of the reference's
    ``_use_pallas`` (``unclerenderer_tpu/render/common.py:161``).
    ``raster_backend="xla"`` takes the reference's XLA path -- the
    exhaustive raster X1, plain draw-mask gathers, the per-texel f16 PCF
    table, and none of K1-K9 --, whose image differs from the kernel path's
    at shadow edges (the PCF table's rounding) and at bin drops.
    ``"pallas"`` and ``"auto"`` take the kernel path on either device (its
    CPU runs are the kernels' plain versions); the reference's ``"auto"``
    picks by JAX's backend instead, XLA on the CPU and Pallas elsewhere.
    Any other value is refused by ``params.check_supported``."""
    return settings.raster_backend != "xla"


def tri_draw_masks(scene: DeviceScene, model_visible: torch.Tensor,
                   settings: RenderSettings | None = None):
    """Per-triangle opaque / alpha-masked draw masks: the two per-model
    flags gathered per triangle by K5 (``ops/texture.py gather_rows``), or
    on the XLA path of ``settings`` (``use_kernel_path``) by two plain
    gathers."""
    if settings is not None and not use_kernel_path(settings):
        tri_model = scene.tri_model.long()
        vis, masked = model_visible[tri_model], scene.alpha_mode[tri_model] == 1
        return vis & ~masked, vis & masked
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


def use_fused_resolve(settings: RenderSettings) -> bool:
    """Fused resolve (``fused_resolve="on"`` on the kernel path): the raster
    kernels emit each pixel's resolve record, which replaces the resolve's
    per-pixel record gather.  "auto" keeps it off, as the reference does,
    and so does the XLA path (the reference's ``:234``).  The frame is
    bit-equal either way."""
    return settings.fused_resolve == "on" and use_kernel_path(settings)


def _raster(setup, width, height, tile_h, tile_w, chunk, depth_mode, settings,
            want_ids=True, ortho=False, budget_factor=None, giant_tile=(0, 0),
            big_tile=None, records=None, region=None):
    """``rasterize_binned`` at the settings' bin parameters (its fine K1
    level prints its live blocks under ``kernel_debug_print``); with
    ``records`` it returns the record image fourth.  Under
    ``raster_backend="xla"`` the exhaustive raster X1 at the same tiles,
    which drops nothing: its drop counters are 0 (the reference's XLA
    branch of ``_dispatch_raster``).  ``region`` (``_slab``) rasterizes only
    a region of the ``height``-row image and crops the slab out of it."""
    rows, y0, crop = region or (height, 0, None)
    if not use_kernel_path(settings):  # records never come: use_fused_resolve is off
        depth, tri_id = rasterize_exhaustive(setup, width, rows, tile_h=tile_h, tile_w=tile_w,
                                             chunk=chunk, depth_mode=depth_mode, y_offset=y0,
                                             want_ids=want_ids, ortho=ortho)
        zero = torch.zeros((), dtype=torch.int32, device=setup.coef.device)
        stats = {"pair_overflow": zero, "giant_truncated": zero}
        if crop is None:
            return depth, tri_id, stats
        return depth[crop], None if tri_id is None else tri_id[crop], stats
    big = {} if big_tile is None else {"big_tile_h": big_tile[0], "big_tile_w": big_tile[1]}
    res = rasterize_binned(
        setup, width, rows, tile_h=tile_h, tile_w=tile_w, chunk=chunk,
        depth_mode=depth_mode, y_offset=y0, full_height=None if crop is None else height,
        max_span=settings.bin_max_span, **big,
        budget_factor=(settings.bin_budget_factor if budget_factor is None else budget_factor),
        mid_divisor=settings.bin_mid_divisor, giant_divisor=settings.bin_giant_divisor,
        giant_tile_h=giant_tile[0], giant_tile_w=giant_tile[1],
        giant_chunk=settings.bin_giant_chunk, want_ids=want_ids, ortho=ortho,
        mat_idx=settings.bin_mat_idx, records=records,
        debug_print=settings.kernel_debug_print,
    )
    if crop is None:
        return res
    return tuple(r[crop] if isinstance(r, torch.Tensor) else r for r in res)


def _slab(height: int, dist, align: int = 1):
    """``(rows, first global row, crop)``: the region this rank rasterizes
    for its slab of a ``height``-row image, and the slice of the region's
    rows that is the slab.  The region is the slab widened to multiples of
    ``align`` (every raster level's tile height; the exhaustive raster's
    one tile height on the XLA path), so that its tiles are the whole
    image's and each of its pixels is rasterized as there: a sliver's
    edge functions can cover pixels past its bounding box, and the tile
    holding the box's edge decides which of them are kept (the binned
    levels and the exhaustive raster's box test alike).  The whole image
    and crop None without a sharded ``dist``."""
    if dist is None or dist.n_dev == 1:
        return height, 0, None
    if height % dist.n_dev:
        raise ValueError(f"{height} rows must divide over {dist.n_dev} ranks")
    rows = height // dist.n_dev
    row0 = dist.rank * rows
    y0 = row0 // align * align
    y1 = min(height, -(-(row0 + rows) // align) * align)
    return y1 - y0, y0, slice(row0 - y0, row0 - y0 + rows)


@named_pass("VisibilityRaster")
def raster_opaque(scene: DeviceScene, tri_mask, settings: RenderSettings, verts,
                  fused: bool = False, dist=None):
    """Camera visibility raster over ``verts`` (``frame_vertices``: SoA or
    AoS).  Returns ``(depth, tri_id, stats, attr, compact_ids)``; with a
    nonzero ``compaction_cap`` the raster runs over the frame-visible
    compacted list and ``tri_id`` holds COMPACT ids (``compact_ids`` maps
    them back; None when off).  ``fused`` (fused resolve) makes the kernels
    emit each pixel's resolve record, the (H, W, 128) ``attr`` (else None),
    from ``build_resolve_records`` of the rows the raster runs over (the
    compact rows under compaction: the values of the reference's
    ``records[cids]``).  With a sharded ``dist`` (``parallel/dist.py``)
    it renders this rank's row slab in global pixel coordinates, the rows
    of the whole frame bit for bit; the setup and compaction are the
    same on every rank, so are the compact ids."""
    with scope("VertexSetup"):
        setup = triangle_setup_any(verts, tri_mask, CULL_BACK, settings.width, settings.height)
    cap = compaction_cap(settings, setup.valid.shape[0])
    cids = None
    c_overflow = torch.zeros((), dtype=torch.int32, device=tri_mask.device)
    if cap:
        with scope("Compaction"):
            setup, cids, c_overflow = compact_setup(setup, cap)
    records = build_resolve_records(scene, verts.pix9(), ids=cids) if fused else None
    h = settings.height
    tile_h, giant_h = min(settings.tile_h, h), min(settings.giant_tile_h, h)
    align = math.lcm(tile_h, BIG_TILE_H, giant_h) if use_kernel_path(settings) else tile_h
    res = _raster(
        setup, settings.width, h, tile_h, settings.tile_w, settings.chunk, DEPTH_MAX, settings,
        giant_tile=(giant_h, settings.giant_tile_w), records=records,
        region=_slab(h, dist, align),
    )
    stats = dict(res[2])
    stats["compact_overflow"] = c_overflow
    attr = res[3] if records is not None else None
    return res[0], res[1], stats, attr, cids


@named_pass("ShadowMap")
def raster_shadow(scene: DeviceScene, light_view_proj, tri_mask, settings: RenderSettings,
                  dist=None):
    """Depth-only shadow raster: CULL_FRONT + LESS_EQUAL over an ortho
    projection, from the vertex stage ``frame_vertices`` picks.  Returns
    ``(depth, compact_overflow)``.  With a sharded ``dist`` each rank
    rasterizes a row slab of the map and the slabs are all-gathered, so
    every rank holds the whole map."""
    size = settings.shadow_map_size
    with scope("VertexSetup"):
        vs = frame_vertices(scene, light_view_proj, size, size, settings)
        setup = triangle_setup_any(vs, tri_mask, CULL_FRONT, size, size)
    cap = shadow_compaction_cap(settings, setup.valid.shape[0])
    overflow = torch.zeros((), dtype=torch.int32, device=tri_mask.device)
    if cap:
        with scope("Compaction"):
            setup, _ids, overflow = compact_setup(setup, cap)
    setup = normalize_ortho_setup(setup)
    tile_h, big_h = min(settings.shadow_tile_h, size), min(settings.shadow_big_tile_h, size)
    align = (math.lcm(tile_h, big_h, settings.shadow_giant_tile_h) if use_kernel_path(settings)
             else tile_h)
    region = _slab(size, dist, align)
    depth, _, _stats = _raster(
        setup, size, size, tile_h, settings.shadow_tile_w,
        settings.shadow_chunk, DEPTH_MIN, settings, want_ids=False, ortho=True,
        budget_factor=settings.shadow_bin_budget_factor,
        giant_tile=(settings.shadow_giant_tile_h, settings.shadow_giant_tile_w),
        big_tile=(big_h, settings.shadow_big_tile_w), region=region,
    )
    if region[2] is not None:
        depth = dist.all_gather_rows(depth)
    return depth, overflow


# ---------------------------------------------------------------------------
# Alpha-masked raster
# ---------------------------------------------------------------------------

def _alpha_records(scene: DeviceScene, setup: RasterSetup):
    """The (T, 19) alpha record of every triangle: the interpolation
    numerators (a, b, c) of u, v, vertex alpha and 1 (columns 0:12), the
    base-colour rect (12:16), has a base-colour map, alpha scale and cutoff
    (16, 17, 18).  The KHR transform of the base slot is affine in uv, so it
    folds into the per-vertex uvs; the weight of vertex k is edge function
    k, so each numerator is sum_k e_k(q) * x_k per (a, b, c) column."""
    model = scene.tri_model.long()
    uv_os = scene.uv_transform[model, SLOT_BASE]
    uv_rot = scene.uv_rotation[model, SLOT_BASE]
    t_count = scene.uv.shape[0] // 3
    uv_tri = scene.uv.reshape(t_count, 3, 2)
    uvk = [tex.apply_texture_transform(uv_tri[:, k], uv_os, uv_rot) for k in range(3)]
    ca = scene.color.reshape(t_count, 3, 4)[..., 3]
    coef = setup.coef

    def interp_coef(x0, x1, x2):
        return torch.stack([fdot([(coef[:, 3 * r], x0), (coef[:, 3 * r + 1], x1),
                                  (coef[:, 3 * r + 2], x2)]) for r in range(3)], dim=1)

    ones = torch.ones_like(ca[:, 0])
    return torch.cat([
        interp_coef(uvk[0][:, 0], uvk[1][:, 0], uvk[2][:, 0]),
        interp_coef(uvk[0][:, 1], uvk[1][:, 1], uvk[2][:, 1]),
        interp_coef(ca[:, 0], ca[:, 1], ca[:, 2]),
        interp_coef(ones, ones, ones),
        scene.tri_mrec[:, PK.M_RECT + SLOT_BASE * 4:PK.M_RECT + SLOT_BASE * 4 + 4],
        scene.has_map[model, SLOT_BASE].to(torch.float32)[:, None],
        scene.base_color_alpha[model][:, None],
        scene.alpha_cutoff[model][:, None],
    ], dim=1)


def _masked_level(scene: DeviceScene, settings: RenderSettings, arec, blocks, tile_h: int,
                  tile_w: int, height: int, y_offset: int, stats: bool):
    """One masked raster level through M1 (``ops/raster_kernels.py
    masked_raster``) on the scene's material atlas at the settings' filter;
    ``blocks`` = (coef, tri_id, valid, arec rows, tile_start, tile_count)."""
    quad_flat = scene.quad_img.reshape(-1, scene.quad_img.shape[-1])
    return raster_kernels.masked_raster(*blocks, arec, quad_flat, scene.quad_img.shape[1], tile_h,
                                        tile_w, settings.width, height, y_offset,
                                        settings.height, settings.texture_filter == "bilinear",
                                        stats)


def _rasterize_alpha(setup: RasterSetup, arec, scene: DeviceScene, settings: RenderSettings,
                     height: int, y_offset: int = 0, stats: bool = False):
    """Exhaustive masked raster (``masked_tri_cap == 0``): every tile
    against every chunk of the table, as the reference's scan; a pixel
    takes the max key, then (argmax's first index within a chunk, a strict
    ``>`` across chunks) the min triangle id -- M1's exhaustive form, which
    skips a chunk no valid triangle of which may pass its edge tests at a
    pixel of the tile (``ops/raster_kernels.py _edge_may_pass`` at the
    tile's corners): such a chunk cannot cover a pixel of it.  The image is
    ``height`` rows from
    global row ``y_offset``.  Returns (key image, tri_id, counts): key -1
    and id -1 where nothing won; counts (``stats``) as
    ``_rasterize_alpha_binned``'s, one level."""
    coef, rows, valid = raster_kernels.table_chunks(setup, settings.chunk)
    key, ids, counts = _masked_level(scene, settings, arec, (coef, rows, valid, rows, None, None),
                                     min(settings.tile_h, settings.height), settings.tile_w,
                                     height, y_offset, stats)
    return key, ids, [counts]


def _compact_chunks(mask, cap: int, chunk: int):
    """Order-preserving packed-sort compaction to ``cap`` rounded up to
    whole chunks: (ids i32, ok bool) -- the first rows of ``mask`` in
    ascending order, then the others."""
    n = mask.shape[0]
    idx_bits = max((n - 1).bit_length(), 1)
    packed = torch.where(mask, 0, 1 << idx_bits) + torch.arange(n, device=mask.device)
    sp = torch.sort(packed).values[:-(-cap // chunk) * chunk]
    return (sp & ((1 << idx_bits) - 1)).to(torch.int32), sp < (1 << idx_bits)


def _masked_tile_heights(settings: RenderSettings):
    """(level 1, level 2) tile heights of the binned masked raster: the
    scene tiles and the reference's 32 x 128 tiles."""
    return min(settings.tile_h, settings.height), min(32, settings.height)


def _rasterize_alpha_binned(setup: RasterSetup, arec, scene: DeviceScene,
                            settings: RenderSettings, height: int, y_offset: int = 0,
                            stats: bool = False):
    """Binned masked raster (``masked_tri_cap != 0``): with 0 < cap < T the
    masked triangles first compact to a list of ``cap`` rows (rounded up to
    whole chunks); level 1 bins them to the scene tiles (span 4, budget
    4.0), level 2 bins level 1's big triangles to 32 x 128 tiles (span 8,
    budget 2.0), and the levels merge by max key, min id on ties.  Only
    the blocks in use are evaluated.  As in the reference, pairs past a level's bin budget and
    triangles too big for level 2 are dropped; with ``stats`` the counts
    report them (``bin_overflow``, ``big_dropped``) beside M1's counts of
    each level (live blocks, covered and tapped pairs), all device tensors.
    Each level is one M1 launch over all its block slots, dead blocks too.
    The image is ``height`` rows from global row ``y_offset``.  Returns
    (key image, tri_id, counts) as ``_rasterize_alpha``."""
    width = settings.width
    chunk = min(settings.chunk, 64)
    t_count = setup.coef.shape[0]
    cap = settings.masked_tri_cap
    if 0 < cap < t_count:
        sel, sel_valid = _compact_chunks(setup.valid, cap, chunk)
        li = sel.long()
        lvl_setup = RasterSetup(coef=setup.coef[li], valid=sel_valid, bbox=setup.bbox[:, li])
        # searchsorted keys must ascend: the invalid tail of sel restarts at
        # small ids, so it maps to an out-of-range sentinel
        arec_ids = torch.where(sel_valid, sel, torch.full_like(sel, t_count))
        arec = arec[li]
        tri_ids = sel
    else:
        lvl_setup, arec_ids, tri_ids = setup, None, None

    def level(bins, tile_h, tile_w):
        # each tile walks only its live block range
        n_tiles = -(-width // tile_w) * -(-height // tile_h)
        ids = bins.tri_id[:, 0]
        rows = ids
        if arec_ids is not None:
            rows = torch.clamp(torch.searchsorted(arec_ids, ids), 0,
                               arec.shape[0] - 1).to(torch.int32)
        start, count = tile_block_ranges(bins, n_tiles)
        return _masked_level(scene, settings, arec,
                             (bins.coef, ids, bins.valid, rows, start, count), tile_h, tile_w,
                             height, y_offset, stats)

    full_h = None if height == settings.height else settings.height
    tile_h, big_th = _masked_tile_heights(settings)
    bins = bin_triangles(lvl_setup, width, height, tile_h, settings.tile_w, chunk, max_span=4,
                         budget_factor=4.0, tri_ids=tri_ids, y_offset=y_offset,
                         full_height=full_h)
    key_img, id_img, counts1 = level(bins, tile_h, settings.tile_w)

    t1 = lvl_setup.coef.shape[0]
    cap2 = min(t1, max(chunk, -(-(t1 // 4) // chunk) * chunk))
    sel2, sel2_valid = _compact_chunks(bins.big_mask, cap2, chunk)
    l2 = sel2.long()
    big_setup = RasterSetup(coef=lvl_setup.coef[l2], valid=sel2_valid, bbox=lvl_setup.bbox[:, l2])
    g2 = tri_ids[l2] if tri_ids is not None else sel2
    bins2 = bin_triangles(big_setup, width, height, big_th, 128, chunk, max_span=8,
                          budget_factor=2.0, tri_ids=g2, y_offset=y_offset, full_height=full_h)
    key2, id2, counts2 = level(bins2, big_th, 128)
    key_img, id_img = merge_levels(key_img, id_img, key2, id2)
    if stats:
        counts1["bin_overflow"] = bins.overflow
        counts2["bin_overflow"] = bins2.overflow
        counts2["big_dropped"] = ((bins.big_mask.sum() - sel2_valid.sum())
                                  + bins2.big_mask.sum()).to(torch.int32)
    return key_img, id_img, [counts1, counts2]


@named_pass("MaskedRaster")
def raster_masked_combine(scene: DeviceScene, masked_mask, depth, tri_id,
                          settings: RenderSettings, verts, stats: bool = False,
                          attr=None, dist=None):
    """Rasterize the alpha-masked geometry with an in-raster alpha test (the
    base-colour tap at the analytic LOD, ``ops/raster_kernels.py
    _alpha_lod``) by M1, then depth-combine with the opaque visibility
    buffer: a masked pixel wins only with a strictly greater key, so opaque
    wins ties.  Returns (depth, tri_id, counts); with ``stats`` counts
    holds M1's counts (live blocks, covered and tapped pairs) and the drops
    of each masked level as device tensors (the reference counts none of
    them), else None.  At every ``masked_tri_cap`` the shapes are static and
    nothing is read back, so the frame programs capture it
    (``render/program.py``, whose only refusal left is a row-sharded
    ``dist``).

    ``attr`` (fused resolve: the opaque raster's (H, W, 128) record image)
    is returned fourth, its masked-won pixels replaced in place by their
    triangle's resolve record, as the reference takes them: at 0 < cap < T
    from the records of the compacted masked list (the rows of
    ``_compact_chunks``, looked up by ``searchsorted``), else from the
    whole table.  With a sharded ``dist`` the images are this rank's row
    slab (``raster_opaque``)."""
    setup = triangle_setup_any(verts, masked_mask, CULL_BACK, settings.width, settings.height)
    arec = _alpha_records(scene, setup)
    tile_h, big_th = _masked_tile_heights(settings)
    if settings.masked_tri_cap != 0:
        h, y0, crop = _slab(settings.height, dist, math.lcm(tile_h, big_th))
        m_key, m_tri, counts = _rasterize_alpha_binned(setup, arec, scene, settings, h, y0,
                                                       stats)
    else:
        h, y0, crop = _slab(settings.height, dist, tile_h)
        m_key, m_tri, counts = _rasterize_alpha(setup, arec, scene, settings, h, y0, stats)
    if crop is not None:
        m_key, m_tri = m_key[crop], m_tri[crop]
    m_depth = torch.where(m_key >= 0.0, m_key, torch.zeros_like(m_key))
    take = m_depth > depth
    out = (torch.where(take, m_depth, depth), torch.where(take, m_tri, tri_id),
           counts if stats else None)
    if attr is None:
        return out
    t_count = setup.coef.shape[0]
    cap = settings.masked_tri_cap
    safe_m = torch.clamp(m_tri, min=0)
    if 0 < cap < t_count:
        sel, ok = _compact_chunks(setup.valid, cap, min(settings.chunk, 64))
        rec_m = build_resolve_records(scene, verts.pix9(), ids=sel)
        ids_m = torch.where(ok, sel, torch.full_like(sel, t_count))
        local = torch.clamp(torch.searchsorted(ids_m, safe_m), 0, sel.shape[0] - 1)
        attr_m = rec_m[local.long()]
    else:
        attr_m = build_resolve_records(scene, verts.pix9())[safe_m.long()]
    return out + (torch.where(take[..., None], attr_m, attr, out=attr),)


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


def _same_next(tri_id, dim: int, after=None):
    """Whether the next pixel along ``dim`` shows the same triangle: the
    reference's ``jnp.diff(tri_id, append=<last>) == 0``, True at the last
    row or column; ``after`` is the slice past the end (the row below a
    slab) when there is one."""
    n = tri_id.shape[dim]
    if after is not None:
        return tri_id == torch.cat([tri_id.narrow(dim, 1, n - 1), after], dim=dim)
    same = tri_id.narrow(dim, 1, n - 1) == tri_id.narrow(dim, 0, n - 1)
    edge = torch.ones_like(tri_id.narrow(dim, 0, 1), dtype=torch.bool)
    return torch.cat([same, edge], dim=dim)


def _aniso_cap(n_pix: int, frac: float) -> int:
    """The compacted anisotropic taps' static cap: ``frac`` of the image's
    pixels in whole 1024s, at least 1024."""
    return max(1024, (int(n_pix * frac) // 1024) * 1024)


def aniso_counters(extent, valid, settings: RenderSettings) -> dict:
    """The anisotropic tap's counters of one material slot, int64 on the
    device: ``aniso_pixels`` (the valid pixels), ``aniso_line_pixels``
    (those with ``extent`` > 0, whose N taps are not coincident) and
    ``aniso_taps`` (the trilinear taps taken at them: N each on the dense
    path; under ``aniso_compact_frac`` a centre tap each and N more at each
    compacted pixel)."""
    pixels = valid.sum()
    line = ((extent > 0.0) & valid).sum()
    n = settings.max_anisotropy
    frac = settings.aniso_compact_frac
    if 0.0 < frac < 1.0:
        taps = pixels + n * torch.clamp(line, max=_aniso_cap(valid.numel(), frac))
    else:
        taps = n * pixels
    return {"aniso_pixels": pixels, "aniso_line_pixels": line, "aniso_taps": taps}


def _sample_aniso(quad_flat, atlas_width, rect0, suv, footprint, valid,
                  settings: RenderSettings):
    """D3D12_FILTER_ANISOTROPIC analog: ``max_anisotropy`` trilinear taps
    along the major-axis footprint at the minor-axis LOD; ``footprint``:
    the slot's (lod, dmaj, extent) planes (``tex.tap_footprint`` or
    ``tex.uv_screen_lod_aniso``).  Returns (sample, aniso_tap_overflow).

    With 0 < ``aniso_compact_frac`` < 1 the line taps run only over a
    compacted list of the anisotropic pixels (extent > 0; static cap =
    that fraction of the image, at least 1024) and every other pixel takes
    one centre tap, which equals its N coincident taps; pixels past the cap
    keep the centre tap and are counted.  The shapes are static and nothing
    is read back, so the frame programs capture it."""
    n = settings.max_anisotropy
    sk = settings.mat_select_kernel and use_kernel_path(settings)
    lod, dmaj, extent = footprint

    def line_taps(rect, uv, lod, dmaj, extent):
        return tex.sample_aniso_line(quad_flat, atlas_width, rect, uv, lod, dmaj, extent, n,
                                     select_kernel=sk)

    frac = settings.aniso_compact_frac
    if not 0.0 < frac < 1.0:
        return line_taps(rect0, suv, lod, dmaj, extent), torch.zeros((), dtype=torch.int32,
                                                                     device=suv.device)
    lead = suv.shape[:-1]
    n_pix = lead.numel()
    cap = _aniso_cap(n_pix, frac)
    amask = ((extent > 0.0) & valid).reshape(n_pix)
    ids, ok = compact_mask(amask, cap)
    safe = torch.where(ok, ids, torch.zeros_like(ids)).long()

    def flat(x):
        return x.reshape((n_pix,) + x.shape[len(lead):])[safe]

    acc = line_taps(flat(rect0), flat(suv), flat(lod), flat(dmaj), flat(extent))
    center = tex.sample_trilinear_any(quad_flat, atlas_width, rect0, suv, lod, select_kernel=sk)
    # a static scatter: the rows past the cap go to a dump row, cut off after
    tail = center.shape[len(lead):]
    img = torch.cat([center.reshape((n_pix,) + tail), center.new_zeros((1,) + tail)])
    img = img.index_put_((torch.where(ok, ids, n_pix).long(),), acc)[:n_pix]
    overflow = (amask.sum() - ok.sum()).to(torch.int32)
    return img.reshape(center.shape), overflow


def tap_kernels_engage(quad_flat, settings: RenderSettings) -> bool:
    """Whether a material tap's taps run as ``tex.material_tap`` (T2 on the
    card, ``material_tap_ref`` on the CPU): on the kernel path, on the
    packed 256-lane atlas (C = 16) in u8, f32 or bf16, with the
    quad-derivative LOD, trilinear or the dense anisotropic taps.  The rule
    reads the settings and the atlas, never the device.  Every other tap
    (the xla backend, bilinear, forward-difference LOD, the compacted
    anisotropic taps, the quad atlas) takes the plain samplers."""
    if settings.texture_filter == "anisotropic":
        dense = not 0.0 < settings.aniso_compact_frac < 1.0
    else:
        dense = settings.texture_filter == "trilinear"
    return (dense and use_kernel_path(settings)
            and settings.lod_derivatives == "quad" and tex.atlas_is_packed_tri(quad_flat)
            and quad_flat.dtype in tex.ATLAS_DTYPE_CODE)


@named_pass("MaterialResolve")
def resolve_materials(scene: DeviceScene, pix9, tri_id, settings: RenderSettings,
                      compact_ids=None, full_override=None, row0: int = 0, next_tri_row=None,
                      prev_tri_row=None, row_halo=None):
    """Visibility buffer -> interpolated attributes + sampled materials:
    ONE per-pixel gather of the 128-wide record (or ``full_override``, the
    (H, W, 128) record image the raster kernels emitted under fused
    resolve: the same records where ``tri_id >= 0``, zeros elsewhere, where
    nothing reaches the outputs), the attributes at the pixel centres
    (``tex.interp_attrs``: R1 on the card), then the material taps
    (``settings.texture_filter``) at the LOD of ``lod_derivatives``: the
    quad derivatives ("quad"), or forward differences of the pixels' uvs
    gated by triangle edges ("forward", ``tex.uv_screen_lod``); one
    combined-material tap (``combined_material``), else one tap per enabled
    slot (``slot_enabled``) on the per-map atlas.

    A slot's tap has two stages, the same on both devices.  The footprint:
    the slot's planes (su, sv, lod and, anisotropic, dmaj.u, dmaj.v,
    extent) from ``tex.tap_footprint`` under quad LOD (T1 on the card), else
    from the forward differences.  The taps: ``tex.material_tap`` where
    ``tap_kernels_engage`` holds (T2 on the card), else the plain samplers
    at the planes.  The result carries
    ``aniso_tap_overflow`` (0 unless the compacted anisotropic taps
    overflowed their cap; per-slot, the last slot's count) and
    ``aniso_counts`` (``aniso_counters`` summed over the slots tapped; empty
    unless the filter is anisotropic) and ``tap_counts``: ``tap_pixels``
    (the valid pixels tapped, summed over the slots),
    ``tap_kernel_pixels`` (those the kernels T1 and T2 took: the taps of
    ``tap_kernels_engage`` with the atlas on the card; 0 on the CPU),
    ``attr_pixels`` (the valid pixels interpolated) and
    ``attr_kernel_pixels`` (those R1 took: all of them on the card, 0 on
    the CPU).

    A row slab (sharded frame): ``tri_id`` holds the slab's rows from
    global row ``row0``, pixel centres stay global; ``next_tri_row`` /
    ``prev_tri_row`` are the id rows just below and above the slab and
    ``row_halo(x)`` gives the rows above and below a slab image, for the
    forward differences at the seams."""
    width = settings.width
    dev = tri_id.device
    if full_override is not None:
        full = full_override
    else:
        with scope("RecGather"):
            rec = build_resolve_records(scene, pix9, ids=compact_ids)
            full = rec[torch.clamp(tri_id, min=0).long()]  # (H, W, 128)
    mrec = full[..., 57:121]
    valid = tri_id >= 0

    with scope("InterpAttr"):
        world_pos, v_normal, tangent4, uv, v_color = tex.interp_attrs(full, width, row0)

    def M(c, n=1):
        return mrec[..., c:c + n] if n > 1 else mrec[..., c]

    model_id = M(PK.M_ID).to(torch.int32)
    has = M(PK.M_HAS, 4) > 0.5
    uv_os = M(PK.M_UVOS, 16)
    uv_rot = M(PK.M_UVROT, 8)
    rects = M(PK.M_RECT, 16)

    quad_flat = scene.quad_img.reshape(-1, scene.quad_img.shape[-1])
    atlas_width = scene.quad_img.shape[1]
    kernels = tap_kernels_engage(quad_flat, settings)
    quad_lod = settings.lod_derivatives == "quad"
    if not quad_lod:
        # forward differences of the pixels' uvs, gated by the triangle
        # ids of the neighbours (+x/+y, then -x/-y); the frame's edge rows
        # and columns count as the same triangle (a 0 difference)
        same_x = _same_next(tri_id, 1)
        same_y = _same_next(tri_id, 0, next_tri_row)
        same_bx = _same_next(tri_id.flip(1), 1).flip(1)
        same_by = _same_next(tri_id.flip(0), 0, prev_tri_row).flip(0)

    # the anisotropic sampler's overflow count; with per-slot taps each slot
    # overwrites it, as the reference does (render/common.py:1219)
    aniso_overflow = [torch.zeros((), dtype=torch.int32, device=dev)]
    aniso_counts: dict = {}  # aniso_counters, summed over the slots tapped
    slots_tapped = [0]
    aniso = settings.texture_filter == "anisotropic"
    n_taps = settings.max_anisotropy if aniso else 0
    select = settings.mat_select_kernel and use_kernel_path(settings)
    shape = valid.shape

    def sample_slot(slot):
        """The material tap of ``slot`` (``settings.texture_filter``) with
        the slot's own rect and KHR transform: its footprint, then its
        taps."""
        slots_tapped[0] += 1
        base = 9 + PK.GEO  # the material record's first lane in the resolve record
        lanes = (base + PK.M_UVOS + slot * 4, base + PK.M_UVROT + slot * 2,
                 base + PK.M_RECT + slot * 4)
        rect0 = rects[..., slot * 4:slot * 4 + 4]
        with scope("MaterialTap"):
            # the footprint: planes (K, H*W) su, sv, lod[, dmaj.u, dmaj.v, extent]
            with scope("AnisoFootprint") if aniso else contextlib.nullcontext():
                if quad_lod:
                    # D3D 2x2-quad derivatives with helper-lane semantics,
                    # evaluated analytically from the pixel's own triangle
                    # at the quad corners
                    planes = tex.tap_footprint(full, uv, lanes, row0, n_taps)
                else:
                    t_os = uv_os[..., slot * 4:slot * 4 + 4]
                    suv = tex.apply_texture_transform(uv, t_os, uv_rot[..., slot * 2:slot * 2 + 2])
                    base_w = rect0[..., 2] * t_os[..., 2].abs()
                    base_h = rect0[..., 3] * t_os[..., 3].abs()
                    # a slab's seam rows difference against the neighbours' rows
                    ua, ub = row_halo(suv) if row_halo is not None else (None, None)
                    edges = dict(uv_above=ua, uv_below=ub, same_tri_bx=same_bx,
                                 same_tri_by=same_by)
                    if aniso:
                        lod, dmaj, extent = tex.uv_screen_lod_aniso(
                            suv, base_w, base_h, same_x, same_y, n_taps, **edges)
                        fp = (lod, dmaj[..., 0], dmaj[..., 1], extent)
                    else:
                        fp = (tex.uv_screen_lod(suv, base_w, base_h, same_x, same_y, **edges),)
                    planes = torch.stack((suv[..., 0], suv[..., 1]) + fp).reshape(2 + len(fp), -1)
            if aniso:
                for k, v in aniso_counters(planes[5].reshape(shape), valid, settings).items():
                    aniso_counts[k] = aniso_counts[k] + v if k in aniso_counts else v
            # the taps at the planes
            with scope("AnisoTaps") if aniso else contextlib.nullcontext():
                if kernels:
                    s = tex.material_tap(quad_flat, atlas_width, full, lanes[2], planes, n_taps,
                                         select)
                    return s.reshape(shape + (s.shape[-1],))
                suv = planes[0:2].t().reshape(shape + (2,))
                lod = planes[2].reshape(shape)
                if aniso:
                    fp = (lod, planes[3:5].t().reshape(shape + (2,)), planes[5].reshape(shape))
                    s, aniso_overflow[0] = _sample_aniso(quad_flat, atlas_width, rect0, suv, fp,
                                                         valid, settings)
                    return s
                if settings.texture_filter == "bilinear":
                    level = tex._to_int(torch.round(torch.clamp(lod, min=0.0)))
                    return tex.sample_level_any(quad_flat, atlas_width, rect0, suv, level)
                return tex.sample_trilinear_any(quad_flat, atlas_width, rect0, suv, lod,
                                                select_kernel=select)

    albedo = M(PK.M_BCF, 3) * v_color[..., :3]
    alpha = M(PK.M_ALPHA) * v_color[..., 3]
    metallic, roughness, emissive = M(PK.M_METAL), M(PK.M_ROUGH), M(PK.M_EMISSIVE, 3)
    if settings.combined_material:
        # all maps fused into one 16-channel texture, neutral where a map is
        # absent; the shared rect + transform live in slot 0
        s = sample_slot(0)
        albedo = albedo * s[..., 0:3]
        alpha = alpha * s[..., 3]
        roughness = roughness * s[..., 4]
        metallic = metallic * s[..., 5]
        emissive = emissive * s[..., 8:11]
        nm_rg = s[..., 6:8]
    else:
        # one tap per enabled slot, applied where the model has that map
        on = settings.slot_enabled
        if on[SLOT_BASE]:
            s = sample_slot(SLOT_BASE)
            albedo = torch.where(has[..., SLOT_BASE:SLOT_BASE + 1], albedo * s[..., :3], albedo)
            alpha = torch.where(has[..., SLOT_BASE], alpha * s[..., 3], alpha)
        if on[SLOT_MR]:
            s = sample_slot(SLOT_MR)
            metallic = torch.where(has[..., SLOT_MR], metallic * s[..., 2], metallic)
            roughness = torch.where(has[..., SLOT_MR], roughness * s[..., 1], roughness)
        if on[SLOT_EMISSIVE]:
            s = sample_slot(SLOT_EMISSIVE)
            emissive = torch.where(has[..., SLOT_EMISSIVE:SLOT_EMISSIVE + 1],
                                   emissive * s[..., :3], emissive)
        nm_rg = sample_slot(SLOT_NORMAL)[..., :2] if on[SLOT_NORMAL] else None

    with scope("NormalMap"):
        if nm_rg is None:
            shading_normal = pbr.normalize(v_normal)
        else:
            rg = nm_rg * 2.0 - 1.0
            tangent_normal = torch.cat([rg, pbr.reconstruct_normal_z(rg)[..., None]], dim=-1)
            mapped = pbr.apply_normal_map(v_normal, tangent4, tangent_normal)
            shading_normal = torch.where(has[..., SLOT_NORMAL:SLOT_NORMAL + 1], mapped,
                                         pbr.normalize(v_normal))
    n_valid = valid.sum()
    return {
        "valid": valid,
        "aniso_tap_overflow": aniso_overflow[0],
        "aniso_counts": aniso_counts,
        "tap_counts": {"tap_pixels": n_valid * slots_tapped[0],
                       "tap_kernel_pixels": n_valid * (slots_tapped[0]
                                                        if kernels and quad_flat.is_cuda else 0),
                       "attr_pixels": n_valid,
                       "attr_kernel_pixels": n_valid * int(full.is_cuda)},
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
