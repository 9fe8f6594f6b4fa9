"""Frame building blocks (``unclerenderer_tpu/render/common.py``): the vertex
stage (SoA, or AoS under ``soa_vertex=False``), draw masks, the opaque,
alpha-masked and shadow visibility rasters, and the material resolve (the
combined material on the quad or the packed-trilinear atlas, or per-slot
taps on the per-map quad atlas; trilinear, bilinear and anisotropic filters
with quad-derivative or forward-difference LOD; compact id space; fused
resolve, where the raster kernels emit each pixel's resolve record).  The
passes and their sub-scopes carry the reference's names as profiler ranges
(``core/passes.py``)."""

from __future__ import annotations

import math

import torch

from ..core.passes import named_pass, scope
from ..ops import pbr
from ..ops import texture as tex
from ..ops.fma import fdiff, fdot, fma
from ..ops.binning import bin_triangles
from ..ops.raster import (
    COEF_COLS,
    CULL_BACK,
    CULL_FRONT,
    DEPTH_MAX,
    DEPTH_MIN,
    INT32_MAX,
    RasterSetup,
    VertexAoS,
    VertexSoA,
    compact_mask,
    compact_setup,
    eval_keys,
    normalize_ortho_setup,
    triangle_setup_any,
    viewport_homogeneous,
)
from ..ops.raster_kernels import BIG_TILE_H, merge_levels, rasterize_binned
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


def use_fused_resolve(settings: RenderSettings) -> bool:
    """Fused resolve (``fused_resolve="on"``): the raster kernels emit each
    pixel's resolve record, which replaces the resolve's per-pixel record
    gather.  The port has one raster implementation whatever
    ``raster_backend`` says, so "on" alone decides; "auto" keeps it off, as
    the reference does.  The frame is bit-equal either way."""
    return settings.fused_resolve == "on"


def _raster(setup, width, height, tile_h, tile_w, chunk, depth_mode, settings,
            want_ids=True, ortho=False, budget_factor=None, giant_tile=(0, 0),
            big_tile=None, records=None, region=None):
    """``rasterize_binned`` at the settings' bin parameters (its fine K1
    level prints its live blocks under ``kernel_debug_print``); with
    ``records`` it returns the record image fourth.  ``region`` (``_slab``)
    rasterizes only a region of the ``height``-row image and crops the
    slab out of it."""
    rows, y0, crop = region or (height, 0, None)
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
    ``align`` (every raster level's tile height), so that its tiles are the
    whole image's and each of its pixels is rasterized as there: a sliver's
    edge functions can cover pixels past its bounding box, and the tile
    holding the box's edge decides which of them are kept.  The whole image
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
    res = _raster(
        setup, settings.width, h, tile_h, settings.tile_w, settings.chunk, DEPTH_MAX, settings,
        giant_tile=(giant_h, settings.giant_tile_w), records=records,
        region=_slab(h, dist, math.lcm(tile_h, BIG_TILE_H, giant_h)),
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
    region = _slab(size, dist, math.lcm(tile_h, big_h, settings.shadow_giant_tile_h))
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

# (pixel, slot) pairs one group of blocks holds at once: the groups are
# sized to memory (any size gives the same result)
ALPHA_PAIR_BUDGET = 1 << 24


def _alpha_lod(u, v, au, bu, av, bv, a1, b1, denom, tw_, th_):
    """Analytic per-(pixel, candidate) LOD of the in-raster alpha test: u =
    U/D with U = au*qx + bu*qy + cu, D = a1*qx + b1*qy + c1, so du/dx =
    (au - u*a1)/D; the footprint rule of ``tex.footprint_lod`` (max axis
    length in texels, squared).  Contracted as the reference is; its log2
    differs from PyTorch's by an ulp now and then."""
    inv_d = 1.0 / denom
    dudx = fma(-u, a1, au) * inv_d
    dudy = fma(-u, b1, bu) * inv_d
    dvdx = fma(-v, a1, av) * inv_d
    dvdy = fma(-v, b1, bv) * inv_d
    px, qx = dudx * tw_, dvdx * th_
    py, qy = dudy * tw_, dvdy * th_
    lx = fma(px, px, qx * qx)
    ly = fma(py, py, qy * qy)
    return 0.5 * torch.log2(torch.clamp(torch.maximum(lx, ly), min=1e-12))


def _alpha_tap(quad_flat, atlas_width, rect0, uv, lod, settings: RenderSettings):
    """Alpha-test texture tap at the analytic LOD, honouring the material
    filter: nearest-mip bilinear under "bilinear", trilinear otherwise."""
    if settings.texture_filter == "bilinear":
        level = tex._to_int(torch.round(torch.clamp(lod, min=0.0)))
        return _sample_level_any(quad_flat, atlas_width, rect0, uv, level)
    return _sample_trilinear_any(quad_flat, atlas_width, rect0, uv, lod)


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


# Edge-test margin of the masked raster's candidate filter (``_edge_may_pass``):
# a multiple of the f32 unit roundoff 2^-24 with room to spare.
EDGE_SLACK = 2.0 ** -20


def _edge_may_pass(coef, X, Y, width: int, height: int):
    """Superset filter of the raster's edge tests: False only where a pixel
    centre (X, Y) cannot pass the three contracted edge tests of
    ``eval_keys`` (``fma(a, X, b*Y) + c`` against a threshold >= 0).  Each
    edge is summed in plain f32 against -m, m = 2^-20 * (|a| W + |b| H +
    |c|) + 2^-120: either summation order lies within ~4 * 2^-24 * (|a X| +
    |b Y| + |c|) of the exact value (3 and 4 roundings), so a pair that the
    contracted form passes is kept, however thin its triangle -- a sliver's
    rounded edge functions can cover pixels beyond its bounding box (a
    pixel 3 columns past one, at 128x128 in tests/test_torch_forward.py),
    where the reference, which evaluates every pixel of a tile, covers them.
    A NaN keeps the pair.  coef (..., 16, C); X, Y pixel centres (..., P,
    1), or each a (min, max) pair of a rectangle's extreme centres: each
    edge is then tested at its best corner (the exact edge function is
    linear, so no pixel of the rectangle exceeds it there), which keeps
    every (rectangle, slot) pair that a pixel of the rectangle may pass."""
    ok = None
    for e in range(3):
        a, b, c = coef[..., None, e, :], coef[..., None, 3 + e, :], coef[..., None, 6 + e, :]
        m = (a.abs() * width + b.abs() * height + c.abs()) * EDGE_SLACK + 2.0 ** -120
        xe = X if isinstance(X, torch.Tensor) else torch.where(a > 0, X[1], X[0])
        ye = Y if isinstance(Y, torch.Tensor) else torch.where(b > 0, Y[1], Y[0])
        may = ~((a * xe + b * ye + c) < -m)
        ok = may if ok is None else ok & may
    return ok


def _alpha_candidates(tiles, coef, valid, tile_h, tile_w, n_tx, width, height, y_offset,
                      full_h):
    """The (block, pixel, slot) triples of a group of blocks whose pixel
    lies in the image and may pass the slot's edge tests
    (``_edge_may_pass`` over the ``full_h``-row frame); the reference
    evaluates every pixel of the block's tile and crops the padded tiles'
    pixels.  The image is ``height`` rows from global row ``y_offset``.
    tiles (G,), coef (G, 16, C), valid (G, C) -> (g, p, c, pixel x, pixel y
    in the image)."""
    pix = tile_h * tile_w
    col = torch.arange(pix, device=tiles.device)
    px = ((tiles % n_tx) * tile_w)[:, None] + col % tile_w
    py = ((tiles // n_tx) * tile_h)[:, None] + col // tile_w
    X = (px.to(torch.float32) + 0.5)[:, :, None]
    Y = ((py + y_offset).to(torch.float32) + 0.5)[:, :, None]
    cand = (_edge_may_pass(coef, X, Y, width, full_h) & valid[:, None, :]
            & ((px < width) & (py < height))[:, :, None])
    g, p, c = cand.nonzero(as_tuple=True)
    return g, p, c, px[g, p], py[g, p]


def _alpha_eval(coef, arec, x, y, quad_flat, atlas_width, settings: RenderSettings):
    """Depth key of candidate (pixel, triangle) pairs that the triangle
    covers, whose depth is in [0, 1] and whose alpha passes the cutoff, -1
    for the others.  coef (N, 16), arec (N, 19), x/y (N,) pixel ints.  The
    edge tests and depth are the opaque raster's (``eval_keys``); the
    interpolation is the reference's ``a*qx + b*qy + c`` contracted as
    ``fma(a, qx, b*qy) + c``, like them.  The alpha tap runs only for the
    pairs that are covered and in depth range (it enters only through
    ``ok &``).  Returns (key (N,), covered pairs)."""
    qx, qy = x.to(torch.float32) + 0.5, y.to(torch.float32) + 0.5
    key, ok = eval_keys(coef[:, :, None], torch.ones_like(qx, dtype=torch.bool)[:, None],
                        qx[:, None], qy[:, None])
    key, ok = key.reshape(-1), ok.reshape(-1)
    idx = ok.nonzero(as_tuple=True)[0]
    ar, qx, qy = arec[idx], qx[idx], qy[idx]

    def form(a, b, c):
        return fma(a, qx, b * qy) + c

    denom = form(ar[:, 9], ar[:, 10], ar[:, 11])
    denom = torch.where(denom != 0.0, denom, torch.ones_like(denom))
    u = form(ar[:, 0], ar[:, 1], ar[:, 2]) / denom
    v = form(ar[:, 3], ar[:, 4], ar[:, 5]) / denom
    ca = form(ar[:, 6], ar[:, 7], ar[:, 8]) / denom
    lod = _alpha_lod(u, v, ar[:, 0], ar[:, 1], ar[:, 3], ar[:, 4], ar[:, 9], ar[:, 10], denom,
                     ar[:, 14], ar[:, 15])
    texel = _alpha_tap(quad_flat, atlas_width, ar[:, 12:16], torch.stack([u, v], dim=-1), lod,
                       settings)
    tex_a = torch.where(ar[:, 16] > 0.5, texel[:, 3], torch.ones_like(u))
    passed = ar[:, 17] * ca * tex_a >= ar[:, 18]
    ok[idx] = passed
    return torch.where(ok, key, torch.full_like(key, -1.0)), int(idx.shape[0])


def _alpha_level(blocks, scene: DeviceScene, arec, tile_h, tile_w, width, height,
                 settings: RenderSettings, y_offset: int = 0):
    """One masked raster level: per pixel the max key of the candidates that
    pass, and the min triangle id among those at it -- per block, then per
    tile in the reference (its segment merges); the order of such merges
    does not matter.  ``blocks`` = (coef (B, 16, C), rows (B, C) into
    arec/bbox, ids (B, C), valid (B, C) bool, tile (B,)).  The image is
    ``height`` rows from global row ``y_offset``.  Returns (key image, id
    image, pair counts): keys -1 and ids -1 where nothing won."""
    coef, rows, ids, valid, tiles = blocks
    n_tx = -(-width // tile_w)
    dev = coef.device
    quad_flat = scene.quad_img.reshape(-1, scene.quad_img.shape[-1])
    atlas_width = scene.quad_img.shape[1]
    per_block = tile_h * tile_w * coef.shape[-1]
    pix_i = [torch.zeros(0, dtype=torch.int64, device=dev)]
    keys = [torch.zeros(0, dtype=torch.float32, device=dev)]
    kids = [torch.zeros(0, dtype=torch.int32, device=dev)]
    counts = {"blocks": int(tiles.shape[0]), "pairs": int(tiles.shape[0]) * per_block,
              "candidates": 0, "covered": 0}
    step = max(1, ALPHA_PAIR_BUDGET // per_block)
    for b0 in range(0, tiles.shape[0], step):
        sl = slice(b0, b0 + step)
        g, p, c, x, y = _alpha_candidates(tiles[sl], coef[sl], valid[sl], tile_h, tile_w, n_tx,
                                          width, height, y_offset, settings.height)
        cr = rows[sl][g, c]
        key, covered = _alpha_eval(coef[sl].transpose(1, 2)[g, c], arec[cr], x, y + y_offset,
                                   quad_flat, atlas_width, settings)
        won = key >= 0.0
        pix_i.append((y * width + x)[won])
        keys.append(key[won])
        kids.append(ids[sl][g, c][won])
        counts["candidates"] += int(g.shape[0])
        counts["covered"] += covered
    pix_i, keys, kids = torch.cat(pix_i), torch.cat(keys), torch.cat(kids)
    n = width * height
    key_img = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    key_img = key_img.scatter_reduce(0, pix_i, keys, reduce="amax", include_self=True)
    at = keys == key_img[pix_i]
    id_img = torch.full((n,), INT32_MAX, dtype=torch.int32, device=dev)
    id_img = id_img.scatter_reduce(0, pix_i[at], kids[at].to(torch.int32), reduce="amin",
                                   include_self=True)
    id_img = torch.where(key_img >= 0.0, id_img, torch.full_like(id_img, -1))
    return key_img.reshape(height, width), id_img.reshape(height, width), counts


def _rasterize_alpha(setup: RasterSetup, arec, scene: DeviceScene, settings: RenderSettings,
                     height: int, y_offset: int = 0):
    """Exhaustive masked raster (``masked_tri_cap == 0``): every tile
    against every chunk of the table, as the reference's scan; a pixel
    takes the max key, then (argmax's first index within a chunk, a strict
    ``>`` across chunks) the min triangle id.  Only (tile, chunk) blocks
    with a valid triangle that may pass its edge tests at a pixel of the
    tile (``_edge_may_pass`` at the tile's corners) are evaluated; the
    others cannot cover a pixel of it.  The image is ``height`` rows from
    global row ``y_offset``.  Returns (key image, tri_id, counts): key -1
    and id -1 where nothing won."""
    width = settings.width
    tile_h, tile_w, chunk = min(settings.tile_h, settings.height), settings.tile_w, settings.chunk
    n_tx, n_ty = -(-width // tile_w), -(-height // tile_h)
    dev = setup.coef.device
    t = setup.coef.shape[0]
    n_chunks = max(1, -(-t // chunk))
    rows = torch.arange(n_chunks * chunk, device=dev).reshape(n_chunks, chunk)
    valid = (rows < t) & setup.valid[rows.clamp(max=t - 1)]
    rows = rows.clamp(max=t - 1)
    coef = torch.zeros((n_chunks * chunk, COEF_COLS), dtype=torch.float32, device=dev)
    coef[:t] = setup.coef
    coef = coef.reshape(n_chunks, chunk, COEF_COLS).transpose(1, 2)
    tile = torch.arange(n_tx * n_ty, device=dev)
    tx0 = ((tile % n_tx) * tile_w).to(torch.float32)[:, None]
    ty0 = ((tile // n_tx) * tile_h + y_offset).to(torch.float32)[:, None]
    xs, ys = (tx0 + 0.5, tx0 + (tile_w - 0.5)), (ty0 + 0.5, ty0 + (tile_h - 0.5))
    live = [(_edge_may_pass(coef[c], xs, ys, width, settings.height) & valid[c]).any(dim=1)
            for c in range(n_chunks)]
    b_tile, b_chunk = torch.stack(live, dim=1).nonzero(as_tuple=True)
    blocks = (coef[b_chunk], rows[b_chunk], rows[b_chunk], valid[b_chunk], b_tile)
    key, ids, counts = _alpha_level(blocks, scene, arec, tile_h, tile_w, width, height,
                                    settings, y_offset)
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
    the blocks in use are evaluated (an unused block's slots are all
    invalid).  As in the reference, pairs past a level's bin budget and
    triangles too big for level 2 are dropped; with ``stats`` the counts
    report them (``bin_overflow``, ``big_dropped``) beside the pair counts
    of each level.  The image is ``height`` rows from global row
    ``y_offset``.  Returns (key image, tri_id, counts) as
    ``_rasterize_alpha``."""
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
        live = bins.blk_live.nonzero(as_tuple=True)[0]
        ids = bins.tri_id[live, 0]
        rows = ids.long()
        if arec_ids is not None:
            rows = torch.clamp(torch.searchsorted(arec_ids, ids), 0, arec.shape[0] - 1)
        blocks = (bins.coef[live], rows, ids, bins.valid[live, 0] > 0.0, bins.blk_tile[live].long())
        return _alpha_level(blocks, scene, arec, tile_h, tile_w, width, height, settings,
                            y_offset)

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
    base-colour tap at the analytic LOD, ``_alpha_lod``), then depth-combine
    with the opaque visibility buffer: a masked pixel wins only with a
    strictly greater key, so opaque wins ties.  Returns (depth, tri_id,
    counts); with ``stats`` counts holds the pair counts and drops of each
    masked level (the reference counts neither), else None.

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
        m_key, m_tri, counts = _rasterize_alpha(setup, arec, scene, settings, h, y0)
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


def _sample_aniso(quad_flat, atlas_width, rect0, suv, footprint, valid,
                  settings: RenderSettings):
    """D3D12_FILTER_ANISOTROPIC analog: ``max_anisotropy`` trilinear taps
    along the major-axis footprint at the minor-axis LOD; ``footprint``:
    the (lod, dmaj, extent) of ``tex.footprint_lod_aniso`` or
    ``tex.uv_screen_lod_aniso``.  Returns (sample, aniso_tap_overflow).

    With 0 < ``aniso_compact_frac`` < 1 the line taps run only over a
    compacted list of the anisotropic pixels (extent > 0; static cap =
    that fraction of the image, at least 1024) and every other pixel takes
    one centre tap, which equals its N coincident taps; pixels past the cap
    keep the centre tap and are counted."""
    n = settings.max_anisotropy
    sk = settings.mat_select_kernel
    lod, dmaj, extent = footprint

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


@named_pass("MaterialResolve")
def resolve_materials(scene: DeviceScene, pix9, tri_id, settings: RenderSettings,
                      compact_ids=None, full_override=None, row0: int = 0, next_tri_row=None,
                      prev_tri_row=None, row_halo=None):
    """Visibility buffer -> interpolated attributes + sampled materials:
    ONE per-pixel gather of the 128-wide record (or ``full_override``, the
    (H, W, 128) record image the raster kernels emitted under fused
    resolve: the same records where ``tri_id >= 0``, zeros elsewhere, where
    nothing reaches the outputs), then the material taps
    (``settings.texture_filter``) at the LOD of ``lod_derivatives``: the
    quad derivatives ("quad"), or forward differences of the pixels' uvs
    gated by triangle edges ("forward", ``tex.uv_screen_lod``); one
    combined-material tap (``combined_material``), else one tap per enabled
    slot (``slot_enabled``) on the per-map atlas.  The result carries
    ``aniso_tap_overflow`` (0 unless the compacted anisotropic taps
    overflowed their cap; per-slot, the last slot's count).

    A row slab (sharded frame): ``tri_id`` holds the slab's rows from
    global row ``row0``, pixel centres stay global; ``next_tri_row`` /
    ``prev_tri_row`` are the id rows just below and above the slab and
    ``row_halo(x)`` gives the rows above and below a slab image, for the
    forward differences at the seams."""
    width, height = settings.width, tri_id.shape[0]
    dev = tri_id.device
    if full_override is not None:
        full = full_override
    else:
        with scope("RecGather"):
            rec = build_resolve_records(scene, pix9, ids=compact_ids)
            full = rec[torch.clamp(tri_id, min=0).long()]  # (H, W, 128)
    av = full[..., 0:57]
    mrec = full[..., 57:121]
    valid = tri_id >= 0
    p0, p1, p2 = av[..., 0:3], av[..., 3:6], av[..., 6:9]

    yy = torch.arange(row0, row0 + height, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    qx, qy = xx + 0.5, yy + 0.5

    with scope("InterpAttr"):
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

    quad_lod = settings.lod_derivatives == "quad"
    if quad_lod:
        # D3D 2x2-quad derivatives with helper-lane semantics, evaluated
        # analytically from the pixel's own triangle at the quad corners
        xi = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
        yi = torch.arange(row0, row0 + height, dtype=torch.int32, device=dev)[:, None]
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
    else:
        # forward differences of the pixels' uvs, gated by the triangle
        # ids of the neighbours (+x/+y, then -x/-y); the frame's edge rows
        # and columns count as the same triangle (a 0 difference)
        same_x = _same_next(tri_id, 1)
        same_y = _same_next(tri_id, 0, next_tri_row)
        same_bx = _same_next(tri_id.flip(1), 1).flip(1)
        same_by = _same_next(tri_id.flip(0), 0, prev_tri_row).flip(0)

    quad_flat = scene.quad_img.reshape(-1, scene.quad_img.shape[-1])
    atlas_width = scene.quad_img.shape[1]
    # the anisotropic sampler's overflow count; with per-slot taps each slot
    # overwrites it, as the reference does (render/common.py:1219)
    aniso_overflow = [torch.zeros((), dtype=torch.int32, device=dev)]

    def sample_slot(slot):
        with scope("MaterialTap"):
            return _sample_slot(slot)

    def _sample_slot(slot):
        """The material tap of ``slot`` (``settings.texture_filter``) with
        the slot's own rect and KHR transform."""
        t_os = uv_os[..., slot * 4:slot * 4 + 4]
        t_rot = uv_rot[..., slot * 2:slot * 2 + 2]
        suv = tex.apply_texture_transform(uv, t_os, t_rot)
        rect0 = rects[..., slot * 4:slot * 4 + 4]
        scale = uv_os[..., slot * 4 + 2:slot * 4 + 4]
        base_w = rect0[..., 2] * scale[..., 0].abs()
        base_h = rect0[..., 3] * scale[..., 1].abs()
        # a slab's seam rows difference against the neighbours' rows
        ua, ub = row_halo(suv) if row_halo is not None and not quad_lod else (None, None)
        if quad_lod:
            # derivatives of the transformed uv, as the shader's quad sees
            s_tl = tex.apply_texture_transform(uv_tl, t_os, t_rot)
            d_dx = tex.apply_texture_transform(uv_tr, t_os, t_rot) - s_tl
            d_dy = tex.apply_texture_transform(uv_bl, t_os, t_rot) - s_tl
        if settings.texture_filter == "anisotropic":
            if quad_lod:
                footprint = tex.footprint_lod_aniso(d_dx, d_dy, base_w, base_h,
                                                    settings.max_anisotropy)
            else:
                footprint = tex.uv_screen_lod_aniso(suv, base_w, base_h, same_x, same_y,
                                                    settings.max_anisotropy, uv_above=ua,
                                                    uv_below=ub, same_tri_bx=same_bx,
                                                    same_tri_by=same_by)
            s, aniso_overflow[0] = _sample_aniso(quad_flat, atlas_width, rect0, suv, footprint,
                                                 valid, settings)
            return s
        if quad_lod:
            lod = tex.footprint_lod(d_dx, d_dy, base_w, base_h)
        else:
            lod = tex.uv_screen_lod(suv, base_w, base_h, same_x, same_y, uv_above=ua,
                                    uv_below=ub, same_tri_bx=same_bx, same_tri_by=same_by)
        if settings.texture_filter == "bilinear":
            level = tex._to_int(torch.round(torch.clamp(lod, min=0.0)))
            return _sample_level_any(quad_flat, atlas_width, rect0, suv, level)
        return _sample_trilinear_any(quad_flat, atlas_width, rect0, suv, lod,
                                     select_kernel=settings.mat_select_kernel)

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
    return {
        "valid": valid,
        "aniso_tap_overflow": aniso_overflow[0],
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
