"""Triangle setup, compaction and the plain visibility raster
(``unclerenderer_tpu/ops/raster.py``).

Clipless homogeneous rasterization: edge functions are 2D cross products of
viewport-scaled homogeneous vertices, the reverse-Z depth test is a max over
triangles with ties resolved to the minimum triangle id (commutative, so no
ordering and no atomics are needed).  Conventions as in the reference: D3D
viewport (y down, pixel centers at +0.5), clockwise front faces, top-left
fill rule.

Every expression on the depth/id path spells out the reference's FMA
contractions (``ops/fma.py``), so setups, keys and winners are bit-equal to
the JAX package on the CPU and to the CUDA kernels on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from .fma import fdiff, fdot, fma

CULL_NONE = 0
CULL_BACK = 1
CULL_FRONT = 2

DEPTH_MAX = 0  # reverse-Z main pass: nearest = largest z_ndc, clear to 0
DEPTH_MIN = 1  # shadow pass (LESS_EQUAL, cleared to 1): nearest = smallest

# Packed coefficient record columns (T, 16):
#   [0:3] edge a (x gradient) | [3:6] edge b (y gradient) | [6:9] edge c
#   [9:12] depth numerator (a, b, c) | [12:15] depth denominator | [15] pad
COEF_EA, COEF_EB, COEF_EC = 0, 3, 6
COEF_NZ, COEF_NW = 9, 12
COEF_COLS = 16

SUBCENTER_CULL = True
SUBCENTER_MARGIN = 1e-2

INT32_MAX = 0x7FFFFFFF


def viewport_homogeneous(clip, width: int, height: int):
    """Clip coordinates (V, 4) -> homogeneous pixel coordinates (V, 3) =
    (X, Y, w), X/w the pixel x, Y/w the pixel y (D3D viewport: y flipped,
    origin top-left).  Its multiplies by 0.5 are exact, so no contraction
    order matters."""
    x, y, w = clip[..., 0], clip[..., 1], clip[..., 3]
    px = (x * 0.5 + w * 0.5) * width
    py = (w * 0.5 - y * 0.5) * height
    return torch.stack([px, py, w], dim=-1)


@dataclasses.dataclass
class RasterSetup:
    """Per-triangle rasterization coefficients."""

    coef: torch.Tensor   # (T, 16) f32 packed record, see COEF_* columns
    valid: torch.Tensor  # (T,) bool
    bbox: torch.Tensor   # (4, T) f32 pixel-space AABB rows (x0, y0, x1, y1)


@dataclasses.dataclass
class VertexSoA:
    """Per-vertex-slot clip/pixel components, each a (T,) vector."""

    px: tuple  # 3 x (T,) homogeneous pixel X (pixel x * clip w)
    py: tuple  # 3 x (T,) homogeneous pixel Y
    pw: tuple  # 3 x (T,) clip w
    z: tuple   # 3 x (T,) clip z

    def pix9(self) -> torch.Tensor:
        """(T, 9) rows [x0 y0 w0 x1 y1 w1 x2 y2 w2]."""
        return torch.stack(
            [self.px[0], self.py[0], self.pw[0],
             self.px[1], self.py[1], self.pw[1],
             self.px[2], self.py[2], self.pw[2]],
            dim=1,
        )


@dataclasses.dataclass
class VertexAoS:
    """The AoS vertex stage's outputs (``RenderSettings.soa_vertex=False``,
    or a scene without ``pos_soa``): de-indexed vertex rows, vertex i of
    triangle t at row 3t + i."""

    clip: torch.Tensor   # (V, 4) clip coordinates
    pix_h: torch.Tensor  # (V, 3) homogeneous pixel coordinates

    def pix9(self) -> torch.Tensor:
        """(T, 9) rows [x0 y0 w0 x1 y1 w1 x2 y2 w2]."""
        return self.pix_h.reshape(-1, 9)


def triangle_setup_expanded(pix_h, z_clip, tri_mask, cull_mode=CULL_BACK, width: int = 0,
                            height: int = 0) -> RasterSetup:
    """Setup for de-indexed geometry: vertex i of triangle t at row 3t + i."""
    t = pix_h.shape[0] // 3
    p = pix_h.reshape(t, 3, 3)
    z = z_clip.reshape(t, 3)
    return triangle_setup_from_verts(p[:, 0], p[:, 1], p[:, 2], z[:, 0], z[:, 1], z[:, 2],
                                     tri_mask, cull_mode, width, height)


def triangle_setup_from_verts(p0, p1, p2, z0, z1, z2, tri_mask, cull_mode=CULL_BACK,
                              width: int = 0, height: int = 0) -> RasterSetup:
    """Setup from per-triangle (T, 3) homogeneous pixel vertices, with the
    AoS setup's contraction order (``triangle_setup_from_components``)."""
    return triangle_setup_from_components(
        p0[:, 0], p0[:, 1], p0[:, 2], p1[:, 0], p1[:, 1], p1[:, 2],
        p2[:, 0], p2[:, 1], p2[:, 2], z0, z1, z2, tri_mask, cull_mode, width, height, aos=True)


def triangle_setup_any(verts, tri_mask, cull_mode=CULL_BACK, width: int = 0,
                       height: int = 0) -> RasterSetup:
    """Setup from either vertex stage's outputs: ``VertexSoA`` or
    ``VertexAoS``."""
    if isinstance(verts, VertexAoS):
        return triangle_setup_expanded(verts.pix_h, verts.clip[:, 2], tri_mask, cull_mode,
                                       width, height)
    return triangle_setup_from_soa(verts, tri_mask, cull_mode, width, height)


def triangle_setup_from_soa(v: VertexSoA, tri_mask, cull_mode=CULL_BACK,
                            width: int = 0, height: int = 0) -> RasterSetup:
    return triangle_setup_from_components(
        v.px[0], v.py[0], v.pw[0],
        v.px[1], v.py[1], v.pw[1],
        v.px[2], v.py[2], v.pw[2],
        v.z[0], v.z[1], v.z[2], tri_mask, cull_mode, width, height,
    )


def triangle_setup_from_components(
    x0, y0v, w0, x1, y1v, w1, x2, y2v, w2, z0, z1, z2,
    tri_mask, cull_mode=CULL_BACK, width: int = 0, height: int = 0, aos: bool = False,
) -> RasterSetup:
    """Edge/depth coefficients and conservative bbox from per-triangle
    homogeneous pixel vertices (reference ``triangle_setup_from_components``).
    ``aos``: the components were sliced from the AoS vertex rows
    (``triangle_setup_from_verts``), whose depth planes the reference
    contracts in another order under CULL_FRONT (below).

    For a clockwise-on-screen triangle with all w > 0, det < 0; edge signs
    are flipped so the rasterized interior is always e_k > 0."""

    def cross(ax, ay, aw, bx, by, bw):
        return fdiff(ay, bw, aw, by), fdiff(aw, bx, ax, bw), fdiff(ax, by, ay, bx)

    e0a, e0b, e0c = cross(x1, y1v, w1, x2, y2v, w2)
    e1a, e1b, e1c = cross(x2, y2v, w2, x0, y0v, w0)
    e2a, e2b, e2c = cross(x0, y0v, w0, x1, y1v, w1)
    det = fdot([(e0a, x0), (e0b, y0v), (e0c, w0)])

    front = det < 0.0  # D3D front face (clockwise)
    if cull_mode == CULL_BACK:
        keep = front
        sign = torch.full_like(det, -1.0)
    elif cull_mode == CULL_FRONT:
        keep = ~front
        sign = torch.ones_like(det)
    else:
        keep = torch.ones_like(front)
        sign = torch.where(front, -1.0, 1.0)

    e0a, e0b, e0c = e0a * sign, e0b * sign, e0c * sign
    e1a, e1b, e1c = e1a * sign, e1b * sign, e1c * sign
    e2a, e2b, e2c = e2a * sign, e2b * sign, e2c * sign

    valid = tri_mask & keep & (det != 0.0)

    # Depth planes sum_k e_k * v_k.  LLVM picks the FMA operand order per
    # expression from its DAG, so the reference's order differs by cull
    # mode and column (measured against the jitted reference setup: 0
    # differing coefficients with these, 1-9% of rows with any other):
    # CULL_BACK accumulates e0*v0 -> e1 -> e2 everywhere; CULL_FRONT does so
    # except in the b columns, which start from fma(e0, v0, e1*v1) -- and,
    # on the AoS setup (whose setup the reference does not pin with an
    # optimization barrier), in every column (0 differing coefficients of
    # the light-space setup against the jitted reference; 1-2% of rows with
    # the SoA order).
    def plane(e0, e1, e2, v0, v1, v2, b_col):
        if cull_mode == CULL_NONE or (cull_mode == CULL_FRONT and (b_col or aos)):
            return fdot([(e0, v0), (e1, v1), (e2, v2)])
        return fma(e2, v2, fma(e1, v1, e0 * v0))

    nza = plane(e0a, e1a, e2a, z0, z1, z2, False)
    nzb = plane(e0b, e1b, e2b, z0, z1, z2, True)
    nzc = plane(e0c, e1c, e2c, z0, z1, z2, False)
    nwa = plane(e0a, e1a, e2a, w0, w1, w2, False)
    nwb = plane(e0b, e1b, e2b, w0, w1, w2, True)
    nwc = plane(e0c, e1c, e2c, w0, w1, w2, False)

    coef = torch.stack(
        [e0a, e1a, e2a, e0b, e1b, e2b, e0c, e1c, e2c,
         nza, nzb, nzc, nwa, nwb, nwc, torch.zeros_like(e0a)],
        dim=1,
    )

    # conservative pixel bbox; vertices behind the camera get the viewport
    eps = 1e-9
    any_behind = (w0 <= eps) | (w1 <= eps) | (w2 <= eps)
    iw0 = 1.0 / torch.clamp(w0, min=eps)
    iw1 = 1.0 / torch.clamp(w1, min=eps)
    iw2 = 1.0 / torch.clamp(w2, min=eps)
    sx0, sx1, sx2 = x0 * iw0, x1 * iw1, x2 * iw2
    sy0, sy1, sy2 = y0v * iw0, y1v * iw1, y2v * iw2
    sx_min = torch.minimum(torch.minimum(sx0, sx1), sx2)
    sx_max = torch.maximum(torch.maximum(sx0, sx1), sx2)
    sy_min = torch.minimum(torch.minimum(sy0, sy1), sy2)
    sy_max = torch.maximum(torch.maximum(sy0, sy1), sy2)
    wmax, hmax = float(max(width - 1, 0)), float(max(height - 1, 0))
    zero = torch.zeros_like(sx_min)
    bx0 = torch.where(any_behind, zero, torch.floor(sx_min))
    by0 = torch.where(any_behind, zero, torch.floor(sy_min))
    bx1 = torch.where(any_behind, zero + wmax, torch.ceil(sx_max))
    by1 = torch.where(any_behind, zero + hmax, torch.ceil(sy_max))
    bbox = torch.stack(
        [bx0.clamp(0.0, wmax), by0.clamp(0.0, hmax),
         bx1.clamp(0.0, wmax), by1.clamp(0.0, hmax)],
        dim=0,
    )
    on_screen = (bx1 >= 0) & (by1 >= 0) & (bx0 <= width - 1) & (by0 <= height - 1)
    valid = valid & (on_screen | any_behind)

    # sub-center cull: a triangle whose hull range holds no pixel center in
    # x or in y can never win a pixel (reference comment, ops/raster.py)
    if SUBCENTER_CULL:
        mg = SUBCENTER_MARGIN
        has_center = (
            (torch.ceil(sx_min - 0.5 - mg) + 0.5 <= sx_max + mg)
            & (torch.ceil(sy_min - 0.5 - mg) + 0.5 <= sy_max + mg)
        )
        valid = valid & (has_center | any_behind)

    return RasterSetup(coef=coef, valid=valid, bbox=bbox)


def normalize_ortho_setup(setup: RasterSetup) -> RasterSetup:
    """Orthographic specialization: the depth denominator is the constant
    determinant, so fold the division into the numerator once per triangle;
    nw becomes (0, 0, 1) and kernels with ``ortho`` skip the divide."""
    coef = setup.coef.clone()
    nwc = coef[:, COEF_NW + 2].clone()
    inv = 1.0 / torch.where(nwc != 0.0, nwc, torch.ones_like(nwc))
    coef[:, COEF_NZ:COEF_NZ + 3] = coef[:, COEF_NZ:COEF_NZ + 3] * inv[:, None]
    coef[:, COEF_NW + 0] = 0.0
    coef[:, COEF_NW + 1] = 0.0
    coef[:, COEF_NW + 2] = 1.0
    valid = setup.valid & (nwc > 0.0)
    return RasterSetup(coef=coef, valid=valid, bbox=setup.bbox)


def flip_depth_key(setup: RasterSetup) -> RasterSetup:
    """Depth numerator -> (nw - nz): key = 1 - depth, so the max-reduction
    implements the LESS_EQUAL shadow test."""
    coef = setup.coef.clone()
    coef[:, COEF_NZ:COEF_NZ + 3] = (
        setup.coef[:, COEF_NW:COEF_NW + 3] - setup.coef[:, COEF_NZ:COEF_NZ + 3]
    )
    return RasterSetup(coef=coef, valid=setup.valid, bbox=setup.bbox)


def compact_mask(mask: torch.Tensor, cap: int, mode: str = "sort"):
    """First ``cap`` True rows of ``mask`` in ascending index order.
    Returns ``(ids (cap,) i32, ok (cap,) bool)``.  The reference's three
    modes give identical outputs; the port runs the packed sort."""
    del mode
    t_count = mask.shape[0]
    iota = torch.arange(t_count, dtype=torch.int64, device=mask.device)
    idx_bits = max((t_count - 1).bit_length(), 1)
    packed = torch.where(mask, 0, 1 << idx_bits) + iota
    sp = torch.sort(packed).values[:cap]
    ids = (sp & ((1 << idx_bits) - 1)).to(torch.int32)
    return ids, sp < (1 << idx_bits)


def compact_setup(setup: RasterSetup, cap: int, mode: str = "sort"):
    """Frame-visible triangle compaction: ``(setup_c, ids, overflow)`` with
    the first ``cap`` valid triangles in ascending id order (so compact-id
    order == global-id order and min-id tie-breaks are preserved), the
    compact -> global id map, and the count of valid triangles DROPPED."""
    ids, ok = compact_mask(setup.valid, cap, mode)
    overflow = (setup.valid.sum() - ok.sum()).to(torch.int32)
    li = ids.long()
    setup_c = RasterSetup(coef=setup.coef[li], valid=ok, bbox=setup.bbox[:, li])
    return setup_c, ids, overflow


# ---------------------------------------------------------------------------
# Plain block evaluation shared by the raster references
# ---------------------------------------------------------------------------


def tile_pixel_centers(tile: torch.Tensor, tile_h: int, tile_w: int, n_tx: int,
                       y_offset: float = 0.0):
    """(B,) tile ids -> pixel-center coordinates (B, tile_h*tile_w) each,
    computed like the kernels: x0 + col + 0.5 in f32."""
    pix = tile_h * tile_w
    col = torch.arange(pix, device=tile.device)
    x0 = ((tile % n_tx) * tile_w).to(torch.float32)
    y0 = ((tile // n_tx) * tile_h).to(torch.float32) + y_offset
    qx = x0[:, None] + (col % tile_w).to(torch.float32)[None, :] + 0.5
    qy = y0[:, None] + (col // tile_w).to(torch.float32)[None, :] + 0.5
    return qx, qy


def eval_keys(coef: torch.Tensor, valid: torch.Tensor, qx: torch.Tensor,
              qy: torch.Tensor, ortho: bool = False):
    """Per-(block, pixel, slot) depth keys, -1 where not covered.

    coef (B, 16, C) f32, valid (B, C) bool, qx/qy (B, P) f32 ->
    (key (B, P, C), ok (B, P, C)).  The same arithmetic as the reference's
    ``_eval_chunk``: top-left edge tests, key = nz / nw (nz when ortho)."""
    X = qx[:, :, None]
    Y = qy[:, :, None]

    def row(i):
        return coef[:, None, i, :]  # (B, 1, C)

    ok = None
    for i in range(3):
        a, b, c = row(i), row(3 + i), row(6 + i)
        ev = fma(a, X, b * Y) + c
        tl = (a > 0.0) | ((a == 0.0) & (b > 0.0))
        inside = (ev > 0.0) | ((ev == 0.0) & tl)
        ok = inside if ok is None else ok & inside
    key = fma(row(9), X, row(10) * Y) + row(11)
    if not ortho:
        nw = fma(row(12), X, row(13) * Y) + row(14)
        key = key / torch.where(nw != 0.0, nw, torch.ones_like(nw))
        ok = ok & (nw > 0.0)
    ok = ok & (key >= 0.0) & (key <= 1.0) & valid[:, None, :]
    return torch.where(ok, key, torch.full_like(key, -1.0)), ok


def block_winners(coef, valid, tid, qx, qy, ortho=False, want_ids=True):
    """Per block and pixel: max key, and the minimum triangle id among the
    slots at that key (INT32_MAX where none).  tid (B, C) i32."""
    key, ok = eval_keys(coef, valid, qx, qy, ortho)
    k_best = key.max(dim=-1).values
    if not want_ids:
        return k_best, None
    big = torch.full_like(tid, INT32_MAX)[:, None, :]
    at = (key == k_best[..., None]) & ok
    k_id = torch.where(at, tid[:, None, :], big).min(dim=-1).values
    return k_best, k_id


def merge_blocks(blk_key, blk_id, blk_tile, n_tiles: int):
    """Tile-level merge of per-block winners: max key, min id on key ties
    (-1 / -1 for tiles no block reached).  blk_key/blk_id (B, P)."""
    p = blk_key.shape[1]
    dev = blk_key.device
    idx = blk_tile.long()[:, None].expand(-1, p)
    tile_key = torch.full((n_tiles, p), -1.0, dtype=torch.float32, device=dev)
    tile_key = tile_key.scatter_reduce(0, idx, blk_key, reduce="amax", include_self=True)
    if blk_id is None:
        return tile_key, None
    at_best = (blk_key == tile_key.gather(0, idx)) & (blk_key >= 0.0)
    cand = torch.where(at_best, blk_id, torch.full_like(blk_id, INT32_MAX))
    tile_id = torch.full((n_tiles, p), INT32_MAX, dtype=torch.int32, device=dev)
    tile_id = tile_id.scatter_reduce(0, idx, cand, reduce="amin", include_self=True)
    tile_id = torch.where(tile_key >= 0.0, tile_id, torch.full_like(tile_id, -1))
    return tile_key, tile_id


def batched_blocks(n_blocks: int, per_block: int, budget: int = 1 << 22):
    """Block ranges sized so one batch holds ~``budget`` (pixel, slot)
    pairs: the plain references stream blocks through memory in batches."""
    step = max(1, budget // max(per_block, 1))
    for b0 in range(0, n_blocks, step):
        yield b0, min(b0 + step, n_blocks)


def untile(x: torch.Tensor, width: int, height: int, tile_h: int, tile_w: int):
    """(n_tiles, tile_h*tile_w[, R]) tile-major -> (height, width[, R])."""
    pad_w = -(-width // tile_w) * tile_w
    pad_h = -(-height // tile_h) * tile_h
    n_ty, n_tx = pad_h // tile_h, pad_w // tile_w
    rest = x.shape[2:]
    return (
        x.reshape((n_ty, n_tx, tile_h, tile_w) + rest)
        .transpose(1, 2)
        .reshape((pad_h, pad_w) + rest)[:height, :width]
    )


def rasterize(setup: RasterSetup, width: int, height: int, tile_h: int = 32,
              tile_w: int = 64, chunk: int = 128, depth_mode: int = DEPTH_MAX,
              y_offset: float = 0.0):
    """Exhaustive visibility raster (reference ``rasterize``): every tile
    against every triangle, with a per-(tile, triangle) bbox rejection.
    Returns (depth (H, W) f32, tri_id (H, W) i32, -1 where empty)."""
    dev = setup.coef.device
    pad_w = -(-width // tile_w) * tile_w
    pad_h = -(-height // tile_h) * tile_h
    n_tx = pad_w // tile_w
    n_tiles = n_tx * (pad_h // tile_h)
    if depth_mode != DEPTH_MAX:
        setup = flip_depth_key(setup)
    t = setup.coef.shape[0]
    n_chunks = max(1, -(-t // chunk))
    t_pad = n_chunks * chunk
    coef = torch.zeros((t_pad, COEF_COLS), dtype=torch.float32, device=dev)
    coef[:t] = setup.coef
    valid = torch.zeros(t_pad, dtype=torch.bool, device=dev)
    valid[:t] = setup.valid
    bbox = torch.zeros((4, t_pad), dtype=torch.float32, device=dev)
    bbox[:, :t] = setup.bbox
    coef = coef.reshape(n_chunks, chunk, COEF_COLS).transpose(1, 2)
    tid = torch.arange(t_pad, dtype=torch.int32, device=dev).reshape(n_chunks, chunk)
    # every (tile, chunk) pair is a block; the per-triangle bbox test
    # folds into its valid row
    pair_tile = torch.arange(n_tiles, device=dev).repeat_interleave(n_chunks)
    pair_chunk = torch.arange(n_chunks, device=dev).repeat(n_tiles)
    tx0 = ((pair_tile % n_tx) * tile_w).to(torch.float32)
    ty0 = ((pair_tile // n_tx) * tile_h).to(torch.float32) + y_offset
    bb = bbox.reshape(4, n_chunks, chunk)[:, pair_chunk]  # (4, pairs, chunk)
    overlap = (
        (bb[0] <= (tx0 + (tile_w - 1))[:, None]) & (bb[2] >= tx0[:, None])
        & (bb[1] <= (ty0 + (tile_h - 1))[:, None]) & (bb[3] >= ty0[:, None])
    )
    pair_valid = valid.reshape(n_chunks, chunk)[pair_chunk] & overlap
    keys, ids = [], []
    for b0, b1 in batched_blocks(pair_tile.shape[0], tile_h * tile_w * chunk):
        qx, qy = tile_pixel_centers(pair_tile[b0:b1], tile_h, tile_w, n_tx, y_offset)
        k, i = block_winners(coef[pair_chunk[b0:b1]], pair_valid[b0:b1],
                             tid[pair_chunk[b0:b1]], qx, qy)
        keys.append(k)
        ids.append(i)
    tile_key, tile_id = merge_blocks(torch.cat(keys), torch.cat(ids), pair_tile, n_tiles)
    hit = tile_key >= 0.0
    if depth_mode == DEPTH_MAX:
        depth = torch.where(hit, tile_key, torch.zeros_like(tile_key))
    else:
        depth = torch.where(hit, 1.0 - tile_key, torch.ones_like(tile_key))
    return (untile(depth, width, height, tile_h, tile_w),
            untile(tile_id, width, height, tile_h, tile_w))
