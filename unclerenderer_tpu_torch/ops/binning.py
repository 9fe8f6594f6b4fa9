"""Sort-based triangle binning (``unclerenderer_tpu/ops/binning.py``).

1. expand each triangle into up to S (tile, tri) pairs from its pixel bbox
   (triangles spanning more than S tiles go to the next, coarser level);
2. sort pairs by tile with ONE packed-key sort (pairs of a tile end up in
   ascending triangle id);
3. block-align: block slot (b, s) reads sorted pair
   ``starts[tile(b)] + (b - blk_start[tile(b)]) * chunk + s``;
4. gather the packed coefficient records into (n_blocks, 16, chunk)
   (with ``mat_idx``, through a K9 copy of the block index array first,
   ``raster_kernels.materialize_rows``).

A fixed pair budget keeps the block count static; pairs past it are counted
(``overflow``), never silently dropped.  The block tables equal the
reference's exactly.
"""

from __future__ import annotations

import dataclasses

import torch

from .raster import RasterSetup


def _sort_pairs(keys: torch.Tensor, n_tiles: int, s_slots: int):
    """Sort (tile, pair) by tile id.  Returns (sorted_key, sorted_tri): the
    tile id and originating triangle row of each pair in tile order, pairs
    of one tile ascending in triangle id -- the order of the reference's
    packed sort (and of its stable-argsort fallback)."""
    n_pairs = keys.shape[0]
    n_tris = max(n_pairs // s_slots, 1)
    tri_bits = max((n_tris - 1).bit_length(), 1)
    tri = torch.arange(n_pairs, dtype=torch.int64, device=keys.device) // s_slots
    packed = (keys.long() << tri_bits) + tri
    sp = torch.sort(packed).values
    return (sp >> tri_bits).to(torch.int32), (sp & ((1 << tri_bits) - 1)).to(torch.int32)


@dataclasses.dataclass
class BinnedTriangles:
    """Block-aligned per-tile triangle lists + gathered coefficients."""

    coef: torch.Tensor      # (n_blocks, 16, chunk) f32
    tri_id: torch.Tensor    # (n_blocks, 1, chunk) i32 original triangle ids
    valid: torch.Tensor     # (n_blocks, 1, chunk) f32
    blk_tile: torch.Tensor  # (n_blocks,) i32 tile id of each block
    blk_first: torch.Tensor  # (n_blocks,) i32 1 = first block of its tile
    blk_live: torch.Tensor  # (n_blocks,) i32 1 = block holds real pairs
    tile_used: torch.Tensor  # (n_tiles,) bool tile has any content
    big_mask: torch.Tensor  # (T,) bool triangles for the next level
    overflow: torch.Tensor  # () i32 dropped pair count


def _pair_keys(setup: RasterSetup, width, height, tile_h, tile_w, max_span, y_offset=0.0,
               full_height=None):
    """Each triangle's bbox -> up to S tile keys (``n_tiles`` = invalid),
    plus the mask of triangles spanning more than S x S tiles.

    The image is ``height`` rows from global row ``y_offset``.  With
    ``full_height`` it is a region of a ``full_height``-row image whose
    tiles are that image's (``y_offset`` a multiple of ``tile_h``): a
    triangle's span counts its tiles in the whole image, so that it goes to
    the level it goes to there, and keys only the region's tiles."""
    n_tx = -(-width // tile_w)
    n_ty = -(-height // tile_h)
    n_tiles = n_tx * n_ty
    s_slots = max_span * max_span
    dev = setup.coef.device

    bbox = setup.bbox
    lo, hi = ((y_offset, y_offset + (height - 1)) if full_height is None
              else (0.0, float(full_height - 1)))
    by0 = torch.clamp(bbox[1], lo, hi) - y_offset
    by1 = torch.clamp(bbox[3], lo, hi) - y_offset
    row_in = (bbox[3] >= y_offset) & (bbox[1] <= y_offset + (height - 1))
    # bbox values are integers: floor division is exact
    tx0 = torch.div(bbox[0], tile_w, rounding_mode="floor").to(torch.int64)
    ty0 = torch.div(by0, tile_h, rounding_mode="floor").to(torch.int64)
    tx1 = torch.div(bbox[2], tile_w, rounding_mode="floor").to(torch.int64)
    ty1 = torch.div(by1, tile_h, rounding_mode="floor").to(torch.int64)
    span_w = tx1 - tx0 + 1
    span_h = ty1 - ty0 + 1
    small = setup.valid & row_in & (span_w <= max_span) & (span_h <= max_span)
    big = setup.valid & row_in & ~small

    s = torch.arange(s_slots, dtype=torch.int64, device=dev)
    sy = torch.div(s[None, :], span_w[:, None], rounding_mode="floor")
    sx = s[None, :] - sy * span_w[:, None]
    slot_ty = ty0[:, None] + sy
    slot_tile = slot_ty * n_tx + tx0[:, None] + sx
    slot_ok = small[:, None] & (s[None, :] < (span_w * span_h)[:, None])
    if full_height is not None:  # tiles of the whole image outside the region
        slot_ok = slot_ok & (slot_ty >= 0) & (slot_ty < n_ty)
    keys = torch.where(slot_ok, slot_tile, n_tiles).reshape(-1)
    return keys, big


def _align_pairs(sorted_key, sorted_tri, n_tiles: int, chunk: int, n_blocks: int):
    """Block-align sorted (tile, tri) pairs.  Returns (blocks_tid,
    slot_valid, blk_tile, blk_first, in_use, tile_used, overflow)."""
    dev = sorted_key.device
    starts = torch.searchsorted(
        sorted_key.long(), torch.arange(n_tiles + 1, dtype=torch.int64, device=dev))
    counts = starts[1:] - starts[:-1]
    nblk = torch.div(counts + (chunk - 1), chunk, rounding_mode="floor")
    blk_start = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(nblk, 0)])
    total_used = blk_start[-1]

    blk_ids = torch.arange(n_blocks, dtype=torch.int64, device=dev)
    blk_tile = torch.clamp(
        torch.searchsorted(blk_start, blk_ids, right=True) - 1, 0, n_tiles - 1)
    in_use = blk_ids < total_used
    blk_first = (blk_ids == blk_start[blk_tile]).to(torch.int32)

    slot = torch.arange(chunk, dtype=torch.int64, device=dev)[None, :]
    pair_src = (starts[blk_tile][:, None]
                + (blk_ids - blk_start[blk_tile])[:, None] * chunk + slot)
    slot_valid = in_use[:, None] & (pair_src < starts[blk_tile + 1][:, None])
    pair_src_c = torch.clamp(pair_src, 0, sorted_tri.shape[0] - 1)
    raw_tid = sorted_tri[pair_src_c]
    blocks_tid = torch.where(slot_valid, raw_tid, torch.zeros_like(raw_tid))
    overflow = torch.clamp(starts[n_tiles] - slot_valid.sum(), min=0)
    # a tile is usable only if its first block fits the block budget
    tile_used = (counts > 0) & (blk_start[:-1] < n_blocks)
    return (blocks_tid, slot_valid, blk_tile.to(torch.int32), blk_first,
            in_use, tile_used, overflow)


def bin_triangles(
    setup: RasterSetup, width: int, height: int, tile_h: int, tile_w: int,
    chunk: int, max_span: int = 2, budget_factor: float = 3.0,
    tri_ids: torch.Tensor | None = None, y_offset: float = 0.0, mat_idx: bool = False,
    full_height: int | None = None,
) -> BinnedTriangles:
    """tri_ids (optional) maps local rows of a compacted setup back to
    global triangle ids for the output id buffers.  ``y_offset`` and
    ``full_height``: the image is a region of a larger one (``_pair_keys``)."""
    n_tx = -(-width // tile_w)
    n_ty = -(-height // tile_h)
    n_tiles = n_tx * n_ty
    t_count = setup.coef.shape[0]
    s_slots = max_span * max_span

    keys, big = _pair_keys(setup, width, height, tile_h, tile_w, max_span, y_offset, full_height)
    sorted_key, sorted_tri = _sort_pairs(keys, n_tiles, s_slots)

    n_blocks = int(budget_factor * t_count) // chunk + n_tiles
    n_blocks = max(n_blocks, 2)
    (blocks_tid, slot_valid, blk_tile, blk_first, in_use, tile_used,
     overflow) = _align_pairs(sorted_key, sorted_tri, n_tiles, chunk, n_blocks)
    blocks_valid = slot_valid.to(torch.float32)
    out_tid = blocks_tid if tri_ids is None else torch.where(
        slot_valid, tri_ids[blocks_tid.long()], torch.zeros_like(blocks_tid))
    gather_tid = blocks_tid
    if mat_idx:
        from .raster_kernels import materialize_rows  # raster_kernels imports this module

        gather_tid = materialize_rows(blocks_tid)
    coef = setup.coef[gather_tid.long()].transpose(1, 2).contiguous()  # (n_blocks, 16, chunk)
    return BinnedTriangles(
        coef=coef,
        tri_id=out_tid.to(torch.int32)[:, None, :].contiguous(),
        valid=blocks_valid[:, None, :].contiguous(),
        blk_tile=blk_tile,
        blk_first=blk_first,
        blk_live=in_use.to(torch.int32),
        tile_used=tile_used,
        big_mask=big,
        overflow=overflow.to(torch.int32),
    )
