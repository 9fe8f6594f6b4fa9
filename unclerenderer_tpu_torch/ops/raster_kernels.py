"""Binned three-level visibility raster with its two CUDA kernels
(``unclerenderer_tpu/ops/pallas_raster.py``).

* ``binned_raster`` (K1, ``csrc/binned_raster.cu``): the fine and mid
  levels -- every bin block of a tile against that tile's pixels.
* ``giant_raster`` (K2/K3, ``csrc/giant_raster.cu``): the giant level --
  every pixel against the small compacted giant table, skipping chunks
  whose overlap bit for the tile is clear.
* ``materialize_rows`` (K9, ``csrc/copy_bytes.cu``): the identity
  copy of the binning's block-aligned index array before the coefficient
  gather, under ``RenderSettings.bin_mat_idx``.
* ``rasterize_binned``: fine bins + coarse (mid) bins + giant brute force,
  merged by depth key with min-id tie-breaks.

Each kernel wrapper runs its plain version (``*_ref``) for CPU tensors and
launches the kernel for CUDA tensors; there is no fallback between the two.
"""

from __future__ import annotations

import math

import torch

from . import _cuda
from .binning import BinnedTriangles, bin_triangles
from .raster import (
    COEF_COLS,
    DEPTH_MAX,
    RasterSetup,
    batched_blocks,
    block_winners,
    compact_mask,
    flip_depth_key,
    merge_blocks,
    tile_pixel_centers,
    untile,
)

BINNED_MAX_CHUNK = 128  # K1 stages a block with cp.async: chunk % 4 == 0
GIANT_MAX_CHUNK = 256  # one K2 window of staged rows holds a chunk


def _check_y_offset(name, y_offset):
    # the kernels' warp skip needs finite pixel centres (source notes)
    if not math.isfinite(y_offset):
        raise ValueError(f"{name}: y_offset must be finite, got {y_offset}")


def _split_last(x: torch.Tensor, pieces: int, width: int) -> torch.Tensor:
    """(B, R, chunk) -> (B * pieces, R, width): the last axis zero-padded to
    ``pieces * width`` and cut into ``pieces`` runs, each block's runs kept
    together in order."""
    b, r, chunk = x.shape
    x = torch.nn.functional.pad(x, (0, pieces * width - chunk))
    # contiguous: for b == 1 a reshape alone would return a strided view
    return x.reshape(b, r, pieces, width).transpose(1, 2).contiguous().view(b * pieces, r, width)


def fit_binned_blocks(coef, tri_id, valid, tile_start, tile_count):
    """K1's inputs at any chunk -> the same bins in blocks of at most
    ``BINNED_MAX_CHUNK`` slots, a multiple of 4 (what K1 stages), returned
    untouched when the chunk already fits.  Each block becomes ``k`` runs
    of its slots, zero-padded (``valid = 0``: such a slot never wins), and a
    tile's block range scales by ``k`` and stays contiguous.  Exact: a
    tile's winner is the max key, then the min id among those at it, over
    all its valid slots -- the same whatever blocks hold them and in
    whatever order they are visited."""
    chunk = coef.shape[-1]
    if chunk % 4 == 0 and 4 <= chunk <= BINNED_MAX_CHUNK:
        return coef, tri_id, valid, tile_start, tile_count
    k = -(-chunk // BINNED_MAX_CHUNK)
    width = -(-chunk // (4 * k)) * 4
    return (_split_last(coef, k, width), _split_last(tri_id, k, width),
            _split_last(valid, k, width), tile_start * k, tile_count * k)


def fit_giant_chunks(coef, valid, overlap, ids):
    """K2's inputs at any chunk -> chunks of at most ``GIANT_MAX_CHUNK`` rows
    (one staged window), returned untouched when the chunk already fits.
    Chunk c becomes ``k`` pieces c*k .. c*k + k-1, each with c's overlap
    bit, so every tile visits the same rows in the same ascending order.
    Local row c*chunk + s becomes (c*k + s // w)*w + s % w for pieces of w
    rows: where k*w == chunk that is the same number and ``ids`` is kept;
    otherwise the pieces are zero-padded (``valid = 0``) and ``ids`` is laid
    out to match, the identity map made explicit where it was None."""
    n_chunks, chunk = valid.shape
    if chunk <= GIANT_MAX_CHUNK:
        return coef, valid, overlap, ids
    k = -(-chunk // GIANT_MAX_CHUNK)
    width = -(-chunk // k)
    if k * width != chunk:
        if ids is None:
            ids = torch.arange(n_chunks * chunk, dtype=torch.int32, device=coef.device)
        ids = _split_last(ids.reshape(n_chunks, 1, chunk), k, width).reshape(-1)
    return (_split_last(coef, k, width), _split_last(valid[:, None], k, width)[:, 0],
            overlap.repeat_interleave(k, dim=1), ids)


# ---------------------------------------------------------------------------
# K9: identity copy of the block index array
# ---------------------------------------------------------------------------


def materialize_rows_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: a copy of ``x``."""
    return x.clone()


def materialize_rows(x: torch.Tensor) -> torch.Tensor:
    """K9 wrapper: a bit-exact copy of a 4-byte-element tensor into a fresh
    one, made by a launched kernel (the reference's ``materialize_rows``)."""
    if _cuda.on_cpu("materialize_rows", x):
        return materialize_rows_ref(x)
    if x.element_size() != 4:
        raise ValueError(f"materialize_rows: expects 4-byte elements, got {x.dtype}")
    # .contiguous() costs a dispatcher call even when it returns x itself
    return _cuda.copy("materialize_rows", x if x.is_contiguous() else x.contiguous())


# ---------------------------------------------------------------------------
# K1: binned blocks -> tile key/id
# ---------------------------------------------------------------------------


def binned_raster_ref(coef, tri_id, valid, tile_start, tile_count, tile_h, tile_w,
                      n_tx, y_offset=0.0, want_ids=True, ortho=False):
    """Plain version of K1.  coef (n_blocks, 16, chunk), tri_id/valid
    (n_blocks, 1, chunk), tile_start/tile_count (n_tiles,) i32: tile t owns
    blocks [tile_start[t], tile_start[t] + tile_count[t]).  Returns raw
    keys (n_tiles, pix) f32 (-1 = miss) and ids (n_tiles, pix) i32."""
    n_tiles = tile_start.shape[0]
    dev = coef.device
    counts = tile_count.long()
    blk_tile = torch.repeat_interleave(torch.arange(n_tiles, device=dev), counts)
    first = torch.repeat_interleave(tile_start.long() - torch.cumsum(counts, 0) + counts, counts)
    blk = first + torch.arange(blk_tile.shape[0], device=dev)
    pix = tile_h * tile_w
    keys, ids = [], []
    for b0, b1 in batched_blocks(blk.shape[0], pix * coef.shape[-1]):
        sel = blk[b0:b1]
        qx, qy = tile_pixel_centers(blk_tile[b0:b1], tile_h, tile_w, n_tx, y_offset)
        k, i = block_winners(coef[sel], valid[sel, 0] > 0.0, tri_id[sel, 0], qx, qy,
                             ortho=ortho, want_ids=want_ids)
        keys.append(k)
        ids.append(i)
    empty = torch.empty((0, pix), dtype=torch.float32, device=dev)
    blk_key = torch.cat(keys) if keys else empty
    blk_id = (torch.cat(ids) if ids else empty.to(torch.int32)) if want_ids else None
    return merge_blocks(blk_key, blk_id, blk_tile, n_tiles)


def binned_raster(coef, tri_id, valid, tile_start, tile_count, tile_h, tile_w,
                  n_tx, y_offset=0.0, want_ids=True, ortho=False):
    """K1 wrapper (same contract as ``binned_raster_ref``)."""
    if _cuda.on_cpu("binned_raster", coef):
        return binned_raster_ref(coef, tri_id, valid, tile_start, tile_count,
                                 tile_h, tile_w, n_tx, y_offset, want_ids, ortho)
    coef, tri_id, valid, tile_start, tile_count = fit_binned_blocks(
        coef, tri_id, valid, tile_start, tile_count)
    n_tiles = tile_start.shape[0]
    chunk = coef.shape[-1]
    pix = tile_h * tile_w
    if (coef.dtype != torch.float32 or valid.dtype != torch.float32 or tri_id.dtype != torch.int32
            or tile_start.dtype != torch.int32 or tile_count.dtype != torch.int32):
        raise ValueError("binned_raster: expects f32 coef/valid and i32 tri_id/tile_start/tile_count")
    _check_y_offset("binned_raster", y_offset)
    dev = _cuda.check_cuda("binned_raster", coef, tri_id, valid, tile_start, tile_count)
    if (coef.data_ptr() | tri_id.data_ptr() | valid.data_ptr()) % 16:
        raise ValueError("binned_raster: coef, tri_id and valid must be 16-byte aligned")
    out_key = torch.empty((n_tiles, pix), dtype=torch.float32, device=coef.device)
    out_id = (torch.empty((n_tiles, pix), dtype=torch.int32, device=coef.device)
              if want_ids else None)
    if n_tiles:
        _cuda.launch(
            "binned_raster", dev, coef.data_ptr(), tri_id.data_ptr(), valid.data_ptr(),
            tile_start.data_ptr(), tile_count.data_ptr(), out_key.data_ptr(),
            _cuda.ptr(out_id), n_tiles, chunk, tile_h, tile_w, n_tx,
            float(y_offset), int(want_ids), int(ortho),
        )
    return out_key, out_id


def tile_block_ranges(bins: BinnedTriangles, n_tiles: int):
    """Live blocks are [0, total_used) in tile order, so each tile's blocks
    form one contiguous range: (start, count) per tile.  Dead budget blocks
    belong to no tile and cost the kernel nothing."""
    live = bins.blk_live == 1
    count = torch.bincount(bins.blk_tile[live].long(), minlength=n_tiles)[:n_tiles]
    start = torch.cumsum(count, 0) - count
    return start.to(torch.int32), count.to(torch.int32)


def _run_binned_kernel(bins: BinnedTriangles, width, height, tile_h, tile_w,
                       y_offset=0.0, want_ids=True, ortho=False):
    """One binned level -> (key_img, id_img) cropped to (height, width),
    key = -1 where empty."""
    n_tx = -(-width // tile_w)
    n_tiles = n_tx * (-(-height // tile_h))
    start, count = tile_block_ranges(bins, n_tiles)
    key, ids = binned_raster(bins.coef, bins.tri_id, bins.valid, start, count,
                             tile_h, tile_w, n_tx, y_offset, want_ids, ortho)
    used = bins.tile_used[:, None]
    key = torch.where(used, key, torch.full_like(key, -1.0))
    key_img = untile(key, width, height, tile_h, tile_w)
    if not want_ids:
        return key_img, None
    ids = torch.where(used, ids, torch.full_like(ids, -1))
    return key_img, untile(ids, width, height, tile_h, tile_w)


# ---------------------------------------------------------------------------
# K2/K3: giant level -> tile key/id
# ---------------------------------------------------------------------------


def giant_raster_ref(coef, valid, overlap, ids, tile_h, tile_w, n_tx, y_offset=0.0,
                     want_ids=True, ortho=False):
    """Plain version of K2/K3.  coef (n_chunks, 16, chunk), valid
    (n_chunks, chunk) f32, overlap (n_tiles, n_chunks) i32 work bits, ids
    (n_chunks*chunk,) i32 local -> global id map (None = local ids).
    Only (tile, chunk) pairs with their bit set are evaluated, and every
    row of such a chunk is -- the reference kernels' skip granularity.
    Returns raw keys (n_tiles, pix) and global ids (n_tiles, pix)."""
    n_tiles, n_chunks = overlap.shape
    chunk = coef.shape[-1]
    pair = torch.nonzero(overlap != 0)
    p_tile, p_chunk = pair[:, 0], pair[:, 1]
    dev = coef.device
    local = torch.arange(n_chunks * chunk, dtype=torch.int32, device=dev).reshape(n_chunks, chunk)
    pix = tile_h * tile_w
    keys, lids = [], []
    for b0, b1 in batched_blocks(p_tile.shape[0], pix * chunk):
        c = p_chunk[b0:b1]
        qx, qy = tile_pixel_centers(p_tile[b0:b1], tile_h, tile_w, n_tx, y_offset)
        k, i = block_winners(coef[c], valid[c] > 0.0, local[c], qx, qy,
                             ortho=ortho, want_ids=want_ids)
        keys.append(k)
        lids.append(i)
    empty = torch.empty((0, pix), dtype=torch.float32, device=dev)
    blk_key = torch.cat(keys) if keys else empty
    blk_id = (torch.cat(lids) if lids else empty.to(torch.int32)) if want_ids else None
    key, lid = merge_blocks(blk_key, blk_id, p_tile, n_tiles)
    if not want_ids or ids is None:
        return key, lid
    gid = ids[lid.clamp(min=0).long()]
    return key, torch.where(lid >= 0, gid, torch.full_like(gid, -1))


def giant_raster(coef, valid, overlap, ids, tile_h, tile_w, n_tx, y_offset=0.0,
                 want_ids=True, ortho=False):
    """K2/K3 wrapper (same contract as ``giant_raster_ref``); emits int32
    global ids directly."""
    if _cuda.on_cpu("giant_raster", coef):
        return giant_raster_ref(coef, valid, overlap, ids, tile_h, tile_w, n_tx,
                                y_offset, want_ids, ortho)
    coef, valid, overlap, ids = fit_giant_chunks(coef, valid, overlap, ids)
    n_tiles, n_chunks = overlap.shape
    chunk = coef.shape[-1]
    pix = tile_h * tile_w
    if coef.dtype != torch.float32 or valid.dtype != torch.float32 or overlap.dtype != torch.int32:
        raise ValueError("giant_raster: expects f32 coef/valid and i32 overlap")
    _check_y_offset("giant_raster", y_offset)
    tensors = [coef, valid, overlap] + ([ids] if ids is not None else [])
    dev = _cuda.check_cuda("giant_raster", *tensors)
    if ids is not None and ids.dtype != torch.int32:
        raise ValueError("giant_raster: ids must be int32")
    out_key = torch.empty((n_tiles, pix), dtype=torch.float32, device=coef.device)
    out_id = (torch.empty((n_tiles, pix), dtype=torch.int32, device=coef.device)
              if want_ids else None)
    if n_tiles:
        _cuda.launch(
            "giant_raster", dev, coef.data_ptr(), valid.data_ptr(), overlap.data_ptr(),
            _cuda.ptr(ids), out_key.data_ptr(), _cuda.ptr(out_id),
            n_tiles, n_chunks, chunk, tile_h, tile_w, n_tx, float(y_offset),
            int(want_ids), int(ortho),
        )
    return out_key, out_id


def rasterize_giant(setup: RasterSetup, width: int, height: int, tile_h: int = 32,
                    tile_w: int = 128, chunk: int = 64, depth_mode: int = DEPTH_MAX,
                    y_offset: float = 0.0, want_ids: bool = True, ortho: bool = False,
                    ids: torch.Tensor | None = None):
    """Brute-force raster over a (small) table (reference
    ``rasterize_pallas``): per-(tile, chunk) overlap bits, then K2.

    want_ids: returns (depth, tri_id) images (tri_id through ``ids`` when
    given, else local rows).  Depth-only: returns (raw key image, None),
    -1 = miss, so callers merge levels before converting to depth."""
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
    coef = coef.reshape(n_chunks, chunk, COEF_COLS).transpose(1, 2).contiguous()
    valid = torch.zeros(t_pad, dtype=torch.bool, device=dev)
    valid[:t] = setup.valid
    bbox = torch.zeros((4, t_pad), dtype=torch.float32, device=dev)
    bbox[:, :t] = setup.bbox
    bbox = bbox.reshape(4, n_chunks, chunk)
    tile_ids = torch.arange(n_tiles, device=dev)
    tx0 = ((tile_ids % n_tx) * tile_w).to(torch.float32)[:, None, None]
    ty0 = ((tile_ids // n_tx) * tile_h).to(torch.float32)[:, None, None] + y_offset
    ov = (
        (bbox[0][None] <= tx0 + (tile_w - 1)) & (bbox[2][None] >= tx0)
        & (bbox[1][None] <= ty0 + (tile_h - 1)) & (bbox[3][None] >= ty0)
        & valid.reshape(n_chunks, chunk)[None]
    )
    overlap = ov.any(dim=2).to(torch.int32)
    id_map = None
    if want_ids and ids is not None:
        id_map = torch.zeros(t_pad, dtype=torch.int32, device=dev)
        id_map[:t] = ids.to(torch.int32)
    key, tid = giant_raster(coef, valid.to(torch.float32).reshape(n_chunks, chunk),
                            overlap, id_map, tile_h, tile_w, n_tx, y_offset,
                            want_ids, ortho)
    key_img = untile(key, width, height, tile_h, tile_w)
    if not want_ids:
        return key_img, None
    hit = key_img >= 0.0
    if depth_mode == DEPTH_MAX:
        depth = torch.where(hit, key_img, torch.zeros_like(key_img))
    else:
        depth = torch.where(hit, 1.0 - key_img, torch.ones_like(key_img))
    tri = untile(tid, width, height, tile_h, tile_w)
    return depth, torch.where(hit, tri, torch.full_like(tri, -1))


# ---------------------------------------------------------------------------
# Three-level binned raster
# ---------------------------------------------------------------------------


def merge_levels(key_img, id_img, key2, id2):
    """Max key; on equal (hit) keys the smaller id wins."""
    take = key2 > key_img
    tie = (key2 == key_img) & (key2 >= 0.0)
    sel = take | (tie & (id2 < id_img))
    return torch.where(take, key2, key_img), torch.where(sel, id2, id_img)


def rasterize_binned(
    setup: RasterSetup, width: int, height: int, tile_h: int = 16, tile_w: int = 64,
    chunk: int = 128, depth_mode: int = DEPTH_MAX, y_offset: float = 0.0,
    max_span: int = 2, budget_factor: float = 2.0, big_tile_h: int = 32,
    big_tile_w: int = 128, big_chunk: int = 32, mid_divisor: int = 16,
    giant_divisor: int = 128, giant_tile_h: int = 0, giant_tile_w: int = 0,
    giant_chunk: int = 0, want_ids: bool = True, ortho: bool = False,
    mat_idx: bool = False,
):
    """Binned visibility raster, three levels merged by depth key:
    fine tiles for small triangles, coarse tiles for medium ones over a
    compacted list, and the giant brute-force level for the rest.

    ``mat_idx`` copies each binning level's block index array through K9
    before its coefficient gather (the reference's ``bin_mat_idx``).

    Returns (depth, tri_id, stats) with ``pair_overflow`` (fine/mid pairs
    dropped at the bin budget) and ``giant_truncated`` (giant triangles
    past the compaction cap, not rasterized)."""
    if depth_mode != DEPTH_MAX:
        setup = flip_depth_key(setup)

    bins = bin_triangles(setup, width, height, tile_h, tile_w, chunk,
                         max_span=max_span, budget_factor=budget_factor,
                         y_offset=y_offset, mat_idx=mat_idx)
    key_img, id_img = _run_binned_kernel(bins, width, height, tile_h, tile_w,
                                         y_offset, want_ids, ortho)
    t_count = setup.coef.shape[0]

    # mid level over a compacted list; ONE full-T compaction serves both the
    # mid list (rows [0, cap_mid)) and the mid-cap overflow for the giant
    # level (rows [cap_mid, cap_mid + cap_g)), all in ascending id order
    cap_mid = min(t_count, max(big_chunk, -(-(t_count // mid_divisor) // big_chunk) * big_chunk))
    cap_g = min(t_count, max(big_chunk, -(-(t_count // giant_divisor) // big_chunk) * big_chunk))
    ext_idx, ext_valid = compact_mask(bins.big_mask, min(cap_mid + cap_g, t_count))
    mid_idx, mid_valid = ext_idx[:cap_mid], ext_valid[:cap_mid]
    mi = mid_idx.long()
    mid_setup = RasterSetup(coef=setup.coef[mi], valid=mid_valid, bbox=setup.bbox[:, mi])
    mid_bins = bin_triangles(mid_setup, width, height, big_tile_h, big_tile_w, big_chunk,
                             max_span=4, budget_factor=2.0, tri_ids=mid_idx,
                             y_offset=y_offset, mat_idx=mat_idx)
    mid_key, mid_id = _run_binned_kernel(mid_bins, width, height, big_tile_h, big_tile_w,
                                         y_offset, want_ids, ortho)
    if want_ids:
        key_img, id_img = merge_levels(key_img, id_img, mid_key, mid_id)
    else:
        key_img = torch.maximum(key_img, mid_key)

    # giant set = (mid rows flagged giant by the coarse binning) U (mid-cap
    # overflow rows); both parts are ascending and every B id exceeds every
    # A id, so the concatenation is ascending too
    a_mask = mid_bins.big_mask & mid_valid
    a_local, a_ok = compact_mask(a_mask, cap_g)
    a_ids = torch.where(a_ok, mid_idx[a_local.long()], torch.zeros_like(a_local))
    b_ids, b_ok = ext_idx[cap_mid:], ext_valid[cap_mid:]
    cat_ids = torch.cat([a_ids, b_ids])
    cat_ok = torch.cat([a_ok, b_ok])
    g_local, g_valid = compact_mask(cat_ok, cap_g)
    g_idx = torch.where(g_valid, cat_ids[g_local.long()], torch.zeros_like(g_local))
    n_big = bins.big_mask.sum()
    lost_beyond = torch.clamp(n_big - min(cap_mid + cap_g, t_count), min=0)
    lost_a = torch.clamp(a_mask.sum() - a_ok.sum(), min=0)
    giant_truncated = (cat_ok.sum() - g_valid.sum() + lost_beyond + lost_a).to(torch.int32)
    gi = g_idx.long()
    giant_setup = RasterSetup(coef=setup.coef[gi], valid=g_valid, bbox=setup.bbox[:, gi])

    gth = giant_tile_h or big_tile_h
    gtw = giant_tile_w or big_tile_w
    g_chunk = giant_chunk or big_chunk
    # the reference halves the id-emitting giant tiles to fit its VMEM scope;
    # kept so the chunk-skip granularity (and so every evaluated pair) is
    # the reference's
    while want_ids and gth * gtw > 8192 and gth > 8:
        gth //= 2
    big_out = rasterize_giant(giant_setup, width, height, tile_h=gth, tile_w=gtw,
                              chunk=g_chunk, y_offset=y_offset, want_ids=want_ids,
                              ortho=ortho, ids=g_idx)
    if want_ids:
        big_depth, big_id = big_out
        big_key = torch.where(big_id >= 0, big_depth, torch.full_like(big_depth, -1.0))
        key_img, id_img = merge_levels(key_img, id_img, big_key, big_id)
    else:
        key_img = torch.maximum(key_img, big_out[0])

    hit = key_img >= 0.0
    if depth_mode == DEPTH_MAX:
        depth = torch.where(hit, key_img, torch.zeros_like(key_img))
    else:
        depth = torch.where(hit, 1.0 - key_img, torch.ones_like(key_img))
    tri_id = torch.where(hit, id_img, torch.full_like(id_img, -1)) if want_ids else None
    stats = {
        "pair_overflow": (bins.overflow + mid_bins.overflow).to(torch.int32),
        "giant_truncated": giant_truncated,
    }
    return depth, tri_id, stats
