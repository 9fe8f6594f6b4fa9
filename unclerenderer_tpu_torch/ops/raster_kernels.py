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
* ``rasterize_exhaustive`` (X1, ``csrc/exhaustive_raster.cu``): every tile
  against every triangle whose box overlaps it, the raster of
  ``raster_backend="xla"`` (``ops/raster.py rasterize`` is its plain
  version); the kernel finds each tile's rows as its band's row mask AND
  its column's (``band_masks_plain``, ``column_masks_plain``).  Not a port
  of a TPU kernel: the reference runs it as XLA.

Debug print (``debug=True``, the reference's ``debug_print`` under
``RenderSettings.kernel_debug_print``): K1 prints one line
``binned raster: block <b> -> tile <t>`` per live bin block of the fine
level (the reference passes the flag to no other level), through its
``binned_raster_debug`` C entry (device ``printf``; counted under that
name), and its plain version prints the same lines from the host.

Fused resolve (``records=``, the reference's ``want_attrs``): K1 and K2 also
emit each pixel's winning row's record from a (T, R) f32 table indexed by
the rows' ids -- a (tiles, pix, R) image, zeros where no row won, equal to
``records_ref`` -- through their ``*_attrs`` C entries, counted as
``binned_raster_attrs`` / ``giant_raster_attrs``.

Each kernel wrapper runs its plain version (``*_ref``; X1: ``rasterize``)
for CPU tensors and launches the kernel for CUDA tensors; there is no
fallback between the two.
"""

from __future__ import annotations

import math

import torch

from ..core.passes import scope
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
    rasterize,
    tile_pixel_centers,
    untile,
)

BINNED_MAX_CHUNK = 128  # K1 stages a block with cp.async: chunk % 4 == 0
GIANT_MAX_CHUNK = 256  # one K2 window of staged rows holds a chunk
# device printf FIFO bytes a debug line may take (its record: a header, the
# format's address and two int arguments, with room to spare)
PRINTF_LINE_BYTES = 128


def _check_y_offset(name, y_offset):
    # the kernels' warp skip needs finite pixel centres (source notes)
    if not math.isfinite(y_offset):
        raise ValueError(f"{name}: y_offset must be finite, got {y_offset}")


def records_ref(records: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernels' record emission: row ``ids`` of the
    (T, R) table, zeros where ``ids < 0`` -- what the reference's one-hot f32
    dot selects (one nonzero term a column, so exact)."""
    rows = records[ids.clamp(min=0).long()]
    return torch.where((ids >= 0)[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                device=rows.device))


def _check_records(name, records, want_ids):
    if records is None:
        return
    if not want_ids:
        raise ValueError(f"{name}: records requires want_ids=True")
    if records.dtype != torch.float32 or records.dim() != 2 or records.shape[1] < 1:
        raise ValueError(f"{name}: records must be a (T, R) float32 table")


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


def debug_lines(tile_start, tile_count) -> list:
    """K1's debug lines, one per live bin block: block b of tile t, in tile
    order (the kernel prints them in no order)."""
    lines = []
    for t, (s, c) in enumerate(zip(tile_start.tolist(), tile_count.tolist())):
        lines += [f"binned raster: block {b} -> tile {t}" for b in range(s, s + c)]
    return lines


def binned_raster_ref(coef, tri_id, valid, tile_start, tile_count, tile_h, tile_w,
                      n_tx, y_offset=0.0, want_ids=True, ortho=False, records=None,
                      debug=False):
    """Plain version of K1.  coef (n_blocks, 16, chunk), tri_id/valid
    (n_blocks, 1, chunk), tile_start/tile_count (n_tiles,) i32: tile t owns
    blocks [tile_start[t], tile_start[t] + tile_count[t]).  Returns raw
    keys (n_tiles, pix) f32 (-1 = miss) and ids (n_tiles, pix) i32; with
    ``records`` ((T, R) f32, row = id) also the winners' records (n_tiles,
    pix, R), zeros where no row won.  ``debug`` prints ``debug_lines``."""
    _check_records("binned_raster", records, want_ids)
    if debug:
        lines = debug_lines(tile_start, tile_count)
        if lines:
            print("\n".join(lines), flush=True)
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
    key, win = merge_blocks(blk_key, blk_id, blk_tile, n_tiles)
    if records is None:
        return key, win
    return key, win, records_ref(records, win)


def binned_raster(coef, tri_id, valid, tile_start, tile_count, tile_h, tile_w,
                  n_tx, y_offset=0.0, want_ids=True, ortho=False, records=None, debug=False):
    """K1 wrapper (same contract as ``binned_raster_ref``); with
    ``records`` it launches the ``binned_raster_attrs`` entry, whose keys
    and ids are those of the launch without; with ``debug`` the
    ``binned_raster_debug`` entry, the same kernel printing each live
    block's line on the device."""
    _check_records("binned_raster", records, want_ids)
    entry = ("binned_raster_debug" if debug else
             "binned_raster" if records is None else "binned_raster_attrs")
    if _cuda.on_cpu(entry, coef):
        return binned_raster_ref(coef, tri_id, valid, tile_start, tile_count,
                                 tile_h, tile_w, n_tx, y_offset, want_ids, ortho, records, debug)
    n_blocks = coef.shape[0]
    coef, tri_id, valid, tile_start, tile_count = fit_binned_blocks(
        coef, tri_id, valid, tile_start, tile_count)
    recut = coef.shape[0] // n_blocks if n_blocks else 1
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
    out_attr = None
    if records is not None:
        _cuda.check_cuda("binned_raster", coef, records)
        out_attr = torch.empty((n_tiles, pix, records.shape[1]), dtype=torch.float32,
                               device=coef.device)
    if debug:
        if n_tiles:
            need = PRINTF_LINE_BYTES * int(tile_count.sum()) // recut
            have = _cuda.printf_fifo(need)
            if have < need:
                raise RuntimeError(
                    f"binned_raster debug print: the device printf FIFO holds {have} bytes and "
                    f"this launch prints up to {need}; it can grow only before the process's "
                    "first kernel launch: call unclerenderer_tpu_torch.ops._cuda.printf_fifo("
                    f"{need}) before any other CUDA work")
            _cuda.launch(
                "binned_raster_debug", dev, coef.data_ptr(), tri_id.data_ptr(), valid.data_ptr(),
                tile_start.data_ptr(), tile_count.data_ptr(), _cuda.ptr(records),
                out_key.data_ptr(), _cuda.ptr(out_id), _cuda.ptr(out_attr), n_tiles, chunk,
                tile_h, tile_w, n_tx, float(y_offset),
                0 if records is None else records.shape[1], int(want_ids), int(ortho), recut)
        return (out_key, out_id) if records is None else (out_key, out_id, out_attr)
    if records is not None:
        if n_tiles:
            _cuda.launch(
                "binned_raster_attrs", dev, coef.data_ptr(), tri_id.data_ptr(),
                valid.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
                records.data_ptr(), out_key.data_ptr(), out_id.data_ptr(), out_attr.data_ptr(),
                n_tiles, chunk, tile_h, tile_w, n_tx, float(y_offset), records.shape[1],
                int(ortho),
            )
        return out_key, out_id, out_attr
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
                       y_offset=0.0, want_ids=True, ortho=False, records=None, debug=False):
    """One binned level -> (key_img, id_img) cropped to (height, width),
    key = -1 where empty; with ``records`` also the (height, width, R)
    record image.  An unused tile has no live block, so K1 leaves its
    records zero as the reference's mask does.  ``debug``: K1 prints its
    live blocks."""
    n_tx = -(-width // tile_w)
    n_tiles = n_tx * (-(-height // tile_h))
    start, count = tile_block_ranges(bins, n_tiles)
    # records and debug by keyword, and only when given: a call without is
    # the K1 call as it always was (callers that record calls read its
    # positions)
    rec_kw = {} if records is None else {"records": records}
    if debug:
        rec_kw["debug"] = True
    out = binned_raster(bins.coef, bins.tri_id, bins.valid, start, count,
                        tile_h, tile_w, n_tx, y_offset, want_ids, ortho, **rec_kw)
    key, ids = out[0], out[1]
    used = bins.tile_used[:, None]
    key = torch.where(used, key, torch.full_like(key, -1.0))
    key_img = untile(key, width, height, tile_h, tile_w)
    if not want_ids:
        return key_img, None
    ids = torch.where(used, ids, torch.full_like(ids, -1))
    id_img = untile(ids, width, height, tile_h, tile_w)
    if records is None:
        return key_img, id_img
    return key_img, id_img, untile(out[2], width, height, tile_h, tile_w)


# ---------------------------------------------------------------------------
# K2/K3: giant level -> tile key/id
# ---------------------------------------------------------------------------


def giant_raster_ref(coef, valid, overlap, ids, tile_h, tile_w, n_tx, y_offset=0.0,
                     want_ids=True, ortho=False, records=None):
    """Plain version of K2/K3.  coef (n_chunks, 16, chunk), valid
    (n_chunks, chunk) f32, overlap (n_tiles, n_chunks) i32 work bits, ids
    (n_chunks*chunk,) i32 local -> global id map (None = local ids).
    Only (tile, chunk) pairs with their bit set are evaluated, and every
    row of such a chunk is -- the reference kernels' skip granularity.
    Returns raw keys (n_tiles, pix) and global ids (n_tiles, pix); with
    ``records`` ((T, R) f32, row = global id) also the winners' records
    (n_tiles, pix, R), zeros where no row won."""
    _check_records("giant_raster", records, want_ids)
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
    key, win = merge_blocks(blk_key, blk_id, p_tile, n_tiles)
    if want_ids and ids is not None:
        gid = ids[win.clamp(min=0).long()]
        win = torch.where(win >= 0, gid, torch.full_like(gid, -1))
    if records is None:
        return key, win
    return key, win, records_ref(records, win)


def giant_raster(coef, valid, overlap, ids, tile_h, tile_w, n_tx, y_offset=0.0,
                 want_ids=True, ortho=False, records=None):
    """K2/K3 wrapper (same contract as ``giant_raster_ref``); emits int32
    global ids directly, and with ``records`` launches the
    ``giant_raster_attrs`` entry."""
    _check_records("giant_raster", records, want_ids)
    if _cuda.on_cpu("giant_raster" if records is None else "giant_raster_attrs", coef):
        return giant_raster_ref(coef, valid, overlap, ids, tile_h, tile_w, n_tx,
                                y_offset, want_ids, ortho, records)
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
    if records is not None:
        _cuda.check_cuda("giant_raster", coef, records)
        out_attr = torch.empty((n_tiles, pix, records.shape[1]), dtype=torch.float32,
                               device=coef.device)
        if n_tiles:
            _cuda.launch(
                "giant_raster_attrs", dev, coef.data_ptr(), valid.data_ptr(),
                overlap.data_ptr(), _cuda.ptr(ids), records.data_ptr(), out_key.data_ptr(),
                out_id.data_ptr(), out_attr.data_ptr(), n_tiles, n_chunks, chunk, tile_h,
                tile_w, n_tx, float(y_offset), records.shape[1], int(ortho),
            )
        return out_key, out_id, out_attr
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
                    ids: torch.Tensor | None = None, records: torch.Tensor | None = None):
    """Brute-force raster over a (small) table (reference
    ``rasterize_pallas``): per-(tile, chunk) overlap bits, then K2.

    want_ids: returns (depth, tri_id) images (tri_id through ``ids`` when
    given, else local rows), and with ``records`` (rows indexed by those
    ids) the (height, width, R) image of the winners' records.  Depth-only:
    returns (raw key image, None), -1 = miss, so callers merge levels
    before converting to depth."""
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
    rec_kw = {} if records is None else {"records": records}  # as in _run_binned_kernel
    out = giant_raster(coef, valid.to(torch.float32).reshape(n_chunks, chunk),
                       overlap, id_map, tile_h, tile_w, n_tx, y_offset,
                       want_ids, ortho, **rec_kw)
    key_img = untile(out[0], width, height, tile_h, tile_w)
    if not want_ids:
        return key_img, None
    hit = key_img >= 0.0
    if depth_mode == DEPTH_MAX:
        depth = torch.where(hit, key_img, torch.zeros_like(key_img))
    else:
        depth = torch.where(hit, 1.0 - key_img, torch.ones_like(key_img))
    tri = untile(out[1], width, height, tile_h, tile_w)
    tri = torch.where(hit, tri, torch.full_like(tri, -1))
    if records is None:
        return depth, tri
    return depth, tri, untile(out[2], width, height, tile_h, tile_w)


# ---------------------------------------------------------------------------
# X1: exhaustive raster (raster_backend="xla")
# ---------------------------------------------------------------------------


X1_PASS = 256  # csrc/exhaustive_raster.cu kScan: rows a pass; a mask line holds whole passes


def _mask_words(bits: torch.Tensor) -> torch.Tensor:
    """(lines, T) bool -> (lines, ceil(T / 256) * 8) int32 words: bit b of
    word w is row 32 w + b, zeros past the table (X1's mask layout)."""
    n, t = bits.shape
    n_words = -(-t // X1_PASS) * (X1_PASS // 32)
    padded = torch.zeros((n, n_words * 32), dtype=torch.int64, device=bits.device)
    padded[:, :t] = bits
    words = (padded.reshape(n, n_words, 32) << torch.arange(32, device=bits.device)).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def mask_bits(words: torch.Tensor, t: int) -> torch.Tensor:
    """X1 mask words -> (lines, t) bool, bit b of word w as row 32 w + b."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :t].bool()


def band_masks_plain(setup: RasterSetup, height: int, tile_h: int,
                     y_offset: float = 0.0) -> torch.Tensor:
    """Plain version of X1's band masks: bit r of band b (a row of tiles,
    ``tile_h`` image rows from global row ``y_offset + b * tile_h``) is set
    where row r is valid and its box passes the y half of the box test of
    ``ops/raster.py rasterize``, whose tile edges (``ty0``, ``ty0 + tile_h -
    1``) every tile of the band shares.  (bands, ceil(T / 256) * 8) int32."""
    n_bands = -(-height // tile_h)
    y0 = (torch.arange(n_bands, device=setup.bbox.device) * tile_h).to(torch.float32) + y_offset
    y1 = y0 + (tile_h - 1)
    bits = (setup.valid[None] & (setup.bbox[1][None] <= y1[:, None])
            & (setup.bbox[3][None] >= y0[:, None]))
    return _mask_words(bits)


def column_masks_plain(setup: RasterSetup, width: int, tile_w: int) -> torch.Tensor:
    """Plain version of X1's column masks: bit r of column c is set where
    row r's box passes the x half of the box test (tile edges ``tx0 = c *
    tile_w``, ``tx0 + tile_w - 1``).  (columns, ceil(T / 256) * 8) int32."""
    n_tx = -(-width // tile_w)
    x0 = (torch.arange(n_tx, device=setup.bbox.device) * tile_w).to(torch.float32)
    x1 = x0 + (tile_w - 1)
    bits = (setup.bbox[0][None] <= x1[:, None]) & (setup.bbox[2][None] >= x0[:, None])
    return _mask_words(bits)


def rasterize_exhaustive(setup: RasterSetup, width: int, height: int, tile_h: int = 32,
                         tile_w: int = 64, chunk: int = 128, depth_mode: int = DEPTH_MAX,
                         y_offset: float = 0.0, want_ids: bool = True, ortho: bool = False,
                         want_masks: bool = False):
    """X1 wrapper: the exhaustive raster of ``ops/raster.py rasterize`` (same
    contract: (depth (height, width), tri_id or None), rows from global
    row ``y_offset``), by the plain version for CPU tensors and by the
    ``exhaustive_raster`` kernel for CUDA tensors.  ``chunk`` only sizes
    the plain version's blocks; the result does not depend on it.

    ``want_masks`` also returns the row masks the tiles walked: the band
    masks then the column masks, (bands + columns, ceil(T / 256) * 8)
    int32 (the kernel's scratch; ``band_masks_plain`` and
    ``column_masks_plain`` on the CPU)."""
    if _cuda.on_cpu("exhaustive_raster", setup.coef):
        out = rasterize(setup, width, height, tile_h=tile_h, tile_w=tile_w, chunk=chunk,
                        depth_mode=depth_mode, y_offset=y_offset, want_ids=want_ids, ortho=ortho)
        if not want_masks:
            return out
        return out + (torch.cat([band_masks_plain(setup, height, tile_h, y_offset),
                                 column_masks_plain(setup, width, tile_w)]),)
    coef, bbox, valid = setup.coef, setup.bbox, setup.valid
    t_count = coef.shape[0]
    if (coef.dtype != torch.float32 or bbox.dtype != torch.float32 or valid.dtype != torch.bool
            or tuple(coef.shape) != (t_count, COEF_COLS) or tuple(bbox.shape) != (4, t_count)
            or tuple(valid.shape) != (t_count,)):
        raise ValueError("rasterize_exhaustive: expects coef (T, 16) f32, bbox (4, T) f32 and "
                         "valid (T,) bool")
    _check_y_offset("rasterize_exhaustive", y_offset)
    coef, bbox, valid = (x if x.is_contiguous() else x.contiguous() for x in (coef, bbox, valid))
    dev = _cuda.check_cuda("rasterize_exhaustive", coef, bbox, valid)
    if coef.data_ptr() % 16:  # a row is read as four 16-byte loads
        raise ValueError("rasterize_exhaustive: coef must be 16-byte aligned")
    depth = torch.empty((height, width), dtype=torch.float32, device=coef.device)
    tri_id = (torch.empty((height, width), dtype=torch.int32, device=coef.device)
              if want_ids else None)
    lines = -(-height // tile_h) + -(-width // tile_w) if height and width else 0
    masks = torch.empty((lines, -(-t_count // X1_PASS) * (X1_PASS // 32)), dtype=torch.int32,
                        device=coef.device)
    if height and width:
        _cuda.launch("exhaustive_raster", dev, coef.data_ptr(), bbox.data_ptr(),
                     valid.data_ptr(), masks.data_ptr(), depth.data_ptr(), _cuda.ptr(tri_id),
                     t_count, width, height, tile_h, tile_w, float(y_offset), int(want_ids),
                     int(ortho), int(depth_mode == DEPTH_MAX))
    return (depth, tri_id, masks) if want_masks else (depth, tri_id)


# ---------------------------------------------------------------------------
# Three-level binned raster
# ---------------------------------------------------------------------------


def merge_levels(key_img, id_img, key2, id2, attr=None, attr2=None):
    """Max key; on equal (hit) keys the smaller id wins.  With the two
    levels' record images ``attr``/``attr2``, the records follow the ids:
    ``attr`` takes ``attr2`` in place where the second level wins, and is
    returned third."""
    take = key2 > key_img
    tie = (key2 == key_img) & (key2 >= 0.0)
    sel = take | (tie & (id2 < id_img))
    merged = torch.where(take, key2, key_img), torch.where(sel, id2, id_img)
    if attr is None:
        return merged
    # in place: the frame holds one (H, W, R) image, not one per merge
    return merged + (torch.where(sel[..., None], attr2, attr, out=attr),)


BIG_TILE_H = 32  # the mid level's tile height unless the caller sets one


def rasterize_binned(
    setup: RasterSetup, width: int, height: int, tile_h: int = 16, tile_w: int = 64,
    chunk: int = 128, depth_mode: int = DEPTH_MAX, y_offset: float = 0.0,
    max_span: int = 2, budget_factor: float = 2.0, big_tile_h: int = BIG_TILE_H,
    big_tile_w: int = 128, big_chunk: int = 32, mid_divisor: int = 16,
    giant_divisor: int = 128, giant_tile_h: int = 0, giant_tile_w: int = 0,
    giant_chunk: int = 0, want_ids: bool = True, ortho: bool = False,
    mat_idx: bool = False, records: torch.Tensor | None = None, debug_print: bool = False,
    full_height: int | None = None,
):
    """Binned visibility raster, three levels merged by depth key:
    fine tiles for small triangles, coarse tiles for medium ones over a
    compacted list, and the giant brute-force level for the rest.

    ``mat_idx`` copies each binning level's block index array through K9
    before its coefficient gather (the reference's ``bin_mat_idx``);
    ``debug_print`` makes the fine level's K1 print its live blocks (the
    reference's ``kernel_debug_print``, which its mid level does not pass
    on).

    Returns (depth, tri_id, stats) with ``pair_overflow`` (fine/mid pairs
    dropped at the bin budget) and ``giant_truncated`` (giant triangles
    past the compaction cap, not rasterized).  With ``records`` ((T, R) f32,
    row = the setup's triangle row; fused resolve) each level's kernel also
    emits its winners' records, merged with the ids, and the record image
    (height, width, R) is returned fourth: ``records_ref(records,
    tri_id)``.  Every level reads the one table through its rows' ids (the
    reference gathers ``records[mid_idx]`` and ``records[g_idx]`` first).

    The image is ``height`` rows from global row ``y_offset``; with
    ``full_height`` it is a region of a ``full_height``-row image whose
    tiles at every level are that image's (``y_offset`` a multiple of each
    level's tile height), and each triangle goes to the level it goes to in
    the whole image (``binning._pair_keys``): the region's pixels are then
    the whole image's, bit for bit."""
    _check_records("rasterize_binned", records, want_ids)
    if depth_mode != DEPTH_MAX:
        setup = flip_depth_key(setup)

    with scope("FineBinning"):
        bins = bin_triangles(setup, width, height, tile_h, tile_w, chunk,
                             max_span=max_span, budget_factor=budget_factor,
                             y_offset=y_offset, mat_idx=mat_idx, full_height=full_height)
    with scope("RasterKernel"):
        fine = _run_binned_kernel(bins, width, height, tile_h, tile_w, y_offset, want_ids, ortho,
                                  records, debug_print)
    key_img, id_img = fine[0], fine[1]
    attr = fine[2] if records is not None else None
    t_count = setup.coef.shape[0]

    with scope("MidLevel"):
        # mid level over a compacted list; ONE full-T compaction serves both
        # the mid list (rows [0, cap_mid)) and the mid-cap overflow for the
        # giant level (rows [cap_mid, cap_mid + cap_g)), in ascending id order
        cap_mid = min(t_count,
                      max(big_chunk, -(-(t_count // mid_divisor) // big_chunk) * big_chunk))
        cap_g = min(t_count,
                    max(big_chunk, -(-(t_count // giant_divisor) // big_chunk) * big_chunk))
        ext_idx, ext_valid = compact_mask(bins.big_mask, min(cap_mid + cap_g, t_count))
        mid_idx, mid_valid = ext_idx[:cap_mid], ext_valid[:cap_mid]
        mi = mid_idx.long()
        mid_setup = RasterSetup(coef=setup.coef[mi], valid=mid_valid, bbox=setup.bbox[:, mi])
        mid_bins = bin_triangles(mid_setup, width, height, big_tile_h, big_tile_w, big_chunk,
                                 max_span=4, budget_factor=2.0, tri_ids=mid_idx,
                                 y_offset=y_offset, mat_idx=mat_idx, full_height=full_height)
        mid = _run_binned_kernel(mid_bins, width, height, big_tile_h, big_tile_w, y_offset,
                                 want_ids, ortho, records)
        mid_key, mid_id = mid[0], mid[1]
        if records is not None:
            key_img, id_img, attr = merge_levels(key_img, id_img, mid_key, mid_id, attr, mid[2])
            del mid
        elif want_ids:
            key_img, id_img = merge_levels(key_img, id_img, mid_key, mid_id)
        else:
            key_img = torch.maximum(key_img, mid_key)

    with scope("GiantLevel"):
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
        # the reference halves the id-emitting giant tiles to fit its VMEM
        # scope; kept so the chunk-skip granularity (and so every evaluated
        # pair) is the reference's
        while want_ids and gth * gtw > 8192 and gth > 8:
            gth //= 2
        big_out = rasterize_giant(giant_setup, width, height, tile_h=gth, tile_w=gtw,
                                  chunk=g_chunk, y_offset=y_offset, want_ids=want_ids,
                                  ortho=ortho, ids=g_idx, records=records)
    with scope("LevelMerge"):
        if want_ids:
            big_depth, big_id = big_out[0], big_out[1]
            big_key = torch.where(big_id >= 0, big_depth, torch.full_like(big_depth, -1.0))
            merged = merge_levels(key_img, id_img, big_key, big_id, attr,
                                  big_out[2] if records is not None else None)
            key_img, id_img = merged[0], merged[1]
            del big_out
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
    if records is not None:
        return depth, tri_id, stats, attr
    return depth, tri_id, stats
