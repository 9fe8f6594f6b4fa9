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
* ``masked_raster`` (M1, ``csrc/masked_raster.cu``): one level of the
  alpha-masked raster -- each tile's bin block range (or, at
  ``masked_tri_cap == 0``, every chunk of the table) with the alpha test
  inside (``masked_raster_ref``, the data-dependent ``nonzero`` path, is
  its plain version).  Not a port of a TPU kernel either: the reference
  runs its masked raster as XLA under every backend.

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

import ctypes
import functools
import math

import torch

from ..core.passes import scope
from . import _cuda
from .binning import BinnedTriangles, bin_triangles
from . import texture as tex
from .fma import fma
from .raster import (
    COEF_COLS,
    DEPTH_MAX,
    INT32_MAX,
    RasterSetup,
    batched_blocks,
    block_winners,
    compact_mask,
    eval_keys,
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
        # at most one line a block slot: a static bound of the live blocks'
        # lines, so nothing is read back; checked when not capturing (a
        # frame program captures only after the same frame ran op by op)
        need = PRINTF_LINE_BYTES * n_blocks
        if n_tiles and not torch.cuda.is_current_stream_capturing():
            have = _cuda.printf_fifo(need)
            if have < need:
                raise RuntimeError(
                    f"binned_raster debug print: the device printf FIFO holds {have} bytes and "
                    f"this launch may print {need} ({n_blocks} block slots); it can grow only "
                    "before the process's first kernel launch: call "
                    f"unclerenderer_tpu_torch.ops._cuda.printf_fifo({need}) before any other "
                    "CUDA work")
        if n_tiles:
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
    belong to no tile and cost the kernel nothing.  Counted at a static
    shape, with no read back to the host: every block adds one to its
    tile's count, a dead block (or one of a tile past ``n_tiles``) to a
    spill slot ``n_tiles`` that is cut off."""
    live = (bins.blk_live == 1) & (bins.blk_tile < n_tiles)
    slot = torch.where(live, bins.blk_tile.long(), n_tiles)
    count = torch.zeros(n_tiles + 1, dtype=torch.int64, device=slot.device)
    count = count.index_add_(0, slot, torch.ones_like(slot))[:n_tiles]
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
# M1: the alpha-masked raster, one level
# ---------------------------------------------------------------------------

# (pixel, slot) pairs one group of blocks holds at once: the groups are
# sized to memory (any size gives the same result)
ALPHA_PAIR_BUDGET = 1 << 24
ALPHA_COLS = 19  # render/common.py _alpha_records


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


def _alpha_tap(quad_flat, atlas_width, rect0, uv, lod, bilinear: bool):
    """Alpha-test texture tap at the analytic LOD, honouring the material
    filter: nearest-mip bilinear under ``texture_filter="bilinear"``
    (``bilinear``), trilinear otherwise."""
    if bilinear:
        level = tex._to_int(torch.round(torch.clamp(lod, min=0.0)))
        return tex.sample_level_any(quad_flat, atlas_width, rect0, uv, level)
    return tex.sample_trilinear_any(quad_flat, atlas_width, rect0, uv, lod)


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


def _alpha_eval(coef, arec, x, y, quad_flat, atlas_width, bilinear: bool):
    """Depth key of candidate (pixel, triangle) pairs that the triangle
    covers, whose depth is in [0, 1] and whose alpha passes the cutoff, -1
    for the others.  coef (N, 16), arec (N, 19), x/y (N,) pixel ints.  The
    edge tests and depth are the opaque raster's (``eval_keys``); the
    interpolation is the reference's ``a*qx + b*qy + c`` contracted as
    ``fma(a, qx, b*qy) + c``, like them.  The alpha tap runs only for the
    pairs that are covered and in depth range (it enters only through
    ``ok &``).  Returns (key (N,), covered pairs, the covered pairs' keys
    before the alpha test (N,), -1 for the others)."""
    qx, qy = x.to(torch.float32) + 0.5, y.to(torch.float32) + 0.5
    key, ok = eval_keys(coef[:, :, None], torch.ones_like(qx, dtype=torch.bool)[:, None],
                        qx[:, None], qy[:, None])
    key, ok = key.reshape(-1), ok.reshape(-1)
    cover_key = torch.where(ok, key, torch.full_like(key, -1.0))
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
                       bilinear)
    tex_a = torch.where(ar[:, 16] > 0.5, texel[:, 3], torch.ones_like(u))
    passed = ar[:, 17] * ca * tex_a >= ar[:, 18]
    ok[idx] = passed
    return torch.where(ok, key, torch.full_like(key, -1.0)), int(idx.shape[0]), cover_key


def _alpha_level(blocks, quad_flat, atlas_width, arec, tile_h, tile_w, width, height, full_h,
                 bilinear: bool, y_offset: int = 0, needed: bool = False):
    """One masked raster level: per pixel the max key of the candidates that
    pass, and the min triangle id among those at it -- per block, then per
    tile in the reference (its segment merges); the order of such merges
    does not matter.  ``blocks`` = (coef (B, 16, C), rows (B, C) into
    arec, ids (B, C), valid (B, C) bool, tile (B,)).  The image is
    ``height`` rows from global row ``y_offset`` of a ``full_h``-row frame.
    Returns (key image, id image, pair counts): keys -1 and ids -1 where
    nothing won, a zero key +0.0 (which zero a max keeps is not fixed).
    ``needed`` adds the count ``needed``: the alpha taps that the level
    needs at the least, each pixel's covered pairs taken in descending key,
    then ascending id, up to the first that passes -- the pairs whose
    packed word (``masked_pack``) is at least the winner's."""
    coef, rows, ids, valid, tiles = blocks
    n_tx = -(-width // tile_w)
    dev = coef.device
    per_block = tile_h * tile_w * coef.shape[-1]
    pix_i = [torch.zeros(0, dtype=torch.int64, device=dev)]
    keys = [torch.zeros(0, dtype=torch.float32, device=dev)]
    kids = [torch.zeros(0, dtype=torch.int32, device=dev)]
    counts = {"blocks": int(tiles.shape[0]), "covered": 0}
    covers = []  # (pixel, covered pair's word) with ``needed``
    step = max(1, ALPHA_PAIR_BUDGET // per_block)
    for b0 in range(0, tiles.shape[0], step):
        sl = slice(b0, b0 + step)
        g, p, c, x, y = _alpha_candidates(tiles[sl], coef[sl], valid[sl], tile_h, tile_w, n_tx,
                                          width, height, y_offset, full_h)
        cr = rows[sl][g, c].long()
        key, covered, cover_key = _alpha_eval(coef[sl].transpose(1, 2)[g, c], arec[cr], x,
                                              y + y_offset, quad_flat, atlas_width, bilinear)
        if needed:
            hit = cover_key >= 0.0
            covers.append(((y * width + x)[hit],
                           masked_pack(cover_key[hit], ids[sl][g, c][hit])))
        won = key >= 0.0
        pix_i.append((y * width + x)[won])
        keys.append(key[won])
        kids.append(ids[sl][g, c][won])
        counts["covered"] += covered
    pix_i, keys, kids = torch.cat(pix_i), torch.cat(keys), torch.cat(kids)
    n = width * height
    key_img = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    key_img = key_img.scatter_reduce(0, pix_i, keys, reduce="amax", include_self=True) + 0.0
    at = keys == key_img[pix_i]
    id_img = torch.full((n,), INT32_MAX, dtype=torch.int32, device=dev)
    id_img = id_img.scatter_reduce(0, pix_i[at], kids[at].to(torch.int32), reduce="amin",
                                   include_self=True)
    id_img = torch.where(key_img >= 0.0, id_img, torch.full_like(id_img, -1))
    if needed:
        win_word = masked_pack(key_img, id_img)
        counts["needed"] = sum(int((word >= win_word[pix]).sum()) for pix, word in covers)
    return key_img.reshape(height, width), id_img.reshape(height, width), counts


def _masked_atlas(atlas):
    """M1's atlas layout: (lanes, atlas dtype code); ValueError for a layout
    the samplers do not take."""
    if atlas.dim() != 2 or atlas.dtype not in tex.ATLAS_DTYPE_CODE:
        raise ValueError("masked_raster: the atlas must be (rows, lanes) u8, f32 or bf16")
    lanes = atlas.shape[1]
    c = 16 if lanes == 256 else lanes // 4
    if lanes != 256 and (lanes % 4 or c < 4):
        raise ValueError(f"masked_raster: a quad atlas has 4C lanes, C >= 4; got {lanes}")
    if atlas.dtype == torch.uint8 and c != 16:
        raise ValueError("masked_raster: a u8 atlas holds the 16-channel combined material "
                         f"(64 or 256 lanes); got {lanes}")
    return lanes, tex.ATLAS_DTYPE_CODE[atlas.dtype]


def _masked_inputs(coef, tri_id, valid, rows, tile_start, tile_count, arec, tile_h, tile_w,
                   width, height):
    """The level's arrays as (B, C) and its tile count; ValueError for what
    M1 does not take."""
    n_blocks, chunk = coef.shape[0], coef.shape[-1]
    tri_id, valid, rows = (x.reshape(n_blocks, -1) for x in (tri_id, valid, rows))
    if (coef.dtype != torch.float32 or coef.dim() != 3 or coef.shape[1] != COEF_COLS
            or valid.dtype != torch.float32 or tri_id.dtype != torch.int32
            or rows.dtype != torch.int32
            or any(x.shape[1] != chunk for x in (tri_id, valid, rows))):
        raise ValueError("masked_raster: expects coef (B, 16, C) f32, valid (B, C) f32 and "
                         "tri_id / rows (B, C) i32")
    if arec.dtype != torch.float32 or arec.dim() != 2 or arec.shape[1] != ALPHA_COLS:
        raise ValueError("masked_raster: arec must be a (R, 19) f32 table")
    if tile_h < 1 or tile_w < 1:
        raise ValueError(f"masked_raster: tiles of {tile_h}x{tile_w}")
    n_tiles = -(-width // tile_w) * -(-height // tile_h)
    if (tile_start is None) != (tile_count is None):
        raise ValueError("masked_raster: tile_start and tile_count go together")
    if tile_start is not None and (
            tile_start.dtype != torch.int32 or tile_count.dtype != torch.int32
            or tuple(tile_start.shape) != (n_tiles,) or tuple(tile_count.shape) != (n_tiles,)):
        raise ValueError(f"masked_raster: tile_start / tile_count must be ({n_tiles},) i32")
    return tri_id, valid, rows, n_tiles


def table_chunks(setup: RasterSetup, chunk: int):
    """M1's exhaustive-form blocks: the setup's table in chunks of
    ``chunk`` rows, (coef (n_chunks, 16, chunk), ids (n_chunks, chunk) i32,
    valid (n_chunks, chunk) f32); the padding rows are invalid, and a row's
    id is its table row (also its alpha record's row)."""
    dev = setup.coef.device
    t = setup.coef.shape[0]
    n_chunks = max(1, -(-t // chunk))
    rows = torch.arange(n_chunks * chunk, dtype=torch.int32, device=dev).reshape(n_chunks, chunk)
    valid = (rows < t) & setup.valid[rows.clamp(max=t - 1)]
    coef = torch.zeros((n_chunks * chunk, COEF_COLS), dtype=torch.float32, device=dev)
    coef[:t] = setup.coef
    coef = coef.reshape(n_chunks, chunk, COEF_COLS).transpose(1, 2).contiguous()
    return coef, rows.clamp(max=t - 1), valid.to(torch.float32)


def masked_raster_ref(coef, tri_id, valid, rows, tile_start, tile_count, arec, atlas,
                      atlas_width, tile_h, tile_w, width, height, y_offset=0, full_height=None,
                      bilinear=False, stats=False):
    """Plain version of M1 (``masked_raster``'s contract): the masked raster
    of the reference's XLA frame, by a data-dependent compaction of the
    (pixel, slot) pairs that may pass their edge tests (``nonzero``).
    Binned form: tile t owns blocks [tile_start[t], tile_start[t] +
    tile_count[t]).  Exhaustive form (``tile_start`` None): every tile
    against every chunk of the table that a pixel of the tile may reach
    (``_edge_may_pass`` at the tile's corners) -- the others cannot cover
    a pixel of it.  Its counts tap every covered pair."""
    key, win, counts = _masked_ref(coef, tri_id, valid, rows, tile_start, tile_count, arec,
                                   atlas, atlas_width, tile_h, tile_w, width, height, y_offset,
                                   full_height, bilinear)
    if not stats:
        return key, win, None
    n = {k: torch.tensor(v, dtype=torch.int64, device=coef.device) for k, v in counts.items()}
    return key, win, {"blocks": n["blocks"], "covered": n["covered"], "tapped": n["covered"]}


def masked_needed_taps(coef, tri_id, valid, rows, tile_start, tile_count, arec, atlas,
                       atlas_width, tile_h, tile_w, width, height, y_offset=0, full_height=None,
                       bilinear=False) -> dict:
    """The counts of M1's level that its data fixes, from the plain version
    and not from the kernel (ints): ``blocks`` (the live blocks),
    ``covered`` (the pairs that pass the edge and depth tests) and
    ``needed``, the alpha taps of each pixel's covered pairs in descending
    key, then ascending id, up to and including the first that passes (all
    of them where none passes): the least any exact form can tap."""
    return _masked_ref(coef, tri_id, valid, rows, tile_start, tile_count, arec, atlas,
                       atlas_width, tile_h, tile_w, width, height, y_offset, full_height,
                       bilinear, needed=True)[2]


def _masked_ref(coef, tri_id, valid, rows, tile_start, tile_count, arec, atlas, atlas_width,
                tile_h, tile_w, width, height, y_offset, full_height, bilinear, needed=False):
    """``masked_raster_ref``'s level: (key image, id image, ``_alpha_level``'s
    counts)."""
    full_h = height if full_height is None else full_height
    ids, valid, rows, n_tiles = _masked_inputs(coef, tri_id, valid, rows, tile_start,
                                               tile_count, arec, tile_h, tile_w, width, height)
    _masked_atlas(atlas)
    dev = coef.device
    valid = valid > 0.0
    n_tx = -(-width // tile_w)
    if tile_start is None:
        tile = torch.arange(n_tiles, device=dev)
        tx0 = ((tile % n_tx) * tile_w).to(torch.float32)[:, None]
        ty0 = ((tile // n_tx) * tile_h + y_offset).to(torch.float32)[:, None]
        xs, ys = (tx0 + 0.5, tx0 + (tile_w - 0.5)), (ty0 + 0.5, ty0 + (tile_h - 0.5))
        live = [(_edge_may_pass(coef[c], xs, ys, width, full_h) & valid[c]).any(dim=1)
                for c in range(coef.shape[0])]
        live = (torch.stack(live, dim=1) if live else
                torch.zeros((n_tiles, 0), dtype=torch.bool, device=dev))
        b_tile, blk = live.nonzero(as_tuple=True)
    else:
        counts = tile_count.long()
        b_tile = torch.repeat_interleave(torch.arange(n_tiles, device=dev), counts)
        first = torch.repeat_interleave(tile_start.long() - torch.cumsum(counts, 0) + counts,
                                        counts)
        blk = first + torch.arange(b_tile.shape[0], device=dev)
    blocks = (coef[blk], rows[blk], ids[blk], valid[blk], b_tile)
    return _alpha_level(blocks, atlas, atlas_width, arec, tile_h, tile_w, width, height, full_h,
                        bilinear, y_offset, needed)


MASKED_SPLIT = 1  # csrc/masked_raster.cu kSplit: a tile with more blocks is split
MASKED_LIST = 8  # csrc/masked_raster.cu kList: a pixel's candidate list


def masked_pack(key: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """M1's packed winner words (plain version), int64: ``(bits(key) + 1)
    << 32 | (0x7fffffff - id)`` for keys in [0, 1] (-0 taken as +0), 0 where
    ``key`` < 0 (nothing won).  A larger word is a larger key, then a smaller
    id, for every int32 id, so the max word over any set of pairs is their
    winner: the merge of the split tiles (a 64-bit ``atomicMax``)."""
    bits = torch.where(key == 0.0, torch.zeros_like(key), key).view(torch.int32).long()
    word = ((bits + 1) << 32) | ((0x7FFFFFFF - ids.long()) & 0xFFFFFFFF)
    return torch.where(key >= 0.0, word, torch.zeros_like(word))


def masked_unpack(word: torch.Tensor):
    """``masked_pack``'s inverse with M1's output conventions: (key f32, id
    i32), -1 and -1 where the word is 0, +0.0 for a zero key."""
    hit = word != 0
    bits = ((word >> 32) - 1).to(torch.int32)
    key = torch.where(hit, bits.view(torch.float32), torch.full_like(bits.view(torch.float32), -1))
    ids = (0x7FFFFFFF - (word & 0xFFFFFFFF)).to(torch.int32)
    return key, torch.where(hit, ids, torch.full_like(ids, -1))


def masked_split(tile_start: torch.Tensor, tile_count: torch.Tensor, n_blocks: int,
                 split: int = MASKED_SPLIT):
    """M1's work items in the binned form (plain version of
    ``masked_plan_kernel``): a tile with more than ``split`` blocks becomes
    ceil(count / split) items of at most ``split`` blocks, a tile of 0
    blocks none (its -1s are written after the items), any other tile one
    item; split 0 splits nothing.  Items that would overflow M1's table
    (n_tiles + n_blocks entries: only ranges that overlap) give every tile
    one item.  Returns (tile, first block, blocks) of each item, in tile
    order, as int64 tensors."""
    count = tile_count.long()
    n_tiles = count.shape[0]
    one = (count > 0).long()
    parts = (torch.where(count > split, -(-count // max(split, 1)), one) if split > 0 else one)
    if int(parts.sum()) > n_tiles + n_blocks:
        parts = torch.ones_like(count)
    tile = torch.repeat_interleave(torch.arange(n_tiles, device=count.device), parts)
    part = torch.arange(tile.shape[0], device=count.device) - torch.repeat_interleave(
        torch.cumsum(parts, 0) - parts, parts)
    whole = parts[tile] == 1
    j0 = torch.where(whole, torch.zeros_like(part), part * split)
    nb = torch.where(whole, count[tile], torch.minimum(count[tile] - j0,
                                                        torch.full_like(j0, split)))
    return tile, tile_start.long()[tile] + j0, nb


@functools.lru_cache(maxsize=None)
def _masked_scratch_entry():
    fn = _cuda.library().masked_raster_scratch
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_longlong
    return fn


def masked_scratch_bytes(binned: bool, n_blocks: int, n_tiles: int, width: int,
                         height: int) -> int:
    """Bytes of M1's scratch, as its C entry lays it out
    (``csrc/masked_raster.cu masked_raster_scratch``): binned form, a
    packed word a pixel, the item table and each tile's counts; both
    forms, the item counters.  Loads the kernels' library."""
    return int(_masked_scratch_entry()(int(binned), n_blocks, n_tiles, width, height))


def masked_raster(coef, tri_id, valid, rows, tile_start, tile_count, arec, atlas, atlas_width,
                  tile_h, tile_w, width, height, y_offset=0, full_height=None, bilinear=False,
                  stats=False):
    """M1 wrapper (``csrc/masked_raster.cu``): one level of the alpha-masked
    raster, by its plain version ``masked_raster_ref`` for CPU tensors and
    by the ``masked_raster`` kernel for CUDA tensors.

    coef (B, 16, C) f32, tri_id (B, C) or (B, 1, C) i32 (the ids the ties
    compare), valid likewise f32 (> 0 valid), rows (B, C) i32: each slot's
    row of arec (R, 19) f32 (render/common.py ``_alpha_records``).  Binned
    form: tile_start / tile_count (n_tiles,) i32, each tile's contiguous
    block range (``tile_block_ranges``); exhaustive form: both None, every
    tile against every block (the chunks of the table).  atlas (rows,
    lanes): the quad atlas (4C lanes, f32 or bf16, or u8 at C = 16) or the
    256-lane packed-trilinear one, ``atlas_width`` texels a row of its
    image; ``bilinear``: the nearest-mip bilinear tap of
    ``texture_filter="bilinear"``, else trilinear.  The image is ``height``
    rows from global row ``y_offset`` (an int) of a ``full_height``-row
    frame (default ``height``), in tiles of ``tile_h`` x ``tile_w``.

    Returns (key (height, width) f32, id (height, width) i32, counts):
    keys -1 and ids -1 where nothing won; per pixel the max key of the
    pairs that pass (edge and depth tests, valid slot, alpha test), then
    the min id among those at it.  ``stats``: counts {"blocks" (live),
    "covered" (pairs passing the edge and depth tests), "tapped" (alpha
    tests run)}, 0-d int64 device tensors; else None."""
    if _cuda.on_cpu("masked_raster", coef):
        return masked_raster_ref(coef, tri_id, valid, rows, tile_start, tile_count, arec, atlas,
                                 atlas_width, tile_h, tile_w, width, height, y_offset,
                                 full_height, bilinear, stats)
    tri_id, valid, rows, n_tiles = _masked_inputs(coef, tri_id, valid, rows, tile_start,
                                                  tile_count, arec, tile_h, tile_w, width, height)
    lanes, dtype = _masked_atlas(atlas)
    if int(y_offset) != y_offset:
        raise ValueError(f"masked_raster: y_offset must be a whole row, got {y_offset}")
    tiles = [] if tile_start is None else [tile_start, tile_count]
    dev = _cuda.check_cuda("masked_raster", coef, tri_id, valid, rows, arec, atlas, *tiles)
    out_key = torch.empty((height, width), dtype=torch.float32, device=coef.device)
    out_id = torch.empty((height, width), dtype=torch.int32, device=coef.device)
    counts = torch.zeros(3, dtype=torch.int64, device=coef.device) if stats else None
    if n_tiles:
        # the kernel's work items and the split tiles' packed words, laid out
        # by its first kernel: no contents needed
        scratch = torch.empty(masked_scratch_bytes(tile_start is not None, coef.shape[0],
                                                   n_tiles, width, height) // 8,
                              dtype=torch.int64, device=coef.device)
        _cuda.launch("masked_raster", dev, coef.data_ptr(), tri_id.data_ptr(), valid.data_ptr(),
                     rows.data_ptr(), _cuda.ptr(tile_start), _cuda.ptr(tile_count),
                     arec.data_ptr(), atlas.data_ptr(), out_key.data_ptr(), out_id.data_ptr(),
                     _cuda.ptr(counts), scratch.data_ptr(), coef.shape[0], coef.shape[-1],
                     tile_h, tile_w, width, height, int(y_offset),
                     height if full_height is None else full_height, atlas_width, lanes, dtype,
                     int(bilinear))
    if counts is None:
        return out_key, out_id, None
    return out_key, out_id, {"blocks": counts[0], "covered": counts[1], "tapped": counts[2]}


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
