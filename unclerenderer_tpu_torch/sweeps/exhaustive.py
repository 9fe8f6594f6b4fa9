"""X1, the exhaustive raster of ``raster_backend="xla"``
(``csrc/exhaustive_raster.cu``), at the inputs one 1920x1080 xla frame of
the headline geometry (263,184 triangles, 4096^2 shadow map) gives it: the
map's and the camera's compacted tables (163,840 rows each).

For each of the two calls it prints what the inputs hold -- rows, valid
rows, the (tile, row) pairs past the box test, the most rows one tile has
and the most records one warp evaluates after the warp skip (the longest
chain of a tile) -- and the device time of every variant, each first held
bit-equal to the plain version (``ops/raster.py rasterize``):

* ``shipped``  -- the kernel wrapper of ``ops/raster_kernels.py``: band and
  column row masks, then each tile's rows in rounds of 256;
* ``previous`` -- the kernel before the redesign (source below): every tile
  walks the whole table, 256 rows a pass, testing every row's box;
* ``P pixels a thread at every tile`` -- one warp layout for both calls, a
  warp 8 x 4P pixels (shipped: 2 pixels, 8 x 8, on tiles of at most 1,024
  pixels, the camera's; else 4, 8 x 16, the map's; 8, 8 x 32, is K2's and
  the previous kernel's);
* ``8 / 32 warps a block at most`` -- a 32 x 128 map tile's 32 warps in
  four blocks or one (shipped: 16 warps, two blocks);
* ``band words first`` -- a pass's column words loaded only where its band
  words hold a row;
* ``reversed tile order`` -- the grid's blocks take the tiles from the last;
* ``(diagnostic) no evaluation`` -- masks, prefix and staging with no row
  evaluated: what the rest costs (not a result);
* ``(diagnostic) no rows`` -- the masks and each tile's empty image, no
  pass counted: the fixed cost of a tile (not a result).

The variants are the shipped source with a line or two replaced
(``VARIANTS``), built through ``_cuda.build_source``.  Device time per call
(both launches): CUDA graphs of 10 calls, median of three rounds taken in
turns.  ``--ptxas`` first prints what ``nvcc -Xptxas -v`` says of the
shipped and previous kernels.  Run from the repository root on a CUDA
machine::

    python3 -m unclerenderer_tpu_torch.sweeps.exhaustive [--ptxas] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import tempfile
from pathlib import Path

import torch

from ..ops import _cuda
from ..ops import raster_kernels as rk
from ..ops.raster import rasterize
from ..timing import graph_ms, nvidia_smi
from .raster import DIAGNOSTIC, centre, ptxas, same, shipped_source

WIDTH, HEIGHT, SHADOW = 1920, 1080, 4096
ROUNDS, REPS = 3, 10

PREVIOUS = r"""// X1: exhaustive visibility raster (raster_backend="xla").
//
// Not a port of a TPU kernel: it computes what the JAX package's XLA
// raster computes (unclerenderer_tpu/ops/raster.py rasterize, the
// raster_backend="xla" path), which no Pallas kernel implements.  Every tile
// meets every row of the triangle table; a row counts for a tile only if it
// is valid and its bounding box overlaps the tile (the reference's
// per-(tile, triangle) rejection), and then every pixel of the tile tests
// it.  Nothing is binned and nothing is dropped, so the image does not
// depend on a bin budget: it is the cross-check of the binned rasters K1/K2.
//
// The design:
//   * One tile per block (tile_h x tile_w: 16 x 64 for the camera, 32 x 128
//     for the shadow map; larger tiles take several blocks).  A warp owns an
//     8 x 32 rectangle of the tile, a thread 8 pixels of one row in
//     registers, as in giant_raster.cu (K2).
//   * The table is walked in ascending row order, kScan rows a pass: each
//     thread tests the bounding box and valid flag of its rows, the warps'
//     ballots give the pass's kept rows as a bit mask in row order, and each
//     kept row is staged at its rank in shared memory as a record of
//     raster_common.cuh (its tag: the row).  The next pass's boxes are
//     loaded while this pass is staged and evaluated.
//   * Each warp evaluates the staged records in ascending order with K1/K2's
//     warp skip and arithmetic (raster_common.cuh evaluate): a pixel takes a
//     row only for a strictly greater key, so over the whole ascending walk
//     it keeps the maximum key and, among equal keys, the lowest row -- the
//     reference's per-chunk argmax followed by a strict > across chunks.
//   * The depth-min (shadow) key nw - nz is formed while staging (the
//     reference's flip_depth_key), ortho setups (nw = (0, 0, 1)) skip the
//     divide, and the (height, width) depth and id images are written
//     directly (no untile copy), rows offset by y_off in pixel space.
//
// What bounds it.  The function needs the table read once, the images
// written once, and for each (row, tile) pair whose boxes overlap -- found
// from each row's tile range without a walk -- the corner tests of its warp
// rectangles and the coverage tests of the (pixel, row) pairs the warp skip
// keeps, as in K1; that is the bound chip_smoke.py states (work_exhaustive).
// The design pays beyond it for its walk: every block reads every row's box
// and flag, 17 bytes a row, so at 1080p (2,040 camera tiles over 163,840
// compacted rows) 5.7 GB of reads that L2 serves and 334 M box tests, and
// for the 4096^2 map's 4,096 tiles 11.1 GB and 671 M.  The shipped form is
// the simple one: one pass of kScan rows costs two barriers and two
// dependent loads (boxes, then the kept rows' coefficients), so the walk is
// latency-bound where few rows survive the box test.  Its times and bound
// are in PERF.md (chip_smoke.py, "xla" phase).
//
// Exactness: the edge threshold, the warp skip and the evaluation are
// raster_common.cuh's (its note); the box test, the pixel centres and the
// key are the plain version's f32 operations in its order (ops/raster.py
// rasterize, built with -fmad=false).
#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

using raster::centre;

constexpr int kPix = 8;                 // pixels a thread, one row
constexpr int kRectH = 8, kRectW = 32;  // a warp's pixels: kRectH rows of kRowThreads x kPix
constexpr int kRowThreads = 32 / kRectH;
static_assert(kRowThreads * kPix == kRectW, "a warp covers its rectangle");
constexpr int kMinWarps = 4, kMaxWarps = 16;
constexpr int kScan = 256;  // rows a pass
constexpr int kRowsPerThread = kScan / (32 * kMinWarps);
constexpr int kWords = kScan / 32;

// the box and valid flag of rows r: kept for tile [x0, x1] x [y0, y1]
struct Boxes {
  float x0[kRowsPerThread], y0[kRowsPerThread], x1[kRowsPerThread], y1[kRowsPerThread];
  bool ok[kRowsPerThread];
};

__device__ __forceinline__ void load_boxes(Boxes& b, const float* __restrict__ bbox,
                                           const bool* __restrict__ valid, int t_count,
                                           int base) {
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int slot = j * blockDim.x + threadIdx.x;
    const int r = base + slot;
    b.ok[j] = false;
    if (slot < kScan && r < t_count) {  // the flag and the box loads are independent
      b.ok[j] = valid[r];
      b.x0[j] = bbox[r];
      b.y0[j] = bbox[static_cast<size_t>(t_count) + r];
      b.x1[j] = bbox[2 * static_cast<size_t>(t_count) + r];
      b.y1[j] = bbox[3 * static_cast<size_t>(t_count) + r];
    }
  }
}

template <bool kWantIds, bool kOrtho, bool kDepthMax>
__global__ void __launch_bounds__(32 * kMaxWarps)
exhaustive_raster_kernel(const float* __restrict__ coef, const float* __restrict__ bbox,
                         const bool* __restrict__ valid, float* __restrict__ out_depth,
                         int* __restrict__ out_id, int t_count, int width, int height,
                         int tile_h, int tile_w, int n_tx, float y_off, int rects_x,
                         int n_rects) {
  // float4s a record (raster_common.cuh); its tag is the table row
  constexpr int kF4 = (kOrtho && !kWantIds) ? 4 : 5;
  __shared__ float4 s_rec[kScan * kF4];
  __shared__ unsigned s_mask[kWords];

  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rect = blockIdx.y * (blockDim.x >> 5) + warp;
  const bool active = rect < n_rects;  // idle warps still scan, stage and meet barriers
  const int ry = (rect / rects_x) * kRectH, rx = (rect % rects_x) * kRectW;
  const int py = ry + lane / kRowThreads, px0 = rx + (lane % kRowThreads) * kPix;
  const int tx = tile % n_tx, ty = tile / n_tx;
  const float x0 = static_cast<float>(tx * tile_w);
  const float y0 = __fadd_rn(static_cast<float>(ty * tile_h), y_off);
  // the tile's box, as the plain version forms it
  const float tx1 = __fadd_rn(x0, static_cast<float>(tile_w - 1));
  const float ty1 = __fadd_rn(y0, static_cast<float>(tile_h - 1));
  const float qy = centre(y0, py);
  float qx[kPix], best[kPix];
  int win[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    qx[k] = centre(x0, px0 + k);
    best[k] = -1.f;
    win[k] = -1;
  }
  const float2 xs = make_float2(centre(x0, rx), centre(x0, rx + kRectW - 1));
  const float2 ys = make_float2(centre(y0, ry), centre(y0, ry + kRectH - 1));

  Boxes b;
  load_boxes(b, bbox, valid, t_count, 0);
  for (int base = 0; base < t_count; base += kScan) {
    // this pass's kept rows as a mask in row order (a warp's 32 slots of
    // sub-pass j are word j * warps + warp)
    bool keep[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      keep[j] = b.ok[j] && b.x0[j] <= tx1 && b.x1[j] >= x0 && b.y0[j] <= ty1 && b.y1[j] >= y0;
      const int slot0 = j * blockDim.x + (warp << 5);
      const unsigned m = __ballot_sync(0xffffffffu, keep[j]);
      if (slot0 < kScan && lane == 0) s_mask[slot0 >> 5] = m;
    }
    load_boxes(b, bbox, valid, t_count, base + kScan);  // in flight over this pass
    __syncthreads();  // the mask is written; the previous pass's records are no longer read
    int n_kept = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) n_kept += __popc(s_mask[w]);
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      if (!keep[j]) continue;
      const int slot = j * blockDim.x + threadIdx.x;
      int rank = __popc(s_mask[slot >> 5] & ((1u << (slot & 31)) - 1u));
      for (int w = 0; w < (slot >> 5); ++w) rank += __popc(s_mask[w]);
      const int r = base + slot;
      const float4* cf = reinterpret_cast<const float4*>(coef + static_cast<size_t>(r) * 16);
      const float4 c0 = cf[0], c1 = cf[1], c2 = cf[2], c3 = cf[3];
      float v[15] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w,
                     c2.x, c2.y, c2.z, c2.w, c3.x, c3.y, c3.z};
      if (!kDepthMax) {  // key = 1 - depth: numerator nw - nz (flip_depth_key)
#pragma unroll
        for (int i = 0; i < 3; ++i) v[9 + i] = __fsub_rn(v[12 + i], v[9 + i]);
      }
      raster::put_record<kF4>(s_rec + rank * kF4, v, true, __int_as_float(r));
    }
    __syncthreads();
    if (active)
      raster::evaluate<kPix, kF4, kOrtho, false>(s_rec, n_kept, lane, xs, ys, qy, qx, best, win);
  }

  if (!active || py >= tile_h) return;
  const int gy = ty * tile_h + py;
  if (gy >= height) return;
  const size_t o = static_cast<size_t>(gy) * width;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int lx = px0 + k, gx = tx * tile_w + lx;
    if (lx >= tile_w || gx >= width) break;
    const bool hit = best[k] >= 0.f;
    out_depth[o + gx] = hit ? (kDepthMax ? best[k] : __fsub_rn(1.f, best[k]))
                            : (kDepthMax ? 0.f : 1.f);
    if (kWantIds) out_id[o + gx] = hit ? win[k] : -1;
  }
}

template <bool kWantIds, bool kOrtho, bool kDepthMax>
void launch(const float* coef, const float* bbox, const bool* valid, float* out_depth,
            int* out_id, int t_count, int width, int height, int tile_h, int tile_w, float y_off,
            cudaStream_t stream) {
  const int n_tx = (width + tile_w - 1) / tile_w;
  const int n_tiles = n_tx * ((height + tile_h - 1) / tile_h);
  const int rects_x = (tile_w + kRectW - 1) / kRectW;
  const int n_rects = rects_x * ((tile_h + kRectH - 1) / kRectH);
  int warps = kMinWarps;
  while (warps < n_rects && warps < kMaxWarps) warps *= 2;
  const dim3 grid(n_tiles, (n_rects + warps - 1) / warps);
  exhaustive_raster_kernel<kWantIds, kOrtho, kDepthMax><<<grid, 32 * warps, 0, stream>>>(
      coef, bbox, valid, out_depth, out_id, t_count, width, height, tile_h, tile_w, n_tx, y_off,
      rects_x, n_rects);
}

}  // namespace

// coef (T, 16) f32 row-major, bbox (4, T) f32, valid (T,) bool -> depth
// (height, width) f32 and, with want_ids, ids (height, width) i32 (-1 where
// empty); depth_max: DEPTH_MAX (reverse-Z, empty 0), else DEPTH_MIN (empty 1)
extern "C" int exhaustive_raster(const float* coef, const float* bbox, const bool* valid,
                                 float* out_depth, int* out_id, int t_count, int width,
                                 int height, int tile_h, int tile_w, float y_off, int want_ids,
                                 int ortho, int depth_max, void* stream) {
  if (t_count < 0 || width < 1 || height < 1 || tile_h < 1 || tile_w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int mode = (want_ids ? 4 : 0) | (ortho ? 2 : 0) | (depth_max ? 1 : 0);
#define X1_LAUNCH(W, O, D)                                                                  \
  launch<W, O, D>(coef, bbox, valid, out_depth, out_id, t_count, width, height, tile_h, tile_w, \
                  y_off, s)
  switch (mode) {
    case 0: X1_LAUNCH(false, false, false); break;
    case 1: X1_LAUNCH(false, false, true); break;
    case 2: X1_LAUNCH(false, true, false); break;
    case 3: X1_LAUNCH(false, true, true); break;
    case 4: X1_LAUNCH(true, false, false); break;
    case 5: X1_LAUNCH(true, false, true); break;
    case 6: X1_LAUNCH(true, true, false); break;
    default: X1_LAUNCH(true, true, true); break;
  }
#undef X1_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
"""

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the previous C entry: no mask scratch
PREVIOUS_SIGNATURE = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P]

PIX = "constexpr int kSmallPix = 2, kLargePix = 4;"
MAX_WARPS = "constexpr int kMinWarps = 4, kMaxWarps = 16;"
EVALUATE = "raster::evaluate<kPix, kF4, kOrtho, false>(s_rec, n, lane, xs, ys, qy, qx, best, win);"
VARIANTS = {
    **{f"{p} pixels a thread at every tile": [(PIX, f"constexpr int kSmallPix = {p}, "
                                                    f"kLargePix = {p};")] for p in (2, 4, 8)},
    "8 warps a block at most": [(MAX_WARPS, "constexpr int kMinWarps = 4, kMaxWarps = 8;")],
    "32 warps a block at most": [(MAX_WARPS, "constexpr int kMinWarps = 4, kMaxWarps = 32;")],
    "band words first": [("  pass_words(w, band, col, p);\n  int n = 0;",
                          "  const uint4* b = reinterpret_cast<const uint4*>(band + "
                          "static_cast<size_t>(p) * kWords);\n  const uint4 b0 = b[0], b1 = b[1];\n"
                          "  if ((b0.x | b0.y | b0.z | b0.w | b1.x | b1.y | b1.z | b1.w) == 0) "
                          "return 0;\n  pass_words(w, band, col, p);\n  int n = 0;")],
    "reversed tile order": [("  const int tile = blockIdx.x;",
                             "  const int tile = gridDim.x - 1 - blockIdx.x;")],
    DIAGNOSTIC + "no evaluation": [(EVALUATE, "(void)n;")],
    DIAGNOSTIC + "no rows": [("cnt[i] = pass_count(band, col, g0 + p);", "cnt[i] = 0;")],
}


def with_headers(text: str) -> str:
    for header in _cuda.headers():
        text = text.replace(f'#include "{header.name}"', header.read_text())
    return text


def variant_sources():
    """variant -> source text: the previous kernel and the shipped source
    with its lines replaced."""
    out = {"previous": with_headers(PREVIOUS)}
    shipped = shipped_source("exhaustive_raster")
    for label, edits in VARIANTS.items():
        text = shipped
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"exhaustive_raster.cu no longer holds a line of {label!r}")
            text = text.replace(old, new)
        out[label] = text
    return out


def bind(label: str, text: str, signature):
    entry = "sweep_x1_" + "".join(ch if ch.isalnum() else "_" for ch in label)
    text = text.replace('extern "C" int exhaustive_raster(', f'extern "C" int {entry}(')
    fn = getattr(ctypes.PyDLL(str(_cuda.build_source(entry, text))), entry)
    fn.argtypes, fn.restype = signature, ctypes.c_int
    return fn


def entry_call(fn, label, setup, width, height, tile_h, tile_w, depth_mode, y_offset=0.0,
               want_ids=True, ortho=False, **_):
    """One call of a variant's C entry: (depth, ids or None)."""
    coef, bbox, valid = setup.coef, setup.bbox, setup.valid
    t = coef.shape[0]
    depth = torch.empty((height, width), dtype=torch.float32, device=coef.device)
    ids = torch.empty((height, width), dtype=torch.int32, device=coef.device) if want_ids else None
    tail = (t, width, height, tile_h, tile_w, float(y_offset), int(want_ids), int(ortho),
            int(depth_mode == rk.DEPTH_MAX), torch.cuda.current_stream().cuda_stream)
    if label == "previous":
        err = fn(coef.data_ptr(), bbox.data_ptr(), valid.data_ptr(), depth.data_ptr(),
                 _cuda.ptr(ids), *tail)
    else:
        lines = -(-height // tile_h) + -(-width // tile_w)
        masks = torch.empty((lines, -(-t // rk.X1_PASS) * (rk.X1_PASS // 32)),
                            dtype=torch.int32, device=coef.device)
        err = fn(coef.data_ptr(), bbox.data_ptr(), valid.data_ptr(), masks.data_ptr(),
                 depth.data_ptr(), _cuda.ptr(ids), *tail)
    if err:
        raise RuntimeError(f"exhaustive_raster {label}: cudaError {err}")
    return depth, ids


def frame_calls(dev):
    """X1's two calls of one xla frame: [(label, args, kwargs)], map first."""
    from ..render import common
    from ..render.deferred import deferred_frame
    from ..render.params import FrameState, RenderSettings
    from ..render.testing import synthetic_device_scene, synthetic_frame_params

    scene, data = synthetic_device_scene(340, sphere_res=(32, 24), ground=True,
                                         rich_materials=True, atlas_u8=True, device=dev)
    settings = RenderSettings(width=WIDTH, height=HEIGHT, shadow_map_size=SHADOW,
                              has_masked_models=False, raster_backend="xla")
    params = synthetic_frame_params(data, WIDTH, HEIGHT, device=dev)
    calls, orig = [], common.rasterize_exhaustive

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    common.rasterize_exhaustive = rec
    try:
        deferred_frame(scene, params, FrameState.initial(WIDTH, HEIGHT, dev), settings)
        torch.cuda.synchronize()
    finally:
        common.rasterize_exhaustive = orig
    return [(label, a, k) for label, (a, k) in zip(("shadow", "camera"), calls)]


def box_pairs(setup, width, height, tile_h, tile_w, y_offset=0.0):
    """The (row, tile) pairs whose box test X1 passes: every valid row with a
    finite box against the tiles its box overlaps.  Box and tile edges are
    integers, so the tile range of a row is exact.  Returns (rows, tiles)."""
    rows = torch.nonzero(setup.valid & torch.isfinite(setup.bbox).all(0)).flatten()
    b = setup.bbox[:, rows].double()
    n_tx, n_ty = -(-width // tile_w), -(-height // tile_h)
    x_lo = torch.ceil((b[0] - (tile_w - 1)) / tile_w).clamp(min=0)
    x_hi = torch.floor(b[2] / tile_w).clamp(max=n_tx - 1)
    y_lo = torch.ceil((b[1] - y_offset - (tile_h - 1)) / tile_h).clamp(min=0)
    y_hi = torch.floor((b[3] - y_offset) / tile_h).clamp(max=n_ty - 1)
    nx = (x_hi - x_lo + 1).clamp(min=0).long()
    n = nx * (y_hi - y_lo + 1).clamp(min=0).long()
    k = torch.arange(int(n.sum()), device=rows.device) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    nxr = torch.repeat_interleave(nx, n)
    tx = torch.repeat_interleave(x_lo.long(), n) + k % nxr
    ty = torch.repeat_interleave(y_lo.long(), n) + k // nxr
    return torch.repeat_interleave(rows, n), ty * n_tx + tx


def work(setup, width, height, tile_h, tile_w, y_offset=0.0, **_):
    """Rows, valid rows, (tile, row) pairs past the box test, the most rows a
    tile has, and the most records one warp rectangle keeps after the warp
    skip (raster_common.cuh's corner test) -- the longest chain a tile
    evaluates -- and the sum of each tile's longest chain."""
    from ..ops.fma import fma

    rows, tiles = box_pairs(setup, width, height, tile_h, tile_w, y_offset)
    n_tx = -(-width // tile_w)
    n_tiles = n_tx * -(-height // tile_h)
    rh, rw = 8, (8 if tile_h * tile_w <= 1024 else 16)  # the shipped warp rectangle
    rx_n = -(-tile_w // rw)
    rect = torch.arange(rx_n * -(-tile_h // rh), device=rows.device)
    rx, ry = (rect % rx_n) * rw, (rect // rx_n) * rh
    per = torch.zeros((n_tiles, rect.shape[0]), dtype=torch.long, device=rows.device)
    for s0 in range(0, rows.shape[0], 1 << 19):
        coef = setup.coef[rows[s0:s0 + (1 << 19)]]
        t = tiles[s0:s0 + (1 << 19)]
        x0 = ((t % n_tx) * tile_w).to(torch.float32)[:, None]
        y0 = ((t // n_tx) * tile_h).to(torch.float32)[:, None] + y_offset
        may = torch.ones((coef.shape[0], rect.shape[0]), dtype=torch.bool, device=coef.device)
        for e in range(3):
            a, b, c = (coef[:, i][:, None] for i in (e, 3 + e, 6 + e))
            qx = torch.where(a > 0, centre(x0, rx + rw - 1), centre(x0, rx))
            qy = torch.where(b > 0, centre(y0, ry + rh - 1), centre(y0, ry))
            ev = fma(a, qx, b * qy) + c
            may &= (ev > 0) | ((ev == 0) & ((a > 0) | ((a == 0) & (b > 0))))
        may |= ~torch.isfinite(coef[:, :9]).all(1, keepdim=True)
        per.index_add_(0, t, may.long())
    chain = per.max(1).values
    return {"rows": int(setup.coef.shape[0]), "valid_rows": int(setup.valid.sum()),
            "box_pairs": int(rows.shape[0]),
            "most_rows_a_tile": int(torch.bincount(tiles, minlength=n_tiles).max()),
            "longest_chain": int(chain.max()), "sum_of_chains": int(chain.sum()),
            "kept_rect_rows": int(per.sum())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v first")
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("exhaustive sweep: needs a CUDA card")
    smi = nvidia_smi()
    result = {"device": smi, "ptxas": {}, "calls": []}
    sources = variant_sources()
    if args.ptxas:
        result["ptxas"]["shipped"] = ptxas("shipped", _cuda.CSRC / "exhaustive_raster.cu")
        with tempfile.TemporaryDirectory() as tmp:
            src = Path(tmp) / "previous_exhaustive_raster.cu"
            src.write_text(sources["previous"])
            result["ptxas"]["previous"] = ptxas("previous", src)
    _cuda.library()
    fns = {label: bind(label, text, PREVIOUS_SIGNATURE if label == "previous"
                       else _cuda.SIGNATURES["exhaustive_raster"])
           for label, text in sources.items()}
    dev = torch.device("cuda", 0)
    for label, a, k in frame_calls(dev):
        want = rasterize(*a, **k)
        variants = {"shipped": lambda a=a, k=k: rk.rasterize_exhaustive(*a, **k)}
        for vname, fn in fns.items():
            variants[vname] = lambda a=a, k=k, fn=fn, vname=vname: entry_call(fn, vname, *a, **k)
        for vname, fn in variants.items():
            if not same(fn(), want) and not vname.startswith(DIAGNOSTIC):
                raise RuntimeError(f"{vname} != plain at the {label} call")
        times = {}
        for r in range(ROUNDS):
            order = list(variants.items())
            for vname, fn in (order if r % 2 == 0 else order[::-1]):
                times.setdefault(vname, []).append(graph_ms(fn, REPS))
        row = {"call": label, "shape": [a[1], a[2]], **work(*a, **k),
               "ms": {v: statistics.median(ts) for v, ts in times.items()},
               "ms_rounds": times}
        result["calls"].append(row)
        counts = {key: v for key, v in row.items() if key not in ("call", "ms", "ms_rounds")}
        print(f"[x1 {label}] {counts}")
        print(f"[x1 {label}] graph ms per call: "
              + ", ".join(f"{v} {ms:.4f}" for v, ms in row["ms"].items())
              + f" (bit-equal to plain; {smi})")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
