// X1: exhaustive visibility raster (raster_backend="xla").
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
