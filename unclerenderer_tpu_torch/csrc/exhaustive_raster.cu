// X1: exhaustive visibility raster (raster_backend="xla").
//
// Not a port of a TPU kernel: it computes what the JAX package's XLA
// raster computes (unclerenderer_tpu/ops/raster.py rasterize, the
// raster_backend="xla" path), which no Pallas kernel implements.  A row of
// the triangle table counts for a tile only if it is valid and its
// bounding box overlaps the tile (the reference's per-(tile, triangle)
// rejection), and then every pixel of the tile tests it.  Nothing is binned
// and nothing is dropped, so the image does not depend on a bin budget: it
// is the cross-check of the binned rasters K1/K2.
//
// The design: two launches from the one C entry, on the caller's stream.
//   1. Row masks (exhaustive_masks_kernel).  The box test splits into a y
//      half, the same for every tile of a band (one row of tiles: tile_h
//      image rows across the width), and an x half, the same for every
//      tile of a column.  Each thread takes one table row and ballots, for
//      each band of its block's share, valid && y0 <= band_y1 && y1 >=
//      band_y0, and for each column x0 <= col_x1 && x1 >= col_x0: one
//      32-bit word of mask[line][r / 32] a warp and line, bit order = row
//      order.  The band and column edges are formed exactly as the
//      per-tile test forms its tile's (y_off included), so the words are
//      its two halves, evaluated once a band or column instead of once a
//      tile.  No atomics, no counts: the result does not depend on
//      scheduling.  A mask line holds whole passes (kScan rows, 8 words),
//      zeros past the table.
//   2. Tiles (exhaustive_raster_kernel).  One tile per block (tile_h x
//      tile_w: 16 x 64 for the camera, 32 x 128 for the shadow map; larger
//      tiles take several blocks); a warp owns an 8 x 8 rectangle of a
//      camera tile, 8 x 16 of a map tile, a thread 2 or 4 pixels of one row
//      in registers (K2's are 8 x 32 and 8: the time goes to the tiles with
//      the most rows, whose every warp evaluates each row alone, so smaller
//      rectangles shorten the longest chain; on the map's many tiles the
//      blocks a tile takes cost more than that saves).  The tile's rows are
//      band[ty] & column[tx].
//      The table is taken kGroup passes at a time: each thread popcounts
//      its consecutive passes' words, a block scan gives every pass's
//      kept-row prefix in shared memory, and the group's kept rows are then
//      staged kScan at a time -- thread q finds the pass of position q by a
//      binary search over the prefix and its row by popcounts of that
//      pass's words -- at their rank, in row order, as records of
//      raster_common.cuh (tag: the row), and evaluated.  So a tile pays two
//      barriers a group and two a round of kScan kept rows, however its rows
//      spread over the table, and a round's row loads are independent.
//   Each warp evaluates the staged records in ascending order with K1/K2's
//   warp skip and arithmetic (raster_common.cuh evaluate): a pixel takes a
//   row only for a strictly greater key, so over the whole ascending walk it
//   keeps the maximum key and, among equal keys, the lowest row -- the
//   reference's per-chunk argmax followed by a strict > across chunks.  The
//   depth-min (shadow) key nw - nz is formed while staging (the reference's
//   flip_depth_key), ortho setups (nw = (0, 0, 1)) skip the divide, and the
//   (height, width) depth and id images are written directly (no untile
//   copy), rows offset by y_off in pixel space.
//
// What bounds it.  The function needs the table read once, the images
// written once, and for each (row, tile) pair whose boxes overlap the
// corner tests of its warp rectangles and the coverage tests of the
// (pixel, row) pairs the warp skip keeps, as in K1; that is the bound
// chip_smoke.py states (work_exhaustive).  The design pays beyond it for
// the masks (each row's box read once a block of kMaskLines lines, (bands +
// columns) x T / 8 bytes written, read back by every tile: 64 bytes a pass),
// a fixed cost a tile block (its count, scan and barriers: about 40% of the
// map's time, with two blocks a 32 x 128 tile), and the tiles with the most
// rows, whose warps evaluate them one after another (most of the camera's
// time).  Its times, bound and that split (sweeps/exhaustive.py) are in
// PERF.md (chip_smoke.py, "xla" phase).
//
// Exactness: the set of rows each tile evaluates, and their order, are
// those of the per-tile box test: the band and column compares are its two
// halves with the same f32 operands.  The edge threshold, the warp skip and
// the evaluation are raster_common.cuh's (its note); the box test, the pixel
// centres and the key are the plain version's f32 operations in its order
// (ops/raster.py rasterize, built with -fmad=false).
#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

using raster::centre;

// a warp's pixels: kRectH rows of kRowThreads threads, kPix pixels of one row a
// thread (kRectW = kRowThreads * kPix columns).  kPix is kSmallPix on tiles of at
// most kSmallTile pixels (the camera's 16 x 64: 8 x 8 rectangles), else kLargePix
// (the map's 32 x 128: 8 x 16)
constexpr int kRectH = 8, kRowThreads = 32 / kRectH;
constexpr int kSmallTile = 1024;
constexpr int kSmallPix = 2, kLargePix = 4;
constexpr int kMinWarps = 4, kMaxWarps = 16;
constexpr int kScan = 256;  // rows a pass
constexpr int kWords = kScan / 32;  // mask words a pass
constexpr int kMaskLines = 16;      // bands and columns a mask block ballots
constexpr int kGroup = 1024;        // passes whose kept-row prefix a tile block holds at once
static_assert(kGroup % (32 * kMaxWarps) == 0, "a group splits evenly over any block");
constexpr int kMaxPer = kGroup / (32 * kMinWarps);  // passes a thread counts, at most

// mask[l][w] (l < n_bands: band l; else column l - n_bands), `stride` words a
// line; block (x, y): rows x * kScan.., lines y * kMaskLines..
__global__ void __launch_bounds__(kScan)
exhaustive_masks_kernel(const float* __restrict__ bbox, const bool* __restrict__ valid,
                        unsigned* __restrict__ mask, int t_count, int stride, int n_bands,
                        int n_lines, int tile_h, int tile_w, float y_off) {
  const int r = blockIdx.x * kScan + threadIdx.x;
  const int word = r >> 5;
  const bool in = r < t_count;
  const size_t t = static_cast<size_t>(t_count);
  const bool ok = in && valid[r];
  const float bx0 = in ? bbox[r] : 0.f, by0 = in ? bbox[t + r] : 0.f;
  const float bx1 = in ? bbox[2 * t + r] : 0.f, by1 = in ? bbox[3 * t + r] : 0.f;
  const int l0 = blockIdx.y * kMaskLines;
  const int l1 = min(l0 + kMaskLines, n_lines);
  for (int l = l0; l < l1; ++l) {
    bool keep;
    if (l < n_bands) {  // the y half, with the tile edges ty0, ty0 + tile_h - 1 of band l
      const float y0 = __fadd_rn(static_cast<float>(l * tile_h), y_off);
      const float y1 = __fadd_rn(y0, static_cast<float>(tile_h - 1));
      keep = ok && by0 <= y1 && by1 >= y0;
    } else {  // the x half, with the tile edges tx0, tx0 + tile_w - 1 of column l - n_bands
      const float x0 = static_cast<float>((l - n_bands) * tile_w);
      const float x1 = __fadd_rn(x0, static_cast<float>(tile_w - 1));
      keep = in && bx0 <= x1 && bx1 >= x0;
    }
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if ((threadIdx.x & 31) == 0) mask[static_cast<size_t>(l) * stride + word] = m;
  }
}

// the 8 words of pass p of the tile (band & column)
__device__ __forceinline__ void pass_words(unsigned (&w)[kWords], const unsigned* band,
                                           const unsigned* col, int p) {
  const uint4* b = reinterpret_cast<const uint4*>(band + static_cast<size_t>(p) * kWords);
  const uint4* c = reinterpret_cast<const uint4*>(col + static_cast<size_t>(p) * kWords);
  const uint4 b0 = b[0], b1 = b[1], c0 = c[0], c1 = c[1];
  w[0] = b0.x & c0.x, w[1] = b0.y & c0.y, w[2] = b0.z & c0.z, w[3] = b0.w & c0.w;
  w[4] = b1.x & c1.x, w[5] = b1.y & c1.y, w[6] = b1.z & c1.z, w[7] = b1.w & c1.w;
}

// the kept rows of pass p of the tile
__device__ __forceinline__ int pass_count(const unsigned* band, const unsigned* col, int p) {
  unsigned w[kWords];
  pass_words(w, band, col, p);
  int n = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) n += __popc(w[k]);
  return n;
}

// position of the k-th (from 0) set bit of m; m has more than k set bits
__device__ __forceinline__ int select_bit(unsigned m, int k) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half >= 1; half >>= 1) {
    const int c = __popc(m & ((1u << half) - 1u));
    if (k >= c) {
      k -= c;
      m >>= half;
      pos += half;
    }
  }
  return pos;
}

template <int kPix, bool kWantIds, bool kOrtho, bool kDepthMax>
__global__ void __launch_bounds__(32 * kMaxWarps)
exhaustive_raster_kernel(const float* __restrict__ coef, const unsigned* __restrict__ mask,
                         float* __restrict__ out_depth, int* __restrict__ out_id, int stride,
                         int n_bands, int width, int height, int tile_h, int tile_w, int n_tx,
                         float y_off, int rects_x, int n_rects) {
  constexpr int kRectW = kRowThreads * kPix;
  // float4s a record (raster_common.cuh); its tag is the table row
  constexpr int kF4 = (kOrtho && !kWantIds) ? 4 : 5;
  __shared__ float4 s_rec[kScan * kF4];
  __shared__ int s_pre[kGroup + 1];  // kept rows of the group before each of its passes
  __shared__ int s_warp[kMaxWarps];

  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  const int rect = blockIdx.y * n_warps + warp;
  const bool active = rect < n_rects;  // idle warps still count, stage and meet barriers
  const int ry = (rect / rects_x) * kRectH, rx = (rect % rects_x) * kRectW;
  const int py = ry + lane / kRowThreads, px0 = rx + (lane % kRowThreads) * kPix;
  const int tx = tile % n_tx, ty = tile / n_tx;
  const float x0 = static_cast<float>(tx * tile_w);
  const float y0 = __fadd_rn(static_cast<float>(ty * tile_h), y_off);
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

  // the tile's rows: band ty's words AND column tx's
  const unsigned* band = mask + static_cast<size_t>(ty) * stride;
  const unsigned* col = mask + static_cast<size_t>(n_bands + tx) * stride;
  const int n_pass = stride / kWords;
  const int per = kGroup / blockDim.x;  // a thread's consecutive passes in a group
  for (int g0 = 0; g0 < n_pass; g0 += kGroup) {
    const int ng = min(kGroup, n_pass - g0);
    // 1. each pass's kept rows, and their exclusive prefix over the group
    int cnt[kMaxPer], mine = 0;
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      const int p = threadIdx.x * per + i;
      cnt[i] = 0;
      if (i < per && p < ng) cnt[i] = pass_count(band, col, g0 + p);
      mine += cnt[i];
    }
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    __syncthreads();  // the previous group's prefix and records are no longer read
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = incl - mine, total = 0;
    for (int i = 0; i < n_warps; ++i) {
      const int v = s_warp[i];
      before += i < warp ? v : 0;
      total += v;
    }
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      const int p = threadIdx.x * per + i;
      if (i < per && p < ng) {
        s_pre[p] = before;
        before += cnt[i];
      }
    }
    // 2. rounds of kScan kept rows in row order: position q of a round is the
    // k-th kept row of the pass whose prefix is the last <= q
    for (int base = 0; base < total; base += kScan) {
      const int n = min(kScan, total - base);
      __syncthreads();  // the prefix is written; the previous round's records are read
      for (int q = threadIdx.x; q < n; q += blockDim.x) {
        const int pos = base + q;
        int lo = 0, hi = ng - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (s_pre[mid] <= pos) lo = mid;
          else hi = mid - 1;
        }
        int k = pos - s_pre[lo];
        unsigned w[kWords];
        pass_words(w, band, col, g0 + lo);
        int word = 0;
#pragma unroll
        for (int j = 0; j < kWords; ++j) {  // the word holding it (registers only)
          const int c = __popc(w[j]);
          if (word == j && k >= c) {
            k -= c;
            ++word;
          }
        }
        unsigned m = 0;
#pragma unroll
        for (int j = 0; j < kWords; ++j) m = j == word ? w[j] : m;
        const int r = (g0 + lo) * kScan + 32 * word + select_bit(m, k);
        const float4* cf = reinterpret_cast<const float4*>(coef + static_cast<size_t>(r) * 16);
        const float4 c0 = cf[0], c1 = cf[1], c2 = cf[2], c3 = cf[3];
        float v[15] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w,
                       c2.x, c2.y, c2.z, c2.w, c3.x, c3.y, c3.z};
        if (!kDepthMax) {  // key = 1 - depth: numerator nw - nz (flip_depth_key)
#pragma unroll
          for (int e = 0; e < 3; ++e) v[9 + e] = __fsub_rn(v[12 + e], v[9 + e]);
        }
        raster::put_record<kF4>(s_rec + q * kF4, v, true, __int_as_float(r));
      }
      __syncthreads();
      if (active)
        raster::evaluate<kPix, kF4, kOrtho, false>(s_rec, n, lane, xs, ys, qy, qx, best, win);
    }
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

template <int kPix, bool kWantIds, bool kOrtho, bool kDepthMax>
void launch(const float* coef, const unsigned* mask, float* out_depth, int* out_id, int stride,
            int n_bands, int n_tx, int width, int height, int tile_h, int tile_w, float y_off,
            cudaStream_t stream) {
  constexpr int kRectW = kRowThreads * kPix;
  const int n_tiles = n_tx * n_bands;
  const int rects_x = (tile_w + kRectW - 1) / kRectW;
  const int n_rects = rects_x * ((tile_h + kRectH - 1) / kRectH);
  int warps = kMinWarps;
  while (warps < n_rects && warps < kMaxWarps) warps *= 2;
  const dim3 grid(n_tiles, (n_rects + warps - 1) / warps);
  exhaustive_raster_kernel<kPix, kWantIds, kOrtho, kDepthMax><<<grid, 32 * warps, 0, stream>>>(
      coef, mask, out_depth, out_id, stride, n_bands, width, height, tile_h, tile_w, n_tx, y_off,
      rects_x, n_rects);
}

}  // namespace

// coef (T, 16) f32 row-major, bbox (4, T) f32, valid (T,) bool -> depth
// (height, width) f32 and, with want_ids, ids (height, width) i32 (-1 where
// empty); depth_max: DEPTH_MAX (reverse-Z, empty 0), else DEPTH_MIN (empty
// 1).  mask: scratch of (ceil(height / tile_h) + ceil(width / tile_w)) x
// ceil(T / 256) x 8 u32 words, left holding the band masks then the column
// masks.
extern "C" int exhaustive_raster(const float* coef, const float* bbox, const bool* valid,
                                 unsigned* mask, float* out_depth, int* out_id, int t_count,
                                 int width, int height, int tile_h, int tile_w, float y_off,
                                 int want_ids, int ortho, int depth_max, void* stream) {
  if (t_count < 0 || width < 1 || height < 1 || tile_h < 1 || tile_w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int n_tx = (width + tile_w - 1) / tile_w, n_bands = (height + tile_h - 1) / tile_h;
  const int n_pass = (t_count + kScan - 1) / kScan, stride = n_pass * kWords;
  const int n_lines = n_bands + n_tx;
  if (n_pass > 0) {
    const dim3 grid(n_pass, (n_lines + kMaskLines - 1) / kMaskLines);
    exhaustive_masks_kernel<<<grid, kScan, 0, s>>>(bbox, valid, mask, t_count, stride, n_bands,
                                                   n_lines, tile_h, tile_w, y_off);
  }
  const int mode = (want_ids ? 4 : 0) | (ortho ? 2 : 0) | (depth_max ? 1 : 0);
#define X1_LAUNCH(W, O, D)                                                                  \
  (small ? launch<kSmallPix, W, O, D>(coef, mask, out_depth, out_id, stride, n_bands, n_tx,   \
                                      width, height, tile_h, tile_w, y_off, s)                \
         : launch<kLargePix, W, O, D>(coef, mask, out_depth, out_id, stride, n_bands, n_tx,   \
                                      width, height, tile_h, tile_w, y_off, s))
  const bool small = tile_h * tile_w <= kSmallTile;
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
