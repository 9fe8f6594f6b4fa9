// K2/K3: giant-level visibility raster (brute force over a small table).
//
// Replaces unclerenderer_tpu/ops/pallas_raster.py _raster_kernel_onepass
// (K2, 1D tile grid with an in-kernel chunk loop) and _raster_kernel (K3,
// its 2D tiles x chunks fallback), both launched by rasterize_pallas for the
// giant level of rasterize_binned.  One kernel serves both: the pair of TPU
// grids only differed in how the chunk loop was scheduled.
//
// What bounds it.  A frame's giant table has ~160 chunks of 8 rows and a
// tile overlaps about one of them, so the (pixel, row) work is small (~8
// rows a pixel) and the output write (4-8 bytes a pixel) sets the floor;
// control flow repeated for every few pixels (a walk over the tile's
// overlap words, staging barriers) would cost far more than that work:
//   * a block takes 1,024 pixels of one tile (4 warps, each an 8 x 32
//     rectangle; a thread holds 8 pixels of one row in registers), so a
//     tile's overlap words are read by tile_pixels / 1024 blocks, not / 256;
//   * the words are read in one coalesced pass of 128 and turned into the
//     ascending list of live chunks with __ballot_sync / __popc;
//   * the live chunks' rows are staged with one barrier as the records of
//     raster_common.cuh, whose warp skip and evaluation K1 shares; tables
//     with more live rows than one window (kWindow rows) are walked window
//     by window, and more than 128 chunks pass by pass: one path for every
//     table size.
// Bound now: the output write (4-8 bytes a pixel) and the two dependent
// loads of a block's scan and staging.  On an H100 the two launches of a
// 1080p frame take 0.061 ms; the 85 MB they move take 0.0255 ms, while the
// corner tests and the edge tests of the 10.5 M (pixel, row) pairs the
// warp skip keeps take 0.0016 ms at the f32 peak (chip_smoke.py;
// python3 -m unclerenderer_tpu_torch.sweeps.raster).
//
// Exactness (the threshold, the warp skip, the tie rule): raster_common.cuh,
// shared with binned_raster.cu.  Every row of every live chunk is evaluated
// for every pixel unless the warp skip proves that no pixel of the warp
// passes its edge test; an invalid row is staged with a failing threshold.
// Live chunks and their rows are visited in ascending order, so equal keys
// go to the smallest row.  Output: raw key (-1 = miss) and the
// winner's int32 GLOBAL id via the ids map (the TPU kernel emitted it as an
// f32 record column, exact only below 2^24; here it is an integer load).
//
// want_attrs (fused resolve; replaces the wide-record branch of both TPU
// kernels, _emit_records' one-hot dot over records[g_idx]): each pixel's
// winning row's record, read through its global id from a (T, R) f32
// table, copied to a (tiles, pix, R) output, zeros where no row won
// (raster_common.cuh emit_records).  Tables of any size take the same path
// (the TPU's grid form K3 took over above 4,096 rows with wide records).
// The 1.1 GB image write bounds it: the fused 1080p frame's launch takes
// 0.38 ms on an H100 (0.027 without records) against a 0.35 ms bound,
// index_select of the same winners' rows 1.35 ms (chip_smoke.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

using raster::centre;

constexpr int kPix = 8;                // pixels a thread, one row
constexpr int kRectH = 8, kRectW = 32;  // a warp's pixels: kRectH rows of kRowThreads x kPix
constexpr int kRowThreads = 32 / kRectH;
static_assert(kRowThreads * kPix == kRectW && kPix % 4 == 0, "a warp covers its rectangle");
constexpr int kWarps = 4;              // rectangles (1,024 pixels) a block
constexpr int kThreads = 32 * kWarps;
constexpr int kScan = kThreads;        // overlap words a pass
constexpr int kWindow = 256;           // rows staged at once

template <bool kWantIds, bool kOrtho, bool kWantAttrs>
__global__ void __launch_bounds__(kThreads)
giant_raster_kernel(const float* __restrict__ coef, const float* __restrict__ valid,
                    const int* __restrict__ overlap, const int* __restrict__ ids,
                    const float* __restrict__ rec, float* __restrict__ out_key,
                    int* __restrict__ out_id, float* __restrict__ out_attr, int r_cols,
                    int n_chunks, int chunk, int tile_h, int tile_w, int n_tx, float y_off,
                    int rects_x, int n_rects) {
  static_assert(kWantIds || !kWantAttrs, "records follow the winning ids");
  // float4s a record (raster_common.cuh); its tag is the table row
  constexpr int kF4 = (kOrtho && !kWantIds) ? 4 : 5;
  __shared__ float4 s_rec[kWindow * kF4];
  __shared__ int s_live[kScan];
  __shared__ int s_count[kWarps];

  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rect = blockIdx.y * kWarps + warp;
  const bool active = rect < n_rects;  // idle warps still stage and meet barriers
  const int ry = (rect / rects_x) * kRectH, rx = (rect % rects_x) * kRectW;
  const int py = ry + lane / kRowThreads, px0 = rx + (lane % kRowThreads) * kPix;
  const float x0 = static_cast<float>((tile % n_tx) * tile_w);
  const float y0 = __fadd_rn(static_cast<float>((tile / n_tx) * tile_h), y_off);
  const float qy = centre(y0, py);
  float qx[kPix], best[kPix];
  int brow[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    qx[k] = centre(x0, px0 + k);
    best[k] = -1.f;
    brow[k] = -1;
  }
  const float2 xs = make_float2(centre(x0, rx), centre(x0, rx + kRectW - 1));
  const float2 ys = make_float2(centre(y0, ry), centre(y0, ry + kRectH - 1));
  const int per_window = kWindow / chunk;
  const int* ov = overlap + static_cast<size_t>(tile) * n_chunks;

  for (int base = 0; base < n_chunks; base += kScan) {
    // this pass's live chunks, ascending, in s_live[0, n_live)
    const int c = base + threadIdx.x;
    const bool live = c < n_chunks && ov[c] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_count[warp] = __popc(m);
    __syncthreads();
    int before = 0, n_live = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = s_count[w];
      before += w < warp ? n : 0;
      n_live += n;
    }
    if (live) s_live[before + __popc(m & ((1u << lane) - 1u))] = c;

    for (int l0 = 0; l0 < n_live; l0 += per_window) {
      const int rows = min(per_window, n_live - l0) * chunk;
      __syncthreads();  // s_live written; the previous window is no longer read
      for (int i = threadIdx.x; i < rows; i += kThreads) {
        const int cc = s_live[l0 + i / chunk], s = i % chunk;
        const float* cf = coef + static_cast<size_t>(cc) * 16 * chunk + s;
        float v[15];
#pragma unroll
        for (int j = 0; j < 15; ++j) v[j] = (kOrtho && j >= 12) ? 0.f : cf[j * chunk];
        const bool ok = valid[static_cast<size_t>(cc) * chunk + s] > 0.f;
        raster::put_record<kF4>(s_rec + i * kF4, v, ok, __int_as_float(cc * chunk + s));
      }
      __syncthreads();
      if (!active) continue;
      raster::evaluate<kPix, kF4, kOrtho, false>(s_rec, rows, lane, xs, ys, qy, qx, best, brow);
    }
    __syncthreads();  // s_count and s_live are rewritten by the next pass
  }

  if (!active) return;
  const size_t o = static_cast<size_t>(tile) * tile_h * tile_w + static_cast<size_t>(py) * tile_w;
  int gid[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k)
    gid[k] = brow[k] < 0 ? -1 : (ids != nullptr ? ids[brow[k]] : brow[k]);
  if (kWantAttrs) {
    const int n_in = py < tile_h ? max(0, min(kPix, tile_w - px0)) : 0;
    raster::emit_records<kPix>(rec, r_cols, out_attr, lane, gid,
                               static_cast<long long>(o + px0), n_in);
  }
  if (py >= tile_h) return;
  if (tile_w % kPix == 0) {  // kPix whole pixels, 16-byte aligned
    if (px0 >= tile_w) return;
#pragma unroll
    for (int v = 0; v < kPix / 4; ++v) {
      reinterpret_cast<float4*>(out_key + o + px0)[v] =
          make_float4(best[4 * v], best[4 * v + 1], best[4 * v + 2], best[4 * v + 3]);
      if (kWantIds)
        reinterpret_cast<int4*>(out_id + o + px0)[v] =
            make_int4(gid[4 * v], gid[4 * v + 1], gid[4 * v + 2], gid[4 * v + 3]);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (px0 + k >= tile_w) break;
    out_key[o + px0 + k] = best[k];
    if (kWantIds) out_id[o + px0 + k] = gid[k];
  }
}

template <bool kWantIds, bool kOrtho, bool kWantAttrs = false>
void launch(const float* coef, const float* valid, const int* overlap, const int* ids,
            float* out_key, int* out_id, int n_tiles, int n_chunks, int chunk, int tile_h,
            int tile_w, int n_tx, float y_off, cudaStream_t stream,
            const float* rec = nullptr, float* out_attr = nullptr, int r_cols = 0) {
  const int rects_x = (tile_w + kRectW - 1) / kRectW;
  const int n_rects = rects_x * ((tile_h + kRectH - 1) / kRectH);
  const dim3 grid(n_tiles, (n_rects + kWarps - 1) / kWarps);
  giant_raster_kernel<kWantIds, kOrtho, kWantAttrs><<<grid, kThreads, 0, stream>>>(
      coef, valid, overlap, ids, rec, out_key, out_id, out_attr, r_cols, n_chunks, chunk, tile_h,
      tile_w, n_tx, y_off, rects_x, n_rects);
}

}  // namespace

extern "C" int giant_raster(const float* coef, const float* valid, const int* overlap,
                            const int* ids, float* out_key, int* out_id, int n_tiles,
                            int n_chunks, int chunk, int tile_h, int tile_w, int n_tx,
                            float y_off, int want_ids, int ortho, void* stream) {
  if (chunk < 1 || chunk > kWindow) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (want_ids) {
    if (ortho)
      launch<true, true>(coef, valid, overlap, ids, out_key, out_id, n_tiles, n_chunks, chunk,
                         tile_h, tile_w, n_tx, y_off, s);
    else
      launch<true, false>(coef, valid, overlap, ids, out_key, out_id, n_tiles, n_chunks, chunk,
                          tile_h, tile_w, n_tx, y_off, s);
  } else {
    if (ortho)
      launch<false, true>(coef, valid, overlap, ids, out_key, out_id, n_tiles, n_chunks, chunk,
                          tile_h, tile_w, n_tx, y_off, s);
    else
      launch<false, false>(coef, valid, overlap, ids, out_key, out_id, n_tiles, n_chunks, chunk,
                           tile_h, tile_w, n_tx, y_off, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// want_attrs: keys and global ids as giant_raster with want_ids, plus each
// pixel's winning row's record (r_cols floats of rec, the row of its global
// id; zeros where no row won) in out_attr (n_tiles, tile_h * tile_w, r_cols)
extern "C" int giant_raster_attrs(const float* coef, const float* valid, const int* overlap,
                                  const int* ids, const float* rec, float* out_key, int* out_id,
                                  float* out_attr, int n_tiles, int n_chunks, int chunk,
                                  int tile_h, int tile_w, int n_tx, float y_off, int r_cols,
                                  int ortho, void* stream) {
  if (chunk < 1 || chunk > kWindow || r_cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (ortho)
    launch<true, true, true>(coef, valid, overlap, ids, out_key, out_id, n_tiles, n_chunks, chunk,
                             tile_h, tile_w, n_tx, y_off, s, rec, out_attr, r_cols);
  else
    launch<true, false, true>(coef, valid, overlap, ids, out_key, out_id, n_tiles, n_chunks,
                              chunk, tile_h, tile_w, n_tx, y_off, s, rec, out_attr, r_cols);
  return static_cast<int>(cudaGetLastError());
}
