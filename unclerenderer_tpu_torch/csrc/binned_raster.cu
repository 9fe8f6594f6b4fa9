// K1: binned visibility raster, one bin level (fine or mid).
//
// Replaces unclerenderer_tpu/ops/pallas_raster.py _binned_kernel (launched by
// _run_binned_kernel / rasterize_binned).  The TPU kernel walked bin blocks
// in order on one core and revisited each tile's output block; here every
// tile is one thread block that walks its own contiguous block range
// [tile_start, tile_start + tile_count), so tiles need no atomics.
//
// What bounds it: the (pixel, valid slot) pairs whose edge tests run, how
// evenly they fall on the warps that meet at each barrier (the rows that
// survive the warp skip crowd into a few rectangles), and a frame's
// busiest tile (at 1080p a 16 x 64 camera tile holds 29 bin blocks against
// a mean of 5).  On an H100 the four launches of a 1080p frame take 0.37
// ms against a bound of 0.058 ms, the 193 MB they move (the corner tests
// and the edge tests of the 103 M (pixel, row) pairs the skip keeps take
// 0.016 ms at the f32 peak; chip_smoke.py); ~0.14 ms is launch, staging
// and the output write (measured with evaluation removed), the rest the
// kept rows, unevenly spread over a tile's warps
// (python3 -m unclerenderer_tpu_torch.sweeps.raster).  The design:
//   * Pixels: a warp owns a 16 x 8 rectangle of the tile (16 rows of 2
//     threads), a thread 4 pixels of one row (so b*qy is one multiply for
//     4 pixels): small rectangles let the warp skip drop more rows.
//     A block covers 2 rectangles (256 pixels), so no pixel slot is dead at
//     the frame's tiles and a barrier waits on few warps.
//   * Busy tiles: every tile gets up to 32 warps.  The warps beyond one a
//     rectangle form G groups that each cover the block's rectangles and
//     take every G-th bin block of the tile (a 16 x 64 tile: 4 blocks of 4
//     groups; a 32 x 128 tile of 32 rectangles: 16 blocks of 1); the
//     groups' winners are merged in shared memory at the end (max key,
//     then min id: exact in any order).  Groups pay where tiles hold many
//     blocks (the camera's 16 x 64 fine tiles) and idle where they hold 0-1.
//   * Staging: a bin block's 16 x chunk coefficients, valid flags and ids
//     are one contiguous run each, copied with cp.async; block b+1 is in
//     flight while block b is evaluated.  Each valid slot becomes a record
//     of raster_common.cuh (invalid slots are compacted away with ballots).
//   * Skip: each lane tests one of 32 records for its whole warp, and the
//     warp then evaluates only the records whose edges may pass
//     (raster_common.cuh, shared with giant_raster.cu).
//
// want_attrs (fused resolve; replaces the want_attrs branch of
// _binned_kernel, its _emit_records one-hot dot): with a (T, R) f32 record
// table indexed by the slots' ids, each pixel's winning row's record is
// copied to a (tiles, pix, R) output, zeros where no row won.  The TPU
// kernel gathered a record for every (block, slot) pair and selected the
// winner's with a one-hot matmul per block; here the record is read only
// for the final winner, after the group merge (raster_common.cuh
// emit_records): R * 4 bytes a pixel read and written, nothing per slot.
// The writes bound it: at R = 128 the fused 1080p frame's two camera
// launches write 2.1 GB; on an H100 they take 0.89 ms (0.18 without
// records) against a 0.66 ms bound, and index_select of the same winners'
// rows takes 2.52 ms (chip_smoke.py).
//
// debug_print (replaces the kernel_debug_print branch of _binned_kernel,
// its pl.debug_print of every live grid step): the binned_raster_debug
// entry launches the same kernel with kDebug set, so the default entries'
// code is unchanged.  One thread a live bin block prints
// "binned raster: block <b> -> tile <t>" with device printf, b the block's
// index in the level's block arrays before fit_binned_blocks recut them
// (the wrapper passes the recut factor).  The TPU kernel printed at its
// grid step; here the lines arrive in no order.  Device printf drops what
// overflows its FIFO, and the runtime lets the FIFO grow only before the
// process's first launch of a kernel that prints (PyTorch's device asserts
// count), so the wrapper checks the FIFO against the launch's block slots
// (a static bound of its lines) and raises where they may not fit
// (printf_fifo below; ops/_cuda.py).
//
// Exactness (the threshold, the warp skip, the min-id tie rule):
// raster_common.cuh.  The group merge applies the same tie rule, so the
// order in which groups visit blocks is free.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "raster_common.cuh"

namespace {

using raster::centre;

constexpr int kPix = 4;                 // pixels a thread, one row
constexpr int kRectH = 16, kRectW = 8;  // a warp's pixels: kRectH rows of kRowThreads x kPix
constexpr int kRowThreads = 32 / kRectH;
static_assert(kRowThreads * kPix == kRectW && kPix % 4 == 0, "a warp covers its rectangle");
constexpr int kPartRects = 2;           // rectangles (256 pixels) a block
constexpr int kTileWarps = 32;          // warps a tile gets, over blocks and groups
constexpr int kMaxThreads = 256;
constexpr int kMaxChunk = 128;          // four ballots of valid flags

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool kWantIds, bool kOrtho, bool kWantAttrs, bool kDebug>
__global__ void __launch_bounds__(kMaxThreads)
binned_raster_kernel(const float* __restrict__ coef, const int* __restrict__ tri_id,
                     const float* __restrict__ valid, const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, const float* __restrict__ records,
                     float* __restrict__ out_key, int* __restrict__ out_id,
                     float* __restrict__ out_attr, int r_cols, int chunk, int tile_h,
                     int tile_w, int n_tx, float y_off, int rects_x, int n_rects, int groups,
                     int recut) {
  static_assert(kWantIds || !kWantAttrs, "records follow the winning ids");
  // float4s a record (raster_common.cuh); its tag is the row's id
  constexpr int kF4 = (kOrtho && !kWantIds) ? 4 : 5;
  constexpr int kRaw = kWantIds ? 18 : 17;  // raw floats a slot: 16 coef, valid, id
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp / kPartRects;  // this warp's group
  const int rect = blockIdx.y * kPartRects + warp % kPartRects;  // of the tile
  const bool active = rect < n_rects;  // idle warps still stage and meet barriers
  const int g_threads = 32 * kPartRects, gt = threadIdx.x - g * g_threads;
  float4* raw = smem + g * (kRaw * chunk / 4 + kF4 * chunk);  // this group's staging
  float4* rec = raw + kRaw * chunk / 4;

  const int tile = blockIdx.x;
  if (kDebug && blockIdx.y == 0) {
    // the tile's live blocks, one line each (a recut block's first run)
    for (int j = threadIdx.x; j < tile_count[tile]; j += blockDim.x) {
      const int b = tile_start[tile] + j;
      if (b % recut == 0) printf("binned raster: block %d -> tile %d\n", b / recut, tile);
    }
  }
  const int ry = (rect / rects_x) * kRectH, rx = (rect % rects_x) * kRectW;
  const int py = ry + lane / kRowThreads, px0 = rx + (lane % kRowThreads) * kPix;
  const float x0 = static_cast<float>((tile % n_tx) * tile_w);
  const float y0 = __fadd_rn(static_cast<float>((tile / n_tx) * tile_h), y_off);
  const float qy = centre(y0, py);
  float qx[kPix], best[kPix];
  int bid[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    qx[k] = centre(x0, px0 + k);
    best[k] = -1.f;
    bid[k] = -1;
  }
  const float2 xs = make_float2(centre(x0, rx), centre(x0, rx + kRectW - 1));
  const float2 ys = make_float2(centre(y0, ry), centre(y0, ry + kRectH - 1));

  // this group's copy of bin block b: coef [16][chunk], valid [chunk], ids [chunk]
  auto stage = [&](int b) {
    const float4* c4 = reinterpret_cast<const float4*>(coef + static_cast<size_t>(b) * 16 * chunk);
    const float4* v4 = reinterpret_cast<const float4*>(valid + static_cast<size_t>(b) * chunk);
    const float4* t4 = reinterpret_cast<const float4*>(tri_id + static_cast<size_t>(b) * chunk);
    for (int i = gt; i < 4 * chunk; i += g_threads) copy16(raw + i, c4 + i);
    for (int i = gt; i < chunk / 4; i += g_threads) {
      copy16(raw + 4 * chunk + i, v4 + i);
      if (kWantIds) copy16(raw + 4 * chunk + chunk / 4 + i, t4 + i);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int b0 = tile_start[tile], nb = tile_count[tile];
  if (g < nb) stage(b0 + g);
  for (int j = g; j - g < nb; j += groups) {
    copies_done();
    __syncthreads();  // block j has landed for every thread; the records are free
    // valid slots -> records, compacted in slot order
    const float* rc = reinterpret_cast<const float*>(raw);
    const float* rv = rc + 16 * chunk;
    unsigned mk[kMaxChunk / 32];
    int n = 0;
#pragma unroll
    for (int q = 0; q < kMaxChunk / 32; ++q) {
      const int s = 32 * q + lane;
      mk[q] = __ballot_sync(0xffffffffu, j < nb && s < chunk && rv[s] > 0.f);
      n += __popc(mk[q]);
    }
    for (int s = gt; s < chunk; s += g_threads) {  // s % 32 == lane
      const int q = s >> 5;
      int pos = 0;
      unsigned mq = 0;
#pragma unroll
      for (int u = 0; u < kMaxChunk / 32; ++u) {
        pos += u < q ? __popc(mk[u]) : 0;
        mq = u == q ? mk[u] : mq;
      }
      if (!((mq >> lane) & 1u)) continue;
      pos += __popc(mq & ((1u << lane) - 1u));
      float v[15];
#pragma unroll
      for (int i = 0; i < 15; ++i) v[i] = (kOrtho && i >= 12) ? 0.f : rc[i * chunk + s];
      raster::put_record<kF4>(rec + pos * kF4, v, true, kWantIds ? rv[chunk + s] : 0.f);
    }
    __syncthreads();  // records ready; the raw buffer is free
    if (j + groups < nb) stage(b0 + j + groups);
    if (!active) continue;

    raster::evaluate<kPix, kF4, kOrtho, kWantIds>(rec, n, lane, xs, ys, qy, qx, best, bid);
  }

  const int merged = min(groups, nb);  // groups that saw a block
  if (merged > 1) {
    // groups 1.. hand their winners to group 0 through shared memory: slot
    // (h, k, gt) holds pixel k of thread gt of group h (all groups' thread
    // gt hold the same pixels)
    float* s_key = reinterpret_cast<float*>(smem);
    int* s_id = reinterpret_cast<int*>(s_key + (groups - 1) * kPix * g_threads);
    __syncthreads();
    if (g > 0 && g < merged) {
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const int i = ((g - 1) * kPix + k) * g_threads + gt;
        s_key[i] = best[k];
        if (kWantIds) s_id[i] = bid[k];
      }
    }
    __syncthreads();
    if (g == 0) {
      for (int h = 1; h < merged; ++h) {
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const int i = ((h - 1) * kPix + k) * g_threads + gt;
          const float key = s_key[i];
          const int t = kWantIds ? s_id[i] : 0;
          if (key > best[k] || (kWantIds && key == best[k] && key >= 0.f && t < bid[k])) {
            best[k] = key;
            bid[k] = t;
          }
        }
      }
    }
  }

  if (g != 0 || !active) return;
  const size_t o = static_cast<size_t>(tile) * tile_h * tile_w + static_cast<size_t>(py) * tile_w;
  if (kWantAttrs) {
    const int n_in = py < tile_h ? max(0, min(kPix, tile_w - px0)) : 0;
    raster::emit_records<kPix>(records, r_cols, out_attr, lane, bid,
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
            make_int4(bid[4 * v], bid[4 * v + 1], bid[4 * v + 2], bid[4 * v + 3]);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (px0 + k >= tile_w) break;
    out_key[o + px0 + k] = best[k];
    if (kWantIds) out_id[o + px0 + k] = bid[k];
  }
}

template <bool kWantIds, bool kOrtho, bool kWantAttrs = false, bool kDebug = false>
int launch(const float* coef, const int* tri_id, const float* valid, const int* tile_start,
           const int* tile_count, float* out_key, int* out_id, int n_tiles, int chunk,
           int tile_h, int tile_w, int n_tx, float y_off, cudaStream_t stream,
           const float* rec = nullptr, float* out_attr = nullptr, int r_cols = 0,
           int recut = 1) {
  constexpr int kF4 = (kOrtho && !kWantIds) ? 4 : 5;
  constexpr int kRaw = kWantIds ? 18 : 17;
  if (chunk < 4 || chunk > kMaxChunk || chunk % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rects_x = (tile_w + kRectW - 1) / kRectW;
  const int n_rects = rects_x * ((tile_h + kRectH - 1) / kRectH);
  // kTileWarps warps a tile, within 256 threads and 4 staged 64-slot blocks (39 KB)
  int groups = kTileWarps / n_rects;
  const int by_threads = kMaxThreads / 32 / kPartRects, by_smem = 256 / chunk;
  groups = groups < by_threads ? groups : by_threads;
  groups = groups < by_smem ? groups : by_smem;
  groups = groups > 1 ? groups : 1;
  const int threads = 32 * kPartRects * groups;
  const size_t stage = static_cast<size_t>(groups) * chunk * (4 * kRaw + 16 * kF4);
  const size_t merge = static_cast<size_t>(groups - 1) * threads / groups * kPix * 4 *
                       (kWantIds ? 2 : 1);
  const dim3 grid(n_tiles, (n_rects + kPartRects - 1) / kPartRects);
  binned_raster_kernel<kWantIds, kOrtho, kWantAttrs, kDebug>
      <<<grid, threads, stage > merge ? stage : merge, stream>>>(
          coef, tri_id, valid, tile_start, tile_count, rec, out_key, out_id, out_attr, r_cols,
          chunk, tile_h, tile_w, n_tx, y_off, rects_x, n_rects, groups, recut);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int binned_raster(const float* coef, const int* tri_id, const float* valid,
                             const int* tile_start, const int* tile_count, float* out_key,
                             int* out_id, int n_tiles, int chunk, int tile_h, int tile_w,
                             int n_tx, float y_off, int want_ids, int ortho, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (want_ids)
    return ortho ? launch<true, true>(coef, tri_id, valid, tile_start, tile_count, out_key,
                                      out_id, n_tiles, chunk, tile_h, tile_w, n_tx, y_off, s)
                 : launch<true, false>(coef, tri_id, valid, tile_start, tile_count, out_key,
                                       out_id, n_tiles, chunk, tile_h, tile_w, n_tx, y_off, s);
  return ortho ? launch<false, true>(coef, tri_id, valid, tile_start, tile_count, out_key,
                                     out_id, n_tiles, chunk, tile_h, tile_w, n_tx, y_off, s)
               : launch<false, false>(coef, tri_id, valid, tile_start, tile_count, out_key,
                                      out_id, n_tiles, chunk, tile_h, tile_w, n_tx, y_off, s);
}

// want_attrs: keys and ids as binned_raster with want_ids, plus each pixel's
// winning row's record (r_cols floats of rec, the row of its id; zeros where
// no row won) in out_attr (n_tiles, tile_h * tile_w, r_cols)
extern "C" int binned_raster_attrs(const float* coef, const int* tri_id, const float* valid,
                                   const int* tile_start, const int* tile_count,
                                   const float* rec, float* out_key, int* out_id,
                                   float* out_attr, int n_tiles, int chunk, int tile_h,
                                   int tile_w, int n_tx, float y_off, int r_cols, int ortho,
                                   void* stream) {
  if (r_cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return ortho ? launch<true, true, true>(coef, tri_id, valid, tile_start, tile_count, out_key,
                                          out_id, n_tiles, chunk, tile_h, tile_w, n_tx, y_off,
                                          s, rec, out_attr, r_cols)
               : launch<true, false, true>(coef, tri_id, valid, tile_start, tile_count, out_key,
                                           out_id, n_tiles, chunk, tile_h, tile_w, n_tx, y_off,
                                           s, rec, out_attr, r_cols);
}

// kernel_debug_print: binned_raster (rec == nullptr) or binned_raster_attrs
// (rec != nullptr, want_ids set) with each live block's line printed; recut:
// the blocks fit_binned_blocks made of each block of the level
extern "C" int binned_raster_debug(const float* coef, const int* tri_id, const float* valid,
                                   const int* tile_start, const int* tile_count,
                                   const float* rec, float* out_key, int* out_id,
                                   float* out_attr, int n_tiles, int chunk, int tile_h,
                                   int tile_w, int n_tx, float y_off, int r_cols, int want_ids,
                                   int ortho, int recut, void* stream) {
  if (recut < 1 || (rec != nullptr && (r_cols < 1 || !want_ids)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (rec != nullptr)
    return ortho ? launch<true, true, true, true>(coef, tri_id, valid, tile_start, tile_count,
                                                  out_key, out_id, n_tiles, chunk, tile_h,
                                                  tile_w, n_tx, y_off, s, rec, out_attr, r_cols,
                                                  recut)
                 : launch<true, false, true, true>(coef, tri_id, valid, tile_start, tile_count,
                                                   out_key, out_id, n_tiles, chunk, tile_h,
                                                   tile_w, n_tx, y_off, s, rec, out_attr, r_cols,
                                                   recut);
  if (want_ids)
    return ortho ? launch<true, true, false, true>(coef, tri_id, valid, tile_start, tile_count,
                                                   out_key, out_id, n_tiles, chunk, tile_h,
                                                   tile_w, n_tx, y_off, s, nullptr, nullptr, 0,
                                                   recut)
                 : launch<true, false, false, true>(coef, tri_id, valid, tile_start, tile_count,
                                                    out_key, out_id, n_tiles, chunk, tile_h,
                                                    tile_w, n_tx, y_off, s, nullptr, nullptr, 0,
                                                    recut);
  return ortho ? launch<false, true, false, true>(coef, tri_id, valid, tile_start, tile_count,
                                                  out_key, out_id, n_tiles, chunk, tile_h,
                                                  tile_w, n_tx, y_off, s, nullptr, nullptr, 0,
                                                  recut)
               : launch<false, false, false, true>(coef, tri_id, valid, tile_start, tile_count,
                                                   out_key, out_id, n_tiles, chunk, tile_h,
                                                   tile_w, n_tx, y_off, s, nullptr, nullptr, 0,
                                                   recut);
}

// The device printf FIFO of the current device: grown to `bytes` where it
// is smaller and the runtime allows it (before the first launch of a kernel
// that prints); returns its size in bytes after, or -1 if unreadable.
extern "C" long long printf_fifo(long long bytes) {
  size_t fifo = 0;
  if (cudaDeviceGetLimit(&fifo, cudaLimitPrintfFifoSize) != cudaSuccess) return -1;
  if (static_cast<long long>(fifo) < bytes &&
      cudaDeviceSetLimit(cudaLimitPrintfFifoSize, static_cast<size_t>(bytes)) == cudaSuccess)
    cudaDeviceGetLimit(&fifo, cudaLimitPrintfFifoSize);
  cudaGetLastError();  // a refused growth leaves no error for the next launch to report
  return static_cast<long long>(fifo);
}
