// K1: binned visibility raster, one bin level (fine or mid).
//
// Replaces unclerenderer_tpu/ops/pallas_raster.py _binned_kernel (launched by
// _run_binned_kernel / rasterize_binned).  The TPU kernel walked bin blocks
// in order on one core and revisited each tile's output block; here every
// tile is one thread block that walks its own contiguous block range
// [tile_start, tile_start + tile_count), so blocks need no order and tiles
// no atomics: max-key / min-id is commutative.
//
// Bound: ALU -- each (pixel, slot) pair costs three edge functions, the
// depth numerator and denominator and one IEEE divide (~20 FP ops).  The
// design keeps the block's 16 x chunk coefficients, ids and valid flags in
// shared memory (read as warp broadcasts), keeps each pixel's best key and
// id in registers for the whole tile, and writes every pixel once.  Dead
// budget blocks belong to no tile and cost nothing.
//
// Bit-exactness: the arithmetic is the reference's contraction pattern,
// written with explicit round-to-nearest intrinsics (built with -fmad=false):
//   ev  = (a*qx + b*qy) + c   ->  fma(a, qx, b*qy) + c
//   key = nz / nw              ->  IEEE division (__fdiv_rn)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kPixPerThread = 8;  // tiles up to 4096 pixels

__device__ __forceinline__ float lin(float a, float b, float c, float qx, float qy) {
  return __fadd_rn(__fmaf_rn(a, qx, __fmul_rn(b, qy)), c);
}

__device__ __forceinline__ bool inside(float a, float b, float c, float qx, float qy) {
  const float ev = lin(a, b, c, qx, qy);
  const bool tl = (a > 0.f) || (a == 0.f && b > 0.f);
  return (ev > 0.f) || (ev == 0.f && tl);
}

template <bool kWantIds, bool kOrtho>
__global__ void __launch_bounds__(kThreads)
binned_raster_kernel(const float* __restrict__ coef, const int* __restrict__ tri_id,
                     const float* __restrict__ valid, const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, float* __restrict__ out_key,
                     int* __restrict__ out_id, int chunk, int tile_h, int tile_w, int n_tx,
                     float y_off) {
  extern __shared__ float smem[];
  float* s_coef = smem;                 // [16][chunk]
  float* s_valid = smem + 16 * chunk;   // [chunk]
  int* s_tid = reinterpret_cast<int*>(s_valid + chunk);  // [chunk]

  const int tile = blockIdx.x;
  const int pix = tile_h * tile_w;
  const float x0 = static_cast<float>((tile % n_tx) * tile_w);
  const float y0 = __fadd_rn(static_cast<float>((tile / n_tx) * tile_h), y_off);

  float qx[kPixPerThread], qy[kPixPerThread], best[kPixPerThread];
  int bid[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    qx[k] = __fadd_rn(__fadd_rn(x0, static_cast<float>(p % tile_w)), 0.5f);
    qy[k] = __fadd_rn(__fadd_rn(y0, static_cast<float>(p / tile_w)), 0.5f);
    best[k] = -1.f;
    bid[k] = -1;
  }

  const int b0 = tile_start[tile];
  const int nb = tile_count[tile];
  for (int bi = 0; bi < nb; ++bi) {
    const size_t b = static_cast<size_t>(b0 + bi);
    __syncthreads();  // previous block's smem is no longer read
    for (int i = threadIdx.x; i < 16 * chunk; i += kThreads) s_coef[i] = coef[b * 16 * chunk + i];
    for (int i = threadIdx.x; i < chunk; i += kThreads) {
      s_valid[i] = valid[b * chunk + i];
      if (kWantIds) s_tid[i] = tri_id[b * chunk + i];
    }
    __syncthreads();
    for (int s = 0; s < chunk; ++s) {
      if (!(s_valid[s] > 0.f)) continue;
      const float a0 = s_coef[0 * chunk + s], a1 = s_coef[1 * chunk + s], a2 = s_coef[2 * chunk + s];
      const float e0 = s_coef[3 * chunk + s], e1 = s_coef[4 * chunk + s], e2 = s_coef[5 * chunk + s];
      const float c0 = s_coef[6 * chunk + s], c1 = s_coef[7 * chunk + s], c2 = s_coef[8 * chunk + s];
      const float za = s_coef[9 * chunk + s], zb = s_coef[10 * chunk + s], zc = s_coef[11 * chunk + s];
      const float wa = s_coef[12 * chunk + s], wb = s_coef[13 * chunk + s], wc = s_coef[14 * chunk + s];
      const int t = kWantIds ? s_tid[s] : 0;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        if (threadIdx.x + k * kThreads >= pix) continue;
        if (!(inside(a0, e0, c0, qx[k], qy[k]) && inside(a1, e1, c1, qx[k], qy[k]) &&
              inside(a2, e2, c2, qx[k], qy[k])))
          continue;
        float key = lin(za, zb, zc, qx[k], qy[k]);
        if (!kOrtho) {
          const float nw = lin(wa, wb, wc, qx[k], qy[k]);
          if (!(nw > 0.f)) continue;
          key = __fdiv_rn(key, nw);
        }
        if (!(key >= 0.f && key <= 1.f)) continue;
        if (key > best[k] || (kWantIds && key == best[k] && t < bid[k])) {
          best[k] = key;
          bid[k] = t;
        }
      }
    }
  }

  const size_t base = static_cast<size_t>(tile) * pix;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (p >= pix) continue;
    out_key[base + p] = best[k];
    if (kWantIds) out_id[base + p] = bid[k];
  }
}

template <bool kWantIds, bool kOrtho>
void launch(const float* coef, const int* tri_id, const float* valid, const int* tile_start,
            const int* tile_count, float* out_key, int* out_id, int n_tiles, int chunk,
            int tile_h, int tile_w, int n_tx, float y_off, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (16 * chunk + chunk) + sizeof(int) * chunk;
  binned_raster_kernel<kWantIds, kOrtho><<<n_tiles, kThreads, smem, stream>>>(
      coef, tri_id, valid, tile_start, tile_count, out_key, out_id, chunk, tile_h, tile_w,
      n_tx, y_off);
}

}  // namespace

extern "C" int binned_raster(const float* coef, const int* tri_id, const float* valid,
                             const int* tile_start, const int* tile_count, float* out_key,
                             int* out_id, int n_tiles, int chunk, int tile_h, int tile_w,
                             int n_tx, float y_off, int want_ids, int ortho, void* stream) {
  if (tile_h * tile_w > kThreads * kPixPerThread) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (want_ids) {
    if (ortho)
      launch<true, true>(coef, tri_id, valid, tile_start, tile_count, out_key, out_id, n_tiles,
                         chunk, tile_h, tile_w, n_tx, y_off, s);
    else
      launch<true, false>(coef, tri_id, valid, tile_start, tile_count, out_key, out_id, n_tiles,
                          chunk, tile_h, tile_w, n_tx, y_off, s);
  } else {
    if (ortho)
      launch<false, true>(coef, tri_id, valid, tile_start, tile_count, out_key, out_id, n_tiles,
                          chunk, tile_h, tile_w, n_tx, y_off, s);
    else
      launch<false, false>(coef, tri_id, valid, tile_start, tile_count, out_key, out_id,
                           n_tiles, chunk, tile_h, tile_w, n_tx, y_off, s);
  }
  return static_cast<int>(cudaGetLastError());
}
