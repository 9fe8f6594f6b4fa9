// K2/K3: giant-level visibility raster (brute force over a small table).
//
// Replaces unclerenderer_tpu/ops/pallas_raster.py _raster_kernel_onepass
// (K2, 1D tile grid with an in-kernel chunk loop) and _raster_kernel (K3,
// its 2D tiles x chunks fallback), both launched by rasterize_pallas for the
// giant level of rasterize_binned.  One kernel serves both: the pair of TPU
// grids only differed in how the chunk loop was scheduled.
//
// Bound: ALU (edge evaluations per live (pixel, triangle) pair).  The giant
// table holds tens of triangles that each cover many tiles, so the cost is
// set by the skip granularity: a chunk whose overlap bit for the tile is
// clear is skipped with one uniform branch; a live chunk's 16 x chunk
// coefficients are staged in shared memory and read as warp broadcasts.
// One thread per pixel keeps its best key and row in registers.
//
// Output: raw key (-1 = miss) and the winner's int32 GLOBAL id via the
// ids map (the TPU kernel emitted it as an f32 record column, exact only
// below 2^24; here it is an integer load).  Ties resolve to the smallest
// row, i.e. the smallest global id (rows ascend in global id).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
giant_raster_kernel(const float* __restrict__ coef, const float* __restrict__ valid,
                    const int* __restrict__ overlap, const int* __restrict__ ids,
                    float* __restrict__ out_key, int* __restrict__ out_id, int n_chunks,
                    int chunk, int tile_h, int tile_w, int n_tx, float y_off) {
  extern __shared__ float smem[];
  float* s_coef = smem;                // [16][chunk]
  float* s_valid = smem + 16 * chunk;  // [chunk]

  const int tile = blockIdx.x;
  const int pix = tile_h * tile_w;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  const float x0 = static_cast<float>((tile % n_tx) * tile_w);
  const float y0 = __fadd_rn(static_cast<float>((tile / n_tx) * tile_h), y_off);
  const float qx = __fadd_rn(__fadd_rn(x0, static_cast<float>(p % tile_w)), 0.5f);
  const float qy = __fadd_rn(__fadd_rn(y0, static_cast<float>(p / tile_w)), 0.5f);

  float best = -1.f;
  int brow = -1;
  const int* ov = overlap + static_cast<size_t>(tile) * n_chunks;
  for (int c = 0; c < n_chunks; ++c) {
    if (ov[c] == 0) continue;  // uniform across the block
    __syncthreads();
    for (int i = threadIdx.x; i < 16 * chunk; i += kThreads)
      s_coef[i] = coef[static_cast<size_t>(c) * 16 * chunk + i];
    for (int i = threadIdx.x; i < chunk; i += kThreads)
      s_valid[i] = valid[static_cast<size_t>(c) * chunk + i];
    __syncthreads();
    if (p >= pix) continue;
    for (int s = 0; s < chunk; ++s) {
      if (!(s_valid[s] > 0.f)) continue;
      if (!(inside(s_coef[0 * chunk + s], s_coef[3 * chunk + s], s_coef[6 * chunk + s], qx, qy) &&
            inside(s_coef[1 * chunk + s], s_coef[4 * chunk + s], s_coef[7 * chunk + s], qx, qy) &&
            inside(s_coef[2 * chunk + s], s_coef[5 * chunk + s], s_coef[8 * chunk + s], qx, qy)))
        continue;
      float key = lin(s_coef[9 * chunk + s], s_coef[10 * chunk + s], s_coef[11 * chunk + s], qx, qy);
      if (!kOrtho) {
        const float nw =
            lin(s_coef[12 * chunk + s], s_coef[13 * chunk + s], s_coef[14 * chunk + s], qx, qy);
        if (!(nw > 0.f)) continue;
        key = __fdiv_rn(key, nw);
      }
      if (!(key >= 0.f && key <= 1.f)) continue;
      // rows are visited in ascending order: a later equal key never wins
      if (key > best) {
        best = key;
        brow = c * chunk + s;
      }
    }
  }
  if (p >= pix) return;
  const size_t o = static_cast<size_t>(tile) * pix + p;
  out_key[o] = best;
  if (kWantIds) out_id[o] = brow < 0 ? -1 : (ids != nullptr ? ids[brow] : brow);
}

template <bool kWantIds, bool kOrtho>
void launch(const float* coef, const float* valid, const int* overlap, const int* ids,
            float* out_key, int* out_id, int n_tiles, int n_chunks, int chunk, int tile_h,
            int tile_w, int n_tx, float y_off, cudaStream_t stream) {
  const int pix = tile_h * tile_w;
  const dim3 grid(n_tiles, (pix + kThreads - 1) / kThreads);
  const size_t smem = sizeof(float) * (16 * chunk + chunk);
  giant_raster_kernel<kWantIds, kOrtho><<<grid, kThreads, smem, stream>>>(
      coef, valid, overlap, ids, out_key, out_id, n_chunks, chunk, tile_h, tile_w, n_tx, y_off);
}

}  // namespace

extern "C" int giant_raster(const float* coef, const float* valid, const int* overlap,
                            const int* ids, float* out_key, int* out_id, int n_tiles,
                            int n_chunks, int chunk, int tile_h, int tile_w, int n_tx,
                            float y_off, int want_ids, int ortho, void* stream) {
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
