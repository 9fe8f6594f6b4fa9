// K5: exact row gather out[i, c] = float(table[idx[i], c]) for f32 and bf16
// tables.
//
// Replaces unclerenderer_tpu/ops/texture.py gather_rows_onehot_matmul (the
// kernel at :105), which the reference calls from render/common.py
// tri_draw_masks to gather the per-model visible / alpha-masked flags for
// every triangle.  The TPU did the gather as a one-hot x table matmul on
// the MXU because small-table row gathers were slow there, and it was
// limited to tables that fit VMEM.  A GPU gathers directly: no one-hot, no
// table-size limit, and the bf16 -> f32 widening is exact.
//
// Bound: bandwidth -- one index read and C output writes per row, the small
// table stays in L1/L2.  One thread per output element, consecutive
// threads on consecutive outputs (coalesced writes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                   float* __restrict__ out, int64_t total, int c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int64_t r = i / c;
  const int col = static_cast<int>(i - r * c);
  out[i] = widen(table[static_cast<int64_t>(idx[r]) * c + col]);
}

}  // namespace

extern "C" int gather_rows(const void* table, const int* idx, float* out, int n, int c,
                           int is_bf16, void* stream) {
  const int64_t total = static_cast<int64_t>(n) * c;
  if (total > 0) {
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    auto s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
      gather_rows_kernel<<<blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(table), idx, out, total, c);
    else
      gather_rows_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(table), idx,
                                                     out, total, c);
  }
  return static_cast<int>(cudaGetLastError());
}
