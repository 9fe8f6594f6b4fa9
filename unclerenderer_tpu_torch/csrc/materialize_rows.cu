// K9: identity copy of a 4-byte-element array into a fresh buffer.
//
// Replaces unclerenderer_tpu/ops/pallas_raster.py _mat_kernel (via
// materialize_rows), which the reference's bin_triangles runs on the
// block-aligned index array blocks_tid under RenderSettings.bin_mat_idx
// before the coefficient gather: on the TPU a real kernel boundary forced
// XLA to materialise the in-graph indices.  The port computes the same
// thing -- a bit-exact copy, launched as a kernel (not a library copy).
//
// Bound: bandwidth, 8 bytes moved per element (~2 MB per binning level at
// 1080p).  16-byte vector loads and stores when both buffers are 16-byte
// aligned, a scalar pass for the remainder.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
copy_vec4(const int4* __restrict__ src, int4* __restrict__ dst, int64_t n4) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n4) dst[i] = __ldg(src + i);
}

__global__ void __launch_bounds__(kThreads)
copy_scalar(const int* __restrict__ src, int* __restrict__ dst, int64_t start, int64_t n) {
  const int64_t i = start + static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) dst[i] = __ldg(src + i);
}

}  // namespace

extern "C" int materialize_rows(const int* src, int* dst, long long n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const int64_t n4 = aligned ? n / 4 : 0;
  if (n4 > 0)
    copy_vec4<<<static_cast<unsigned>((n4 + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        reinterpret_cast<const int4*>(src), reinterpret_cast<int4*>(dst), n4);
  const int64_t rest = n - 4 * n4;
  if (rest > 0)
    copy_scalar<<<static_cast<unsigned>((rest + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        src, dst, 4 * n4, n);
  return static_cast<int>(cudaGetLastError());
}
