// K9, K11, K12: identity copy of any array into a fresh buffer, by bytes.
//
// Replaces three TPU identity kernels, each a hard materialisation boundary
// for XLA on the TPU:
//   K9  unclerenderer_tpu/ops/pallas_raster.py _mat_kernel (materialize_rows),
//       the block-aligned index array of every binning level under
//       RenderSettings.bin_mat_idx (int32);
//   K11 tools/prof_tap_bisect.py _pl_copy, gathered texture rows (the probe's
//       (2,073,600, 16) int32 and (2,073,600, 64) f32 rows; its pad to
//       1024-row blocks only served the TPU grid: the result is the input);
//   K12 tools/prof_fuse.py _id_kernel (materialize), the binning index array
//       and a merged id image (int32).
// The port computes the same thing -- a bit-exact copy, launched as a
// kernel (not a library copy); each caller keeps its own wrapper and launch
// count.
//
// Bound: bandwidth, 2 x nbytes moved.  16-byte vector loads and stores
// (one per thread) when both buffers are 16-byte aligned, a byte-wise pass
// for the tail, or for everything when either buffer is misaligned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
copy_vec16(const int4* __restrict__ src, int4* __restrict__ dst, int64_t n16) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n16) dst[i] = __ldg(src + i);
}

__global__ void __launch_bounds__(kThreads)
copy_byte(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int64_t start, int64_t n) {
  const int64_t i = start + static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) dst[i] = __ldg(src + i);
}

unsigned blocks(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int copy_bytes(const void* src, void* dst, long long nbytes, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const int64_t n16 = aligned ? nbytes / 16 : 0;
  if (n16 > 0)
    copy_vec16<<<blocks(n16), kThreads, 0, s>>>(static_cast<const int4*>(src),
                                                 static_cast<int4*>(dst), n16);
  const int64_t rest = nbytes - 16 * n16;
  if (rest > 0)
    copy_byte<<<blocks(rest), kThreads, 0, s>>>(static_cast<const uint8_t*>(src),
                                                static_cast<uint8_t*>(dst), 16 * n16, nbytes);
  return static_cast<int>(cudaGetLastError());
}
