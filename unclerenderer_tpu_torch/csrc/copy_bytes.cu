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
// Bound: bandwidth, 2 x nbytes moved.  The paths' K9 and K12 copies are
// 2-8 MB (1-5 us of traffic at 3.35 TB/s) and pay mostly the launch and the
// grid's ramp; K11's 0.13 and 0.53 GB copies are bandwidth-bound.
//
// Design: ONE launch per call, whatever the alignment and length.  The word
// is the widest of 16, 8, 4, 2 or 1 bytes that divides both addresses
// (buffers from the allocator are 16-byte aligned, so every call on the
// paths moves 16-byte vectors; a view that starts mid-word moves narrower
// words); each thread copies one word, and the first (nbytes mod word)
// threads also copy the byte tail, in the same launch.  The grid is not
// capped: blocks retire in address order, so the copy streams through
// memory as one moving window.  A grid capped at 4-64 blocks per SM with a
// grid-stride loop and 2-4 loads in flight per thread ran 2-8% slower at
// K11's sizes and at most 0.13 us faster at 2-8 MB, where the launch's
// host cost dwarfs it (unclerenderer_tpu_torch/sweeps/copy_grid.py;
// PERF.md).
//
// No TMA: a bulk copy (cp.async.bulk) goes from device memory through
// shared memory back to device memory, a hop the 16-byte register path does
// not take, and its barriers and issuing thread add set-up to every tile.
// At 2-8 MB the copy is launch-bound, so that set-up can only add time; at
// 0.5 GB the register path already runs at ~90% of the bandwidth bound,
// level with PyTorch's clone, and a TMA copy cannot pass the same memory's
// rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename W>
__global__ void __launch_bounds__(kThreads)
copy_words(const W* __restrict__ src, W* __restrict__ dst, int64_t n,
           const uint8_t* __restrict__ tail_src, uint8_t* __restrict__ tail_dst, int tail) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) dst[i] = __ldg(src + i);
  if (i < tail) tail_dst[i] = __ldg(tail_src + i);
}

template <typename W>
void launch_words(const void* src, void* dst, int64_t nbytes, cudaStream_t s) {
  const int64_t n = nbytes / static_cast<int64_t>(sizeof(W));
  const int64_t body = n * static_cast<int64_t>(sizeof(W));
  const int tail = static_cast<int>(nbytes - body);  // < 16: block 0 covers it
  const int64_t blocks = n > 0 ? (n + kThreads - 1) / kThreads : 1;
  copy_words<W><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const W*>(src), static_cast<W*>(dst), n,
      static_cast<const uint8_t*>(src) + body, static_cast<uint8_t*>(dst) + body, tail);
}

}  // namespace

extern "C" int copy_bytes(const void* src, void* dst, long long nbytes, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t both = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst);
  if (nbytes > 0) {
    if (both % 16 == 0)
      launch_words<uint4>(src, dst, nbytes, s);
    else if (both % 8 == 0)
      launch_words<uint2>(src, dst, nbytes, s);
    else if (both % 4 == 0)
      launch_words<unsigned>(src, dst, nbytes, s);
    else if (both % 2 == 0)
      launch_words<unsigned short>(src, dst, nbytes, s);
    else
      launch_words<unsigned char>(src, dst, nbytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}
