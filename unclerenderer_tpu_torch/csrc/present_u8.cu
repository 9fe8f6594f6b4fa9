// present_u8: a frame's f32 colour as the UNORM backbuffer stores it, on the
// card: u8 = clamp(rint(x * 255), 0, 255), round half to even.
//
// Replaces no TPU kernel.  The reference converts on the host
// (unclerenderer_tpu/render/renderer.py:779 render_to_u8,
// np.clip(np.rint(color * 255.0), 0, 255).astype(np.uint8)); so did the port's
// present, after copying the 24.9 MB f32 colour of a 1080p frame to pageable
// host memory, with the card idle for both.  Converting here leaves 6.2 MB to
// read back.
//
// Bytes equal to numpy's formula on every finite input, halves included:
// __fmul_rn is the f32 product numpy takes (no contraction), rintf rounds half
// to even as np.rint does, and the clamp is exact.  +inf gives 255 and -inf 0;
// NaN gives 0, as numpy's cast gives on x86-64: the clamp tests `v > 0`, which
// NaN fails (fminf(NaN, 255) would give 255).
//
// Bound: bandwidth, 4n bytes read and n written (31.1 MB at 1080p: 9.3 us at
// 3.35 TB/s).
//
// Design: ONE launch per call, as copy_bytes.cu.  Where the source is 16-byte
// and the destination 4-byte aligned (buffers from the allocator are), each
// thread loads four floats as one 16-byte vector and stores their four bytes
// as one 4-byte word; the first (n mod 4) threads also convert the scalar
// tail (1080p colour is n = 6,220,800, a multiple of 4).  A misaligned view
// takes one element a thread.  The grid is not capped: blocks retire in
// address order, so the pass streams through memory as one moving window.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned char to_u8(float x) {
  const float v = rintf(__fmul_rn(x, 255.0f));
  return static_cast<unsigned char>(v > 0.0f ? fminf(v, 255.0f) : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
present_quads(const float4* __restrict__ src, uchar4* __restrict__ dst, int64_t quads,
              const float* __restrict__ tail_src, unsigned char* __restrict__ tail_dst,
              int tail) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < quads) {
    const float4 x = __ldg(src + i);
    dst[i] = make_uchar4(to_u8(x.x), to_u8(x.y), to_u8(x.z), to_u8(x.w));
  }
  if (i < tail) tail_dst[i] = to_u8(__ldg(tail_src + i));
}

__global__ void __launch_bounds__(kThreads)
present_scalars(const float* __restrict__ src, unsigned char* __restrict__ dst, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) dst[i] = to_u8(__ldg(src + i));
}

}  // namespace

extern "C" int present_u8(const void* src, void* dst, long long n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(src);
  auto* y = static_cast<unsigned char*>(dst);
  if (n > 0) {
    if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && reinterpret_cast<uintptr_t>(dst) % 4 == 0) {
      const int64_t quads = n / 4;
      const int tail = static_cast<int>(n - quads * 4);  // < 4: block 0 covers it
      const int64_t blocks = quads > 0 ? (quads + kThreads - 1) / kThreads : 1;
      present_quads<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          reinterpret_cast<const float4*>(x), reinterpret_cast<uchar4*>(y), quads,
          x + quads * 4, y + quads * 4, tail);
    } else {
      present_scalars<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
          x, y, n);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
