// K10: merge select  out = (ka > kb) ? a : b  over two id images and their
// keys (int32 ids, f32 keys, any equal length).
//
// Replaces tools/prof_r5.py _merge_k (merge_pallas), the TPU probe's
// jnp.where(ka > kb, a, b) on (8, W) row blocks of (H, W) images, which put
// the merge behind a kernel boundary ahead of a record gather.  Semantics
// are the IEEE compare: a NaN key on either side, equal keys and
// -0.0 vs +0.0 all choose b.  No tie-break by id: this is not the frame's
// level merge (ops/raster_kernels.py), and it is not on the frame path.
//
// Bound: bandwidth -- 16 bytes read (two keys, two ids) and 4 written per
// element, 41.5 MB at 1920x1080.  Each thread handles 4 elements with
// 16-byte vector loads and stores when all five buffers are 16-byte
// aligned; a scalar pass covers the tail (or everything when misaligned).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int pick(float ka, float kb, int a, int b) { return ka > kb ? a : b; }

__global__ void __launch_bounds__(kThreads)
merge_vec4(const int4* __restrict__ a, const int4* __restrict__ b, const float4* __restrict__ ka,
           const float4* __restrict__ kb, int4* __restrict__ out, int64_t n4) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n4) return;
  const float4 x = __ldg(ka + i), y = __ldg(kb + i);
  const int4 va = __ldg(a + i), vb = __ldg(b + i);
  out[i] = make_int4(pick(x.x, y.x, va.x, vb.x), pick(x.y, y.y, va.y, vb.y),
                     pick(x.z, y.z, va.z, vb.z), pick(x.w, y.w, va.w, vb.w));
}

__global__ void __launch_bounds__(kThreads)
merge_scalar(const int* __restrict__ a, const int* __restrict__ b, const float* __restrict__ ka,
             const float* __restrict__ kb, int* __restrict__ out, int64_t start, int64_t n) {
  const int64_t i = start + static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = pick(__ldg(ka + i), __ldg(kb + i), __ldg(a + i), __ldg(b + i));
}

unsigned blocks(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int merge_select(const int* a, const int* b, const float* ka, const float* kb,
                            int* out, long long n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t any = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(ka) | reinterpret_cast<uintptr_t>(kb) |
                        reinterpret_cast<uintptr_t>(out);
  const int64_t n4 = (any & 15) == 0 ? n / 4 : 0;
  if (n4 > 0)
    merge_vec4<<<blocks(n4), kThreads, 0, s>>>(
        reinterpret_cast<const int4*>(a), reinterpret_cast<const int4*>(b),
        reinterpret_cast<const float4*>(ka), reinterpret_cast<const float4*>(kb),
        reinterpret_cast<int4*>(out), n4);
  const int64_t rest = n - 4 * n4;
  if (rest > 0)
    merge_scalar<<<blocks(rest), kThreads, 0, s>>>(a, b, ka, kb, out, 4 * n4, n);
  return static_cast<int>(cudaGetLastError());
}
