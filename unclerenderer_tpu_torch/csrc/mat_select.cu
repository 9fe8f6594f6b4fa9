// K8: packed-trilinear material decode, one C-channel trilinear sample per
// pixel from ONE 16C-lane row of the packed atlas.
//
// Replaces unclerenderer_tpu/ops/texture.py _mat_select_kernel (via
// _mat_select_call, called from sample_pyramid_tri under
// RenderSettings.mat_select_kernel).  Row lanes 0:4C are the mip-L bilinear
// quad (TL, TR, BL, BR), lanes 4C:13C the parent texel's 3x3 at mip L+1.
// Per channel: u8 -> f32 as (float)(int)byte * (1/255) with gamma 2
// (x * x) on channels {0,1,2,8,9,10} of C=16, tap-a quad blend, tap-b 2x2
// picked from the 3x3 by (cox < 0.5, roy < 0.5), mip lerp -- the Pallas
// kernel's expressions, with the multiply-adds XLA:CPU contracts in it as
// explicit __fmaf_rn and no other contraction (-fmad=false).
//
// The TPU call first gathered every pixel's whole row into a materialised
// (grid, 1024, 16C) array in HBM (530 MB of u8 rows at 1080p) and decoded
// all 13C lanes in VMEM.  Here C threads serve one pixel, one per channel;
// each reads only its 8 winning lanes straight from the atlas by rows_idx
// (4 quad lanes + the 2x2 of the 3x3), so no row array exists and 5 of the
// 13 lanes are never decoded.
//
// Bound: latency of scattered row reads (2M rows of 256 B from a ~200 MB
// atlas at 1080p).  Neighbouring threads read neighbouring bytes of one
// row, so each quarter-row read is one transaction; parameters are read as
// (7, N) rows (coalesced across pixels) and the (N, C) output is written
// contiguously.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float decode(T v, bool gamma);

template <>
__device__ __forceinline__ float decode<uint8_t>(uint8_t v, bool gamma) {
  const float x = __fmul_rn(static_cast<float>(static_cast<int>(v)),
                            static_cast<float>(1.0 / 255.0));
  return gamma ? __fmul_rn(x, x) : x;
}

template <>
__device__ __forceinline__ float decode<float>(float v, bool) { return v; }

template <>
__device__ __forceinline__ float decode<__nv_bfloat16>(__nv_bfloat16 v, bool) {
  return __bfloat162float(v);
}

// a * (1 - f) + b * f, contracted as XLA:CPU contracts the Pallas kernel:
// fma(a, 1 - f, b * f) for the taps, fma(b, f, a * (1 - f)) for the mip lerp
__device__ __forceinline__ float lerp_fa(float a, float b, float f) {
  return __fmaf_rn(a, __fsub_rn(1.0f, f), __fmul_rn(b, f));
}

__device__ __forceinline__ float lerp_fb(float a, float b, float f) {
  return __fmaf_rn(b, f, __fmul_rn(a, __fsub_rn(1.0f, f)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mat_select_kernel(const T* __restrict__ atlas, const int* __restrict__ rows_idx,
                  const float* __restrict__ params, float* __restrict__ out, int64_t n,
                  int c, int lanes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n * c) return;
  const int64_t p = i / c;
  const int ch = static_cast<int>(i - p * c);
  const bool gamma = (ch < 3) || (ch >= 8 && ch < 11);
  const T* row = atlas + static_cast<int64_t>(rows_idx[p]) * lanes + ch;

  const float fx = params[p], fy = params[n + p];
  const float fx2 = params[2 * n + p], fy2 = params[3 * n + p];
  const float frac = params[4 * n + p];
  const int i0 = params[5 * n + p] < 0.5f ? 0 : 1;  // 3x3 column of the base
  const int j0 = params[6 * n + p] < 0.5f ? 0 : 1;  // 3x3 row of the base

  const float q00 = decode(__ldg(row), gamma);
  const float q10 = decode(__ldg(row + c), gamma);
  const float q01 = decode(__ldg(row + 2 * c), gamma);
  const float q11 = decode(__ldg(row + 3 * c), gamma);
  const T* r3 = row + 4 * c;  // lane of 3x3 cell (j, i): (j * 3 + i) * c
  const float tl2 = decode(__ldg(r3 + (j0 * 3 + i0) * c), gamma);
  const float tr2 = decode(__ldg(r3 + (j0 * 3 + i0 + 1) * c), gamma);
  const float bl2 = decode(__ldg(r3 + ((j0 + 1) * 3 + i0) * c), gamma);
  const float br2 = decode(__ldg(r3 + ((j0 + 1) * 3 + i0 + 1) * c), gamma);

  const float a = lerp_fa(lerp_fa(q00, q10, fx), lerp_fa(q01, q11, fx), fy);
  const float b = lerp_fa(lerp_fa(tl2, tr2, fx2), lerp_fa(bl2, br2, fx2), fy2);
  out[i] = lerp_fb(a, b, frac);
}

}  // namespace

// dtype: 0 = u8, 1 = f32, 2 = bf16
extern "C" int mat_select(const void* atlas, const int* rows_idx, const float* params,
                          float* out, long long n, int c, int lanes, int dtype,
                          void* stream) {
  const int64_t total = static_cast<int64_t>(n) * c;
  if (total > 0) {
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
      mat_select_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const uint8_t*>(atlas),
                                                    rows_idx, params, out, n, c, lanes);
    else if (dtype == 1)
      mat_select_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(atlas),
                                                    rows_idx, params, out, n, c, lanes);
    else
      mat_select_kernel<<<blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(atlas), rows_idx, params, out, n, c, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}
