// K7: seamless packed-env decode, one RGBA trilinear cube sample per pixel
// from ONE row of the packed env atlas (cube=True rows, >= 72 lanes).
//
// Replaces unclerenderer_tpu/ops/texture.py _env_select_kernel (via
// _env_select_call, called from sample_cube_pyramid_tri under
// RenderSettings.env_select_kernel).  Row lanes 0:16 are the mip-L quad,
// 16:52 the parent 3x3 at mip L+1, 52:72 the baked cross-face border texels
// L, T, corner, L2, T2 that a bilinear base index of -1 needs.  Per channel:
// tap a picks its 2x2 by (m_ix > 0.5, m_iy > 0.5), tap b picks its 2x2 of
// the 3x3 by (cox < 0.5, roy < 0.5) -- cox/roy arrive UNCLIPPED, exactly as
// the Pallas kernel receives them -- then the mip lerp, in the Pallas
// kernel's expressions, with the multiply-adds XLA:CPU contracts in it as
// explicit __fmaf_rn and no other contraction (-fmad=false).
//
// The TPU call gathered each pixel's whole 128-lane row into a materialised
// (grid, 1024, 128) array and wrote 8 output lanes (4 of them padding).
// Here 4 threads serve one pixel, one per channel; each reads only its 8
// winning lanes straight from the (small, L2-resident) env atlas by
// env_rows and writes the 4 real channels of an (N, 4) output.
//
// Bound: scattered 2-byte reads from a table that stays in L2; the (9, N)
// parameters (36 B per pixel) are the largest stream, read coalesced.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// a * (1 - f) + b * f, contracted as XLA:CPU contracts the Pallas kernel
__device__ __forceinline__ float lerp_fa(float a, float b, float f) {
  return __fmaf_rn(a, __fsub_rn(1.0f, f), __fmul_rn(b, f));
}

__device__ __forceinline__ float lerp_fb(float a, float b, float f) {
  return __fmaf_rn(b, f, __fmul_rn(a, __fsub_rn(1.0f, f)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
env_select_kernel(const T* __restrict__ env, const int* __restrict__ env_rows,
                  const float* __restrict__ params, float* __restrict__ out, int64_t n,
                  int lanes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n * 4) return;
  const int64_t p = i >> 2;
  const int ch = static_cast<int>(i & 3);
  const T* row = env + static_cast<int64_t>(env_rows[p]) * lanes + ch;
  auto lane = [&](int k) { return widen(__ldg(row + k)); };

  const float fx = params[p], fy = params[n + p];
  const float fx2 = params[2 * n + p], fy2 = params[3 * n + p];
  const float frac = params[4 * n + p];
  const bool m_ix = params[5 * n + p] > 0.5f;
  const bool m_iy = params[6 * n + p] > 0.5f;
  const int i0 = params[7 * n + p] < 0.5f ? 0 : 1;
  const int j0 = params[8 * n + p] < 0.5f ? 0 : 1;

  // tap a: lanes of TL, TR, BL, BR (quad 0/4/8/12, borders L 52, T 56,
  // corner 60, L2 64, T2 68)
  int tl, tr, bl, br;
  if (m_ix && m_iy) {
    tl = 60; tr = 56; bl = 52; br = 0;
  } else if (m_ix) {
    tl = 52; tr = 0; bl = 64; br = 8;
  } else if (m_iy) {
    tl = 56; tr = 68; bl = 0; br = 4;
  } else {
    tl = 0; tr = 4; bl = 8; br = 12;
  }
  const float a = lerp_fa(lerp_fb(lane(tl), lane(tr), fx), lerp_fb(lane(bl), lane(br), fx), fy);

  // tap b: 3x3 cell (j, i) at lane 16 + (j * 3 + i) * 4
  const int c00 = 16 + (j0 * 3 + i0) * 4;
  const float b = lerp_fa(lerp_fa(lane(c00), lane(c00 + 4), fx2),
                          lerp_fa(lane(c00 + 12), lane(c00 + 16), fx2), fy2);
  out[i] = lerp_fb(a, b, frac);
}

}  // namespace

extern "C" int env_select(const void* env, const int* env_rows, const float* params,
                          float* out, long long n, int lanes, int is_bf16, void* stream) {
  const int64_t total = static_cast<int64_t>(n) * 4;
  if (total > 0) {
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    auto s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
      env_select_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(env),
                                                    env_rows, params, out, n, lanes);
    else
      env_select_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(env), env_rows,
                                                    params, out, n, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}
