// The design that the two raster kernels share: binned_raster.cu (K1, the
// fine and mid bin levels) and giant_raster.cu (K2, the giant level).
//
// A warp owns a rectangle of its tile's pixels, a thread kPix pixels of one
// row in registers.  The rows (triangles) a warp may meet are staged in
// shared memory as records of kF4 float4s, read back as broadcasts:
//   e0, e1, e2       (a, b, c, lo) of the three edge functions;
//   (za, zb, zc, f)  the depth numerator; f = 0 where an edge coefficient is
//                    not finite (such a row is never skipped);
//   (wa, wb, wc, t)  the depth denominator and the row's tag (K1: its id;
//                    K2: its table row), left out (kF4 = 4) where an ortho
//                    depth-only call needs neither.
// A staged run of records is evaluated in 32-record steps: lane l tests
// record r0 + l for the whole warp at the rectangle's corners (the skip
// below), and the warp then evaluates only the records that may pass, in
// ascending order.
//
// Exactness.  The arithmetic is the reference's contraction pattern with
// round-to-nearest intrinsics (built with -fmad=false):
//   ev = (a*qx + b*qy) + c  ->  fma(a, qx, b*qy) + c;  key = nz / nw (IEEE).
//   * Top-left threshold: inside <=> ev > 0 || (ev == 0 && top-left) <=>
//     ev >= lo with lo = 0 on a top-left edge and lo = 2^-149 (the least
//     positive float, nothing lies strictly between it and 0) otherwise;
//     NaN fails both.  A row staged as invalid gets lo = NaN and fails
//     everywhere.
//   * Warp skip: with finite a, b, c and finite pixel centres, each
//     rounded step (b*qy, fma, + c) is monotone in its operands, so the
//     computed ev is monotone in qx (direction sign a) and in qy (sign b)
//     and takes no NaN.  Its largest value over the warp's rectangle is at
//     the corner (a > 0 ? x_max : x_min, b > 0 ? y_max : y_min); if that is
//     below lo, every pixel fails the edge and the row changes nothing.
//   * Ties: a larger key wins; with kMinTag an equal key wins where its tag
//     is smaller (K1: min id, in any visiting order).  Without it an equal
//     key never displaces an earlier one (K2: rows ascend, so equal keys go
//     to the smallest row).
#pragma once

#include <cuda_runtime.h>

namespace raster {

__device__ __forceinline__ float lin(float a, float b, float c, float qx, float qy) {
  return __fadd_rn(__fmaf_rn(a, qx, __fmul_rn(b, qy)), c);
}

// ev >= edge_floor(a, b)  <=>  (ev > 0) || (ev == 0 && top-left edge)
__device__ __forceinline__ float edge_floor(float a, float b) {
  return (a > 0.f || (a == 0.f && b > 0.f)) ? 0.f : __int_as_float(1);
}

// some pixel of the rectangle may pass edge e (x, y: its extreme centres)
__device__ __forceinline__ bool reach(float4 e, float2 x, float2 y) {
  return lin(e.x, e.y, e.z, e.x > 0.f ? x.y : x.x, e.y > 0.f ? y.y : y.x) >= e.w;
}

__device__ __forceinline__ float centre(float origin, int offset) {
  return __fadd_rn(__fadd_rn(origin, static_cast<float>(offset)), 0.5f);
}

// The record of a row from its 15 coefficients (edge a x3, edge b x3, edge
// c x3, depth numerator, denominator); ok = false stages an invalid row.
template <int kF4>
__device__ __forceinline__ void put_record(float4* r, const float (&v)[15], bool ok, float tag) {
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 9; ++i) finite = finite && isfinite(v[i]);
#pragma unroll
  for (int e = 0; e < 3; ++e)
    r[e] = make_float4(v[e], v[3 + e], v[6 + e],
                       ok ? edge_floor(v[e], v[3 + e]) : __int_as_float(0x7fc00000));
  r[3] = make_float4(v[9], v[10], v[11], finite ? 1.f : 0.f);
  if (kF4 == 5) r[4] = make_float4(v[12], v[13], v[14], tag);
}

// Records rec[0, n) against this thread's kPix pixels (centres qx[k], qy)
// of a warp rectangle with extreme centres xs, ys: best key and its tag.
template <int kPix, int kF4, bool kOrtho, bool kMinTag>
__device__ __forceinline__ void evaluate(const float4* rec, int n, int lane, float2 xs,
                                         float2 ys, float qy, const float (&qx)[kPix],
                                         float (&best)[kPix], int (&win)[kPix]) {
  for (int r0 = 0; r0 < n; r0 += 32) {
    // lane l tests record r0 + l for the whole warp
    bool may = false;
    if (r0 + lane < n) {
      const float4* r = rec + (r0 + lane) * kF4;
      may = r[3].w == 0.f || (reach(r[0], xs, ys) && reach(r[1], xs, ys) && reach(r[2], xs, ys));
    }
    for (unsigned todo = __ballot_sync(0xffffffffu, may); todo != 0; todo &= todo - 1) {
      const float4* r = rec + (r0 + __ffs(todo) - 1) * kF4;
      const float4 e0 = r[0], e1 = r[1], e2 = r[2], z = r[3];
      const float4 wr = kF4 == 5 ? r[4] : make_float4(0.f, 0.f, 1.f, 0.f);
      const float m0 = __fmul_rn(e0.y, qy), m1 = __fmul_rn(e1.y, qy);
      const float m2 = __fmul_rn(e2.y, qy), mz = __fmul_rn(z.y, qy);
      const int t = __float_as_int(wr.w);
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        bool hit = __fadd_rn(__fmaf_rn(e0.x, qx[k], m0), e0.z) >= e0.w &&
                   __fadd_rn(__fmaf_rn(e1.x, qx[k], m1), e1.z) >= e1.w &&
                   __fadd_rn(__fmaf_rn(e2.x, qx[k], m2), e2.z) >= e2.w;
        float key = __fadd_rn(__fmaf_rn(z.x, qx[k], mz), z.z);
        if (!kOrtho) {
          const float nw = lin(wr.x, wr.y, wr.z, qx[k], qy);
          hit = hit && nw > 0.f;
          if (hit) key = __fdiv_rn(key, nw);
        }
        if (hit && key >= 0.f && key <= 1.f &&
            (key > best[k] || (kMinTag && key == best[k] && t < win[k]))) {
          best[k] = key;
          win[k] = t;
        }
      }
    }
  }
}

}  // namespace raster
