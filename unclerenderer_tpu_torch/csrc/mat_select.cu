// K8: packed-trilinear material decode, one 16-channel trilinear sample per
// pixel from ONE 256-lane row of the packed atlas.
//
// Replaces unclerenderer_tpu/ops/texture.py _mat_select_kernel (via
// _mat_select_call, called from sample_pyramid_tri under
// RenderSettings.mat_select_kernel, only at C = 16 channels).  Row lanes
// 0:4C are the mip-L bilinear quad (TL, TR, BL, BR), lanes 4C:13C the parent
// texel's 3x3 at mip L+1.  Per channel: u8 -> f32 as (float)(int)byte *
// (1/255) with gamma 2 (x * x) on channels {0,1,2,8,9,10}, tap-a quad blend,
// tap-b 2x2 picked from the 3x3 by (cox < 0.5, roy < 0.5), mip lerp -- the
// Pallas kernel's expressions, with the multiply-adds XLA:CPU contracts in it
// as explicit __fmaf_rn and no other contraction (-fmad=false).
//
// The TPU call first gathered every pixel's whole row into a materialised
// (grid, 1024, 16C) array in HBM and decoded all 13C lanes in VMEM.  Here
// each pixel reads only its 8 winning lane groups (the quad and the 2x2 of
// the 3x3) straight from the atlas by rows_idx: no row array exists and 5 of
// the 13 groups are never read.
//
// What bounds it: bytes.  At 1080p (2,073,600 pixels) the (N, 16) f32 output
// is 133 MB, params7 58 MB, rows_idx 8 MB and the distinct rows' 8 groups
// ~32 MB: 0.069 ms at 3.35 TB/s (chip_smoke.py).  On an H100 this kernel
// takes 0.114 ms there (the one before it, a thread a (pixel, channel),
// 0.230).  The design keeps the instructions per byte low, so that the
// loads stay in flight:
//   * kTpp threads a pixel, each holding kC / kTpp channels: one vector load
//     of each lane group and float4 stores of its channels (u8 at kTpp = 2,
//     shipped: one 8-byte load a group, two float4 stores, 16 pixels a
//     warp; kTpp = 4 and 1 ran 7% and 4% slower);
//   * a pixel's row index and 7 parameters are read once: the pixel's kTpp
//     lanes each load some of the 8 values and pass them on with __shfl_sync
//     (kShfl, shipped), or every lane loads all 8 through L1;
//   * kPpt pixels a thread, their loads issued before any is decoded (1
//     shipped: 2 and 4 cost registers and ran slower);
//   * C = 16 is a compile-time constant, so the pixel index is 32-bit math
//     with no divide (only row and output offsets are 64-bit), and the gamma
//     channels are a mask fixed by the thread's channel group.
// python3 -m unclerenderer_tpu_torch.sweeps.select times these choices.
// Element types: u8 (the frame's atlas), f32 and bf16 (the same template,
// the vector width set by the element size).  The atlas must be 16-byte
// aligned (checked by the wrapper); params7 and rows_idx take scalar loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 16;           // channels a material sample holds
constexpr int kLanes = 16 * kC;  // lanes a packed row holds
constexpr int kThreads = 256;

struct U8 { static constexpr int kSize = 1; };
struct F32 { static constexpr int kSize = 4; };
struct BF16 { static constexpr int kSize = 2; };

// element j of the little-endian words w as f32
template <typename T>
__device__ __forceinline__ float element(const uint32_t* w, int j, bool gamma);

template <>
__device__ __forceinline__ float element<U8>(const uint32_t* w, int j, bool gamma) {
  const int v = static_cast<int>((w[j >> 2] >> (8 * (j & 3))) & 0xffu);
  const float x = __fmul_rn(static_cast<float>(v), static_cast<float>(1.0 / 255.0));
  return gamma ? __fmul_rn(x, x) : x;
}

template <>
__device__ __forceinline__ float element<F32>(const uint32_t* w, int j, bool) {
  return __uint_as_float(w[j]);
}

template <>
__device__ __forceinline__ float element<BF16>(const uint32_t* w, int j, bool) {
  const uint32_t h = w[j >> 1];
  return __uint_as_float((j & 1) ? (h & 0xffff0000u) : (h << 16));
}

// kBytes bytes at p (aligned to min(kBytes, 16)) as 32-bit words
template <int kBytes>
__device__ __forceinline__ void load(const unsigned char* p, uint32_t* w) {
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (kBytes == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else {
    static_assert(kBytes == 4, "a thread reads whole 32-bit words of a lane group");
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// a value read once: streaming (kCs) or through the read-only path
template <bool kCs>
__device__ __forceinline__ float value(const float* p) {
  return kCs ? __ldcs(p) : __ldg(p);
}

// a * (1 - f) + b * f, contracted as XLA:CPU contracts the Pallas kernel:
// fma(a, 1 - f, b * f) for the taps, fma(b, f, a * (1 - f)) for the mip lerp
__device__ __forceinline__ float lerp_fa(float a, float b, float f) {
  return __fmaf_rn(a, __fsub_rn(1.0f, f), __fmul_rn(b, f));
}

__device__ __forceinline__ float lerp_fb(float a, float b, float f) {
  return __fmaf_rn(b, f, __fmul_rn(a, __fsub_rn(1.0f, f)));
}

// kTpp threads a pixel, kPpt pixels a thread; kShfl: the pixel's 8 values
// (row index, 7 parameters) loaded by its lanes in turn and shuffled; kCs:
// those loads and the output stores marked streaming (evict first), so that
// the atlas rows keep their place in L2
template <typename T, int kTpp, int kPpt, bool kShfl, bool kCs>
__global__ void __launch_bounds__(kThreads)
mat_select_kernel(const unsigned char* __restrict__ atlas, const int* __restrict__ rows_idx,
                  const float* __restrict__ params, float* __restrict__ out, int n) {
  constexpr int kCh = kC / kTpp;             // channels a thread
  constexpr int kBytes = kCh * T::kSize;     // bytes a thread reads of a lane group
  constexpr int kWords = kBytes / 4;
  constexpr int kGroup = kC * T::kSize;      // bytes a lane group
  constexpr int kRow = kLanes * T::kSize;    // bytes a row
  constexpr int kSlots = kThreads / kTpp;    // pixels a block takes per step
  static_assert(32 % kTpp == 0 && kCh % 4 == 0 && kBytes % 4 == 0, "thread layout");
  const int q = threadIdx.x % kTpp;          // this thread's channel group
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * (kSlots * kPpt) + threadIdx.x / kTpp;

  // value v of pixel p: v = 0 the row index (as bits), v = 1..7 params7[v - 1]
  auto source = [&](int v, int p) {
    return v == 0 ? reinterpret_cast<const float*>(rows_idx) + p
                  : params + static_cast<size_t>(v - 1) * n + p;
  };
  float val[kPpt][8];
#pragma unroll
  for (int k = 0; k < kPpt; ++k) {
    const int p = first + k * kSlots;
    const bool ok = p < n;
    if (kShfl) {
      float mine[8 / kTpp];
#pragma unroll
      for (int r = 0; r < 8 / kTpp; ++r) mine[r] = ok ? value<kCs>(source(r * kTpp + q, p)) : 0.f;
#pragma unroll
      for (int v = 0; v < 8; ++v)
        val[k][v] = __shfl_sync(0xffffffffu, mine[v / kTpp], (lane & ~(kTpp - 1)) | (v % kTpp));
    } else {
#pragma unroll
      for (int v = 0; v < 8; ++v) val[k][v] = ok ? value<kCs>(source(v, p)) : 0.f;
    }
  }

  // the 8 lane groups: quad TL, TR, BL, BR, then the 2x2 of the 3x3 (cell
  // (j, i) is group 4 + 3j + i); a pixel past n reads row 0
  uint32_t w[kPpt][8][kWords];
#pragma unroll
  for (int k = 0; k < kPpt; ++k) {
    const int row = __float_as_int(val[k][0]);
    const int i0 = val[k][6] < 0.5f ? 0 : 1;  // 3x3 column of the base
    const int j0 = val[k][7] < 0.5f ? 0 : 1;  // 3x3 row of the base
    const int cell = 4 + j0 * 3 + i0;
    const unsigned char* r = atlas + static_cast<int64_t>(row) * kRow + q * kBytes;
#pragma unroll
    for (int g = 0; g < 4; ++g) load<kBytes>(r + g * kGroup, w[k][g]);
    load<kBytes>(r + cell * kGroup, w[k][4]);
    load<kBytes>(r + (cell + 1) * kGroup, w[k][5]);
    load<kBytes>(r + (cell + 3) * kGroup, w[k][6]);
    load<kBytes>(r + (cell + 4) * kGroup, w[k][7]);
  }

#pragma unroll
  for (int k = 0; k < kPpt; ++k) {
    const int p = first + k * kSlots;
    if (p >= n) continue;
    const float fx = val[k][1], fy = val[k][2], fx2 = val[k][3], fy2 = val[k][4];
    const float frac = val[k][5];
    float o[kCh];
#pragma unroll
    for (int j = 0; j < kCh; ++j) {
      // gamma channels {0,1,2,8,9,10}: (channel mod 8) < 3
      const bool gamma = T::kSize == 1 && ((q * kCh + j) & 7) < 3;
      float v[8];
#pragma unroll
      for (int g = 0; g < 8; ++g) v[g] = element<T>(w[k][g], j, gamma);
      const float a = lerp_fa(lerp_fa(v[0], v[1], fx), lerp_fa(v[2], v[3], fx), fy);
      const float b = lerp_fa(lerp_fa(v[4], v[5], fx2), lerp_fa(v[6], v[7], fx2), fy2);
      o[j] = lerp_fb(a, b, frac);
    }
    float4* dst = reinterpret_cast<float4*>(out + static_cast<int64_t>(p) * kC + q * kCh);
#pragma unroll
    for (int i = 0; i < kCh / 4; ++i) {
      const float4 v = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
      if (kCs)
        __stcs(dst + i, v);
      else
        dst[i] = v;
    }
  }
}

template <typename T, int kTpp, int kPpt, bool kShfl, bool kCs>
int launch(const void* atlas, const int* rows_idx, const float* params, float* out, long long n,
           cudaStream_t stream) {
  // a 32-bit pixel index: at 2^31 pixels the (N, 16) f32 output alone would
  // be 137 GB, more than the card holds
  if (n < 0 || n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kPerBlock = kThreads / kTpp * kPpt;
  if (n > 0)
    mat_select_kernel<T, kTpp, kPpt, kShfl, kCs>
        <<<static_cast<unsigned>((n + kPerBlock - 1) / kPerBlock), kThreads, 0, stream>>>(
            static_cast<const unsigned char*>(atlas), rows_idx, params, out, static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = u8, 1 = f32, 2 = bf16; the atlas is (rows, 256), 16-byte aligned
extern "C" int mat_select(const void* atlas, const int* rows_idx, const float* params,
                          float* out, long long n, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<U8, 2, 1, true, false>(atlas, rows_idx, params, out, n, s);
    case 1: return launch<F32, 4, 1, true, false>(atlas, rows_idx, params, out, n, s);
    case 2: return launch<BF16, 4, 1, true, false>(atlas, rows_idx, params, out, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
