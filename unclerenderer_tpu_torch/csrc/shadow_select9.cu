// K4: PCF 3x3 neighbourhood fetch from the superblock shadow table, on u16
// rows (the default table) or f32 rows (shadow_table_u16=False).
//
// Replaces unclerenderer_tpu/ops/shadow.py _select9_kernel (via
// _select9_call / _select9_fetch / shadow_factor_blocks), which takes f32 or
// u16 rows.  The TPU path
// first gathered each receiver's whole 128-lane superblock row (256 B) into
// a materialised (grid, 1024, 128) array, then selected 9 lanes in VMEM.
// Here each receiver's 9 texels are read straight from the table, at lanes
// base + dy * (bw + 2) + dx of row `row` (dx, dy in 0..2; bw the block
// width), and written as f32 (u16 -> f32 is exact; an f32 lane is written
// as x + 0, the value of the TPU kernel's one-hot lane sum), so no row
// array exists.
//
// What bounds it: bytes.  At 1080p (2,073,600 receivers, a 4096^2 map in
// 8 x 8 blocks: a 67 MB u16 table, 134 MB f32) the (N, 9) f32 output is
// 74.6 MB, row and base 16.6 MB and the distinct texels ~3 MB (u16; ~6 MB
// f32): 0.028 ms at 3.35 TB/s (chip_smoke.py).  On an H100 the u16 kernel
// takes 0.036 ms there (the one before it 0.155).  The design moves those
// bytes in few, wide accesses:
//   * the deltas are compile-time (a template on bw = 4..8, the range of
//     ops/shadow.py shadow_block_shape), so the C entry takes bw and no
//     host array;
//   * u16 rows: a run of 3 adjacent lanes is read with one aligned 64-bit
//     load, and a 32-bit one where the run crosses it (kU64; or two aligned
//     32-bit loads): 3-6 loads a receiver, not 9;
//   * f32 rows (512 B): a run is one aligned 16-byte load, and an 8-byte one
//     where the run crosses it (run3_f32): 3-6 loads a receiver;
//   * a block stages its receivers' 9 x f32 in shared memory and writes them
//     as contiguous float4s (a scalar tail where 9 x receivers is no
//     multiple of 4), instead of 9 scalar stores at a 36-byte stride;
//   * kR = 2 receivers a thread, their loads issued before any is written;
//   * kCs: row, base and the output are streamed (evict first), so the
//     output write does not push the table out of L2.
// python3 -m unclerenderer_tpu_torch.sweeps.select times these choices on
// the u16 rows (the coalesced store took it to 0.042 ms, 2 receivers to
// 0.039, streaming and the 64-bit loads to 0.036).
// Every load stays inside the table: a word holding a lane that the plain
// version reads is whole, for a lane count that is a multiple of 8 (the
// wrapper checks lanes % 8 == 0 and a 16-byte aligned table).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// the 3 u16 lanes at flat lane e, from 32-bit words (kU64: 64-bit words)
template <bool kU64>
__device__ __forceinline__ uint64_t run3(const uint16_t* __restrict__ table, int64_t e) {
  uint32_t lo, hi;
  int shift;
  if (kU64) {
    // lanes 4f .. 4f+3 in one load; lanes 4f+4, 4f+5 only where the run
    // reaches them (e % 4 >= 2)
    const int64_t f = e >> 2;
    const uint2 d = __ldg(reinterpret_cast<const uint2*>(table) + f);
    const int r = static_cast<int>(e & 3);
    if (r < 2) {
      lo = d.x;
      hi = d.y;
    } else {
      lo = d.y;
      hi = __ldg(reinterpret_cast<const unsigned int*>(table) + 2 * f + 2);
    }
    shift = 16 * (r & 1);
  } else {
    const unsigned int* w = reinterpret_cast<const unsigned int*>(table) + (e >> 1);
    lo = __ldg(w);
    hi = __ldg(w + 1);
    shift = 16 * static_cast<int>(e & 1);
  }
  return ((static_cast<uint64_t>(hi) << 32) | lo) >> shift;
}

// the 3 f32 lanes at flat lane e: the aligned float4 holding lane e, and the
// float2 after it where the run reaches past it (e % 4 >= 2)
__device__ __forceinline__ float3 run3_f32(const float* __restrict__ table, int64_t e) {
  const int64_t f = e >> 2;
  const float4 d = __ldg(reinterpret_cast<const float4*>(table) + f);
  const int r = static_cast<int>(e & 3);
  if (r < 2) return r == 0 ? make_float3(d.x, d.y, d.z) : make_float3(d.y, d.z, d.w);
  const float2 nx = __ldg(reinterpret_cast<const float2*>(table) + 2 * f + 2);
  return r == 2 ? make_float3(d.z, d.w, nx.x) : make_float3(d.w, nx.x, nx.y);
}

// a run of 3 lanes of either row type, and its lane dx as f32
template <bool kU64>
__device__ __forceinline__ uint64_t load_run(const uint16_t* __restrict__ table, int64_t e) {
  return run3<kU64>(table, e);
}
template <bool kU64>
__device__ __forceinline__ float3 load_run(const float* __restrict__ table, int64_t e) {
  return run3_f32(table, e);
}
__device__ __forceinline__ float run_lane(uint64_t run, int dx) {
  return __uint2float_rn(static_cast<uint32_t>(run >> (16 * dx)) & 0xffffu);
}
__device__ __forceinline__ float run_lane(float3 run, int dx) {
  return __fadd_rn(dx == 0 ? run.x : dx == 1 ? run.y : run.z, 0.f);  // -0 -> +0
}

// T: the row type (uint16_t or float); kR receivers a thread; kU64: 64-bit
// u16 loads; kCs: row, base and the output streaming (evict first), so that
// the table keeps its place in L2
template <typename T, int kBw, int kR, bool kU64, bool kCs>
__global__ void __launch_bounds__(kThreads)
select9_kernel(const T* __restrict__ table, const int* __restrict__ row,
               const int* __restrict__ base, float* __restrict__ out, int n, int lanes) {
  using Run = std::conditional_t<std::is_same_v<T, float>, float3, uint64_t>;
  constexpr int kPerBlock = kThreads * kR;
  constexpr int kStride = kBw + 2;  // lanes between the 3x3's rows
  __shared__ float4 s_out4[9 * kPerBlock / 4];
  float* s_out = reinterpret_cast<float*>(s_out4);
  const int first = blockIdx.x * kPerBlock;
  const int count = min(kPerBlock, n - first);

  // the receivers' runs: kR x 3 loads in flight before any is used; a slot
  // past the end repeats the block's last receiver and is not written
  Run runs[kR][3];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = min(r * kThreads + static_cast<int>(threadIdx.x), count - 1);
    const int64_t e = static_cast<int64_t>(kCs ? __ldcs(row + first + i) : __ldg(row + first + i)) *
                          lanes +
                      (kCs ? __ldcs(base + first + i) : __ldg(base + first + i));
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) runs[r][dy] = load_run<kU64>(table, e + dy * kStride);
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = r * kThreads + threadIdx.x;
    if (i >= count) continue;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        s_out[9 * i + 3 * dy + dx] = run_lane(runs[r][dy], dx);
  }
  __syncthreads();
  // the block's 9 x count floats are contiguous and start 16-byte aligned
  float* o = out + static_cast<int64_t>(first) * 9;
  const int total = 9 * count;
  for (int j = threadIdx.x; j < total / 4; j += kThreads) {
    if (kCs)
      __stcs(reinterpret_cast<float4*>(o) + j, s_out4[j]);
    else
      reinterpret_cast<float4*>(o)[j] = s_out4[j];
  }
  for (int j = total / 4 * 4 + threadIdx.x; j < total; j += kThreads) {
    if (kCs)
      __stcs(o + j, s_out[j]);
    else
      o[j] = s_out[j];
  }
}

template <int kR, bool kU64, bool kCs, typename T>
int launch(const T* table, const int* row, const int* base, float* out, int n, int lanes, int bw,
           cudaStream_t s) {
  if (bw < 4 || bw > 8) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + kThreads * kR - 1) / (kThreads * kR));
  if (n > 0) {
    auto kernel = bw == 4   ? select9_kernel<T, 4, kR, kU64, kCs>
                  : bw == 5 ? select9_kernel<T, 5, kR, kU64, kCs>
                  : bw == 6 ? select9_kernel<T, 6, kR, kU64, kCs>
                  : bw == 7 ? select9_kernel<T, 7, kR, kU64, kCs>
                            : select9_kernel<T, 8, kR, kU64, kCs>;
    kernel<<<blocks, kThreads, 0, s>>>(table, row, base, out, n, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (rows, lanes) u16, 16-byte aligned, lanes % 8 == 0; bw in 4..8
extern "C" int shadow_select9(const uint16_t* table, const int* row, const int* base, float* out,
                              int n, int lanes, int bw, void* stream) {
  return launch<2, true, true>(table, row, base, out, n, lanes, bw,
                               static_cast<cudaStream_t>(stream));
}

// the same on f32 rows (shadow_table_u16=False)
extern "C" int shadow_select9_f32(const float* table, const int* row, const int* base, float* out,
                                  int n, int lanes, int bw, void* stream) {
  return launch<2, true, true>(table, row, base, out, n, lanes, bw,
                               static_cast<cudaStream_t>(stream));
}
