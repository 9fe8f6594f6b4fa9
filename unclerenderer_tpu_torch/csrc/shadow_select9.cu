// K4: PCF 3x3 neighbourhood fetch from the u16 superblock shadow table.
//
// Replaces unclerenderer_tpu/ops/shadow.py _select9_kernel (via
// _select9_call / _select9_fetch / shadow_factor_blocks).  The TPU path
// first gathered each receiver's whole 128-lane superblock row (256 B) into
// a materialised (grid, 1024, 128) array, then selected 9 lanes in VMEM.
// Here one thread per receiver reads the 9 texels straight from
// table[row * lanes + base + delta_k] and writes them as f32 (u16 -> f32 is
// exact), so no row array is ever materialised.
//
// Bound: latency of scattered 2-byte reads.  The 9 taps of a receiver lie
// in one 256 B row (3 runs of 3 adjacent texels), neighbouring receivers
// hit neighbouring rows, and the loads are independent, so each thread
// keeps 9 requests in flight and the L1/L2 absorb the row reuse.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Deltas {
  int d[9];
};

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
select9_kernel(const uint16_t* __restrict__ table, const int* __restrict__ row,
               const int* __restrict__ base, float* __restrict__ out, int n, int lanes,
               Deltas deltas) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint16_t* r = table + static_cast<size_t>(row[i]) * lanes + base[i];
  uint16_t v[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) v[k] = __ldg(r + deltas.d[k]);
  float* o = out + static_cast<size_t>(i) * 9;
#pragma unroll
  for (int k = 0; k < 9; ++k) o[k] = static_cast<float>(v[k]);
}

}  // namespace

extern "C" int shadow_select9(const uint16_t* table, const int* row, const int* base,
                              const int* deltas, float* out, int n, int lanes, void* stream) {
  Deltas d;
  for (int k = 0; k < 9; ++k) d.d[k] = deltas[k];  // host array
  if (n > 0) {
    select9_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(table, row, base, out, n, lanes, d);
  }
  return static_cast<int>(cudaGetLastError());
}
