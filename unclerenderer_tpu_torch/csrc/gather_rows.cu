// K5: exact row gather out[i, c] = float(table[idx[i], c]) for f32 and bf16
// tables.
//
// Replaces unclerenderer_tpu/ops/texture.py gather_rows_onehot_matmul (the
// kernel at :105), which the reference calls from render/common.py
// tri_draw_masks to gather the per-model visible / alpha-masked flags for
// every triangle.  The TPU did the gather as a one-hot x table matmul on
// the MXU because small-table row gathers were slow there, and it was
// limited to tables that fit VMEM.  A GPU gathers directly: no one-hot, no
// table-size limit, and the bf16 -> f32 widening is exact.
//
// Bound: bytes -- one 4-byte index read and C 4-byte output writes per row.
// The frame's call (a (342, 2) bf16 table, 263,184 rows: 3.2 MB) is ~1 us
// of traffic at 3.35 TB/s, so it pays mostly its launch and the latency of
// its dependent reads (index, then table, then store).
//
// Design:
// * the table is read straight from device memory through the L1, where a
//   small table stays; staging it in shared memory lost at every workload
//   measured -- the frame's table at 1x and 16x its rows, a 48 KB table --
//   by 6-18% for the frame's table and up to 2.3x for a 48 KB one, a
//   persistent grid that stages once a block included
//   (unclerenderer_tpu_torch/sweeps/gather_rows.py);
// * a thread loads its indices in one load and stores its outputs in whole
//   16-byte stores: it takes R rows with R x C a multiple of 4 (C = 2: 2
//   rows -- one 8-byte index load, one 16-byte store; C = 1 or 3: 4 rows;
//   C = 4: 1 row); the last thread takes the ragged rows one by one;
// * C is a template constant for C = 1..4, so no divide per element; a
//   wider row takes the one-row-per-thread kernel (gather_row);
// * one thread per R rows, no grid-stride loop: as for copy_bytes.cu, a
//   grid of blocks retiring in address order streams the output best.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// rows a thread takes at row width C: its R x C outputs fill whole 16-byte
// stores (C = 2: 2 rows, one store)
template <int C>
constexpr int kRows = C % 4 == 0 ? 1 : (C % 2 == 0 ? 2 : 4);

// R consecutive indices in one 4R-byte load
template <int R>
__device__ __forceinline__ void load_indices(const int* __restrict__ p, int* r) {
  if constexpr (R == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  } else if constexpr (R == 2) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p));
    r[0] = v.x, r[1] = v.y;
  } else {
    r[0] = __ldg(p);
  }
}

// rows R t .. R t + R - 1 (those below n) of thread t, at row width C
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
gather_vec(const T* __restrict__ table, const int* __restrict__ idx, float* __restrict__ out,
           int64_t n, bool idx_vec) {
  constexpr int R = kRows<C>;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row0 = R * t;
  if (row0 >= n) return;
  int r[R];
  if (row0 + R <= n) {
    if (idx_vec) {
      load_indices<R>(idx + row0, r);
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k) r[k] = __ldg(idx + row0 + k);
    }
    float v[R * C];
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int c = 0; c < C; ++c) v[k * C + c] = widen(table[static_cast<int64_t>(r[k]) * C + c]);
    float4* o = reinterpret_cast<float4*>(out + row0 * C);
#pragma unroll
    for (int j = 0; j < R * C / 4; ++j)
      o[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
    for (int64_t row = row0; row < n; ++row) {
      const int64_t src = static_cast<int64_t>(__ldg(idx + row)) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) out[row * C + c] = widen(table[src + c]);
    }
  }
}

// one row of any width c per thread
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_row(const T* __restrict__ table, const int* __restrict__ idx, float* __restrict__ out,
           int64_t n, int c) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n) return;
  const int64_t src = static_cast<int64_t>(__ldg(idx + row)) * c;
  for (int k = 0; k < c; ++k) out[row * c + k] = widen(table[src + k]);
}

unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <typename T, int C>
void launch_vec(const T* table, const int* idx, float* out, int64_t n, cudaStream_t s) {
  constexpr int R = kRows<C>;
  const bool idx_vec = reinterpret_cast<uintptr_t>(idx) % (4 * R) == 0;
  gather_vec<T, C><<<blocks_for((n + R - 1) / R), kThreads, 0, s>>>(table, idx, out, n, idx_vec);
}

template <typename T>
void launch_rows(const T* table, const int* idx, float* out, int64_t n, int c, cudaStream_t s) {
  // the vector kernels store 16 bytes at a time: out on a 16-byte boundary
  const bool out_vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  switch (out_vec ? c : 0) {
    case 1: return launch_vec<T, 1>(table, idx, out, n, s);
    case 2: return launch_vec<T, 2>(table, idx, out, n, s);
    case 3: return launch_vec<T, 3>(table, idx, out, n, s);
    case 4: return launch_vec<T, 4>(table, idx, out, n, s);
    default: break;
  }
  gather_row<T><<<blocks_for(n), kThreads, 0, s>>>(table, idx, out, n, c);
}

}  // namespace

extern "C" int gather_rows(const void* table, const int* idx, float* out, long long n, int c,
                           int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (n > 0 && c > 0) {
    if (is_bf16)
      launch_rows(static_cast<const __nv_bfloat16*>(table), idx, out, n, c, s);
    else
      launch_rows(static_cast<const float*>(table), idx, out, n, c, s);
  }
  return static_cast<int>(cudaGetLastError());
}
