// K6: the HZB pyramid's tail -- every 2x2 min level past the first two --
// in one launch.
//
// Replaces unclerenderer_tpu/ops/hzb.py _hzb_tail_pallas (called from
// build_hzb under RenderSettings.hzb_pallas_tail).  Level l+1 texel (x, y)
// is the min of level l texels (2x+dx, 2y+dy), dx, dy in {0, 1}, with each
// source index clamped to the last row / column: that is _reduce_level's
// duplicate-the-last-row/column pad when the source is short and its crop
// when it is long (the TPU kernel spelled the same selection as one-hot
// MXU products, _reduce_level_mxu).  The level sizes follow hzb_layout's
// halving rule (w -> max(1, w / 2)), so the kernel takes the top's size and
// the level count and derives the rest.  Min is exact, so the result is
// bit-equal to the plain cascade on finite depths.
//
// Bound: bytes (the top, 518 KB at 1080p, read once; 43k texels written),
// 0.0002 ms at 3.35 TB/s -- far under one launch's latency.  So the design
// spreads the one read that matters over the card and keeps the serial part
// short:
//
// * Each block takes a TH x TW tile of the top.  Its threads read row pairs
//   with 16-byte loads (two level-1 texels a thread) and reduce the tile
//   through log2(min(TH, TW)) levels in shared memory, writing each level's
//   part.  No clamp ever reaches outside the block's own tile: level k texel
//   x reads source columns min(2x + dx, w - 1), which lie in [2x, 2x + 1].
// * The levels left over need every block's result.  The block that
//   finishes last (a ticket: __threadfence, then atomicAdd on a counter)
//   reads the last tile level through L2 and walks the remaining small
//   levels in shared memory, then resets the counter to 0, so every launch
//   -- back to back or replayed from a CUDA graph -- starts from 0.  The
//   counter is one unsigned int a device, owned by the wrapper
//   (ops/hzb.py); launches of this kernel on two streams of one device at
//   once would share it and are not supported.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ __forceinline__ int halve(int d) { return d > 1 ? d / 2 : 1; }

__host__ __device__ constexpr int log2_floor(int v) {
  return v <= 1 ? 0 : 1 + log2_floor(v / 2);
}

// floats of each shared buffer the finishing block keeps a level in; a
// larger level (tops past ~4k x 4k) is read back from the output instead
constexpr int kFinishCap = 2048;

// min of the 2x2 source texels of level texel (x, y), every index clamped to
// the source's (sh, sw); ``ld(row, col)`` reads the source
template <typename Load>
__device__ __forceinline__ float min2x2(const Load& ld, int x, int y, int sh, int sw) {
  const int x0 = min(2 * x, sw - 1), x1 = min(2 * x + 1, sw - 1);
  const int y0 = min(2 * y, sh - 1), y1 = min(2 * y + 1, sh - 1);
  return fminf(fminf(ld(y0, x0), ld(y0, x1)), fminf(ld(y1, x0), ld(y1, x1)));
}

// Levels level+1 .. n_levels by one block.  Level ``level`` (h x w) is at
// out + off; ``from_grid``: other blocks wrote it, so it is read through L2.
// A level that fits a shared buffer is read from there by the next one.
template <int THREADS>
__device__ void finish_levels(float* out, long long off, int h, int w, int level, int n_levels,
                              float* buf, bool from_grid) {
  const float* src = out + off;
  int where = from_grid ? 0 : 2;  // 0: L2, 1: shared, 2: written by this block
  int b = 0;
  for (; level < n_levels; ++level) {
    const int sh = h, sw = w;
    h = halve(sh);
    w = halve(sw);
    const long long doff = off + static_cast<long long>(sh) * sw;
    float* keep = h * w <= kFinishCap ? buf + b * kFinishCap : nullptr;
    for (int i = threadIdx.x; i < h * w; i += THREADS) {
      const int y = i / w, x = i - y * w;
      const float v = min2x2(
          [&](int r, int c) {
            const float* p = src + static_cast<long long>(r) * sw + c;
            return where == 0 ? __ldcg(p) : *p;
          },
          x, y, sh, sw);
      out[doff + i] = v;
      if (keep) keep[i] = v;
    }
    __syncthreads();
    if (keep) {
      src = keep;
      where = 1;
      b ^= 1;
    } else {
      src = out + doff;
      where = 2;
    }
    off = doff;
  }
}

// Levels 1 .. min(n_levels, log2(min(TH, TW))) of the block's TH x TW tile
// of the top; then the last block to finish does the rest.
template <int TH, int TW, int THREADS>
__global__ void __launch_bounds__(THREADS)
hzb_tail_kernel(const float* __restrict__ top, float* out, unsigned* counter, int top_h,
                int top_w, int n_levels, bool vec) {
  constexpr int kLevels = log2_floor(TH < TW ? TH : TW);
  constexpr int H1 = TH / 2, W1 = TW / 2, kPairs = W1 / 2;
  constexpr int kTile = H1 * W1 + (H1 / 2) * (W1 / 2);
  constexpr int kSmem = 2 * kFinishCap > kTile ? 2 * kFinishCap : kTile;
  __shared__ float smem[kSmem];
  float* cur = smem;              // levels 1, 3, 5, ...
  float* nxt = smem + H1 * W1;    // levels 2, 4, ...

  // level 1: two texels a thread from a pair of top rows (16-byte loads
  // where the rows allow them: vec = 16-byte aligned top, width % 4 == 0)
  int sh = top_h, sw = top_w;
  int h = halve(sh), w = halve(sw);
  {
    const int ox = blockIdx.x * W1, oy = blockIdx.y * H1;
    for (int i = threadIdx.x; i < H1 * kPairs; i += THREADS) {
      const int ly = i / kPairs, lx = (i - ly * kPairs) * 2;
      const int y = oy + ly, x = ox + lx;
      if (y >= h || x >= w) continue;
      const float* r0 = top + static_cast<long long>(min(2 * y, sh - 1)) * sw;
      const float* r1 = top + static_cast<long long>(min(2 * y + 1, sh - 1)) * sw;
      float a, b;
      if (vec) {  // x even and 2x + 3 <= sw - 1
        const float4 p = __ldg(reinterpret_cast<const float4*>(r0 + 2 * x));
        const float4 q = __ldg(reinterpret_cast<const float4*>(r1 + 2 * x));
        a = fminf(fminf(p.x, p.y), fminf(q.x, q.y));
        b = fminf(fminf(p.z, p.w), fminf(q.z, q.w));
      } else {
        const auto ld = [&](int r, int c) { return __ldg((r == 0 ? r0 : r1) + c); };
        const int c0 = min(2 * x, sw - 1), c1 = min(2 * x + 1, sw - 1);
        const int c2 = min(2 * x + 2, sw - 1), c3 = min(2 * x + 3, sw - 1);
        a = fminf(fminf(ld(0, c0), ld(0, c1)), fminf(ld(1, c0), ld(1, c1)));
        b = fminf(fminf(ld(0, c2), ld(0, c3)), fminf(ld(1, c2), ld(1, c3)));
      }
      cur[ly * W1 + lx] = a;
      out[static_cast<long long>(y) * w + x] = a;
      if (x + 1 < w) {
        cur[ly * W1 + lx + 1] = b;
        out[static_cast<long long>(y) * w + x + 1] = b;
      }
    }
  }

  // levels 2 .. kLevels inside the tile: level k's part is (TH >> k) x
  // (TW >> k) with the tile's stride halving each level
  long long off = 0;
  int level = 1;
#pragma unroll
  for (int k = 2; k <= kLevels; ++k) {
    if (level >= n_levels) break;
    __syncthreads();
    off += static_cast<long long>(h) * w;
    sh = h;
    sw = w;
    h = halve(sh);
    w = halve(sw);
    const int th = TH >> k, tw = TW >> k;
    const int ox = blockIdx.x * tw, oy = blockIdx.y * th;
    for (int i = threadIdx.x; i < th * tw; i += THREADS) {
      const int ly = i / tw, lx = i - ly * tw;
      const int y = oy + ly, x = ox + lx;
      if (y >= h || x >= w) continue;
      // source indices are global; the clamp keeps them inside the tile
      const float v = min2x2(
          [&](int r, int c) { return cur[(r - 2 * oy) * (2 * tw) + (c - 2 * ox)]; }, x, y, sh, sw);
      nxt[ly * tw + lx] = v;
      out[off + static_cast<long long>(y) * w + x] = v;
    }
    float* t = cur;
    cur = nxt;
    nxt = t;
    ++level;
  }

  if (level >= n_levels) return;
  __shared__ unsigned ticket;
  __threadfence();  // this block's part of the last tile level, before its ticket
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1u);
  __syncthreads();
  if (ticket != gridDim.x * gridDim.y - 1) return;
  __threadfence();
  if (threadIdx.x == 0) *counter = 0u;  // every other block has taken its ticket
  finish_levels<THREADS>(out, off, h, w, level, n_levels, smem, true);
}

template <int TH, int TW, int THREADS>
int launch_hzb_tail(const float* top, float* out, unsigned* counter, int top_h, int top_w,
                    int n_levels, cudaStream_t stream) {
  if (n_levels <= 0 || top_h <= 0 || top_w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int h1 = halve(top_h), w1 = halve(top_w);
  const dim3 grid((w1 + TW / 2 - 1) / (TW / 2), (h1 + TH / 2 - 1) / (TH / 2));
  const bool vec = top_w % 4 == 0 && reinterpret_cast<uintptr_t>(top) % 16 == 0;
  hzb_tail_kernel<TH, TW, THREADS>
      <<<grid, THREADS, 0, stream>>>(top, out, counter, top_h, top_w, n_levels, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// counter: one unsigned int on the device, 0 between launches
extern "C" int hzb_tail(const float* top, float* out, unsigned* counter, int top_h, int top_w,
                        int n_levels, void* stream) {
  return launch_hzb_tail<32, 64, 256>(top, out, counter, top_h, top_w, n_levels,
                                      static_cast<cudaStream_t>(stream));
}
