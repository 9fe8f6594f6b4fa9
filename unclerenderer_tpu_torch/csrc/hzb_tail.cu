// K6: the HZB pyramid's tail -- every 2x2 min level past the first two --
// in one launch.
//
// Replaces unclerenderer_tpu/ops/hzb.py _hzb_tail_pallas (called from
// build_hzb under RenderSettings.hzb_pallas_tail).  Level l+1 texel (x, y)
// is the min of level l texels (2x+dx, 2y+dy), dx, dy in {0, 1}, with each
// source index clamped to the last row / column: that is _reduce_level's
// duplicate-the-last-row/column pad when the source is short and its crop
// when it is long (the TPU kernel spelled the same selection as one-hot
// MXU products, _reduce_level_mxu).  Min is exact, so the result is
// bit-equal to the plain cascade on finite depths.
//
// The input level (270x480 f32 at 1080p, 518 KB) does not fit in shared
// memory, and the cascade is serial across levels.  One thread block walks
// the levels in order: threads stride over a level's texels, read the
// previous level (the input, then the kernel's own output, which stays in
// L2), and __syncthreads() separates the levels.  Bound: one launch and
// ~43k outputs at 1080p -- latency, not bandwidth.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxLevels = 32;

struct Levels {
  int n;
  int w[kMaxLevels];
  int h[kMaxLevels];
  long long off[kMaxLevels];
};

// No __restrict__ on the pointers: each level reads what the block wrote
// into ``out`` for the previous one, so the read-only cache must not serve
// those loads.
__global__ void __launch_bounds__(kThreads)
hzb_tail_kernel(const float* top, int top_h, int top_w, float* out, Levels lv) {
  const float* src = top;
  int sh = top_h, sw = top_w;
  for (int l = 0; l < lv.n; ++l) {
    const int w = lv.w[l], h = lv.h[l];
    float* dst = out + lv.off[l];
    for (int i = threadIdx.x; i < w * h; i += kThreads) {
      const int y = i / w, x = i - y * w;
      const int y0 = min(2 * y, sh - 1), y1 = min(2 * y + 1, sh - 1);
      const int x0 = min(2 * x, sw - 1), x1 = min(2 * x + 1, sw - 1);
      const float top_min = fminf(src[y0 * sw + x0], src[y0 * sw + x1]);
      const float bot_min = fminf(src[y1 * sw + x0], src[y1 * sw + x1]);
      dst[i] = fminf(top_min, bot_min);
    }
    __syncthreads();
    src = dst;
    sh = h;
    sw = w;
  }
}

}  // namespace

// dims: host int[3 * n_levels] = (w, h, offset) of each output level
extern "C" int hzb_tail(const float* top, const int* dims, float* out, int top_h, int top_w,
                        int n_levels, void* stream) {
  if (n_levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.w[l] = dims[3 * l];
    lv.h[l] = dims[3 * l + 1];
    lv.off[l] = dims[3 * l + 2];
  }
  if (n_levels > 0)
    hzb_tail_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(top, top_h, top_w,
                                                                          out, lv);
  return static_cast<int>(cudaGetLastError());
}
