// M1: the alpha-masked raster, one level of it.
//
// Not a port of a TPU kernel: the reference runs its masked raster as XLA
// under every raster_backend -- unclerenderer_tpu/render/common.py
// _rasterize_alpha_binned (:689, whose eval_level :766 evaluates and
// texture-taps every (block slot, pixel, slot) triple of a bin level and
// merges blocks and tiles with segment_max / segment_min) and
// _rasterize_alpha (:552, the exhaustive scan of masked_tri_cap == 0).
// ops/raster_kernels.py masked_raster_ref is its plain version.
//
// One thread block a tile.  Binned form (tile_start != NULL): the tile walks
// its block range [tile_start, tile_start + tile_count) of the level's
// (blocks, 16, chunk) bins, as K1 does (ops/raster_kernels.py
// tile_block_ranges).  Exhaustive form (tile_start == NULL): every tile walks
// every chunk of the (chunks, 16, chunk) table.  A block is staged kStage
// slots at a time: each slot that is valid and whose edges may pass at a
// pixel of the tile -- ops/raster_kernels.py _edge_may_pass at the tile's
// corners, in the plain version's own arithmetic: a superset filter --
// becomes a record of raster_common.cuh plus its 19-column alpha record
// (render/common.py _alpha_records).  In the exhaustive form a chunk with no
// such slot is skipped, and only the others count as live blocks.
//
// A warp owns 8 x 4 pixels of the tile at a time (lane l at row l / 8,
// column l % 8), the tile's rectangles dealt to the 8 warps in turn.  Per
// pixel the max depth key wins, then the min triangle id among the keys at
// that max, compared by value (-0.0 and +0.0 tie): the reference's block and
// tile segment merges, exact in any visiting order.  A pixel's winner so far
// lives in the output images (each thread reads and writes only its own
// pixels), so any tile size runs.  Per (pixel, slot) pair:
//   1. the edge and depth tests of ops/raster.py eval_keys (the records and
//      the warp skip of raster_common.cuh: a slot no pixel of the warp's
//      rectangle can pass is skipped for the whole warp, exact by
//      monotonicity);
//   2. only where the pair could change the pixel's winner (key > best, or
//      key == best and id < best id), the alpha test: the interpolation of
//      u, v and vertex alpha, _alpha_lod, _alpha_tap and the cutoff
//      (ops/raster_kernels.py).  A pair
//      that cannot change the winner needs no tap, so the result is the one
//      of tapping every covered pair.
// The output keys are -1 where nothing won and +0.0 for a zero key (the
// plain version adds 0.0 to its merged keys: which zero a max keeps is not
// fixed), and the ids -1 where nothing won.
//
// Exactness: the plain version's arithmetic, built with -fmad=false:
// __fmaf_rn exactly where ops/fma.py puts an fma, the uncontracted lerps
// a*(1-f) + b*f of ops/texture.py, IEEE divisions (1/denom then products in
// _alpha_lod), log2f of the CUDA math library (PyTorch's log2 on the card),
// rintf for torch.round (half to even), to_int as _to_int (saturating,
// NaN -> 0), the wrap as torch.remainder, and NaN kept through clamp and
// maximum as PyTorch keeps it.
//
// Atlases (the layouts ops/texture.py samples): the quad atlas (lanes 4C:
// texel corners TL, TR, BL, BR of C channels) and the packed-trilinear atlas
// (256 lanes: the mip-L quad, then the parent's 3x3 at mip L+1), in f32, bf16
// or u8 (C = 16: (float)byte * (1/255); channel 3, alpha, is stored
// linearly).  Filters: nearest-mip bilinear (bilinear != 0) or trilinear.
//
// Stats (stats != NULL, three u64): live blocks, covered pairs (edge and
// depth tests passed: equal to the plain version's count), tapped pairs
// (alpha tests run: at most the covered ones), summed per thread block and
// added with one atomic each; the frame's call passes NULL and counts nothing.
//
// What bounds it: at 1080p level 1 walks 1,125 live blocks of 64 slots over
// 2,040 tiles of 16 x 64, 232,830 covered pairs of which 213,702 are
// tapped; the 30 MB it must move (the live blocks, their alpha records,
// the two images, the tapped texels) bound it at 0.009 ms on an H100.  It
// takes 0.61 ms there (chip_smoke.py's [masked] lines): a warp walks its
// slots one at a time, and a slot that some lane must tap holds the whole
// warp for that lane's chain of dependent divides, log2 and atlas reads,
// so the taps of a warp's pixels run one after another.  Gathering each
// pixel's candidate pairs first and tapping them in key order across the
// lanes is the untried next design.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

using raster::lin;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRectH = 4, kRectW = 8;  // a warp's pixels: lane l at (l / kRectW, l % kRectW)
constexpr int kStage = 64;             // slots staged at once: warps 0 and 1 compact them
constexpr int kF4 = 5;                 // float4s a record (raster_common.cuh)
constexpr int kArec = 19;              // alpha record columns
constexpr int kPackedC = 16;           // channels of a packed-trilinear texel (256 lanes)

struct Atlas {
  const unsigned char* p;  // (rows, lanes) u8, f32 or bf16
  int width;               // texels a row of the atlas image
  int lanes, c;            // lanes a row; channels a texel
  int dtype;               // 0 u8, 1 f32, 2 bf16
  bool packed;             // the 256-lane packed-trilinear layout
};

struct Level {
  const float* coef;  // (blocks, 16, chunk)
  const int* tri_id;  // (blocks, chunk)
  const float* valid;
  const int* rows;    // (blocks, chunk) alpha record rows
  const int* tile_start;
  const int* tile_count;
  const float* arec;  // (R, 19)
  float* out_key;     // (height, width)
  int* out_id;
  unsigned long long* stats;
  int n_blocks, chunk, tile_h, tile_w, n_tx, rects_x, n_rects, width, height, y_offset;
  float full_w, full_h;  // the slot filter's image size
};

// one lane of atlas row `row` as f32
__device__ __forceinline__ float lane_value(const Atlas& a, int row, int lane) {
  const long long i = static_cast<long long>(row) * a.lanes + lane;
  if (a.dtype == 1) return __ldg(reinterpret_cast<const float*>(a.p) + i);
  if (a.dtype == 2)
    return __uint_as_float(
        static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(a.p) + i)) << 16);
  return __fmul_rn(static_cast<float>(__ldg(a.p + i)), static_cast<float>(1.0 / 255.0));
}

// ops/texture.py _to_int: saturating, NaN -> 0
__device__ __forceinline__ int to_int(float x) {
  if (isnan(x)) return 0;
  return static_cast<int>(fminf(fmaxf(x, -2147483648.f), 2147483520.f));
}

// torch.remainder(i, n) for n > 0
__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// a * (1 - f) + b * f, uncontracted
__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, f)), __fmul_rn(b, f));
}

// torch.round(torch.log2(torch.clamp(x, min=1))) as an int
__device__ __forceinline__ int round_log2(float x) {
  return static_cast<int>(rintf(log2f(x < 1.f ? 1.f : x)));
}

struct Tap {
  int x, y, w, h;  // the mip rect (ops/texture.py _pyramid_rect)
  float fx, fy;    // the fractions of the texel coordinates
  int ix, iy;      // their floors as ints, before the wrap
};

// ops/texture.py _tap_coords: rect0 = (x0, y0, w0, h0) of mip 0
__device__ __forceinline__ Tap tap_coords(const float* rect0, float u, float v, int level) {
  const int x0 = static_cast<int>(rect0[0]), y0 = static_cast<int>(rect0[1]);
  const int w0 = static_cast<int>(rect0[2]), h0 = static_cast<int>(rect0[3]);
  const int lmax = round_log2(static_cast<float>(max(w0, h0)));
  const int lv = min(max(level, 0), lmax);
  Tap t;
  t.w = max(w0 >> lv, 1);
  t.h = max(h0 >> lv, 1);
  t.x = x0 + 2 * (w0 - t.w) + max(lv - round_log2(static_cast<float>(w0)), 0);
  t.y = y0;
  const float tx = __fsub_rn(__fmul_rn(u, static_cast<float>(t.w)), 0.5f);
  const float ty = __fsub_rn(__fmul_rn(v, static_cast<float>(t.h)), 0.5f);
  const float fx0 = floorf(tx), fy0 = floorf(ty);
  t.fx = __fsub_rn(tx, fx0);
  t.fy = __fsub_rn(ty, fy0);
  t.ix = to_int(fx0);
  t.iy = to_int(fy0);
  return t;
}

__device__ __forceinline__ int tap_row(const Atlas& a, const Tap& t) {
  return (t.y + wrap(t.iy, t.h)) * a.width + (t.x + wrap(t.ix, t.w));
}

// channel 3 of a WRAP bilinear tap at an integer mip (either layout: the
// packed row's lanes 0:4C are the quad atlas's row)
__device__ float bilinear_alpha(const Atlas& a, const float* rect0, float u, float v, int level) {
  const Tap t = tap_coords(rect0, u, v, level);
  const int row = tap_row(a, t);
  return lerp(lerp(lane_value(a, row, 3), lane_value(a, row, a.c + 3), t.fx),
              lerp(lane_value(a, row, 2 * a.c + 3), lane_value(a, row, 3 * a.c + 3), t.fx), t.fy);
}

// channel 3 of a trilinear tap: two bilinear taps on the quad atlas
// (sample_pyramid_trilinear), one packed row on the packed atlas
// (sample_pyramid_tri: the second tap's 2x2 a select of the row's 3x3)
__device__ float trilinear_alpha(const Atlas& a, const float* rect0, float u, float v, float lod) {
  lod = lod < 0.f ? 0.f : lod;  // clamp(min=0) keeps NaN
  const int l0 = to_int(floorf(lod));
  float frac = __fsub_rn(lod, static_cast<float>(l0));
  frac = frac < 0.f ? 0.f : (frac > 1.f ? 1.f : frac);
  if (!a.packed)
    return lerp(bilinear_alpha(a, rect0, u, v, l0), bilinear_alpha(a, rect0, u, v, l0 + 1), frac);
  const Tap t = tap_coords(rect0, u, v, l0), t2 = tap_coords(rect0, u, v, l0 + 1);
  const int row = tap_row(a, t);
  // int32 arithmetic that wraps, as PyTorch's
  const int cox = min(max(static_cast<int>(static_cast<unsigned>(t2.ix) -
                                           static_cast<unsigned>(t.ix >> 1) + 1u), 0), 1);
  const int roy = min(max(static_cast<int>(static_cast<unsigned>(t2.iy) -
                                           static_cast<unsigned>(t.iy >> 1) + 1u), 0), 1);
  const float qa = lerp(lerp(lane_value(a, row, 3), lane_value(a, row, kPackedC + 3), t.fx),
                        lerp(lane_value(a, row, 2 * kPackedC + 3),
                             lane_value(a, row, 3 * kPackedC + 3), t.fx), t.fy);
  // cell (j, i) of the 3x3 starts at lane 4C + (3j + i) C
  auto cell = [&](int j, int i) { return lane_value(a, row, (4 + 3 * j + i) * kPackedC + 3); };
  const float qb = lerp(lerp(cell(roy, cox), cell(roy, cox + 1), t2.fx),
                        lerp(cell(roy + 1, cox), cell(roy + 1, cox + 1), t2.fx), t2.fy);
  return lerp(qa, qb, frac);
}

// ops/raster_kernels.py _alpha_lod
__device__ __forceinline__ float alpha_lod(float u, float v, float au, float bu, float av,
                                           float bv, float a1, float b1, float denom, float tw,
                                           float th) {
  const float inv_d = __fdiv_rn(1.f, denom);
  const float dudx = __fmul_rn(__fmaf_rn(-u, a1, au), inv_d);
  const float dudy = __fmul_rn(__fmaf_rn(-u, b1, bu), inv_d);
  const float dvdx = __fmul_rn(__fmaf_rn(-v, a1, av), inv_d);
  const float dvdy = __fmul_rn(__fmaf_rn(-v, b1, bv), inv_d);
  const float px = __fmul_rn(dudx, tw), qx = __fmul_rn(dvdx, th);
  const float py = __fmul_rn(dudy, tw), qy = __fmul_rn(dvdy, th);
  const float lx = __fmaf_rn(px, px, __fmul_rn(qx, qx));
  const float ly = __fmaf_rn(py, py, __fmul_rn(qy, qy));
  float m = (isnan(lx) || isnan(ly)) ? __int_as_float(0x7fc00000) : fmaxf(lx, ly);
  m = m < 1e-12f ? 1e-12f : m;  // clamp(min=1e-12) keeps NaN
  return __fmul_rn(0.5f, log2f(m));
}

// ops/raster_kernels.py _alpha_eval's test of a covered pair at pixel centre
// (qx, qy): ar is the slot's alpha record
__device__ bool alpha_passes(const float* ar, float qx, float qy, const Atlas& a, bool bilinear) {
  float denom = lin(ar[9], ar[10], ar[11], qx, qy);
  denom = denom != 0.f ? denom : 1.f;
  const float u = __fdiv_rn(lin(ar[0], ar[1], ar[2], qx, qy), denom);
  const float v = __fdiv_rn(lin(ar[3], ar[4], ar[5], qx, qy), denom);
  const float ca = __fdiv_rn(lin(ar[6], ar[7], ar[8], qx, qy), denom);
  float tex_a = 1.f;
  if (ar[16] > 0.5f) {  // the model has a base-colour map
    const float lod = alpha_lod(u, v, ar[0], ar[1], ar[3], ar[4], ar[9], ar[10], denom, ar[14],
                                ar[15]);
    tex_a = bilinear ? bilinear_alpha(a, ar + 12, u, v, to_int(rintf(lod < 0.f ? 0.f : lod)))
                     : trilinear_alpha(a, ar + 12, u, v, lod);
  }
  return __fmul_rn(__fmul_rn(ar[17], ca), tex_a) >= ar[18];
}

// ops/raster_kernels.py _edge_may_pass at the tile's extreme pixel centres: False
// only where no pixel of the tile can pass one of the three edge tests
__device__ __forceinline__ bool may_reach_tile(const float (&v)[15], float2 cx, float2 cy,
                                               float full_w, float full_h) {
  bool ok = true;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float a = v[e], b = v[3 + e], c = v[6 + e];
    const float m = __fadd_rn(
        __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(fabsf(a), full_w), __fmul_rn(fabsf(b), full_h)),
                            fabsf(c)), 0x1p-20f), 0x1p-120f);
    const float s = __fadd_rn(__fadd_rn(__fmul_rn(a, a > 0.f ? cx.y : cx.x),
                                        __fmul_rn(b, b > 0.f ? cy.y : cy.x)), c);
    ok = ok && !(s < -m);
  }
  return ok;
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads)
masked_raster_kernel(const Level L, const Atlas A, const bool bilinear) {
  __shared__ float4 s_rec[kStage * kF4];
  __shared__ float s_arec[kStage * kArec];
  __shared__ int s_count[kStage / 32];
  __shared__ unsigned long long s_sum[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x;
  const int px0 = (tile % L.n_tx) * L.tile_w, py0 = (tile / L.n_tx) * L.tile_h;
  const float ftx = static_cast<float>(px0), fty = static_cast<float>(py0 + L.y_offset);
  const float2 cx = make_float2(__fadd_rn(ftx, 0.5f),
                                __fadd_rn(ftx, static_cast<float>(L.tile_w) - 0.5f));
  const float2 cy = make_float2(__fadd_rn(fty, 0.5f),
                                __fadd_rn(fty, static_cast<float>(L.tile_h) - 0.5f));

  // rectangle r's pixel of this lane: in the tile and the image?
  auto pixel = [&](int r, int& gx, int& gy) {
    const int lx = (r % L.rects_x) * kRectW + (lane % kRectW);
    const int ly = (r / L.rects_x) * kRectH + (lane / kRectW);
    gx = px0 + lx;
    gy = py0 + ly;
    return lx < L.tile_w && ly < L.tile_h && gx < L.width && gy < L.height;
  };
  for (int r = warp; r < L.n_rects; r += kWarps) {
    int gx, gy;
    if (pixel(r, gx, gy)) {
      const size_t o = static_cast<size_t>(gy) * L.width + gx;
      L.out_key[o] = -1.f;
      L.out_id[o] = -1;
    }
  }

  const bool binned = L.tile_start != nullptr;
  const int b0 = binned ? L.tile_start[tile] : 0;
  const int nb = binned ? L.tile_count[tile] : L.n_blocks;
  unsigned covered = 0, tapped = 0, live = 0;
  for (int j = 0; j < nb; ++j) {
    const size_t b = static_cast<size_t>(b0 + j);
    bool any = false;  // the block holds a slot that may reach the tile
    for (int s0 = 0; s0 < L.chunk; s0 += kStage) {
      // this thread's slot: valid and reaching the tile?
      const int s = s0 + static_cast<int>(threadIdx.x);
      float v[15];
      bool ok = false;
      int id = 0, row = 0;
      if (threadIdx.x < kStage && s < L.chunk && L.valid[b * L.chunk + s] > 0.f) {
#pragma unroll
        for (int i = 0; i < 15; ++i) v[i] = L.coef[(b * 16 + i) * L.chunk + s];
        ok = may_reach_tile(v, cx, cy, L.full_w, L.full_h);
        id = L.tri_id[b * L.chunk + s];
        row = L.rows[b * L.chunk + s];
      }
      __syncthreads();  // the previous stage's records are read
      const unsigned mk = __ballot_sync(0xffffffffu, ok);
      if (lane == 0 && warp < kStage / 32) s_count[warp] = __popc(mk);
      __syncthreads();
      const int before = warp == 1 ? s_count[0] : 0;
      const int n = s_count[0] + s_count[1];
      if (ok) {  // compacted in slot order
        const int pos = before + __popc(mk & ((1u << lane) - 1u));
        raster::put_record<kF4>(s_rec + pos * kF4, v, true, __int_as_float(id));
        const float* ar = L.arec + static_cast<size_t>(row) * kArec;
#pragma unroll
        for (int k = 0; k < kArec; ++k) s_arec[pos * kArec + k] = ar[k];
      }
      __syncthreads();  // the records are ready
      if (n == 0) continue;
      any = true;

      for (int r = warp; r < L.n_rects; r += kWarps) {
        int gx, gy;
        const bool in = pixel(r, gx, gy);
        const size_t o = static_cast<size_t>(gy) * L.width + gx;
        const float qx = __fadd_rn(static_cast<float>(gx), 0.5f);
        const float qy = __fadd_rn(static_cast<float>(gy + L.y_offset), 0.5f);
        // the rectangle's extreme pixel centres
        const int rx = px0 + (r % L.rects_x) * kRectW;
        const int ry = py0 + (r / L.rects_x) * kRectH + L.y_offset;
        const float2 xs = make_float2(__fadd_rn(static_cast<float>(rx), 0.5f),
                                      __fadd_rn(static_cast<float>(rx + kRectW - 1), 0.5f));
        const float2 ys = make_float2(__fadd_rn(static_cast<float>(ry), 0.5f),
                                      __fadd_rn(static_cast<float>(ry + kRectH - 1), 0.5f));
        float best = in ? L.out_key[o] : -1.f;
        int bid = in ? L.out_id[o] : -1;
        for (int r0 = 0; r0 < n; r0 += 32) {
          bool may = false;
          if (r0 + lane < n) {
            const float4* q = s_rec + (r0 + lane) * kF4;
            may = q[3].w == 0.f || (raster::reach(q[0], xs, ys) && raster::reach(q[1], xs, ys) &&
                                    raster::reach(q[2], xs, ys));
          }
          for (unsigned todo = __ballot_sync(0xffffffffu, may); todo != 0; todo &= todo - 1) {
            if (!in) continue;
            const int k = r0 + __ffs(todo) - 1;
            const float4* q = s_rec + k * kF4;
            const float4 e0 = q[0], e1 = q[1], e2 = q[2], z = q[3], w = q[4];
            if (!(lin(e0.x, e0.y, e0.z, qx, qy) >= e0.w && lin(e1.x, e1.y, e1.z, qx, qy) >= e1.w &&
                  lin(e2.x, e2.y, e2.z, qx, qy) >= e2.w))
              continue;
            const float nw = lin(w.x, w.y, w.z, qx, qy);
            if (!(nw > 0.f)) continue;
            const float key = __fdiv_rn(lin(z.x, z.y, z.z, qx, qy), nw);
            if (!(key >= 0.f && key <= 1.f)) continue;
            if (kStats) ++covered;
            const int t = __float_as_int(w.w);
            if (!(key > best || (key == best && t < bid))) continue;
            if (kStats) ++tapped;
            if (alpha_passes(s_arec + k * kArec, qx, qy, A, bilinear)) {
              best = key;
              bid = t;
            }
          }
        }
        if (in) {
          L.out_key[o] = best == 0.f ? 0.f : best;
          L.out_id[o] = bid;
        }
      }
    }
    if (kStats && threadIdx.x == 0 && (binned || any)) ++live;
  }

  if (kStats) {
    covered = __reduce_add_sync(0xffffffffu, covered);
    tapped = __reduce_add_sync(0xffffffffu, tapped);
    if (threadIdx.x == 0) s_sum[0] = s_sum[1] = 0ull;
    __syncthreads();
    if (lane == 0) {
      atomicAdd(&s_sum[0], static_cast<unsigned long long>(covered));
      atomicAdd(&s_sum[1], static_cast<unsigned long long>(tapped));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicAdd(L.stats, static_cast<unsigned long long>(live));
      atomicAdd(L.stats + 1, s_sum[0]);
      atomicAdd(L.stats + 2, s_sum[1]);
    }
  }
}

}  // namespace

// One masked raster level into out_key / out_id (height, width): the image
// is `height` rows from global row y_offset of a full_height-row frame.
// tile_start / tile_count (n_tiles,) give each tile's block range (binned
// form), or are both NULL (exhaustive form: every tile walks all n_blocks
// chunks).  atlas: (rows, lanes) with atlas_width texels a row of the atlas
// image, dtype 0 u8, 1 f32, 2 bf16; lanes 256 is the packed-trilinear
// layout, any other multiple of 4 the quad layout (u8: 64 lanes only).
// stats: NULL, or three zeroed u64 counts (live blocks, covered, tapped).
extern "C" int masked_raster(const float* coef, const int* tri_id, const float* valid,
                             const int* rows, const int* tile_start, const int* tile_count,
                             const float* arec, const void* atlas, float* out_key, int* out_id,
                             long long* stats, int n_blocks, int chunk, int tile_h, int tile_w,
                             int width, int height, int y_offset, int full_height,
                             int atlas_width, int lanes, int atlas_dtype, int bilinear,
                             void* stream) {
  const bool packed = lanes == 16 * kPackedC;
  const int c = packed ? kPackedC : lanes / 4;
  if (chunk < 1 || n_blocks < 0 || tile_h < 1 || tile_w < 1 || width < 0 || height < 0 ||
      (tile_start == nullptr) != (tile_count == nullptr) || atlas_dtype < 0 || atlas_dtype > 2 ||
      (!packed && (lanes % 4 != 0 || c < 4)) || (atlas_dtype == 0 && c != kPackedC))
    return static_cast<int>(cudaErrorInvalidValue);
  Level L;
  L.coef = coef;
  L.tri_id = tri_id;
  L.valid = valid;
  L.rows = rows;
  L.tile_start = tile_start;
  L.tile_count = tile_count;
  L.arec = arec;
  L.out_key = out_key;
  L.out_id = out_id;
  L.stats = reinterpret_cast<unsigned long long*>(stats);
  L.n_blocks = n_blocks;
  L.chunk = chunk;
  L.tile_h = tile_h;
  L.tile_w = tile_w;
  L.n_tx = (width + tile_w - 1) / tile_w;
  L.rects_x = (tile_w + kRectW - 1) / kRectW;
  L.n_rects = L.rects_x * ((tile_h + kRectH - 1) / kRectH);
  L.width = width;
  L.height = height;
  L.y_offset = y_offset;
  L.full_w = static_cast<float>(width);
  L.full_h = static_cast<float>(full_height);
  const Atlas A{static_cast<const unsigned char*>(atlas), atlas_width, lanes, c, atlas_dtype,
                packed};
  const int n_tiles = L.n_tx * ((height + tile_h - 1) / tile_h);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_tiles > 0) {
    if (stats != nullptr)
      masked_raster_kernel<true><<<n_tiles, kThreads, 0, s>>>(L, A, bilinear != 0);
    else
      masked_raster_kernel<false><<<n_tiles, kThreads, 0, s>>>(L, A, bilinear != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
