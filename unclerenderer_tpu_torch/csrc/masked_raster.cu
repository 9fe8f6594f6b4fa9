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
// Work items.  Binned form (tile_start != NULL): tile t owns the block range
// [tile_start, tile_start + tile_count) of the level's (blocks, 16, chunk)
// bins (ops/raster_kernels.py tile_block_ranges).  A tile with more than
// kSplit blocks is split into ceil(count / kSplit) items of at most kSplit
// blocks each, a tile of no block is no item, any other tile is one item.
// Exhaustive form (tile_start == NULL): one item a tile, over every chunk of
// the (chunks, 16, chunk) table.  A first kernel (masked_plan_kernel) lays
// the items out on the card, with no read back to the host, so a level
// captures into a CUDA graph: block 0 scans the tiles' item counts into the
// item table and lists the empty tiles, every block zeroes the packed words
// of the split tiles' pixels.  The main kernel is persistent (as many
// thread blocks as the card holds at once, kMinBlocks an SM); each takes
// the next item from a counter, and when none is left writes its share of
// the empty tiles' output.  ops/raster_kernels.py masked_split is the
// plan's plain version.
//
// Staging.  An item walks its blocks kStage slots at a time.  A stage's raw
// columns (15 coefficients, flag, id, record row) are copied with cp.async
// one stage ahead; warp 0 then keeps each slot that is valid and whose
// edges may pass at a pixel of the tile -- ops/raster_kernels.py
// _edge_may_pass at the tile's corners, in the plain version's own
// arithmetic: a superset filter -- as a record of raster_common.cuh, and the
// kept slots' 19-column alpha records (render/common.py _alpha_records) are
// copied with cp.async while the stage before is tested, double-buffered.
// In the exhaustive form a chunk with no such slot counts as no live block.
//
// Per stage, a warp owns 8 x 4 pixels of the tile at a time (lane l at row
// l / 8, column l % 8), the tile's rectangles dealt to the 8 warps in turn.
// Per pixel the max depth key wins, then the min triangle id among the keys
// at that max, compared by value (-0.0 and +0.0 tie): the reference's block
// and tile segment merges, exact in any visiting order.  Two phases:
//   1. coverage: each staged slot that some pixel of the warp's rectangle
//      may pass (the warp skip of raster_common.cuh, exact by
//      monotonicity) gets the edge and depth tests of ops/raster.py
//      eval_keys at each lane's pixel; a covered pair that could change the
//      pixel's winner (its packed word above the pixel's best) goes into the
//      lane's list of kList (key, slot) entries in shared memory;
//   2. taps in key order: each lane takes its list's entries in descending
//      key, then ascending id, and runs the alpha test (the interpolation
//      of u, v and vertex alpha, _alpha_lod, _alpha_tap and the cutoff of
//      ops/raster_kernels.py) until one passes: that one is the winner of
//      the list, and the rest are never tapped.  The 32 lanes tap at once,
//      so their chains of divides, log2 and atlas reads overlap.  A list
//      that fills is tapped at once and coverage goes on with the new best
//      as the floor; the result is the same.
// A pair that cannot change the winner needs no tap, so the result is the
// one of tapping every covered pair.
//
// Merge.  A winner is a packed word, (bits(key) + 1) << 32 | (0x7fffffff -
// id) with -0 taken as +0: a larger word is a larger key, then a smaller id,
// and 0 is "nothing won" (ops/raster_kernels.py masked_pack).  An item of an
// unsplit tile keeps its pixels' winners in the output images (a thread
// reads and writes only its own pixels).  The items of a split tile merge
// with a 64-bit atomicMax into the scratch word of each pixel -- order-free,
// so exact -- and read it back as the floor of each stage (it only grows);
// the last item of the tile to finish (a ticket counter) writes the tile's
// output.  The output keys are -1 where nothing won and +0.0
// for a zero key, and the ids -1 where nothing won.
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
// What bounds it.  At 1080p the masked frame's level 1 has 1,125 live
// blocks of 64 slots over 2,040 tiles of 16 x 64 (1,723 tiles empty, 17
// blocks in the busiest) and 232,830 covered pairs, of which it needs
// 213,516 alpha taps (ops/raster_kernels.py masked_needed_taps: each
// pixel's covered pairs in key order down to its winner); the 30 MB it must
// move (the live blocks, their alpha records, the two images, those taps'
// texels) bound it at 0.009 ms on an H100.  The kernel before this design (one
// thread block a tile, the taps in slot order, one lane's chain at a time
// for the whole warp) took 0.61 ms there, the busiest tile's 17 blocks in
// one thread block.  This one takes 0.088 ms graph-replayed (NVIDIA H100
// 80GB HBM3, 700 W; python3 -m unclerenderer_tpu_torch.sweeps.masked): the
// plan 0.009 of it, the items' staging 0.018, the edge and depth tests of
// the (rectangle, slot) pairs that the warp skip keeps 0.040 and the taps
// 0.021 (the sweep's diagnostic forms).  Those tests run warp-wide, one
// slot at a time, and the SMs issue them at 64 registers a thread (116
// uncapped: 2 thread blocks an SM instead of 4, 0.121 ms).  It taps about
// 230,000 pairs, 8% more than needed: most pixels meet one candidate in a
// block, and a split tile's items take their floor only from the items
// that finished before them (the count varies from run to run by that
// order; the image does not).  The empty tiles' -1s, written after the
// items in 16-byte stores, take about 0.0025 ms less at level 1 and 0.001
// less at level 2 (no live block) than empty tiles as items of their own
// (in every call that timed both).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

using raster::lin;

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // thread blocks an SM: caps the registers at 64 a thread
constexpr int kWarps = kThreads / 32;
constexpr int kRectH = 4, kRectW = 8;  // a warp's pixels: lane l at (l / kRectW, l % kRectW)
constexpr int kStage = 64;             // slots staged at once (warp 0 keeps them: 2 x 32)
constexpr int kF4 = 5;                 // float4s a record (raster_common.cuh)
constexpr int kArec = 19;              // alpha record columns
constexpr int kRaw = 18;               // raw columns a slot: 15 coefficients, flag, id, row
constexpr int kPackedC = 16;           // channels of a packed-trilinear texel (256 lanes)
constexpr int kSplit = 1;              // a tile with more blocks is split into items of kSplit
constexpr int kList = 8;               // a pixel's candidate list (entries)
constexpr int kSplitDiv = kSplit > 0 ? kSplit : 1;
constexpr int kPlanThreads = 1024, kPlanBlocks = 132, kPlanTiles = 64;
constexpr int kMaxDevices = 64;

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
  // the scratch (binned form: all; exhaustive form: next and total)
  unsigned long long* words;  // (height, width) packed winners of the split tiles' pixels
  int2* items;                // (tile, part) of each work item: n_tiles + n_blocks at most
  int* parts;                 // (n_tiles,) items of each tile
  unsigned* tickets;          // (n_tiles,) items of a split tile that have finished
  int* empties;               // (n_tiles,) the tiles of no block, n_empty of them
  int* next;                  // the next work item to take
  int* total;                 // work items
  int* n_empty;
  int n_blocks, chunk, tile_h, tile_w, n_tx, n_tiles, rects_x, n_rects, width, height, y_offset;
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


// 4 bytes global -> shared, asynchronously (cp.async); waited for by
// cp_async_wait_all and made visible to the block by the __syncthreads after
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the packed winner word (ops/raster_kernels.py masked_pack): keys in [0, 1]
__device__ __forceinline__ uint32_t key_bits(float key) {
  return key == 0.f ? 0u : __float_as_uint(key);  // -0 as +0
}
__device__ __forceinline__ unsigned long long pack(uint32_t kb, int id) {
  return (static_cast<unsigned long long>(kb + 1u) << 32) |
         (0x7fffffffu - static_cast<uint32_t>(id));
}
__device__ __forceinline__ float unpack_key(unsigned long long w) {
  return w == 0ull ? -1.f : __uint_as_float(static_cast<uint32_t>(w >> 32) - 1u);
}
__device__ __forceinline__ int unpack_id(unsigned long long w) {
  return w == 0ull ? -1 : static_cast<int>(0x7fffffffu - static_cast<uint32_t>(w));
}

// the items of a tile of `count` blocks in the binned form
// (ops/raster_kernels.py masked_split): none for an empty tile (the main
// kernel writes its output after the items)
__device__ __forceinline__ int tile_parts(int count) {
  return count <= 0 ? 0 : kSplit > 0 && count > kSplit ? (count + kSplit - 1) / kSplitDiv : 1;
}

// Tile t's pixels, by `threads` threads from thread `tid`: an empty tile's
// output (-1, -1), or a split tile's packed words zeroed; 4 pixels a
// thread where a row's 4-pixel groups are 16-byte aligned.
__device__ __forceinline__ void fill_tile(const Level& L, int t, bool empty, int tid, int threads) {
  const bool vec = L.width % 4 == 0 && L.tile_w % 4 == 0;
  const int group = vec ? 4 : 1, per_row = L.tile_w / group;
  const int px0 = (t % L.n_tx) * L.tile_w, py0 = (t / L.n_tx) * L.tile_h;
  for (int p = tid; p < L.tile_h * per_row; p += threads) {
    const int gx = px0 + (p % per_row) * group, gy = py0 + p / per_row;
    if (gx >= L.width || gy >= L.height) continue;
    const size_t o = static_cast<size_t>(gy) * L.width + gx;
    if (vec && empty) {
      *reinterpret_cast<float4*>(L.out_key + o) = make_float4(-1.f, -1.f, -1.f, -1.f);
      *reinterpret_cast<int4*>(L.out_id + o) = make_int4(-1, -1, -1, -1);
    } else if (vec) {
      reinterpret_cast<ulonglong2*>(L.words + o)[0] = make_ulonglong2(0ull, 0ull);
      reinterpret_cast<ulonglong2*>(L.words + o)[1] = make_ulonglong2(0ull, 0ull);
    } else if (empty) {
      L.out_key[o] = -1.f;
      L.out_id[o] = -1;
    } else {
      L.words[o] = 0ull;
    }
  }
}

// The work items (binned form): every block zeroes the packed words of the
// split tiles' pixels (grid-stride over tiles); block 0 scans the tiles'
// item counts into the item table and lists the empty tiles, whose output
// the main kernel writes after its items.  Ranges that would overflow the
// table (never those of tile_block_ranges: their blocks are disjoint, so
// the items number at most n_tiles + n_blocks / kSplit) give every tile
// one item.
__global__ void __launch_bounds__(kPlanThreads) masked_plan_kernel(const Level L) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool binned = L.tile_start != nullptr;
  if (binned) {
    // this block's tiles' item counts first, so that the writes below wait
    // on no load
    __shared__ int s_parts[kPlanTiles];
    for (int t0 = blockIdx.x; t0 < L.n_tiles; t0 += gridDim.x * kPlanTiles) {
      __syncthreads();  // the previous round's counts are read
      if (tid < kPlanTiles) {
        const int t = t0 + tid * gridDim.x;
        s_parts[tid] = t < L.n_tiles ? tile_parts(L.tile_count[t]) : 1;
      }
      __syncthreads();
      for (int i = 0; i < kPlanTiles; ++i)
        if (s_parts[i] > 1) fill_tile(L, t0 + i * gridDim.x, false, tid, kPlanThreads);
    }
  }
  if (blockIdx.x != 0) return;
  if (!binned) {
    if (tid == 0) {
      *L.next = 0;
      *L.total = L.n_tiles;
      *L.n_empty = 0;
    }
    return;
  }
  __shared__ int s_warp[kPlanThreads / 32];
  __shared__ int s_carry, s_empty;
  if (tid == 0) s_carry = s_empty = 0;
  __syncthreads();
  const long long cap = static_cast<long long>(L.n_tiles) + L.n_blocks;
  for (int base = 0; base < L.n_tiles; base += kPlanThreads) {
    const int t = base + tid;
    const int k = t < L.n_tiles ? tile_parts(L.tile_count[t]) : 0;
    int x = k;  // inclusive scan within the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    int first = s_carry + x - k;
    for (int w = 0; w < warp; ++w) first += s_warp[w];
    if (t < L.n_tiles) {
      L.parts[t] = k;
      L.tickets[t] = 0u;
      for (int s = 0; s < k; ++s)
        if (first + s < cap) L.items[first + s] = make_int2(t, s);
      if (k == 0) L.empties[atomicAdd(&s_empty, 1)] = t;  // in any order
    }
    __syncthreads();  // s_carry and s_warp are read
    if (tid == kPlanThreads - 1) s_carry = first + k;
    __syncthreads();
  }
  const bool overflow = s_carry > cap;
  if (overflow)
    for (int t = tid; t < L.n_tiles; t += kPlanThreads) {
      L.parts[t] = 1;
      L.items[t] = make_int2(t, 0);
    }
  if (tid == 0) {
    *L.next = 0;
    *L.total = overflow ? L.n_tiles : s_carry;
    *L.n_empty = overflow ? 0 : s_empty;
  }
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
masked_raster_kernel(const Level L, const Atlas A, const bool bilinear) {
  __shared__ float s_raw[kRaw][kStage];
  __shared__ float4 s_rec[2][kStage * kF4];
  __shared__ float s_arec[2][kStage * kArec];
  __shared__ int s_row[2][kStage];
  __shared__ int s_n[2];
  __shared__ uint32_t s_lkey[kWarps][kList][32];  // each lane's candidate list:
  __shared__ unsigned char s_lpos[kWarps][kList][32];  // key bits and slot
  __shared__ int s_item[4];  // tile (-1: no more), first block, blocks, parts of the tile
  __shared__ int s_last;
  __shared__ unsigned long long s_sum[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool binned = L.tile_start != nullptr;
  const int total = *L.total, n_empty = *L.n_empty;
  const int spb = (L.chunk + kStage - 1) / kStage;  // stages a block
  unsigned covered = 0, tapped = 0, live = 0;

  for (;;) {
    __syncthreads();  // the previous item's shared state is read
    if (threadIdx.x == 0) {
      const int item = atomicAdd(L.next, 1);
      int tile = -1, b0 = 0, nb = 0, parts = 1;
      if (item < total) {
        if (binned) {
          const int2 it = L.items[item];
          tile = it.x;
          parts = L.parts[tile];
          const int count = L.tile_count[tile];
          const int j0 = parts > 1 ? it.y * kSplit : 0;
          b0 = L.tile_start[tile] + j0;
          nb = parts > 1 ? min(kSplit, count - j0) : count;
        } else {
          tile = item;
          nb = L.n_blocks;
        }
      }
      s_item[0] = tile;
      s_item[1] = b0;
      s_item[2] = nb;
      s_item[3] = parts;
    }
    __syncthreads();
    const int tile = s_item[0];
    if (tile < 0) break;
    const int b0 = s_item[1], nb = s_item[2], parts = s_item[3];
    const bool split = parts > 1;
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
    // stage g's raw columns -> s_raw (slots past the chunk: flag 0)
    auto issue_raw = [&](int g) {
      const size_t b = static_cast<size_t>(b0 + g / spb);
      const int s0 = (g % spb) * kStage;
      for (int i = threadIdx.x; i < kRaw * kStage; i += kThreads) {
        const int c = i / kStage, s = i - c * kStage, slot = s0 + s;
        if (slot >= L.chunk) {
          if (c == 15) s_raw[15][s] = 0.f;
          continue;
        }
        const size_t at = b * L.chunk + slot;
        const void* src = c < 15   ? static_cast<const void*>(L.coef + (b * 16 + c) * L.chunk + slot)
                          : c == 15 ? static_cast<const void*>(L.valid + at)
                          : c == 16 ? static_cast<const void*>(L.tri_id + at)
                                    : static_cast<const void*>(L.rows + at);
        cp_async4(&s_raw[c][s], src);
      }
    };
    // warp 0: s_raw's slots that are valid and may reach the tile -> records
    // of buffer buf, compacted in slot order
    auto compact = [&](int buf) {
      if (warp != 0) return;
      int n = 0;
#pragma unroll
      for (int h = 0; h < kStage / 32; ++h) {
        const int s = h * 32 + lane;
        float v[15];
        bool ok = false;
        if (s_raw[15][s] > 0.f) {
#pragma unroll
          for (int i = 0; i < 15; ++i) v[i] = s_raw[i][s];
          ok = may_reach_tile(v, cx, cy, L.full_w, L.full_h);
        }
        const unsigned mk = __ballot_sync(0xffffffffu, ok);
        if (ok) {
          const int pos = n + __popc(mk & ((1u << lane) - 1u));
          raster::put_record<kF4>(s_rec[buf] + pos * kF4, v, true, s_raw[16][s]);
          s_row[buf][pos] = __float_as_int(s_raw[17][s]);
        }
        n += __popc(mk);
      }
      if (lane == 0) s_n[buf] = n;
    };
    // the kept slots' alpha records -> buffer buf
    auto issue_arec = [&](int buf) {
      const int n = s_n[buf];
      for (int i = threadIdx.x; i < n * kArec; i += kThreads) {
        const int pos = i / kArec;
        cp_async4(&s_arec[buf][i],
                  L.arec + static_cast<size_t>(s_row[buf][pos]) * kArec + (i - pos * kArec));
      }
    };

    if (!split)  // nothing won yet
      for (int r = warp; r < L.n_rects; r += kWarps) {
        int gx, gy;
        if (pixel(r, gx, gy)) {
          const size_t o = static_cast<size_t>(gy) * L.width + gx;
          L.out_key[o] = -1.f;
          L.out_id[o] = -1;
        }
      }
    const int n_st = nb * spb;
    if (n_st > 0) {
      issue_raw(0);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      compact(0);
      __syncthreads();
      issue_arec(0);
      if (n_st > 1) issue_raw(1);
      cp_async_commit();
    }
    bool any = false;  // the block holds a slot that may reach the tile
    for (int g = 0; g < n_st; ++g) {
      const int cur = g & 1;
      cp_async_wait_all();
      __syncthreads();  // stage g's alpha records and stage g + 1's raw columns are in
      if (g + 1 < n_st) compact(cur ^ 1);
      __syncthreads();  // s_raw is read; stage g + 1's records are ready
      if (g + 1 < n_st) issue_arec(cur ^ 1);
      if (g + 2 < n_st) issue_raw(g + 2);
      cp_async_commit();
      const int n = s_n[cur];
      any = any || n > 0;
      if (g % spb == spb - 1) {
        if (kStats && threadIdx.x == 0 && (binned || any)) ++live;
        any = false;
      }
      if (n == 0) continue;
      const float4* rec = s_rec[cur];
      const float* arec = s_arec[cur];

      for (int r = warp; r < L.n_rects; r += kWarps) {
        int gx, gy;
        const bool in = pixel(r, gx, gy);
        const size_t o = in ? static_cast<size_t>(gy) * L.width + gx : 0;
        const float qx = __fadd_rn(static_cast<float>(gx), 0.5f);
        const float qy = __fadd_rn(static_cast<float>(gy + L.y_offset), 0.5f);
        // the rectangle's extreme pixel centres
        const int rx = px0 + (r % L.rects_x) * kRectW;
        const int ry = py0 + (r / L.rects_x) * kRectH + L.y_offset;
        const float2 xs = make_float2(__fadd_rn(static_cast<float>(rx), 0.5f),
                                      __fadd_rn(static_cast<float>(rx + kRectW - 1), 0.5f));
        const float2 ys = make_float2(__fadd_rn(static_cast<float>(ry), 0.5f),
                                      __fadd_rn(static_cast<float>(ry + kRectH - 1), 0.5f));
        // the floor: the pixel's winner so far (a split tile's word may hold
        // its other items' winners too)
        unsigned long long best = 0ull;
        if (in) {
          if (split) {
            best = __ldcg(L.words + o);
          } else {
            const float k0 = L.out_key[o];
            best = k0 < 0.f ? 0ull : pack(key_bits(k0), L.out_id[o]);
          }
        }
        int cnt = 0;  // this lane's list: key bits and slot, entry j at [j][lane]
        uint32_t* lkey = &s_lkey[warp][0][lane];
        unsigned char* lpos = &s_lpos[warp][0][lane];
        // tap the lists in descending key, then ascending id, to the first pass
        auto tap_lists = [&]() {
          while (__any_sync(0xffffffffu, cnt > 0)) {
            if (cnt == 0) continue;
            int bj = 0, bp = lpos[0];
            uint32_t bk = lkey[0];
            int bid = __float_as_int(rec[bp * kF4 + 4].w);
            for (int j = 1; j < cnt; ++j) {
              const uint32_t kj = lkey[j * 32];
              if (kj < bk) continue;
              const int pj = lpos[j * 32], ij = __float_as_int(rec[pj * kF4 + 4].w);
              if (kj > bk || ij < bid) {
                bj = j;
                bk = kj;
                bp = pj;
                bid = ij;
              }
            }
            --cnt;
            lkey[bj * 32] = lkey[cnt * 32];
            lpos[bj * 32] = lpos[cnt * 32];
            if (kStats) ++tapped;
            if (alpha_passes(arec + bp * kArec, qx, qy, A, bilinear)) {
              best = pack(bk, bid);  // the list's winner: the rest are below it
              cnt = 0;
            }
          }
        };
        for (int r0 = 0; r0 < n; r0 += 32) {
          bool may = false;
          if (r0 + lane < n) {
            const float4* q = rec + (r0 + lane) * kF4;
            may = q[3].w == 0.f || (raster::reach(q[0], xs, ys) && raster::reach(q[1], xs, ys) &&
                                    raster::reach(q[2], xs, ys));
          }
          for (unsigned todo = __ballot_sync(0xffffffffu, may); todo != 0; todo &= todo - 1) {
            const int k = r0 + __ffs(todo) - 1;
            if (in) {
              const float4* q = rec + k * kF4;
              const float4 e0 = q[0], e1 = q[1], e2 = q[2], z = q[3], w = q[4];
              if (lin(e0.x, e0.y, e0.z, qx, qy) >= e0.w && lin(e1.x, e1.y, e1.z, qx, qy) >= e1.w &&
                  lin(e2.x, e2.y, e2.z, qx, qy) >= e2.w) {
                const float nw = lin(w.x, w.y, w.z, qx, qy);
                const float key = nw > 0.f ? __fdiv_rn(lin(z.x, z.y, z.z, qx, qy), nw) : -1.f;
                if (key >= 0.f && key <= 1.f) {
                  if (kStats) ++covered;
                  const uint32_t kb = key_bits(key);
                  if (pack(kb, __float_as_int(w.w)) > best) {
                    lkey[cnt * 32] = kb;
                    lpos[cnt * 32] = static_cast<unsigned char>(k);
                    ++cnt;
                  }
                }
              }
            }
            if (__any_sync(0xffffffffu, cnt == kList)) tap_lists();  // a full list: tap it now
          }
        }
        tap_lists();
        if (in) {
          if (split) {
            if (best != 0ull) atomicMax(L.words + o, best);
          } else {
            L.out_key[o] = unpack_key(best);
            L.out_id[o] = unpack_id(best);
          }
        }
      }
    }

    if (split) {  // the tile's last item to finish writes its output
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0)
        s_last = atomicAdd(L.tickets + tile, 1u) == static_cast<unsigned>(parts - 1);
      __syncthreads();
      if (s_last) {
        __threadfence();
        for (int r = warp; r < L.n_rects; r += kWarps) {
          int gx, gy;
          if (pixel(r, gx, gy)) {
            const size_t o = static_cast<size_t>(gy) * L.width + gx;
            const unsigned long long w = __ldcg(L.words + o);
            L.out_key[o] = unpack_key(w);
            L.out_id[o] = unpack_id(w);
          }
        }
      }
    }
  }

  // this block's share of the empty tiles' output: after the items, so
  // that the blocks that run out of items write while the others finish
  for (int i = blockIdx.x; i < n_empty; i += gridDim.x)
    fill_tile(L, L.empties[i], true, threadIdx.x, kThreads);

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

// thread blocks of the persistent kernel the device holds at once
template <bool kStats>
int resident_blocks() {
  static int cached[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, masked_raster_kernel<kStats>,
                                                      kThreads, 0) != cudaSuccess)
      return 0;
    cached[dev] = sms * per;
  }
  return cached[dev];
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
// scratch: 8-byte aligned, its contents ignored, of masked_raster_scratch
// bytes (a multiple of 8; ops/raster_kernels.py masked_scratch_bytes asks).
extern "C" long long masked_raster_scratch(int binned, int n_blocks, int n_tiles, int width,
                                           int height) {
  if (!binned) return 16;  // next, total, n_empty
  const long long ints = 3LL * n_tiles + 3;  // parts, tickets, empties; next, total, n_empty
  return 8LL * width * height + 8LL * (static_cast<long long>(n_tiles) + n_blocks) +
         (4 * ints + 7) / 8 * 8;
}

extern "C" int masked_raster(const float* coef, const int* tri_id, const float* valid,
                             const int* rows, const int* tile_start, const int* tile_count,
                             const float* arec, const void* atlas, float* out_key, int* out_id,
                             long long* stats, void* scratch, int n_blocks, int chunk, int tile_h,
                             int tile_w, int width, int height, int y_offset, int full_height,
                             int atlas_width, int lanes, int atlas_dtype, int bilinear,
                             void* stream) {
  const bool packed = lanes == 16 * kPackedC;
  const int c = packed ? kPackedC : lanes / 4;
  if (chunk < 1 || n_blocks < 0 || tile_h < 1 || tile_w < 1 || width < 0 || height < 0 ||
      scratch == nullptr || (tile_start == nullptr) != (tile_count == nullptr) ||
      atlas_dtype < 0 || atlas_dtype > 2 || (!packed && (lanes % 4 != 0 || c < 4)) ||
      (atlas_dtype == 0 && c != kPackedC))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool binned = tile_start != nullptr;
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
  L.n_tiles = L.n_tx * ((height + tile_h - 1) / tile_h);
  L.rects_x = (tile_w + kRectW - 1) / kRectW;
  L.n_rects = L.rects_x * ((tile_h + kRectH - 1) / kRectH);
  L.width = width;
  L.height = height;
  L.y_offset = y_offset;
  L.full_w = static_cast<float>(width);
  L.full_h = static_cast<float>(full_height);
  // the scratch: words, items, parts, tickets, empties (binned form only),
  // next, total, n_empty
  char* p = static_cast<char*>(scratch);
  L.words = nullptr;
  L.items = nullptr;
  L.parts = nullptr;
  L.tickets = nullptr;
  L.empties = nullptr;
  if (binned) {
    L.words = reinterpret_cast<unsigned long long*>(p);
    p += 8LL * width * height;
    L.items = reinterpret_cast<int2*>(p);
    p += 8LL * (static_cast<long long>(L.n_tiles) + n_blocks);
    L.parts = reinterpret_cast<int*>(p);
    p += 4LL * L.n_tiles;
    L.tickets = reinterpret_cast<unsigned*>(p);
    p += 4LL * L.n_tiles;
    L.empties = reinterpret_cast<int*>(p);
    p += 4LL * L.n_tiles;
  }
  L.next = reinterpret_cast<int*>(p);
  L.total = L.next + 1;
  L.n_empty = L.next + 2;
  const Atlas A{static_cast<const unsigned char*>(atlas), atlas_width, lanes, c, atlas_dtype,
                packed};
  if (L.n_tiles == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const long long most =
      binned && kSplit > 0 ? static_cast<long long>(L.n_tiles) + n_blocks / kSplitDiv : L.n_tiles;
  const int resident = stats != nullptr ? resident_blocks<true>() : resident_blocks<false>();
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = static_cast<int>(most < resident ? most : resident);
  masked_plan_kernel<<<binned ? (L.n_tiles < kPlanBlocks ? L.n_tiles : kPlanBlocks) : 1,
                       kPlanThreads, 0, s>>>(L);
  if (stats != nullptr)
    masked_raster_kernel<true><<<grid, kThreads, 0, s>>>(L, A, bilinear != 0);
  else
    masked_raster_kernel<false><<<grid, kThreads, 0, s>>>(L, A, bilinear != 0);
  return static_cast<int>(cudaGetLastError());
}
