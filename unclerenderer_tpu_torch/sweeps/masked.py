"""M1, the masked raster (``csrc/masked_raster.cu``), at the inputs one
1920x1080 masked frame gives it: the headline geometry with masked models
(``synthetic_device_scene(340, sphere_res=(32, 24), ground=True,
with_masked=True)``) at the Renderer's exact ``masked_tri_cap``, whose
two masked levels are M1's two calls.

For each call it prints what the inputs hold -- tiles, the per-tile block
counts (most, mean, how many tiles have none, how many the shipped split
divides), the covered pairs, the alpha taps the level needs (the plain
``masked_needed_taps``) and the pairs each form taps, in the whole level
and in its busiest tile -- and the device time of every form, each
first held bit-equal to the plain version (``masked_raster_ref``: key
bits, ids, live blocks and covered pairs):

* ``shipped``  -- the kernel wrapper of ``ops/raster_kernels.py``;
* ``previous`` -- the kernel before the redesign (source below): one thread
  block a tile, the taps in slot order;
* ``split N`` / ``no split`` -- the shipped source with a tile of more than
  N blocks split into items of N blocks (shipped: ``MASKED_SPLIT``), or no
  tile split;
* ``list L``   -- a pixel's candidate list of L entries (shipped: 8;
  1 taps each candidate that beats the floor as it comes, in slot order);
* ``2 / 3 / 5 blocks an SM`` -- the main kernel's registers capped so
  that 3 or 5 of its thread blocks fit an SM (``__launch_bounds__``;
  shipped: 4), or not capped (116 registers: 2);
* ``empty tiles as items`` -- a tile of no block is an item of the main
  kernel (shipped: the main kernel's blocks write the empty tiles' -1s
  after the items, in 16-byte stores);
* ``(diagnostic) every tap passes`` / ``no records`` / ``plan only`` --
  the first candidate of each list taken untapped, no staged record
  evaluated, or the plan kernel alone: what the taps, what everything but
  the records, and what the plan cost (not results).

Device time per call: eager (CUDA events over 20 calls) and graph (10
calls in one CUDA graph), median of three rounds taken in turns.
``--ptxas`` first prints what ``nvcc -Xptxas -v`` says of the shipped and
previous sources; ``--forms`` times only the forms named (beside the
shipped one).  ``chip_smoke.py`` logs ``level_counts`` of the frame's two
calls.  Run from the repository root on a CUDA machine::

    python3 -m unclerenderer_tpu_torch.sweeps.masked [--ptxas] [--out FILE.json]
        [--forms LABEL ...]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops import _cuda
from ..ops import raster_kernels as rk
from ..timing import cuda_ms, graph_ms, nvidia_smi
from .raster import DIAGNOSTIC, ptxas, shipped_source

WIDTH, HEIGHT, SHADOW = 1920, 1080, 4096
ROUNDS, REPS, EAGER_REPS = 3, 10, 20
PREVIOUS_LABEL = "previous"
PREVIOUS_SIGNATURE = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 12 + [ctypes.c_void_p]

BOUNDS = "constexpr int kMinBlocks = 4;"
TAP = "if (alpha_passes(arec + bp * kArec, qx, qy, A, bilinear)) {"
PLAN = "                       kPlanThreads, 0, s>>>(L);\n"
SPLIT = "constexpr int kSplit = 1;"
LIST = "constexpr int kList = 8;"
VARIANTS = {
    "split 2": [(SPLIT, "constexpr int kSplit = 2;")],
    "split 4": [(SPLIT, "constexpr int kSplit = 4;")],
    "no split": [(SPLIT, "constexpr int kSplit = 0;")],
    "list 1": [(LIST, "constexpr int kList = 1;")],
    "list 4": [(LIST, "constexpr int kList = 4;")],
    "list 16": [(LIST, "constexpr int kList = 16;")],
    "2 blocks an SM": [(BOUNDS, BOUNDS.replace("= 4;", "= 2;"))],
    "3 blocks an SM": [(BOUNDS, BOUNDS.replace("= 4;", "= 3;"))],
    "5 blocks an SM": [(BOUNDS, BOUNDS.replace("= 4;", "= 5;"))],
    "empty tiles as items": [("return count <= 0 ? 0 :", "return count <= 0 ? 1 :")],
    DIAGNOSTIC + "every tap passes": [(TAP, "if (true) {")],
    DIAGNOSTIC + "no records": [("const int n = s_n[cur];", "const int n = 0 * s_n[cur];")],
    DIAGNOSTIC + "plan only": [(PLAN, PLAN + "  if (L.n_tiles > 0) return static_cast<int>("
                                             "cudaGetLastError());\n")],
}

PREVIOUS = r"""// M1: the alpha-masked raster, one level of it.
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
"""


def entry_name(label: str) -> str:
    return "sweep_m1_" + "".join(ch if ch.isalnum() else "_" for ch in label)


def variant_sources(labels=None) -> dict:
    """label -> stand-alone source text (headers pasted in, the C entry
    renamed): the previous kernel and the shipped source with its lines replaced."""
    def renamed(text, label):
        return text.replace('extern "C" int masked_raster(', f'extern "C" int {entry_name(label)}(')

    out = {PREVIOUS_LABEL: renamed(PREVIOUS, PREVIOUS_LABEL)}
    for header in _cuda.headers():
        out[PREVIOUS_LABEL] = out[PREVIOUS_LABEL].replace(f'#include "{header.name}"',
                                                          header.read_text())
    shipped = shipped_source("masked_raster")
    for label, edits in VARIANTS.items():
        text = shipped
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"masked_raster.cu no longer holds a line of {label!r}")
            text = text.replace(old, new)
        out[label] = renamed(text, label)
    return {k: v for k, v in out.items() if labels is None or k in labels}


def build(sources: dict) -> dict:
    """label -> bound C entry: one nvcc a source, all started together."""
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, text in sources.items():
        name = entry_name(label)
        src, lib = _cuda.BUILD_DIR / f"{name}.cu", _cuda.BUILD_DIR / f"{name}.so"
        src.write_text(text)
        procs[label] = (lib, subprocess.Popen(
            [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for label, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on M1 form {label!r}:\n{log}")
        fn = getattr(ctypes.PyDLL(str(lib)), entry_name(label))
        fn.argtypes = (PREVIOUS_SIGNATURE if label == PREVIOUS_LABEL
                       else _cuda.SIGNATURES["masked_raster"])
        fn.restype = ctypes.c_int
        fns[label] = fn
    return fns


def entry_call(fn, label, args, stats=False):
    """One call of a form's C entry on ``masked_raster``'s positional
    arguments: (key, id, counts or None) as the wrapper returns them."""
    (coef, tri_id, valid, rows, start, count, arec, atlas, atlas_width, tile_h, tile_w, width,
     height, y_offset, full_height, bilinear) = args
    tri_id, valid, rows, n_tiles = rk._masked_inputs(coef, tri_id, valid, rows, start, count,
                                                     arec, tile_h, tile_w, width, height)
    lanes, dtype = rk._masked_atlas(atlas)
    dev = coef.device
    key = torch.empty((height, width), dtype=torch.float32, device=dev)
    ids = torch.empty((height, width), dtype=torch.int32, device=dev)
    counts = torch.zeros(3, dtype=torch.int64, device=dev) if stats else None
    head = (coef.data_ptr(), tri_id.data_ptr(), valid.data_ptr(), rows.data_ptr(),
            _cuda.ptr(start), _cuda.ptr(count), arec.data_ptr(), atlas.data_ptr(),
            key.data_ptr(), ids.data_ptr(), _cuda.ptr(counts))
    tail = (coef.shape[0], coef.shape[-1], tile_h, tile_w, width, height, int(y_offset),
            height if full_height is None else full_height, atlas_width, lanes, dtype,
            int(bilinear), torch.cuda.current_stream().cuda_stream)
    if label == PREVIOUS_LABEL:
        err = fn(*head, *tail)
    else:
        scratch = torch.empty(rk.masked_scratch_bytes(start is not None, coef.shape[0], n_tiles,
                                                      width, height) // 8,
                              dtype=torch.int64, device=dev)
        err = fn(*head, scratch.data_ptr(), *tail)
    if err:
        raise RuntimeError(f"M1 form {label!r}: cudaError {err}")
    if counts is None:
        return key, ids, None
    return key, ids, {"blocks": counts[0], "covered": counts[1], "tapped": counts[2]}


def frame_calls(dev):
    """M1's two calls of one masked 1080p frame: [(args, kwargs)], level 1
    first."""
    from ..render.deferred import deferred_frame
    from ..render.params import FrameState, RenderSettings
    from ..render.testing import synthetic_device_scene, synthetic_frame_params

    scene, data = synthetic_device_scene(340, sphere_res=(32, 24), ground=True, with_masked=True,
                                         device=dev)
    cap = -(-int(((data.alpha_mode == 1)[data.tri_model]).sum()) // 64) * 64
    settings = RenderSettings(width=WIDTH, height=HEIGHT, shadow_map_size=SHADOW,
                              masked_tri_cap=cap)
    params = synthetic_frame_params(data, WIDTH, HEIGHT, device=dev, camera_pos=(0.0, 1.5, -4.0))
    calls, orig = [], rk.masked_raster

    def rec(*a, **k):
        calls.append((a[:16], k))  # without the frame's stats flag
        return orig(*a, **k)

    rk.masked_raster = rec
    try:
        deferred_frame(scene, params, FrameState.initial(WIDTH, HEIGHT, dev), settings)
        torch.cuda.synchronize()
    finally:
        rk.masked_raster = orig
    return calls


def tile_counts(args, split=rk.MASKED_SPLIT) -> dict:
    """The level's per-tile block counts (binned form; the exhaustive form
    walks every chunk in every tile) and the items the split makes."""
    coef, start, count = args[0], args[4], args[5]
    if count is None:
        return {"form": "exhaustive", "chunks": int(coef.shape[0])}
    c = count.long()
    items = rk.masked_split(start, count, coef.shape[0], split)[0].shape[0]
    return {"tiles": int(c.shape[0]), "blocks": int(c.sum()), "most": int(c.max()),
            "mean": float(c.double().mean()), "mean_of_nonzero": float(c[c > 0].double().mean())
            if bool((c > 0).any()) else 0.0, "zero_tiles": int((c == 0).sum()),
            "split_tiles": int((c > split).sum()) if split > 0 else 0, "items": int(items)}


def busiest_only(args):
    """``args`` with every tile but the one of most blocks emptied."""
    count = args[5]
    only = torch.zeros_like(count)
    t = int(torch.argmax(count))
    only[t] = count[t]
    return args[:5] + (only,) + args[6:]


def check_form(label, out, want):
    key, ids, n = out
    if not (torch.equal(key.view(torch.int32), want[0].view(torch.int32))
            and torch.equal(ids, want[1])):
        raise RuntimeError(f"M1 form {label!r} != plain")
    if n is not None and not (int(n["blocks"]) == int(want[2]["blocks"])
                              and int(n["covered"]) == int(want[2]["covered"])
                              and int(n["tapped"]) <= int(n["covered"])):
        raise RuntimeError(f"M1 form {label!r} counts {n} vs plain {want[2]}")


def level_counts(args, kwargs) -> dict:
    """What one call's inputs hold and what the shipped wrapper taps there:
    the per-tile block counts (``tile_counts``), the plain version's live
    blocks, covered pairs and the taps the level needs
    (``masked_needed_taps``), the wrapper's tapped pairs; the same for its
    busiest tile alone (binned form)."""
    def counts(a):
        need = rk.masked_needed_taps(*a, **kwargs)
        got = rk.masked_raster(*a, **kwargs, stats=True)[2]
        return {"live_blocks": need["blocks"], "covered": need["covered"],
                "needed": need["needed"], "tapped": int(got["tapped"])}

    row = {**tile_counts(args), **counts(args)}
    if args[5] is not None:
        row["busiest_tile"] = counts(busiest_only(args))
    return row


def compare_forms(calls, fns, smi, log=print) -> list:
    """Each call's forms (``fns``: label -> C entry, beside the shipped
    wrapper) held bit-equal to plain in the level and in its busiest tile
    alone, with their tapped pairs there beside ``level_counts``, then
    timed eager and graph in turns.  Returns one row a call."""
    rows = []
    for level, (a, k) in enumerate(calls, 1):
        forms = {"shipped": lambda a=a, k=k, stats=False: rk.masked_raster(*a, **k, stats=stats)}
        for label, fn in fns.items():
            forms[label] = lambda a=a, fn=fn, label=label, stats=False: entry_call(
                fn, label, a, stats)
        row = {"level": level, **level_counts(a, k)}
        parts = [(row, a)] + ([(row["busiest_tile"], busiest_only(a))] if a[5] is not None else [])
        for part, args in parts:
            want = rk.masked_raster_ref(*args, **k, stats=True)
            part["tapped"] = {}
            for label in forms:
                out = (rk.masked_raster(*args, **k, stats=True) if label == "shipped"
                       else entry_call(fns[label], label, args, stats=True))
                if not label.startswith(DIAGNOSTIC):
                    check_form(label, out, want)
                part["tapped"][label] = int(out[2]["tapped"])
        eager, graph = {}, {}
        order = list(forms.items())
        for r in range(ROUNDS):
            for label, fn in (order if r % 2 == 0 else order[::-1]):
                eager.setdefault(label, []).append(cuda_ms(fn, EAGER_REPS))
                graph.setdefault(label, []).append(graph_ms(fn, REPS))
        row["eager_ms"] = {v: statistics.median(ts) for v, ts in eager.items()}
        row["graph_ms"] = {v: statistics.median(ts) for v, ts in graph.items()}
        row["graph_ms_rounds"] = graph
        rows.append(row)
        counts = {key: v for key, v in row.items() if key not in (
            "level", "eager_ms", "graph_ms", "graph_ms_rounds")}
        log(f"[m1 level {level}] {counts}")
        log(f"[m1 level {level}] eager / graph ms per call: "
            + ", ".join(f"{v} {row['eager_ms'][v]:.4f} / {row['graph_ms'][v]:.4f}" for v in forms)
            + f" (each bit-equal to plain; {smi})")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v first")
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    ap.add_argument("--forms", nargs="+", default=None, metavar="LABEL",
                    help="time only these forms beside the shipped one (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("masked sweep: needs a CUDA card")
    smi = nvidia_smi()
    result = {"device": smi, "ptxas": {}}
    sources = variant_sources(args.forms)
    if args.ptxas:
        result["ptxas"]["shipped"] = ptxas("shipped", _cuda.CSRC / "masked_raster.cu")
        with tempfile.TemporaryDirectory() as tmp:
            for label, text in sources.items():
                if label == PREVIOUS_LABEL or "blocks an SM" in label:
                    src = Path(tmp) / f"{entry_name(label)}.cu"
                    src.write_text(text)
                    result["ptxas"][label] = ptxas(label, src)
    _cuda.library()
    fns = build(sources)
    result["calls"] = compare_forms(frame_calls(torch.device("cuda", 0)), fns, smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
