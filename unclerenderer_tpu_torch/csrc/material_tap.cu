// T1 tap_footprint, T2 material_tap and R1 interp_attrs: the material resolve's
// attribute interpolation and its tap on the packed 256-lane atlas (C = 16
// channels) with the quad-derivative LOD: one launch a resolve, then two a
// material slot.
//
// Replace no TPU kernel.  The reference runs the resolve as XLA element-wise
// code (unclerenderer_tpu/render/common.py resolve_materials: InterpAttr at
// :1048-1062; the quad corners' uvs, the KHR transform, footprint_lod or
// footprint_lod_aniso, then sample_pyramid_tri once, or max_anisotropy times
// along the major axis); so did the port, as some hundreds of PyTorch
// element-wise kernels, each writing its (H, W) or (H, W, 16) intermediate to
// device memory, the multiply-adds emulated exactly in f64 (ops/fma.py).  The
// plain versions stay beside the wrappers (ops/texture.py interp_attrs_ref,
// tap_footprint_ref, material_tap_ref) and the frame takes them on the CPU.
//
// R1, one thread a pixel, reads the record's lanes 0:60 (the three
// homogeneous screen vertices, then each vertex's 16 attribute lanes) as 15
// 16-byte loads, forms the three edge functions at the pixel centre (x + 0.5,
// global y + 0.5) and the barycentric weights, and writes the five
// interpolated attributes -- world_pos, v_normal (3 each), tangent4 (4), uv
// (2), v_color (4) -- as five (H, W, n) f32 images, the plain path's tensors.
//
// T1, one thread a pixel, reads from the (H, W, 128) resolve record image the
// pixel's three screen-space vertices (lanes 0:9), the vertices' uvs (lanes
// 19 + 16k), the slot's offset-scale, rotation and rect (lanes given), and
// the centre uv R1 interpolated.  It evaluates the triangle's uv at the
// pixel's 2x2 quad's TL, TR and BL centres (the helper lanes' bases x & ~1,
// y & ~1 on global rows) with R1's weights, transforms centre and corners,
// and writes SoA planes (K, H*W): su, sv, lod (trilinear), and dmaj.u,
// dmaj.v, extent (anisotropic, footprint_lod_aniso's minor-axis LOD).
//
// T2, laid out as K8 (mat_select.cu): kTpp threads a pixel, each holding
// kC / kTpp channels, one vector load of each of the 8 winning lane groups,
// float4 stores.  It reads the planes and the slot's rect and takes N = 1
// trilinear tap at the centre (trilinear) or N = max_anisotropy taps at
// fma(dmaj, t_k, suv), t_k = ((k + 0.5) / N - 0.5) * extent, averaged
// (anisotropic).  Each tap's mip rects, texel coordinates, WRAP remainder,
// row index and 3x3 window live in registers; only (H*W, 16) f32 is written.
//
// Bit-equal on the card to the PyTorch path they replace: every expression is
// the plain path's, operation for operation.  ops/fma.py's fma is __fmaf_rn
// (R1's and T1's fma_ also give a NaN result the emulation's payload);
// every other product, sum and quotient a single _rn intrinsic (-fmad=false
// adds no contraction); torch.log2 is log2f, torch.floor floorf, torch.round
// rintf, sqrt(x.double()).float() __dsqrt_rn then __double2float_rn; maximum,
// minimum and clamp pass NaN on as PyTorch's CUDA kernels do; _to_int is XLA's
// saturating convert; an integer remainder is a floor-mod; a Python scalar is
// rounded to f32 first.  The blends are _lerp uncontracted, or K8's lerp_fa
// and lerp_fb where RenderSettings.mat_select_kernel sends the plain path to
// K8 (kSelect).  A row index below 0 wraps by the atlas's rows, as PyTorch's
// indexing does (the rect of a zero record, fused resolve's empty pixels).
// The plain path divides the N taps' sum by N as PyTorch's CUDA division by a
// Python scalar does: a multiply by the f32 reciprocal.  The edge functions,
// weights and interpolation are written once (edge, edge_at, weights,
// interp3) for R1's centres and T1's quad corners.
//
// What bounds them: bytes.  At 1920x1080 (2,073,600 pixels) R1 reads 8
// sectors of each 512-byte record (lanes 0:64, ~531 MB) and writes 64 B a
// pixel (~133 MB): ~664 MB, ~0.20 ms at 3.35 TB/s.  Its loads are 16 bytes
// wide, all requested before the arithmetic, so each thread has its 240 bytes
// in flight at once; neighbouring threads' rows lie 512 B apart, so a warp's
// load touches 32 sectors and the next load the other halves of them, which
// L1 holds.  T1 reads 8 sectors of each record (~531 MB) and the centre uv
// (17 MB) and writes 3 or 6 planes (25 or 50 MB); T2 reads the planes and
// one record sector, each tap's 8 lane groups of its atlas row (128 B at u8,
// many rows shared by neighbouring pixels) and writes 133 MB.
// chip_smoke.py prints each kernel's time beside its byte bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 16;           // channels a material sample holds
constexpr int kLanes = 16 * kC;  // lanes a packed row holds
constexpr int kRec = 128;        // lanes a resolve record holds (render/packing.py)
constexpr int kUv = 19;          // vertex k's uv at kUv + 16 k (9 pix + 16 k + 10)
constexpr int kThreads = 256;

// ---- PyTorch's CUDA semantics, operation for operation

__device__ __forceinline__ bool isnan_(float x) { return x != x; }

// torch.maximum / torch.minimum: a NaN operand is the result
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan_(a) ? a : isnan_(b) ? b : fmaxf(a, b);
}

__device__ __forceinline__ float tmin(float a, float b) {
  return isnan_(a) ? a : isnan_(b) ? b : fminf(a, b);
}

// torch.clamp(x, min=lo) and torch.clamp(x, lo, hi): NaN passes
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan_(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan_(x) ? x : fminf(fmaxf(x, lo), hi);
}

// ops/texture.py _to_int: NaN -> 0, then clamped to [-2^31, 2147483520]
__device__ __forceinline__ int to_int(float x) {
  if (isnan_(x)) return 0;
  return __float2int_rz(fminf(fmaxf(x, -2147483648.0f), 2147483520.0f));
}

// an int32 tensor's >> as PyTorch computes it (shifts past 30 keep the sign)
__device__ __forceinline__ int rshift(int a, int b) { return (b < 0 || b >= 31) ? a >> 31 : a >> b; }

// torch.remainder of int32 tensors: the result takes the divisor's sign
__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// int32 tensor arithmetic wraps
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// ---- R1 and T1: the edge functions, the weights and the interpolation

// ops/fma.py fma: one rounding, __fmaf_rn.  A NaN result is the emulation's
// own: its f64 product and sum carry an input NaN's payload and sign, where
// the f32 unit returns its canonical NaN, so a NaN is computed as it does.
__device__ __forceinline__ float fma_(float a, float b, float c) {
  const float r = __fmaf_rn(a, b, c);
  if (!isnan_(r)) return r;
  return __double2float_rn(__dadd_rn(__dmul_rn(a, b), c));
}

// ops/texture.py edge_fn's coefficients: fdiff(a, b, c, d) = fma(a, b, -(c * d))
struct Edge {
  float cx, cy, cz;
};

__device__ __forceinline__ Edge edge(const float* pa, const float* pb) {
  return {fma_(pa[1], pb[2], -__fmul_rn(pa[2], pb[1])),
          fma_(pa[2], pb[0], -__fmul_rn(pa[0], pb[2])),
          fma_(pa[0], pb[1], -__fmul_rn(pa[1], pb[0]))};
}

// fdot([(cx, X), (cy, Y)], cz) = fma(cx, X, cy * Y) + cz
__device__ __forceinline__ float edge_at(const Edge& e, float X, float Y) {
  return __fadd_rn(fma_(e.cx, X, __fmul_rn(e.cy, Y)), e.cz);
}

// the barycentric weights at (X, Y) of the edges (p1, p2), (p2, p0), (p0, p1):
// f_k / ((f0 + f1) + f2), a sum of 0 (either sign) replaced by 1, NaN kept
__device__ __forceinline__ void weights(const Edge* e, float X, float Y, float* w) {
  const float f0 = edge_at(e[0], X, Y), f1 = edge_at(e[1], X, Y), f2 = edge_at(e[2], X, Y);
  float fs = __fadd_rn(__fadd_rn(f0, f1), f2);
  fs = fs != 0.0f ? fs : 1.0f;
  w[0] = __fdiv_rn(f0, fs);
  w[1] = __fdiv_rn(f1, fs);
  w[2] = __fdiv_rn(f2, fs);
}

// _interp3 of one lane of the three vertices: fma(w2, a2, fma(w0, a0, w1 * a1))
__device__ __forceinline__ float interp3(const float* w, float a0, float a1, float a2) {
  return fma_(w[2], a2, fma_(w[0], a0, __fmul_rn(w[1], a1)));
}

// ---- T1: the footprint

// uv_at(X, Y): the weights at (X, Y), then the vertices' uvs interpolated
__device__ __forceinline__ void uv_at(const Edge* e, const float* uvs, float X, float Y,
                                      float* out) {
  float w[3];
  weights(e, X, Y, w);
#pragma unroll
  for (int c = 0; c < 2; ++c) out[c] = interp3(w, uvs[c], uvs[2 + c], uvs[4 + c]);
}

// apply_texture_transform: scale, rotate (cos, sin), offset, uncontracted
__device__ __forceinline__ void transform(const float* os, const float* rot, const float* uv,
                                          float* out) {
  const float s0 = __fmul_rn(uv[0], os[2]), s1 = __fmul_rn(uv[1], os[3]);
  out[0] = __fadd_rn(__fsub_rn(__fmul_rn(s0, rot[0]), __fmul_rn(s1, rot[1])), os[0]);
  out[1] = __fadd_rn(__fadd_rn(__fmul_rn(s0, rot[1]), __fmul_rn(s1, rot[0])), os[1]);
}

__global__ void __launch_bounds__(kThreads)
tap_footprint_kernel(const float* __restrict__ rec, const float* __restrict__ uv,
                     float* __restrict__ out, int n, int width, int row0, int lane_os,
                     int lane_rot, int lane_rect, int max_aniso) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const int row = p / width;
  const int x = p - row * width;
  const int y = row0 + row;  // the global row: a slab's quads stay the frame's
  const float* r = rec + static_cast<int64_t>(p) * kRec;
  float pv[9], uvs[6], os[4], rot[2];
#pragma unroll
  for (int i = 0; i < 9; ++i) pv[i] = __ldg(r + i);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    uvs[2 * k] = __ldg(r + kUv + 16 * k);
    uvs[2 * k + 1] = __ldg(r + kUv + 16 * k + 1);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) os[i] = __ldg(r + lane_os + i);
  rot[0] = __ldg(r + lane_rot);
  rot[1] = __ldg(r + lane_rot + 1);
  const float rw = __ldg(r + lane_rect + 2), rh = __ldg(r + lane_rect + 3);
  const float centre[2] = {__ldg(uv + 2 * static_cast<int64_t>(p)),
                           __ldg(uv + 2 * static_cast<int64_t>(p) + 1)};

  // the edges (p1, p2), (p2, p0), (p0, p1); D3D 2x2-quad derivatives with
  // helper-lane semantics at the quad's TL, TR and BL centres
  const Edge e[3] = {edge(pv + 3, pv + 6), edge(pv + 6, pv), edge(pv, pv + 3)};
  const float bx = __int2float_rn(x & ~1), by = __int2float_rn(y & ~1);
  float tl[2], tr[2], bl[2];
  uv_at(e, uvs, __fadd_rn(bx, 0.5f), __fadd_rn(by, 0.5f), tl);
  uv_at(e, uvs, __fadd_rn(bx, 1.5f), __fadd_rn(by, 0.5f), tr);
  uv_at(e, uvs, __fadd_rn(bx, 0.5f), __fadd_rn(by, 1.5f), bl);
  float suv[2], s_tl[2], s_tr[2], s_bl[2];
  transform(os, rot, centre, suv);
  transform(os, rot, tl, s_tl);
  transform(os, rot, tr, s_tr);
  transform(os, rot, bl, s_bl);
  const float dx[2] = {__fsub_rn(s_tr[0], s_tl[0]), __fsub_rn(s_tr[1], s_tl[1])};
  const float dy[2] = {__fsub_rn(s_bl[0], s_tl[0]), __fsub_rn(s_bl[1], s_tl[1])};
  // _footprint_axes: the squared screen-axis footprints in texels
  const float bw = __fmul_rn(rw, fabsf(os[2])), bh = __fmul_rn(rh, fabsf(os[3]));
  const float px = __fmul_rn(dx[0], bw), py = __fmul_rn(dx[1], bh);
  const float qx = __fmul_rn(dy[0], bw), qy = __fmul_rn(dy[1], bh);
  const float lx = __fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py));
  const float ly = __fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy));
  const float tiny = static_cast<float>(1e-12);

  out[p] = suv[0];
  out[n + p] = suv[1];
  if (max_aniso == 0) {  // _iso_lod
    out[2 * n + p] = __fmul_rn(0.5f, log2f(clamp_min(tmax(lx, ly), tiny)));
    return;
  }
  // _aniso_lod
  const float rho_maj = clamp_min(tmax(lx, ly), tiny);
  const float rho_min = clamp_min(tmin(lx, ly), tiny);
  const float ratio = __double2float_rn(__dsqrt_rn(static_cast<double>(__fdiv_rn(rho_maj, rho_min))));
  const float n_eff = clamp(ratio, 1.0f, __int2float_rn(max_aniso));
  const float rho_eff = tmax(rho_min, __fdiv_rn(rho_maj, __fmul_rn(n_eff, n_eff)));
  const bool major_x = lx >= ly;
  out[2 * n + p] = __fmul_rn(0.5f, log2f(rho_eff));
  out[3 * n + p] = major_x ? dx[0] : dy[0];
  out[4 * n + p] = major_x ? dx[1] : dy[1];
  // 1.0 - 1.0 / n_eff: PyTorch's reciprocal, times 1.0, from 1.0
  out[5 * n + p] = __fsub_rn(1.0f, __fdiv_rn(1.0f, n_eff));
}

// ---- R1: the attributes at the pixel centres

// lanes of a resolve record R1 reads: the screen vertices (0:9) and the three
// vertices' attributes (9 + 16 k: world_pos 3, normal 3, tangent 4, uv 2,
// colour 4), rounded up to whole 16-byte loads
constexpr int kAttr = 16;
constexpr int kVertLoads = (9 + 3 * kAttr + 3) / 4;

__global__ void __launch_bounds__(kThreads)
interp_attrs_kernel(const float* __restrict__ rec, float* __restrict__ world_pos,
                    float* __restrict__ v_normal, float* __restrict__ tangent4,
                    float* __restrict__ uv, float* __restrict__ v_color, int n, int width,
                    int row0) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const int row = p / width;
  const int x = p - row * width;
  const float* r = rec + static_cast<int64_t>(p) * kRec;
  float v[4 * kVertLoads];
#pragma unroll
  for (int i = 0; i < kVertLoads; ++i) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(r) + i);
    v[4 * i] = q.x;
    v[4 * i + 1] = q.y;
    v[4 * i + 2] = q.z;
    v[4 * i + 3] = q.w;
  }
  const Edge e[3] = {edge(v + 3, v + 6), edge(v + 6, v), edge(v, v + 3)};
  float w[3];
  // the pixel centre; a slab's rows stay the frame's
  weights(e, __fadd_rn(__int2float_rn(x), 0.5f), __fadd_rn(__int2float_rn(row0 + row), 0.5f),
          w);
  float a[kAttr];
#pragma unroll
  for (int c = 0; c < kAttr; ++c)
    a[c] = interp3(w, v[9 + c], v[9 + kAttr + c], v[9 + 2 * kAttr + c]);
  const int64_t q = p;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    world_pos[3 * q + c] = a[c];
    v_normal[3 * q + c] = a[3 + c];
  }
  reinterpret_cast<float4*>(tangent4)[q] = make_float4(a[6], a[7], a[8], a[9]);
  reinterpret_cast<float2*>(uv)[q] = make_float2(a[10], a[11]);
  reinterpret_cast<float4*>(v_color)[q] = make_float4(a[12], a[13], a[14], a[15]);
}

// ---- T2: the taps

struct U8 { static constexpr int kSize = 1; };
struct F32 { static constexpr int kSize = 4; };
struct BF16 { static constexpr int kSize = 2; };

// element j of the little-endian words w as f32 (K8's decode)
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
  if constexpr (kBytes == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    static_assert(kBytes == 8, "a thread reads 8 or 16 bytes of a lane group");
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  }
}

// _lerp: a * (1 - f) + b * f, uncontracted
__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

// K8's blends: fma(a, 1 - f, b * f) for the taps, fma(b, f, a * (1 - f)) for the mip lerp
__device__ __forceinline__ float lerp_fa(float a, float b, float f) {
  return __fmaf_rn(a, __fsub_rn(1.0f, f), __fmul_rn(b, f));
}

__device__ __forceinline__ float lerp_fb(float a, float b, float f) {
  return __fmaf_rn(b, f, __fmul_rn(a, __fsub_rn(1.0f, f)));
}

// ops/texture.py _pyramid_rect: (x, y, w, h) of mip `level`, clamped to the chain
struct Rect {
  int x, y, w, h;
};

__device__ __forceinline__ Rect pyramid_rect(const float* rect0, int level) {
  const int x0 = __float2int_rz(rect0[0]), y0 = __float2int_rz(rect0[1]);
  const int w0 = __float2int_rz(rect0[2]), h0 = __float2int_rz(rect0[3]);
  const float mx = __int2float_rn(max(w0, h0));
  const int lmax = __float2int_rz(rintf(log2f(fmaxf(mx, 1.0f))));
  const int lv = min(max(level, 0), lmax);
  const int w = max(rshift(w0, lv), 1), h = max(rshift(h0, lv), 1);
  const int lw = __float2int_rz(rintf(log2f(fmaxf(__int2float_rn(w0), 1.0f))));
  return {wadd(wadd(x0, wmul(2, wsub(w0, w))), max(wsub(lv, lw), 0)), y0, w, h};
}

// one trilinear tap (sample_pyramid_tri) of this thread's kCh channels at uv,
// the level's fraction `frac` and its two mip rects given
template <typename T, int kTpp, bool kSelect>
__device__ __forceinline__ void tap(const unsigned char* __restrict__ atlas, int atlas_width,
                                    int atlas_rows, int q, const Rect& a, const Rect& b, float frac,
                                    float u, float v, float* o) {
  constexpr int kCh = kC / kTpp;
  constexpr int kBytes = kCh * T::kSize;
  constexpr int kWords = kBytes / 4;
  constexpr int kGroup = kC * T::kSize;
  constexpr int kRow = kLanes * T::kSize;
  // _tap_coords at both mips
  const float tx = __fsub_rn(__fmul_rn(u, __int2float_rn(a.w)), 0.5f);
  const float ty = __fsub_rn(__fmul_rn(v, __int2float_rn(a.h)), 0.5f);
  const float fx0 = floorf(tx), fy0 = floorf(ty);
  const int ix_raw = to_int(fx0), iy_raw = to_int(fy0);
  const float tx2 = __fsub_rn(__fmul_rn(u, __int2float_rn(b.w)), 0.5f);
  const float ty2 = __fsub_rn(__fmul_rn(v, __int2float_rn(b.h)), 0.5f);
  const float fx20 = floorf(tx2), fy20 = floorf(ty2);
  const int ix2_raw = to_int(fx20), iy2_raw = to_int(fy20);
  // WRAP, the row, and the 3x3 window's column and row of the mip-L+1 base
  int row = wadd(wmul(wadd(a.y, floor_mod(iy_raw, a.h)), atlas_width),
                 wadd(a.x, floor_mod(ix_raw, a.w)));
  if (row < 0) row += atlas_rows;              // PyTorch's negative index
  row = min(max(row, 0), atlas_rows - 1);      // past the end PyTorch would assert
  const int cox = min(max(wadd(wsub(ix2_raw, ix_raw >> 1), 1), 0), 1);
  const int roy = min(max(wadd(wsub(iy2_raw, iy_raw >> 1), 1), 0), 1);
  const float fx = __fsub_rn(tx, fx0), fy = __fsub_rn(ty, fy0);
  const float fx2 = __fsub_rn(tx2, fx20), fy2 = __fsub_rn(ty2, fy20);

  // the 8 lane groups: quad TL, TR, BL, BR, then the 2x2 of the 3x3 (cell
  // (j, i) is group 4 + 3j + i)
  const int cell = 4 + roy * 3 + cox;
  const unsigned char* r = atlas + static_cast<int64_t>(row) * kRow + q * kBytes;
  uint32_t w[8][kWords];
#pragma unroll
  for (int g = 0; g < 4; ++g) load<kBytes>(r + g * kGroup, w[g]);
  load<kBytes>(r + cell * kGroup, w[4]);
  load<kBytes>(r + (cell + 1) * kGroup, w[5]);
  load<kBytes>(r + (cell + 3) * kGroup, w[6]);
  load<kBytes>(r + (cell + 4) * kGroup, w[7]);
#pragma unroll
  for (int j = 0; j < kCh; ++j) {
    // gamma channels {0,1,2,8,9,10}: (channel mod 8) < 3
    const bool gamma = T::kSize == 1 && ((q * kCh + j) & 7) < 3;
    float e[8];
#pragma unroll
    for (int g = 0; g < 8; ++g) e[g] = element<T>(w[g], j, gamma);
    if (kSelect) {
      const float ta = lerp_fa(lerp_fa(e[0], e[1], fx), lerp_fa(e[2], e[3], fx), fy);
      const float tb = lerp_fa(lerp_fa(e[4], e[5], fx2), lerp_fa(e[6], e[7], fx2), fy2);
      o[j] = lerp_fb(ta, tb, frac);
    } else {
      const float ta = lerp(lerp(e[0], e[1], fx), lerp(e[2], e[3], fx), fy);
      const float tb = lerp(lerp(e[4], e[5], fx2), lerp(e[6], e[7], fx2), fy2);
      o[j] = lerp(ta, tb, frac);
    }
  }
}

template <typename T, int kTpp, bool kSelect>
__global__ void __launch_bounds__(kThreads)
material_tap_kernel(const unsigned char* __restrict__ atlas, const float* __restrict__ rec,
                    const float* __restrict__ fp, float* __restrict__ out, int n,
                    int atlas_width, int atlas_rows, int lane_rect, int n_taps) {
  constexpr int kCh = kC / kTpp;
  static_assert(32 % kTpp == 0 && kCh % 4 == 0, "thread layout");
  const int p = blockIdx.x * (kThreads / kTpp) + threadIdx.x / kTpp;
  if (p >= n) return;
  const int q = threadIdx.x % kTpp;  // this thread's channel group
  const float* r = rec + static_cast<int64_t>(p) * kRec + lane_rect;
  const float rect0[4] = {__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3)};
  const float su = __ldg(fp + p), sv = __ldg(fp + n + p);
  // sample_pyramid_tri's level: the same for every tap of the pixel
  const float lod = clamp_min(__ldg(fp + 2 * static_cast<int64_t>(n) + p), 0.0f);
  const int l0 = to_int(floorf(lod));
  const float frac = clamp(__fsub_rn(lod, __int2float_rn(l0)), 0.0f, 1.0f);
  const Rect a = pyramid_rect(rect0, l0), b = pyramid_rect(rect0, wadd(l0, 1));
  float o[kCh];
  if (n_taps == 0) {
    tap<T, kTpp, kSelect>(atlas, atlas_width, atlas_rows, q, a, b, frac, su, sv, o);
  } else {
    // _sample_aniso's dense line taps
    const float dmu = __ldg(fp + 3 * static_cast<int64_t>(n) + p);
    const float dmv = __ldg(fp + 4 * static_cast<int64_t>(n) + p);
    const float extent = __ldg(fp + 5 * static_cast<int64_t>(n) + p);
    float acc[kCh];
#pragma unroll
    for (int j = 0; j < kCh; ++j) acc[j] = 0.0f;
    for (int k = 0; k < n_taps; ++k) {
      const float t = __fmul_rn(extent, __double2float_rn((k + 0.5) / n_taps - 0.5));
      float s[kCh];
      tap<T, kTpp, kSelect>(atlas, atlas_width, atlas_rows, q, a, b, frac,
                            __fmaf_rn(dmu, t, su), __fmaf_rn(dmv, t, sv), s);
#pragma unroll
      for (int j = 0; j < kCh; ++j) acc[j] = __fadd_rn(acc[j], s[j]);
    }
    const float inv = __fdiv_rn(1.0f, __int2float_rn(n_taps));
#pragma unroll
    for (int j = 0; j < kCh; ++j) o[j] = __fmul_rn(acc[j], inv);
  }
  float4* dst = reinterpret_cast<float4*>(out + static_cast<int64_t>(p) * kC + q * kCh);
#pragma unroll
  for (int i = 0; i < kCh / 4; ++i)
    dst[i] = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
}

template <typename T, int kTpp, bool kSelect>
int launch_blend(const void* atlas, const float* rec, const float* fp, float* out, int n,
                 int atlas_width, int atlas_rows, int lane_rect, int n_taps, cudaStream_t stream) {
  constexpr int kPerBlock = kThreads / kTpp;
  material_tap_kernel<T, kTpp, kSelect><<<(n + kPerBlock - 1) / kPerBlock, kThreads, 0, stream>>>(
      static_cast<const unsigned char*>(atlas), rec, fp, out, n, atlas_width, atlas_rows,
      lane_rect, n_taps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kTpp>
int launch_tap(const void* atlas, const float* rec, const float* fp, float* out, int n,
               int atlas_width, int atlas_rows, int lane_rect, int n_taps, int select,
               cudaStream_t stream) {
  return select ? launch_blend<T, kTpp, true>(atlas, rec, fp, out, n, atlas_width, atlas_rows,
                                              lane_rect, n_taps, stream)
                : launch_blend<T, kTpp, false>(atlas, rec, fp, out, n, atlas_width, atlas_rows,
                                               lane_rect, n_taps, stream);
}

}  // namespace

// rec (n, 128) f32 records, uv (n, 2) f32, out (max_aniso ? 6 : 3, n) f32 planes;
// the lanes of the slot's offset-scale, rotation and rect; max_aniso 0 for trilinear
extern "C" int tap_footprint(const float* rec, const float* uv, float* out, long long n, int width,
                             int row0, int lane_os, int lane_rot, int lane_rect, int max_aniso,
                             void* stream) {
  // a 32-bit pixel index: the (n, 128) records alone would be 1 TB at 2^31 pixels
  if (n < 0 || n > 0x7fffffffLL || width <= 0 || max_aniso < 0) return cudaErrorInvalidValue;
  if (n > 0)
    tap_footprint_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        rec, uv, out, static_cast<int>(n), width, row0, lane_os, lane_rot, lane_rect, max_aniso);
  return static_cast<int>(cudaGetLastError());
}

// rec (n, 128) f32 records, 16-byte aligned; the five attributes out, (n, 3),
// (n, 3), (n, 4), (n, 2) and (n, 4) f32; pixel p at column p % width of global
// row row0 + p / width
extern "C" int interp_attrs(const float* rec, float* world_pos, float* v_normal, float* tangent4,
                            float* uv, float* v_color, long long n, int width, int row0,
                            void* stream) {
  if (n < 0 || n > 0x7fffffffLL || width <= 0) return cudaErrorInvalidValue;
  if (n > 0)
    interp_attrs_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        rec, world_pos, v_normal, tangent4, uv, v_color, static_cast<int>(n), width, row0);
  return static_cast<int>(cudaGetLastError());
}

// atlas (atlas_rows, 256) of dtype 0 = u8, 1 = f32, 2 = bf16, 16-byte aligned;
// rec (n, 128) f32; fp the footprint planes; out (n, 16) f32; n_taps 0 takes
// the trilinear tap at the centre; select: K8's blends
extern "C" int material_tap(const void* atlas, const float* rec, const float* fp, float* out,
                            long long n, int atlas_width, long long atlas_rows, int lane_rect,
                            int n_taps, int dtype, int select, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || atlas_rows <= 0 || atlas_rows > 0x7fffffffLL || n_taps < 0)
    return cudaErrorInvalidValue;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(n), rows = static_cast<int>(atlas_rows);
  switch (dtype) {
    case 0: return launch_tap<U8, 2>(atlas, rec, fp, out, m, atlas_width, rows, lane_rect, n_taps,
                                     select, s);
    case 1: return launch_tap<F32, 4>(atlas, rec, fp, out, m, atlas_width, rows, lane_rect,
                                      n_taps, select, s);
    case 2: return launch_tap<BF16, 4>(atlas, rec, fp, out, m, atlas_width, rows, lane_rect,
                                       n_taps, select, s);
    default: return cudaErrorInvalidValue;
  }
}
