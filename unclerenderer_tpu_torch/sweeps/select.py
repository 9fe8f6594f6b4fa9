"""The frame's two select kernels: K4 (``csrc/shadow_select9.cu``, the PCF
3x3 fetch) and K8 (``csrc/mat_select.cu``, the packed material decode) at
the inputs that one 1920x1080 frame gives them: K4 from a frame of the
default path (2,073,600 receivers, 4096^2 shadow map), K8 from a frame of
the packed path (2,073,600 pixels of the u8 packed atlas).

Variants, each first held bit-equal to the plain version:

* ``shipped``   -- the kernel wrapper (``ops/shadow.py select9``,
  ``ops/texture.py mat_select``);
* ``previous``  -- the kernels before their redesign (sources below): K4 one
  thread a receiver, 9 two-byte loads and 9 scalar stores at a 36-byte
  stride, its deltas copied from a host array; K8 one thread a (pixel,
  channel), a 64-bit divide, 7 parameter and 8 single-byte loads a thread;
* K8 ``T threads a pixel, P pixels a thread, shfl / L1`` -- T in 1, 2, 4
  threads share a pixel's 16 channels; its row index and 7 parameters
  loaded by its lanes in turn and shuffled (shfl), or by every lane (L1);
* K4 ``R receivers a thread, 32-bit / 64-bit`` -- R in 1, 2, 4; a run of 3
  lanes from two aligned 32-bit loads, or one aligned 64-bit load and a
  32-bit one where the run crosses it;
* ``..., streaming`` -- the read-once loads and the output stores marked
  evict-first (``__ldcs`` / ``__stcs``), leaving L2 to the atlas or table.

Besides, K4's output layout together with the PCF tail that reads it
(``ops/shadow.py _pcf_tail``, captured from the same frame): the shipped
(N, 9) rows, whose 9 columns the tail reads with a 36-byte stride, against
(9, N) planes written by a sweep-only kernel (``PLANES``; not shipped: the
reference's ``_select9_fetch`` returns (N, 9)); eager device time from
CUDA events over 20 calls, since the tail cannot be captured in a graph.

The alternatives are template instances of the shipped sources, exported
through C entries appended to them (``VARIANTS``); all four sources build
at once through ``_cuda.build_source``.  Device time per call: CUDA graphs
of 10 calls, median of three rounds taken in turns.  ``--ptxas`` first
prints what ``nvcc -Xptxas -v`` says of every instance (registers, spills).
Run from the repository root on a CUDA machine::

    python3 -m unclerenderer_tpu_torch.sweeps.select [--ptxas] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import json
import statistics
import tempfile
from pathlib import Path

import torch

from ..ops import _cuda
from ..ops import shadow as shadow_mod
from ..ops import texture as tex_mod
from ..timing import cuda_ms, graph_ms, nvidia_smi
from .raster import ptxas

WIDTH, HEIGHT, SHADOW = 1920, 1080, 4096
ROUNDS, REPS = 3, 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory

PREVIOUS_SELECT9 = r"""// K4: PCF 3x3 neighbourhood fetch from the u16 superblock shadow table.
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
"""

PREVIOUS_MAT_SELECT = r"""// K8: packed-trilinear material decode, one C-channel trilinear sample per
// pixel from ONE 16C-lane row of the packed atlas.
//
// Replaces unclerenderer_tpu/ops/texture.py _mat_select_kernel (via
// _mat_select_call, called from sample_pyramid_tri under
// RenderSettings.mat_select_kernel).  Row lanes 0:4C are the mip-L bilinear
// quad (TL, TR, BL, BR), lanes 4C:13C the parent texel's 3x3 at mip L+1.
// Per channel: u8 -> f32 as (float)(int)byte * (1/255) with gamma 2
// (x * x) on channels {0,1,2,8,9,10} of C=16, tap-a quad blend, tap-b 2x2
// picked from the 3x3 by (cox < 0.5, roy < 0.5), mip lerp -- the Pallas
// kernel's expressions, with the multiply-adds XLA:CPU contracts in it as
// explicit __fmaf_rn and no other contraction (-fmad=false).
//
// The TPU call first gathered every pixel's whole row into a materialised
// (grid, 1024, 16C) array in HBM (530 MB of u8 rows at 1080p) and decoded
// all 13C lanes in VMEM.  Here C threads serve one pixel, one per channel;
// each reads only its 8 winning lanes straight from the atlas by rows_idx
// (4 quad lanes + the 2x2 of the 3x3), so no row array exists and 5 of the
// 13 lanes are never decoded.
//
// Bound: latency of scattered row reads (2M rows of 256 B from a ~200 MB
// atlas at 1080p).  Neighbouring threads read neighbouring bytes of one
// row, so each quarter-row read is one transaction; parameters are read as
// (7, N) rows (coalesced across pixels) and the (N, C) output is written
// contiguously.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float decode(T v, bool gamma);

template <>
__device__ __forceinline__ float decode<uint8_t>(uint8_t v, bool gamma) {
  const float x = __fmul_rn(static_cast<float>(static_cast<int>(v)),
                            static_cast<float>(1.0 / 255.0));
  return gamma ? __fmul_rn(x, x) : x;
}

template <>
__device__ __forceinline__ float decode<float>(float v, bool) { return v; }

template <>
__device__ __forceinline__ float decode<__nv_bfloat16>(__nv_bfloat16 v, bool) {
  return __bfloat162float(v);
}

// a * (1 - f) + b * f, contracted as XLA:CPU contracts the Pallas kernel:
// fma(a, 1 - f, b * f) for the taps, fma(b, f, a * (1 - f)) for the mip lerp
__device__ __forceinline__ float lerp_fa(float a, float b, float f) {
  return __fmaf_rn(a, __fsub_rn(1.0f, f), __fmul_rn(b, f));
}

__device__ __forceinline__ float lerp_fb(float a, float b, float f) {
  return __fmaf_rn(b, f, __fmul_rn(a, __fsub_rn(1.0f, f)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mat_select_kernel(const T* __restrict__ atlas, const int* __restrict__ rows_idx,
                  const float* __restrict__ params, float* __restrict__ out, int64_t n,
                  int c, int lanes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n * c) return;
  const int64_t p = i / c;
  const int ch = static_cast<int>(i - p * c);
  const bool gamma = (ch < 3) || (ch >= 8 && ch < 11);
  const T* row = atlas + static_cast<int64_t>(rows_idx[p]) * lanes + ch;

  const float fx = params[p], fy = params[n + p];
  const float fx2 = params[2 * n + p], fy2 = params[3 * n + p];
  const float frac = params[4 * n + p];
  const int i0 = params[5 * n + p] < 0.5f ? 0 : 1;  // 3x3 column of the base
  const int j0 = params[6 * n + p] < 0.5f ? 0 : 1;  // 3x3 row of the base

  const float q00 = decode(__ldg(row), gamma);
  const float q10 = decode(__ldg(row + c), gamma);
  const float q01 = decode(__ldg(row + 2 * c), gamma);
  const float q11 = decode(__ldg(row + 3 * c), gamma);
  const T* r3 = row + 4 * c;  // lane of 3x3 cell (j, i): (j * 3 + i) * c
  const float tl2 = decode(__ldg(r3 + (j0 * 3 + i0) * c), gamma);
  const float tr2 = decode(__ldg(r3 + (j0 * 3 + i0 + 1) * c), gamma);
  const float bl2 = decode(__ldg(r3 + ((j0 + 1) * 3 + i0) * c), gamma);
  const float br2 = decode(__ldg(r3 + ((j0 + 1) * 3 + i0 + 1) * c), gamma);

  const float a = lerp_fa(lerp_fa(q00, q10, fx), lerp_fa(q01, q11, fx), fy);
  const float b = lerp_fa(lerp_fa(tl2, tr2, fx2), lerp_fa(bl2, br2, fx2), fy2);
  out[i] = lerp_fb(a, b, frac);
}

}  // namespace

// dtype: 0 = u8, 1 = f32, 2 = bf16
extern "C" int mat_select(const void* atlas, const int* rows_idx, const float* params,
                          float* out, long long n, int c, int lanes, int dtype,
                          void* stream) {
  const int64_t total = static_cast<int64_t>(n) * c;
  if (total > 0) {
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
      mat_select_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const uint8_t*>(atlas),
                                                    rows_idx, params, out, n, c, lanes);
    else if (dtype == 1)
      mat_select_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(atlas),
                                                    rows_idx, params, out, n, c, lanes);
    else
      mat_select_kernel<<<blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(atlas), rows_idx, params, out, n, c, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the previous C entries' signatures (argtypes)
PREVIOUS_SIGNATURES = {
    # table, row, base, deltas (host int[9]), out, n, lanes, stream
    "shadow_select9": [_P, _P, _P, _P, _P, _I, _I, _P],
    # atlas, rows_idx, params (7, n), out, n, c, lanes, dtype, stream
    "mat_select": [_P, _P, _P, _P, _L, _I, _I, _I, _P],
}

# a C entry of one template instance, appended to the shipped source
ENTRY_TEXT = {
    "mat_select": """
extern "C" int {entry}(const void* atlas, const int* rows_idx, const float* params, float* out,
                       long long n, int dtype, void* stream) {{
  return launch<U8, {tpp}, {ppt}, {shfl}, {cs}>(atlas, rows_idx, params, out, n,
                                                static_cast<cudaStream_t>(stream));
}}
""",
    "shadow_select9": """
extern "C" int {entry}(const uint16_t* table, const int* row, const int* base, float* out, int n,
                       int lanes, int bw, void* stream) {{
  return launch<{r}, {u64}, {cs}>(table, row, base, out, n, lanes, bw,
                                  static_cast<cudaStream_t>(stream));
}}
""",
}


# a sweep-only K4 that writes (9, N) planes, one receiver a thread (appended
# to the shipped source: it reuses run3)
PLANES = """
namespace {
template <int kBw>
__global__ void __launch_bounds__(kThreads)
select9_planes_kernel(const uint16_t* __restrict__ table, const int* __restrict__ row,
                      const int* __restrict__ base, float* __restrict__ out, int n, int lanes) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t e = static_cast<int64_t>(__ldcs(row + i)) * lanes + __ldcs(base + i);
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const uint64_t v = run3<true>(table, e + dy * (kBw + 2));
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      __stcs(out + static_cast<int64_t>(3 * dy + dx) * n + i,
             __uint2float_rn(static_cast<uint32_t>(v >> (16 * dx)) & 0xffffu));
  }
}
}  // namespace

extern "C" int sweep_select9_planes(const uint16_t* table, const int* row, const int* base,
                                    float* out, int n, int lanes, int bw, void* stream) {
  if (bw < 4 || bw > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    auto kernel = bw == 4   ? select9_planes_kernel<4>
                  : bw == 5 ? select9_planes_kernel<5>
                  : bw == 6 ? select9_planes_kernel<6>
                  : bw == 7 ? select9_planes_kernel<7>
                            : select9_planes_kernel<8>;
    kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        table, row, base, out, n, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def _plural(n, word):
    return f"{n} {word}{'s' * (n > 1)}"


def _mat_variant(t, p, s, cs=False):
    label = (f"{_plural(t, 'thread')} a pixel, {_plural(p, 'pixel')} a thread, "
             f"{'shfl' if s else 'L1'}{', streaming' * cs}")
    return label, dict(tpp=t, ppt=p, shfl=str(s).lower(), cs=str(cs).lower())


def _select9_variant(r, u, cs=False):
    label = f"{_plural(r, 'receiver')} a thread, {64 if u else 32}-bit{', streaming' * cs}"
    return label, dict(r=r, u64=str(u).lower(), cs=str(cs).lower())


# kernel -> variant -> the template arguments of its instance (shipped: K8
# 2 threads a pixel, 1 pixel a thread, shfl; K4 2 receivers a thread,
# 64-bit, streaming)
VARIANTS = {
    "mat_select": dict(
        [_mat_variant(t, p, s) for t in (1, 2, 4) for p in (1, 2, 4)
         for s in ((False, True) if t > 1 else (False,))]
        + [_mat_variant(t, p, s, cs=True)
           for t, p, s in ((1, 1, False), (2, 1, True), (2, 1, False), (2, 2, False),
                           (4, 1, True))]),
    "shadow_select9": dict(
        [_select9_variant(r, u) for r in (1, 2, 4) for u in (False, True)]
        + [_select9_variant(r, u, cs=True) for r, u in ((1, False), (2, False), (4, False),
                                                        (2, True))]),
}


def entry_name(kernel: str, label: str) -> str:
    return "sweep_" + "".join(ch if ch.isalnum() else "_" for ch in f"{kernel} {label}")


def variant_sources() -> dict:
    """Library name -> source text: each kernel's shipped source with the C
    entry of every variant appended, and the two previous sources."""
    out = {}
    for name, variants in VARIANTS.items():
        text = (_cuda.CSRC / f"{name}.cu").read_text()
        for label, targs in variants.items():
            text += ENTRY_TEXT[name].format(entry=entry_name(name, label), **targs)
        out[f"sweep_{name}"] = text + (PLANES if name == "shadow_select9" else "")
    out["sweep_previous_shadow_select9"] = PREVIOUS_SELECT9
    out["sweep_previous_mat_select"] = PREVIOUS_MAT_SELECT
    return out


def _bound(fn, argtypes):
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def entries(sources: dict) -> dict:
    """(kernel, variant) -> C function: every source built at once (one nvcc
    each) and bound."""
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(lambda kv: _cuda.build_source(*kv), sources.items())))
    libs = {name: ctypes.PyDLL(str(path)) for name, path in paths.items()}
    fns = {}
    for name, variants in VARIANTS.items():
        for label in variants:
            fns[(name, label)] = _bound(getattr(libs[f"sweep_{name}"], entry_name(name, label)),
                                        _cuda.SIGNATURES[name])
        fns[(name, "previous")] = _bound(getattr(libs[f"sweep_previous_{name}"], name),
                                         PREVIOUS_SIGNATURES[name])
    planes = _bound(libs["sweep_shadow_select9"].sweep_select9_planes,
                    _cuda.SIGNATURES["shadow_select9"])
    return fns, planes


def layouts(planes_fn, args, tail):
    """K4's output layout with the PCF tail that reads it: (rows, planes)
    -> a function of no arguments giving the frame's shadow factors."""
    table, row, base, deltas = args
    shape, rest = tail[1].shape, tail[1:]
    n = row.shape[0]
    bw = shadow_mod._PCF_BW[tuple(deltas)]

    def rows_layout():
        nb = shadow_mod.select9(*args).reshape(shape + (9,))
        return shadow_mod._pcf_tail([nb[..., k] for k in range(9)], *rest)

    def planes():
        out = torch.empty((9, n), dtype=torch.float32, device=table.device)
        err = planes_fn(table.data_ptr(), row.data_ptr(), base.data_ptr(), out.data_ptr(), n,
                        table.shape[1], bw, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"select9 planes: cudaError {err}")
        return out

    def planes_layout():
        nb9 = planes()
        return shadow_mod._pcf_tail([nb9[k].reshape(shape) for k in range(9)], *rest)

    return {"(N, 9) rows + tail": rows_layout, "(9, N) planes + tail": planes_layout,
            "(N, 9) rows": lambda: shadow_mod.select9(*args), "(9, N) planes": planes}


def entry_call(fn, name: str, previous: bool, args):
    """One launch of C entry ``fn`` (kernel ``name``; ``previous``: its old
    signature) on a captured call's normalised arguments; returns the
    output like the wrapper."""
    stream = torch.cuda.current_stream().cuda_stream
    if name == "mat_select":
        atlas, rows, params7 = args
        n = rows.shape[0]
        out = torch.empty((n, 16), dtype=torch.float32, device=atlas.device)
        tail = (16, 256, 0) if previous else (0,)  # (c, lanes,) dtype u8
        err = fn(atlas.data_ptr(), rows.data_ptr(), params7.data_ptr(), out.data_ptr(), n, *tail,
                 stream)
    else:
        table, row, base, deltas = args
        n, lanes = row.shape[0], table.shape[1]
        out = torch.empty((n, 9), dtype=torch.float32, device=table.device)
        head = (table.data_ptr(), row.data_ptr(), base.data_ptr())
        if previous:
            err = fn(*head, ctypes.addressof(deltas), out.data_ptr(), n, lanes, stream)
        else:
            err = fn(*head, out.data_ptr(), n, lanes, shadow_mod._PCF_BW[tuple(deltas)], stream)
    if err:
        raise RuntimeError(f"{name}: cudaError {err}")
    return out


def _distinct(idx) -> int:
    return int(torch.unique(idx.reshape(-1)).numel())


def work_select9(table, row, base, deltas):
    """(bytes, operations) of one K4 call: each distinct texel read once, row
    and base, the (N, 9) f32 output written once."""
    d = torch.as_tensor(deltas, device=table.device)
    texels = _distinct(row.long()[:, None] * table.shape[1] + base.long()[:, None] + d[None, :])
    return (texels * table.element_size() + row.shape[0] * (row.element_size() + base.element_size())
            + row.shape[0] * 9 * 4), 0


def work_mat_select(atlas, rows, params7):
    """(bytes, operations) of one K8 call: the 8 lane groups of each distinct
    row read once, rows_idx and params7, the (N, C) f32 output."""
    n, c = rows.shape[0], atlas.shape[-1] // 16
    return (_distinct(rows) * 8 * c * atlas.element_size() + n * rows.element_size()
            + params7.numel() * params7.element_size() + n * c * 4), 0


# kernel -> (wrapper module, attribute, plain version, work)
KERNELS = {
    "shadow_select9": (shadow_mod, "select9", shadow_mod.select9_ref, work_select9),
    "mat_select": (tex_mod, "mat_select", tex_mod.mat_select_ref, work_mat_select),
}


def frame_calls(dev) -> dict:
    """Kernel -> the arguments of its call in one 1920x1080 frame: K4 in a
    default-path frame, K8 in a packed-path frame (the packed u8 atlas,
    ``mat_select_kernel`` on, the plain material tap: the kernel one, T1 and
    T2, takes no K8); "pcf_tail" -> those of the PCF tail after K4."""
    from ..render import common
    from ..render.deferred import deferred_frame
    from ..render.params import FrameState, RenderSettings
    from ..render.testing import synthetic_device_scene, synthetic_frame_params

    settings = RenderSettings(width=WIDTH, height=HEIGHT, shadow_map_size=SHADOW,
                              has_masked_models=False, combined_material=True)
    calls = {}
    for name, packed in (("shadow_select9", False), ("mat_select", True)):
        module, attr = KERNELS[name][:2]
        scene, data = synthetic_device_scene(340, sphere_res=(32, 24), ground=True,
                                             rich_materials=True, atlas_u8=True,
                                             packed_trilinear=packed, device=dev)
        frame_settings = (dataclasses.replace(settings, material_packed_trilinear=True,
                                              mat_select_kernel=True) if packed else settings)
        params = synthetic_frame_params(data, WIDTH, HEIGHT, device=dev)
        recorded = [(name, module, attr)] + ([] if packed else [("pcf_tail", shadow_mod,
                                                                   "_pcf_tail")])
        origs = {key: getattr(mod, at) for key, mod, at in recorded}
        seen = {key: [] for key in origs}

        def recorder(key):
            def rec(*a):
                seen[key].append(a)
                return origs[key](*a)
            return rec

        for key, mod, at in recorded:
            setattr(mod, at, recorder(key))
        engage = common.tap_kernels_engage
        common.tap_kernels_engage = lambda *a: False
        try:
            deferred_frame(scene, params, FrameState.initial(WIDTH, HEIGHT, dev), frame_settings)
            torch.cuda.synchronize()
        finally:
            common.tap_kernels_engage = engage
            for key, mod, at in recorded:
                setattr(mod, at, origs[key])
        calls.update({key: args[0] for key, args in seen.items()})
        del scene
    return calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v first")
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("select sweep: needs a CUDA card")
    smi = nvidia_smi()
    result = {"device": smi, "ptxas": {}, "calls": []}
    sources = variant_sources()
    if args.ptxas:
        with tempfile.TemporaryDirectory() as tmp:
            for label, text in sources.items():
                src = Path(tmp) / f"{label}.cu"
                src.write_text(text)
                result["ptxas"][label] = ptxas(label, src)
    fns, planes_fn = entries(sources)
    _cuda.library()
    dev = torch.device("cuda", 0)
    calls = frame_calls(dev)
    tail = calls.pop("pcf_tail")
    for name, a in calls.items():
        module, attr, ref, work = KERNELS[name]
        wrapper = getattr(module, attr)
        if name == "mat_select":
            norm = (a[0], a[1].to(torch.int32).contiguous(), a[2].contiguous())
        else:
            deltas = (ctypes.c_int * 9)(*a[3])  # the previous entry's host array
            norm = (a[0], a[1].to(torch.int32).contiguous(), a[2].to(torch.int32).contiguous(),
                    deltas)
        want = ref(*a)
        variants = {"shipped": lambda a=a, wrapper=wrapper: wrapper(*a)}
        for (kernel, label), fn in fns.items():
            if kernel == name:
                variants[label] = (lambda fn=fn, prev=label == "previous":
                                   entry_call(fn, name, prev, norm))
        for label, fn in variants.items():
            if not torch.equal(fn(), want):
                raise RuntimeError(f"{label} {name} != plain at the frame's call")
        times = {}
        for r in range(ROUNDS):
            order = list(variants.items())
            for label, fn in (order if r % 2 == 0 else order[::-1]):
                times.setdefault(label, []).append(graph_ms(fn, REPS))
        moved, _ = work(*a)
        row = {"kernel": name, "shapes": [list(x.shape) for x in a if isinstance(x, torch.Tensor)],
               "bytes": moved, "bound_ms": 1e3 * moved / HBM_BYTES_PER_S,
               "ms": {v: statistics.median(ts) for v, ts in times.items()}, "ms_rounds": times}
        result["calls"].append(row)
        ranked = sorted(row["ms"].items(), key=lambda kv: kv[1])
        print(f"[{name}] shapes {row['shapes']}, bound {row['bound_ms']:.4f} ms ({moved} B)")
        print(f"[{name}] graph ms per call, fastest first: "
              + ", ".join(f"{v} {ms:.4f}" for v, ms in ranked) + f" (bit-equal to plain; {smi})")
        if name != "shadow_select9":
            continue
        # the output layout, with the PCF tail that reads it
        fns_layout = layouts(planes_fn, a, tail)
        if not (torch.equal(fns_layout["(9, N) planes"](), want.t())
                and torch.equal(fns_layout["(9, N) planes + tail"](),
                                fns_layout["(N, 9) rows + tail"]())):
            raise RuntimeError("select9 planes != the (N, 9) rows transposed, or their tails differ")
        # eager: the tail copies Python scalars to the card, which a CUDA
        # graph's capture refuses
        times = {}
        for r in range(ROUNDS):
            order = list(fns_layout.items())
            for label, fn in (order if r % 2 == 0 else order[::-1]):
                times.setdefault(label, []).append(cuda_ms(fn, reps=2 * REPS))
        result["layouts"] = {"eager_ms": {v: statistics.median(ts) for v, ts in times.items()},
                             "eager_ms_rounds": times}
        print("[shadow_select9 layout] eager ms (CUDA events over 20 calls): " + ", ".join(
            f"{v} {statistics.median(ts):.4f}" for v, ts in times.items())
            + f" (planes equal to the rows transposed, tails bit-equal; {smi})")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
