"""K6 (``csrc/hzb_tail.cu``, the HZB tail) at the top that one 1920x1080
frame gives it (the 270x480 f32 level under 8 tail levels, captured from a
frame of the packed path with ``hzb_pallas_tail`` on), and at odd tops.

Variants, each first held bit-equal to the plain version (``ops/hzb.py
hzb_tail_ref``) at every top, and again after its timed graph replays (a
ticket counter left non-zero would show there):

* ``shipped``  -- the wrapper (``ops/hzb.py hzb_tail``);
* ``previous`` -- the kernel before its redesign (source below): one block
  of 1,024 threads walks every level with scalar loads, the level table
  copied from a host array;
* ``ticket TH x TW, T threads`` -- the shipped source's tile kernel at other
  tiles and block sizes: a block reduces its tile of the top through
  log2(min(TH, TW)) levels, the last block to finish does the rest;
* ``two launches TH x TW`` -- the same tiles (the shipped kernel asked for
  the tile levels only, so no block takes a ticket), then the remaining
  levels in a second, one-block launch (``TWO_LAUNCHES`` below);
* ``cluster of C`` -- one thread-block cluster of C blocks (C = 16 needs the
  non-portable cluster size): level rows spread over the blocks (row y in
  block y mod C), each level read from the previous one's rows in the
  blocks' distributed shared memory, ``cluster.sync()`` between levels (the
  levels must fit the cluster's shared memory: sweep only).

Device time per call: CUDA graphs of 10 calls, median of three rounds taken
in turns.  ``--ptxas`` first prints what ``nvcc -Xptxas -v`` says of every
instance.  Run from the repository root on a CUDA machine::

    python3 -m unclerenderer_tpu_torch.sweeps.hzb_tail [--ptxas] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import statistics
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..ops import _cuda
from ..ops import hzb as hzb_mod
from ..timing import graph_ms, nvidia_smi
from .raster import ptxas

WIDTH, HEIGHT, SHADOW = 1920, 1080, 4096
ROUNDS, REPS = 3, 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
ODD_TOPS = [(1, 1), (1, 7), (3, 1), (135, 240), (541, 961), (1080, 1920)]

PREVIOUS = r"""// K6 before its redesign: one block walks the levels in order.
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
"""

CLUSTER = r"""// K6 as one thread-block cluster (sweep only).  Level rows are spread over
// the C blocks -- row y in block y % C, at local row y / C -- and each level
// reads the previous one's rows from the blocks' shared memory through the
// cluster's distributed shared memory; cluster.sync() between levels.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__host__ __device__ __forceinline__ int halve(int d) { return d > 1 ? d / 2 : 1; }

template <int C, int THREADS>
__global__ void __launch_bounds__(THREADS)
hzb_tail_cluster(const float* __restrict__ top, float* out, int top_h, int top_w, int n_levels,
                 int cap) {
  extern __shared__ float smem[];  // two buffers of cap floats
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  int sh = top_h, sw = top_w;
  long long off = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int h = halve(sh), w = halve(sw);
    float* dst = smem + (l & 1) * cap;
    float* src = smem + ((l + 1) & 1) * cap;
    const int rows = (h - r + C - 1) / C;  // rows r, r + C, ... below h
    for (int i = threadIdx.x; i < rows * w; i += THREADS) {
      const int j = i / w, x = i - j * w, y = r + j * C;
      const int y0 = min(2 * y, sh - 1), y1 = min(2 * y + 1, sh - 1);
      const int x0 = min(2 * x, sw - 1), x1 = min(2 * x + 1, sw - 1);
      float a, b, c, d;
      if (l == 0) {
        const float* r0 = top + static_cast<long long>(y0) * sw;
        const float* r1 = top + static_cast<long long>(y1) * sw;
        a = __ldg(r0 + x0); b = __ldg(r0 + x1); c = __ldg(r1 + x0); d = __ldg(r1 + x1);
      } else {
        const float* s0 = cluster.map_shared_rank(src, y0 % C) + (y0 / C) * sw;
        const float* s1 = cluster.map_shared_rank(src, y1 % C) + (y1 / C) * sw;
        a = s0[x0]; b = s0[x1]; c = s1[x0]; d = s1[x1];
      }
      const float v = fminf(fminf(a, b), fminf(c, d));
      dst[j * w + x] = v;
      out[off + static_cast<long long>(y) * w + x] = v;
    }
    cluster.sync();
    off += static_cast<long long>(h) * w;
    sh = h;
    sw = w;
  }
}

template <int C, int THREADS>
int launch_cluster(const float* top, float* out, int top_h, int top_w, int n_levels,
                   cudaStream_t stream) {
  const int h1 = halve(top_h), w1 = halve(top_w);
  const int cap = (h1 + C - 1) / C * w1;
  const size_t bytes = 2 * static_cast<size_t>(cap) * sizeof(float);
  if (n_levels <= 0 || bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = hzb_tail_cluster<C, THREADS>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, top, out, top_h, top_w, n_levels, cap);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" int sweep_cluster_8(const float* top, float* out, unsigned*, int top_h, int top_w,
                               int n_levels, void* stream) {
  return launch_cluster<8, 1024>(top, out, top_h, top_w, n_levels,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int sweep_cluster_16(const float* top, float* out, unsigned*, int top_h, int top_w,
                                int n_levels, void* stream) {
  return launch_cluster<16, 1024>(top, out, top_h, top_w, n_levels,
                                  static_cast<cudaStream_t>(stream));
}
"""

TWO_LAUNCHES = r"""
// The two-launch form (sweep only; appended to the shipped source): the
// tile kernel asked for its tile levels only, so no block takes a ticket,
// then one block finishes the remaining levels in a second launch.
namespace {

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
hzb_finish_kernel(float* out, long long off, int h, int w, int level, int n_levels) {
  __shared__ float buf[2 * kFinishCap];
  finish_levels<THREADS>(out, off, h, w, level, n_levels, buf, true);
}

template <int TH, int TW, int THREADS>
int launch_two(const float* top, float* out, unsigned* counter, int top_h, int top_w,
               int n_levels, cudaStream_t stream) {
  constexpr int kLevels = log2_floor(TH < TW ? TH : TW);
  const int e = launch_hzb_tail<TH, TW, THREADS>(top, out, counter, top_h, top_w,
                                                 n_levels < kLevels ? n_levels : kLevels, stream);
  if (e != 0 || n_levels <= kLevels) return e;
  long long off = 0;
  int h = halve(top_h), w = halve(top_w);
  for (int l = 1; l < kLevels; ++l) {
    off += static_cast<long long>(h) * w;
    h = halve(h);
    w = halve(w);
  }
  hzb_finish_kernel<THREADS><<<1, THREADS, 0, stream>>>(out, off, h, w, kLevels, n_levels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
"""

# a C entry of one template instance, appended to the shipped source
ENTRY_TEXT = """
extern "C" int {entry}(const float* top, float* out, unsigned* counter, int top_h, int top_w,
                       int n_levels, void* stream) {{
  return {launch}<{th}, {tw}, {threads}>(top, out, counter, top_h, top_w, n_levels,
                                          static_cast<cudaStream_t>(stream));
}}
"""

# variant -> launcher and template arguments (shipped: ticket, 32 x 64
# tiles, 256 threads)
VARIANTS = {
    "ticket 16x32, 128 threads": dict(launch="launch_hzb_tail", th=16, tw=32, threads=128),
    "ticket 32x32, 256 threads": dict(launch="launch_hzb_tail", th=32, tw=32, threads=256),
    "ticket 32x64, 128 threads": dict(launch="launch_hzb_tail", th=32, tw=64, threads=128),
    "ticket 32x64, 256 threads": dict(launch="launch_hzb_tail", th=32, tw=64, threads=256),
    "ticket 64x64, 512 threads": dict(launch="launch_hzb_tail", th=64, tw=64, threads=512),
    "ticket 64x128, 1024 threads": dict(launch="launch_hzb_tail", th=64, tw=128, threads=1024),
    "two launches 32x64, 256 threads": dict(launch="launch_two", th=32, tw=64, threads=256),
    "two launches 64x64, 512 threads": dict(launch="launch_two", th=64, tw=64, threads=512),
}
CLUSTERS = {"cluster of 8": "sweep_cluster_8", "cluster of 16": "sweep_cluster_16"}
# every C entry here: top, out, counter (the previous source: its level
# table), top_h, top_w, levels, stream
SIGNATURE = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def entry_name(label: str) -> str:
    return "sweep_" + "".join(ch if ch.isalnum() else "_" for ch in label)


def variant_sources() -> dict:
    """Library name -> source text: the shipped source with the two-launch
    form and every variant's C entry appended, the cluster source and the
    previous source."""
    text = (_cuda.CSRC / "hzb_tail.cu").read_text() + TWO_LAUNCHES
    for label, targs in VARIANTS.items():
        text += ENTRY_TEXT.format(entry=entry_name(label), **targs)
    return {"sweep_hzb_tail": text, "sweep_hzb_cluster": CLUSTER,
            "sweep_previous_hzb_tail": PREVIOUS}


def _bound(fn, argtypes):
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def entries(sources: dict) -> dict:
    """Variant -> C function: every source built at once and bound."""
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(lambda kv: _cuda.build_source(*kv), sources.items())))
    libs = {name: ctypes.PyDLL(str(path)) for name, path in paths.items()}
    fns = {label: _bound(getattr(libs["sweep_hzb_tail"], entry_name(label)), SIGNATURE)
           for label in VARIANTS}
    fns.update({label: _bound(getattr(libs["sweep_hzb_cluster"], entry), SIGNATURE)
                for label, entry in CLUSTERS.items()})
    fns["previous"] = _bound(libs["sweep_previous_hzb_tail"].hzb_tail, SIGNATURE)
    return fns


def variant_call(fn, label: str, top: torch.Tensor, dims, counter: torch.Tensor):
    """One launch of C entry ``fn`` on ``top``; returns the output like the
    wrapper."""
    out = torch.empty(sum(w * h for w, h in dims), dtype=torch.float32, device=top.device)
    stream = torch.cuda.current_stream().cuda_stream
    if label == "previous":
        table, off = [], 0
        for w, h in dims:
            table += [w, h, off]
            off += w * h
        host = (ctypes.c_int * len(table))(*table)
        err = fn(top.data_ptr(), ctypes.addressof(host), out.data_ptr(), top.shape[0],
                 top.shape[1], len(dims), stream)
    else:
        err = fn(top.data_ptr(), out.data_ptr(), counter.data_ptr(), top.shape[0], top.shape[1],
                 len(dims), stream)
    if err:
        raise RuntimeError(f"hzb_tail {label}: cudaError {err}")
    return out


def frame_top(dev) -> tuple:
    """(top, dims) of K6's call in one 1920x1080 frame of the packed path."""
    from ..render.deferred import deferred_frame
    from ..render.params import FrameState, RenderSettings
    from ..render.testing import synthetic_device_scene, synthetic_frame_params

    scene, data = synthetic_device_scene(340, sphere_res=(32, 24), ground=True,
                                         rich_materials=True, atlas_u8=True,
                                         packed_trilinear=True, device=dev)
    settings = RenderSettings(width=WIDTH, height=HEIGHT, shadow_map_size=SHADOW,
                              has_masked_models=False, combined_material=True,
                              material_packed_trilinear=True, hzb_pallas_tail=True)
    seen, orig = [], hzb_mod.hzb_tail

    def rec(*a):
        seen.append(a)
        return orig(*a)

    hzb_mod.hzb_tail = rec
    try:
        deferred_frame(scene, synthetic_frame_params(data, WIDTH, HEIGHT, device=dev),
                       FrameState.initial(WIDTH, HEIGHT, dev), settings)
        torch.cuda.synchronize()
    finally:
        hzb_mod.hzb_tail = orig
    (top, dims), = seen
    return top.clone(), list(dims)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v first")
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("hzb_tail sweep: needs a CUDA card")
    smi = nvidia_smi()
    result = {"device": smi, "ptxas": {}, "tops": []}
    sources = variant_sources()
    if args.ptxas:
        with tempfile.TemporaryDirectory() as tmp:
            for label, text in sources.items():
                src = Path(tmp) / f"{label}.cu"
                src.write_text(text)
                result["ptxas"][label] = ptxas(label, src)
    fns = entries(sources)
    _cuda.library()
    dev = torch.device("cuda", 0)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(0)
    tops = {"frame": frame_top(dev)}
    for h, w in ODD_TOPS:
        top = torch.from_numpy(rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)).to(dev)
        tops[f"{h}x{w}"] = (top, list(hzb_mod.tail_dims(h, w, len(hzb_mod.hzb_layout(
            max(1, w // 2), max(1, h // 2))[0]))))
    failed = {}
    for key, (top, dims) in tops.items():
        want = hzb_mod.hzb_tail_ref(top, dims)
        variants = {"shipped": lambda top=top, dims=dims: hzb_mod.hzb_tail(top, dims)}
        for label, fn in fns.items():
            variants[label] = (lambda fn=fn, label=label, top=top, dims=dims:
                               variant_call(fn, label, top, dims, counter))
        for label in list(variants):
            try:
                ok = torch.equal(variants[label](), want)
            except RuntimeError as exc:  # a cluster that does not fit or launch
                failed.setdefault(label, {})[key] = str(exc)
                print(f"[hzb_tail {key}] {label}: {exc}")
                del variants[label]
                continue
            if not ok:
                raise RuntimeError(f"hzb_tail {label} != plain at top {key}")
        if key not in ("frame", "1080x1920"):
            continue
        times = {}
        for r in range(ROUNDS):
            order = list(variants.items())
            for label, fn in (order if r % 2 == 0 else order[::-1]):
                times.setdefault(label, []).append(graph_ms(fn, REPS))
        for label, fn in variants.items():  # after the replays: the counter is back to 0
            if not torch.equal(fn(), want):
                raise RuntimeError(f"hzb_tail {label} != plain after its graph replays ({key})")
        moved = (top.numel() + sum(w * h for w, h in dims)) * 4
        row = {"top": key, "shape": list(top.shape), "levels": len(dims), "bytes": moved,
               "bound_ms": 1e3 * moved / HBM_BYTES_PER_S,
               "ms": {v: statistics.median(ts) for v, ts in times.items()}, "ms_rounds": times}
        result["tops"].append(row)
        ranked = sorted(row["ms"].items(), key=lambda kv: kv[1])
        print(f"[hzb_tail {key}] top {tuple(top.shape)}, {len(dims)} levels, bound "
              f"{row['bound_ms']:.4f} ms ({moved} B)")
        print(f"[hzb_tail {key}] graph ms per call, fastest first: "
              + ", ".join(f"{v} {ms:.4f}" for v, ms in ranked)
              + f" (bit-equal to plain at every top, before and after the replays; {smi})")
    result["failed"] = failed
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
