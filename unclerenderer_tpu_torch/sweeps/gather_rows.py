"""Thread shapes for the K5 row gather of ``csrc/gather_rows.cu``, timed on
the card over (rows, 2) bf16 tables with f32 (n, 2) out: the frame's
draw-mask table (342 rows, 263,184 indices), the same table under 16x the
rows, and a 48 KB table (the most that shared memory takes without an
opt-in) at both counts.

Variants:

* ``shipped``          -- ``gather_rows`` itself;
* ``R rows, staged``   -- R rows a thread, its indices loaded first, then
  the table staged in shared memory by every block;
* ``R rows, direct``   -- R rows a thread, the table read through the L1;
* ``..., word``        -- each row read as one 4-byte word, not two bf16;
* ``..., persistent``  -- at most 8 blocks per SM walking the rows with a
  grid-stride loop, so a block stages the table once for many rows;
* ``index_select``     -- PyTorch's gather of the same rows (bf16 out).

Indices random, then sorted (the frame's ``tri_model`` runs model by
model).  Device time per call from CUDA graphs of 20 calls, median of three
rounds taken in turns.  Run from the repository root on a CUDA machine::

    python3 -m unclerenderer_tpu_torch.sweeps.gather_rows [--out FILE.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics

import numpy as np
import torch

from ..ops import _cuda
from ..ops.texture import gather_rows_ref
from ..timing import graph_ms, nvidia_smi

SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
template <int R>
__device__ __forceinline__ void load(const int* __restrict__ idx, int64_t r0, int64_t n, int* r) {
#pragma unroll
  for (int k = 0; k < R; ++k) r[k] = r0 + k < n ? __ldg(idx + r0 + k) : 0;
}
template <int R, int kStaged, int kWord, int kPersist>
__global__ void __launch_bounds__(256) rows(const __nv_bfloat16* __restrict__ table, int64_t elems,
                                            const int* __restrict__ idx, float* __restrict__ out,
                                            int64_t n) {
  extern __shared__ uint4 raw[];
  int64_t t = (int64_t)blockIdx.x * 256 + threadIdx.x;
  int r[R];
  if (!kPersist) load<R>(idx, t * R, n, r);  // in flight while the table is staged
  const __nv_bfloat16* src = table;
  if (kStaged) {
    __nv_bfloat16* s = reinterpret_cast<__nv_bfloat16*>(raw);
    const int64_t vecs = elems * 2 / 16;
    for (int64_t i = threadIdx.x; i < vecs; i += 256) raw[i] = __ldg(reinterpret_cast<const uint4*>(table) + i);
    for (int64_t i = vecs * 8 + threadIdx.x; i < elems; i += 256) s[i] = table[i];
    __syncthreads();
    src = s;
  }
  for (; t * R < n; t += (int64_t)gridDim.x * 256) {
    const int64_t r0 = t * R;
    if (kPersist) load<R>(idx, r0, n, r);
    float v[2 * R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (kWord) {
        const __nv_bfloat162 h = reinterpret_cast<const __nv_bfloat162*>(src)[r[k]];
        v[2 * k] = __low2float(h), v[2 * k + 1] = __high2float(h);
      } else {
        v[2 * k] = __bfloat162float(src[2 * r[k]]), v[2 * k + 1] = __bfloat162float(src[2 * r[k] + 1]);
      }
    }
    if (r0 + R <= n) {
#pragma unroll
      for (int j = 0; j < R / 2; ++j)
        reinterpret_cast<float4*>(out)[R / 2 * t + j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    } else {
      for (int k = 0; k < R; ++k)
        if (r0 + k < n) out[2 * (r0 + k)] = v[2 * k], out[2 * (r0 + k) + 1] = v[2 * k + 1];
    }
    if (!kPersist) break;
  }
}
template <int R, int S, int W, int P>
void launch(const __nv_bfloat16* t, int64_t elems, const int* idx, float* out, int64_t n, cudaStream_t st) {
  int64_t blocks = (n + R * 256 - 1) / (R * 256);
  if (P) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (blocks > 8LL * sms) blocks = 8LL * sms;
  }
  rows<R, S, W, P><<<(unsigned)blocks, 256, S ? elems * 2 : 0, st>>>(t, elems, idx, out, n);
}
// variant: R | 16 staged | 32 word | 64 persistent
#define CASE(R, S, W, P) case R | 16 * S | 32 * W | 64 * P: launch<R, S, W, P>(t, elems, idx, out, n, st); break;
extern "C" int run(int variant, const void* table, long long rows_, const int* idx, float* out,
                   long long n, void* stream) {
  auto st = (cudaStream_t)stream;
  auto t = (const __nv_bfloat16*)table;
  const int64_t elems = rows_ * 2;
  switch (variant) {
    CASE(2, 1, 0, 0) CASE(4, 1, 0, 0) CASE(2, 0, 0, 0) CASE(4, 0, 0, 0)
    CASE(2, 0, 1, 0) CASE(2, 1, 1, 0) CASE(2, 1, 1, 1) CASE(2, 0, 1, 1)
  }
  return (int)cudaGetLastError();
}
"""

S, W, P = 16, 32, 64
VARIANTS = {"shipped": -1, "2 rows, staged": 2 | S, "4 rows, staged": 4 | S,
            "2 rows, direct": 2, "4 rows, direct": 4, "2 rows, direct, word": 2 | W,
            "2 rows, staged, word": 2 | S | W, "2 rows, staged, word, persistent": 2 | S | W | P,
            "2 rows, direct, word, persistent": 2 | W | P}
# (label, table rows, indices): the frame's draw-mask table and triangle count
WORKLOADS = [("frame", 342, 263184), ("16x rows", 342, 16 * 263184),
             ("48 KB table", 12288, 263184), ("48 KB table, 16x rows", 12288, 16 * 263184)]


def build():
    run = ctypes.PyDLL(str(_cuda.build_source("gather_rows_sweep", SOURCE))).run
    run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gather_rows sweep: needs a CUDA card")
    run = build()
    _cuda.library()
    shipped = _cuda._FNS["gather_rows"]
    smi = nvidia_smi()
    result = {"device": smi, "us_per_call": {}}
    for workload, rows, n in WORKLOADS:
        rng = np.random.default_rng(0)
        table = torch.from_numpy(rng.standard_normal((rows, 2)).astype(np.float32)).to(
            "cuda", torch.bfloat16)
        random_idx = torch.from_numpy(rng.integers(0, rows, n).astype(np.int32)).to("cuda")
        out = torch.empty((n, 2), device="cuda")
        for order, idx in (("random", random_idx), ("sorted", random_idx.sort().values)):
            def call(variant, idx=idx):
                stream = torch.cuda.current_stream().cuda_stream
                t, i, o = table.data_ptr(), idx.data_ptr(), out.data_ptr()
                if variant < 0:
                    err = shipped(t, i, o, n, 2, 1, stream)
                else:
                    err = run(variant, t, rows, i, o, n, stream)
                if err:
                    raise RuntimeError(f"cudaError {err}")

            want = gather_rows_ref(table, idx)
            fns = {}
            for name, variant in VARIANTS.items():
                out.zero_()
                call(variant)
                if not torch.equal(out, want):
                    raise RuntimeError(f"{name} is wrong")
                fns[name] = lambda variant=variant: call(variant)
            fns["index_select"] = lambda idx=idx: torch.index_select(table, 0, idx)
            times = {}
            for _ in range(3):
                for name, fn in fns.items():
                    times.setdefault(name, []).append(1e3 * graph_ms(fn, 20))
            label = f"{workload}, {order} indices"
            print(f"{label}: ({rows}, 2) bf16 table, {n} rows ({smi})")
            result["us_per_call"][label] = {}
            for name, ts in times.items():
                us = statistics.median(ts)
                result["us_per_call"][label][name] = us
                print(f"  {name:34s} {us:9.3f} us per call")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
