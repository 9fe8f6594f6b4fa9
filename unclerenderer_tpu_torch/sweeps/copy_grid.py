"""Grid shapes for the byte copy of ``csrc/copy_bytes.cu`` (K9, K11, K12),
timed on the card at the paths' copy sizes.

Variants, all 16-byte words between aligned buffers:

* ``shipped``       -- ``copy_bytes`` itself: one word a thread, uncapped grid;
* ``2/thread``      -- two words a thread (i, i + 256 in its block), uncapped;
* ``gs U x cap``    -- a grid of ``cap`` blocks per SM walking the words with
  a grid-stride loop, U independent loads in flight per thread;
* ``chunk 2 x 8``   -- 8 blocks per SM, each over one contiguous chunk;
* ``clone``         -- PyTorch's copy of the same tensor.

Device time per copy from CUDA graphs of ``reps`` copies, median of three
rounds taken in turns.  Run from the repository root on a CUDA machine::

    python3 -m unclerenderer_tpu_torch.sweeps.copy_grid [--out FILE.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics

import torch

from ..ops import _cuda
from ..timing import graph_ms, nvidia_smi

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int U>
__global__ void __launch_bounds__(256) gs(const uint4* __restrict__ s, uint4* __restrict__ d, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * 256;
  int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  for (; i + (U - 1) * stride < n; i += U * stride) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = __ldg(s + i + u * stride);
#pragma unroll
    for (int u = 0; u < U; ++u) d[i + u * stride] = v[u];
  }
  for (; i < n; i += stride) d[i] = __ldg(s + i);
}
__global__ void __launch_bounds__(256) chunk2(const uint4* __restrict__ s, uint4* __restrict__ d, int64_t n, int64_t len) {
  const int64_t lo = (int64_t)blockIdx.x * len, hi = lo + len < n ? lo + len : n;
  int64_t i = lo + threadIdx.x;
  for (; i + 256 < hi; i += 512) { const uint4 a = __ldg(s + i), b = __ldg(s + i + 256); d[i] = a; d[i + 256] = b; }
  for (; i < hi; i += 256) d[i] = __ldg(s + i);
}
__global__ void __launch_bounds__(256) two(const uint4* __restrict__ s, uint4* __restrict__ d, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * 512 + threadIdx.x;
  uint4 a, b;
  if (i < n) a = __ldg(s + i);
  if (i + 256 < n) b = __ldg(s + i + 256);
  if (i < n) d[i] = a;
  if (i + 256 < n) d[i + 256] = b;
}
extern "C" int run(int variant, int per_sm, const void* src, void* dst, long long nbytes, void* stream) {
  auto st = (cudaStream_t)stream;
  const int64_t n = nbytes / 16;
  auto s = (const uint4*)src; auto d = (uint4*)dst;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto grid = [&](int64_t threads) { const int64_t b = (threads + 255) / 256, cap = (int64_t)sms * per_sm;
                                     return (unsigned)(b < cap ? (b < 1 ? 1 : b) : cap); };
  switch (variant) {
    case 0: two<<<(unsigned)((n + 511) / 512), 256, 0, st>>>(s, d, n); break;
    case 2: gs<2><<<grid((n + 1) / 2), 256, 0, st>>>(s, d, n); break;
    case 4: gs<4><<<grid((n + 3) / 4), 256, 0, st>>>(s, d, n); break;
    case 9: { const unsigned b = grid((n + 1) / 2); chunk2<<<b, 256, 0, st>>>(s, d, n, (n + b - 1) / b); break; }
  }
  return (int)cudaGetLastError();
}
"""

# label -> (variant, blocks per SM); variant -1 is copy_bytes itself
VARIANTS = {"shipped": (-1, 0), "2/thread": (0, 0), "gs 2 x 8": (2, 8), "gs 2 x 32": (2, 32),
            "gs 2 x 64": (2, 64), "gs 4 x 4": (4, 4), "gs 4 x 32": (4, 32), "chunk 2 x 8": (9, 8)}
# (bytes, copies per graph): K11's v11 and v10 rows, K12's id image, K9/K12's
# largest block index arrays (shadow, camera)
SIZES = [(2073600 * 64 * 4, 5), (2073600 * 16 * 4, 10), (1080 * 1920 * 4, 50),
         (7936 * 64 * 4, 50), (7160 * 64 * 4, 50)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def build():
    run = ctypes.PyDLL(str(_cuda.build_source("copy_grid_sweep", SOURCE))).run
    run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_void_p]
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("copy_grid: needs a CUDA card")
    run = build()
    smi = nvidia_smi()
    result = {"device": smi, "sizes": {}}
    for nbytes, reps in SIZES:
        x = torch.randint(0, 255, (nbytes,), dtype=torch.uint8, device="cuda")
        y = torch.empty_like(x)
        times = {}
        for _ in range(3):
            for label, (variant, per_sm) in VARIANTS.items():
                if variant < 0:
                    def fn():
                        _cuda.copy("materialize", x)
                else:
                    def fn(variant=variant, per_sm=per_sm):
                        err = run(variant, per_sm, x.data_ptr(), y.data_ptr(), nbytes,
                                  torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"cudaError {err}")
                times.setdefault(label, []).append(graph_ms(fn, reps))
            times.setdefault("clone", []).append(graph_ms(x.clone, reps))
        if not torch.equal(x, y):
            raise RuntimeError("a copy variant is wrong")
        bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        print(f"{nbytes} bytes, bound {bound:.5f} ms ({smi})")
        result["sizes"][nbytes] = {"bound_ms": bound, "ms": {}}
        for label, ts in times.items():
            ms = statistics.median(ts)
            result["sizes"][nbytes]["ms"][label] = ms
            print(f"  {label:12s} {ms:.5f} ms  {100 * bound / ms:5.1f}% of the bound")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
