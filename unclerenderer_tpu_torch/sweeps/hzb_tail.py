"""K6 (``csrc/hzb_tail.cu``, the HZB tail) at the top that one 1920x1080
frame gives it (the 270x480 f32 level under 8 tail levels, captured from a
frame of the packed path with ``hzb_pallas_tail`` on), and at odd tops.

Variants, each first held bit-equal to the plain version (``ops/hzb.py
hzb_tail_ref``) at every top, and again after its timed graph replays (a
ticket counter left non-zero would show there):

* ``shipped``  -- the wrapper (``ops/hzb.py hzb_tail``);
* ``ticket TH x TW, T threads`` -- the shipped source's tile kernel at other
  tiles and block sizes: a block reduces its tile of the top through
  log2(min(TH, TW)) levels, the last block to finish does the rest.

Device time per call: CUDA graphs of 10 calls, median of three rounds taken
in turns.  ``--ptxas`` first prints what ``nvcc -Xptxas -v`` says of every
instance.  Run from the repository root on a CUDA machine::

    python3 -m unclerenderer_tpu_torch.sweeps.hzb_tail [--ptxas] [--out FILE.json]
"""

from __future__ import annotations

import argparse
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
}
# every C entry here: top, out, counter, top_h, top_w, levels, stream
SIGNATURE = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def entry_name(label: str) -> str:
    return "sweep_" + "".join(ch if ch.isalnum() else "_" for ch in label)


def variant_sources() -> dict:
    """Library name -> source text: the shipped source with every variant's
    C entry appended."""
    text = (_cuda.CSRC / "hzb_tail.cu").read_text()
    for label, targs in VARIANTS.items():
        text += ENTRY_TEXT.format(entry=entry_name(label), **targs)
    return {"sweep_hzb_tail": text}


def _bound(fn, argtypes):
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def entries(sources: dict) -> dict:
    """Variant -> C function: the source built and bound."""
    lib = ctypes.PyDLL(str(_cuda.build_source("sweep_hzb_tail", sources["sweep_hzb_tail"])))
    return {label: _bound(getattr(lib, entry_name(label)), SIGNATURE) for label in VARIANTS}


def variant_call(fn, label: str, top: torch.Tensor, dims, counter: torch.Tensor):
    """One launch of C entry ``fn`` on ``top``; returns the output like the
    wrapper."""
    out = torch.empty(sum(w * h for w, h in dims), dtype=torch.float32, device=top.device)
    stream = torch.cuda.current_stream().cuda_stream
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
    for key, (top, dims) in tops.items():
        want = hzb_mod.hzb_tail_ref(top, dims)
        variants = {"shipped": lambda top=top, dims=dims: hzb_mod.hzb_tail(top, dims)}
        for label, fn in fns.items():
            variants[label] = (lambda fn=fn, label=label, top=top, dims=dims:
                               variant_call(fn, label, top, dims, counter))
        for label, fn in variants.items():
            if not torch.equal(fn(), want):
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
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
