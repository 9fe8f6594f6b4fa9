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
``--ptxas`` first prints what ``nvcc -Xptxas -v`` says of the shipped
source and the register-capped variants; ``--forms`` times only the forms
named (beside the shipped one).  ``chip_smoke.py`` logs ``level_counts``
of the frame's two calls.  Run from the repository root on a CUDA machine::

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


def entry_name(label: str) -> str:
    return "sweep_m1_" + "".join(ch if ch.isalnum() else "_" for ch in label)


def variant_sources(labels=None) -> dict:
    """label -> stand-alone source text (headers pasted in, the C entry
    renamed): the shipped source with its lines replaced."""
    def renamed(text, label):
        return text.replace('extern "C" int masked_raster(', f'extern "C" int {entry_name(label)}(')

    out = {}
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
        fn.argtypes = _cuda.SIGNATURES["masked_raster"]
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
                if "blocks an SM" in label:
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
