"""X1, the exhaustive raster of ``raster_backend="xla"``
(``csrc/exhaustive_raster.cu``), at the inputs one 1920x1080 xla frame of
the headline geometry (263,184 triangles, 4096^2 shadow map) gives it: the
map's and the camera's compacted tables (163,840 rows each).

For each of the two calls it prints what the inputs hold -- rows, valid
rows, the (tile, row) pairs past the box test, the most rows one tile has
and the most records one warp evaluates after the warp skip (the longest
chain of a tile) -- and the device time of every variant, each first held
bit-equal to the plain version (``ops/raster.py rasterize``):

* ``shipped``  -- the kernel wrapper of ``ops/raster_kernels.py``: band and
  column row masks, then each tile's rows in rounds of 256;
* ``P pixels a thread at every tile`` -- one warp layout for both calls, a
  warp 8 x 4P pixels (shipped: 2 pixels, 8 x 8, on tiles of at most 1,024
  pixels, the camera's; else 4, 8 x 16, the map's; 8, 8 x 32, is K2's);
* ``8 / 32 warps a block at most`` -- a 32 x 128 map tile's 32 warps in
  four blocks or one (shipped: 16 warps, two blocks);
* ``band words first`` -- a pass's column words loaded only where its band
  words hold a row;
* ``reversed tile order`` -- the grid's blocks take the tiles from the last;
* ``(diagnostic) no evaluation`` -- masks, prefix and staging with no row
  evaluated: what the rest costs (not a result);
* ``(diagnostic) no rows`` -- the masks and each tile's empty image, no
  pass counted: the fixed cost of a tile (not a result).

The variants are the shipped source with a line or two replaced
(``VARIANTS``), built through ``_cuda.build_source``.  Device time per call
(both launches): CUDA graphs of 10 calls, median of three rounds taken in
turns.  ``--ptxas`` first prints what ``nvcc -Xptxas -v`` says of the
shipped kernel.  Run from the repository root on a CUDA
machine::

    python3 -m unclerenderer_tpu_torch.sweeps.exhaustive [--ptxas] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
from pathlib import Path

import torch

from ..ops import _cuda
from ..ops import raster_kernels as rk
from ..ops.raster import rasterize
from ..timing import graph_ms, nvidia_smi
from .raster import DIAGNOSTIC, centre, ptxas, same, shipped_source

WIDTH, HEIGHT, SHADOW = 1920, 1080, 4096
ROUNDS, REPS = 3, 10

PIX = "constexpr int kSmallPix = 2, kLargePix = 4;"
MAX_WARPS = "constexpr int kMinWarps = 4, kMaxWarps = 16;"
EVALUATE = "raster::evaluate<kPix, kF4, kOrtho, false>(s_rec, n, lane, xs, ys, qy, qx, best, win);"
VARIANTS = {
    **{f"{p} pixels a thread at every tile": [(PIX, f"constexpr int kSmallPix = {p}, "
                                                    f"kLargePix = {p};")] for p in (2, 4, 8)},
    "8 warps a block at most": [(MAX_WARPS, "constexpr int kMinWarps = 4, kMaxWarps = 8;")],
    "32 warps a block at most": [(MAX_WARPS, "constexpr int kMinWarps = 4, kMaxWarps = 32;")],
    "band words first": [("  pass_words(w, band, col, p);\n  int n = 0;",
                          "  const uint4* b = reinterpret_cast<const uint4*>(band + "
                          "static_cast<size_t>(p) * kWords);\n  const uint4 b0 = b[0], b1 = b[1];\n"
                          "  if ((b0.x | b0.y | b0.z | b0.w | b1.x | b1.y | b1.z | b1.w) == 0) "
                          "return 0;\n  pass_words(w, band, col, p);\n  int n = 0;")],
    "reversed tile order": [("  const int tile = blockIdx.x;",
                             "  const int tile = gridDim.x - 1 - blockIdx.x;")],
    DIAGNOSTIC + "no evaluation": [(EVALUATE, "(void)n;")],
    DIAGNOSTIC + "no rows": [("cnt[i] = pass_count(band, col, g0 + p);", "cnt[i] = 0;")],
}


def variant_sources():
    """variant -> source text: the shipped source with its lines replaced."""
    out = {}
    shipped = shipped_source("exhaustive_raster")
    for label, edits in VARIANTS.items():
        text = shipped
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"exhaustive_raster.cu no longer holds a line of {label!r}")
            text = text.replace(old, new)
        out[label] = text
    return out


def bind(label: str, text: str):
    entry = "sweep_x1_" + "".join(ch if ch.isalnum() else "_" for ch in label)
    text = text.replace('extern "C" int exhaustive_raster(', f'extern "C" int {entry}(')
    fn = getattr(ctypes.PyDLL(str(_cuda.build_source(entry, text))), entry)
    fn.argtypes, fn.restype = _cuda.SIGNATURES["exhaustive_raster"], ctypes.c_int
    return fn


def entry_call(fn, label, setup, width, height, tile_h, tile_w, depth_mode, y_offset=0.0,
               want_ids=True, ortho=False, **_):
    """One call of a variant's C entry: (depth, ids or None)."""
    coef, bbox, valid = setup.coef, setup.bbox, setup.valid
    t = coef.shape[0]
    depth = torch.empty((height, width), dtype=torch.float32, device=coef.device)
    ids = torch.empty((height, width), dtype=torch.int32, device=coef.device) if want_ids else None
    tail = (t, width, height, tile_h, tile_w, float(y_offset), int(want_ids), int(ortho),
            int(depth_mode == rk.DEPTH_MAX), torch.cuda.current_stream().cuda_stream)
    lines = -(-height // tile_h) + -(-width // tile_w)
    masks = torch.empty((lines, -(-t // rk.X1_PASS) * (rk.X1_PASS // 32)),
                        dtype=torch.int32, device=coef.device)
    err = fn(coef.data_ptr(), bbox.data_ptr(), valid.data_ptr(), masks.data_ptr(),
             depth.data_ptr(), _cuda.ptr(ids), *tail)
    if err:
        raise RuntimeError(f"exhaustive_raster {label}: cudaError {err}")
    return depth, ids


def frame_calls(dev):
    """X1's two calls of one xla frame: [(label, args, kwargs)], map first."""
    from ..render import common
    from ..render.deferred import deferred_frame
    from ..render.params import FrameState, RenderSettings
    from ..render.testing import synthetic_device_scene, synthetic_frame_params

    scene, data = synthetic_device_scene(340, sphere_res=(32, 24), ground=True,
                                         rich_materials=True, atlas_u8=True, device=dev)
    settings = RenderSettings(width=WIDTH, height=HEIGHT, shadow_map_size=SHADOW,
                              has_masked_models=False, raster_backend="xla")
    params = synthetic_frame_params(data, WIDTH, HEIGHT, device=dev)
    calls, orig = [], common.rasterize_exhaustive

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    common.rasterize_exhaustive = rec
    try:
        deferred_frame(scene, params, FrameState.initial(WIDTH, HEIGHT, dev), settings)
        torch.cuda.synchronize()
    finally:
        common.rasterize_exhaustive = orig
    return [(label, a, k) for label, (a, k) in zip(("shadow", "camera"), calls)]


def box_pairs(setup, width, height, tile_h, tile_w, y_offset=0.0):
    """The (row, tile) pairs whose box test X1 passes: every valid row with a
    finite box against the tiles its box overlaps.  Box and tile edges are
    integers, so the tile range of a row is exact.  Returns (rows, tiles)."""
    rows = torch.nonzero(setup.valid & torch.isfinite(setup.bbox).all(0)).flatten()
    b = setup.bbox[:, rows].double()
    n_tx, n_ty = -(-width // tile_w), -(-height // tile_h)
    x_lo = torch.ceil((b[0] - (tile_w - 1)) / tile_w).clamp(min=0)
    x_hi = torch.floor(b[2] / tile_w).clamp(max=n_tx - 1)
    y_lo = torch.ceil((b[1] - y_offset - (tile_h - 1)) / tile_h).clamp(min=0)
    y_hi = torch.floor((b[3] - y_offset) / tile_h).clamp(max=n_ty - 1)
    nx = (x_hi - x_lo + 1).clamp(min=0).long()
    n = nx * (y_hi - y_lo + 1).clamp(min=0).long()
    k = torch.arange(int(n.sum()), device=rows.device) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    nxr = torch.repeat_interleave(nx, n)
    tx = torch.repeat_interleave(x_lo.long(), n) + k % nxr
    ty = torch.repeat_interleave(y_lo.long(), n) + k // nxr
    return torch.repeat_interleave(rows, n), ty * n_tx + tx


def work(setup, width, height, tile_h, tile_w, y_offset=0.0, **_):
    """Rows, valid rows, (tile, row) pairs past the box test, the most rows a
    tile has, and the most records one warp rectangle keeps after the warp
    skip (raster_common.cuh's corner test) -- the longest chain a tile
    evaluates -- and the sum of each tile's longest chain."""
    from ..ops.fma import fma

    rows, tiles = box_pairs(setup, width, height, tile_h, tile_w, y_offset)
    n_tx = -(-width // tile_w)
    n_tiles = n_tx * -(-height // tile_h)
    rh, rw = 8, (8 if tile_h * tile_w <= 1024 else 16)  # the shipped warp rectangle
    rx_n = -(-tile_w // rw)
    rect = torch.arange(rx_n * -(-tile_h // rh), device=rows.device)
    rx, ry = (rect % rx_n) * rw, (rect // rx_n) * rh
    per = torch.zeros((n_tiles, rect.shape[0]), dtype=torch.long, device=rows.device)
    for s0 in range(0, rows.shape[0], 1 << 19):
        coef = setup.coef[rows[s0:s0 + (1 << 19)]]
        t = tiles[s0:s0 + (1 << 19)]
        x0 = ((t % n_tx) * tile_w).to(torch.float32)[:, None]
        y0 = ((t // n_tx) * tile_h).to(torch.float32)[:, None] + y_offset
        may = torch.ones((coef.shape[0], rect.shape[0]), dtype=torch.bool, device=coef.device)
        for e in range(3):
            a, b, c = (coef[:, i][:, None] for i in (e, 3 + e, 6 + e))
            qx = torch.where(a > 0, centre(x0, rx + rw - 1), centre(x0, rx))
            qy = torch.where(b > 0, centre(y0, ry + rh - 1), centre(y0, ry))
            ev = fma(a, qx, b * qy) + c
            may &= (ev > 0) | ((ev == 0) & ((a > 0) | ((a == 0) & (b > 0))))
        may |= ~torch.isfinite(coef[:, :9]).all(1, keepdim=True)
        per.index_add_(0, t, may.long())
    chain = per.max(1).values
    return {"rows": int(setup.coef.shape[0]), "valid_rows": int(setup.valid.sum()),
            "box_pairs": int(rows.shape[0]),
            "most_rows_a_tile": int(torch.bincount(tiles, minlength=n_tiles).max()),
            "longest_chain": int(chain.max()), "sum_of_chains": int(chain.sum()),
            "kept_rect_rows": int(per.sum())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v first")
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("exhaustive sweep: needs a CUDA card")
    smi = nvidia_smi()
    result = {"device": smi, "ptxas": {}, "calls": []}
    sources = variant_sources()
    if args.ptxas:
        result["ptxas"]["shipped"] = ptxas("shipped", _cuda.CSRC / "exhaustive_raster.cu")
    _cuda.library()
    fns = {label: bind(label, text) for label, text in sources.items()}
    dev = torch.device("cuda", 0)
    for label, a, k in frame_calls(dev):
        want = rasterize(*a, **k)
        variants = {"shipped": lambda a=a, k=k: rk.rasterize_exhaustive(*a, **k)}
        for vname, fn in fns.items():
            variants[vname] = lambda a=a, k=k, fn=fn, vname=vname: entry_call(fn, vname, *a, **k)
        for vname, fn in variants.items():
            if not same(fn(), want) and not vname.startswith(DIAGNOSTIC):
                raise RuntimeError(f"{vname} != plain at the {label} call")
        times = {}
        for r in range(ROUNDS):
            order = list(variants.items())
            for vname, fn in (order if r % 2 == 0 else order[::-1]):
                times.setdefault(vname, []).append(graph_ms(fn, REPS))
        row = {"call": label, "shape": [a[1], a[2]], **work(*a, **k),
               "ms": {v: statistics.median(ts) for v, ts in times.items()},
               "ms_rounds": times}
        result["calls"].append(row)
        counts = {key: v for key, v in row.items() if key not in ("call", "ms", "ms_rounds")}
        print(f"[x1 {label}] {counts}")
        print(f"[x1 {label}] graph ms per call: "
              + ", ".join(f"{v} {ms:.4f}" for v, ms in row["ms"].items())
              + f" (bit-equal to plain; {smi})")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
