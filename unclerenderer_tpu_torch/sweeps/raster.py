"""The frame's two raster kernels launch by launch: K1 (``csrc/binned_raster.cu``)
and K2 (``csrc/giant_raster.cu``) at the inputs that one 1920x1080 frame of
the default path (263,184 triangles, 4096^2 shadow map) gives them.

For each launch (shadow fine, shadow mid, camera fine, camera mid for K1;
shadow and camera for K2) it prints the shapes, the work the inputs hold
-- live (tile, block) or (tile, chunk) pairs, (pixel, valid row) pairs,
the most blocks or live chunks one tile has, and the share of (warp rectangle, row) pairs that the
kernels' warp skip drops -- and the device time of every variant, each
first held bit-equal to the plain version:

* ``shipped``        -- the kernel wrapper of ``ops/raster_kernels.py``;
* ``1 / 4 rectangles a block`` -- K1 blocks over 128 or 512 pixels of a
  tile (shipped: 256);
* ``16 / 64 warps a tile`` -- K1 with fewer or more spare warps turned
  into groups (shipped: 32);
* ``1 / 2 / 4 groups`` -- K1 with that many groups at every level (shipped:
  32 warps a tile, so 4 groups at 16 x 64 tiles and 1 at 32 x 128);
* ``P pixels a thread, H x W`` -- other warp layouts (shipped: K1 16 x 8
  pixels, 4 a thread; K2 8 x 32, 8 a thread; K1 keeps 4,096 pixels'
  worth of warps a tile and K2 1,024 pixels a block);
* ``no warp skip``   -- every row evaluated by every warp;
* ``reject before divide`` -- K1 skipping the depth divide where
  ``fma(-best, nw, nz) < 0`` proves the key cannot win;
* ``2 / 8 warps``    -- K2 blocks of 512 or 2,048 pixels;
* ``(diagnostic) no evaluation`` -- K1 staging every block and testing its
  rows, with no row evaluated: what the rest costs (not a result).

The variants are the shipped sources with a line or two replaced
(``VARIANTS``), built through ``_cuda.build_source``.  Device time per
launch: CUDA graphs of 10 launches, median of three rounds taken in turns.
``--ptxas`` first prints what ``nvcc -Xptxas -v`` says of the shipped
kernels (registers, shared memory, spills).  Run from the
repository root on a CUDA machine::

    python3 -m unclerenderer_tpu_torch.sweeps.raster [--ptxas] [--out FILE.json]
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
from ..ops.fma import fma
from ..timing import graph_ms, nvidia_smi

WIDTH, HEIGHT, SHADOW = 1920, 1080, 4096
ROUNDS, REPS = 3, 10

# a diagnostic variant computes something else: timed, not held to the plain version
DIAGNOSTIC = "(diagnostic) "
SKIP_TEST = "may = r[3].w == 0.f || (reach(r[0], xs, ys) && reach(r[1], xs, ys) && reach(r[2], xs, ys));"
GROUPS = "int groups = kTileWarps / n_rects;"
PART = "constexpr int kPartRects = 2;"
TILE_WARPS = "constexpr int kTileWarps = 32;"
DIVIDE = "if (hit) key = __fdiv_rn(key, nw);"


# the shipped warp layouts: pixels a thread, and a warp's rectangle (rows, columns)
BINNED_PIX, BINNED_RECT = 4, (16, 8)
GIANT_PIX, GIANT_RECT = 8, (8, 32)


def layout(shipped_pix, shipped_rect, pix, h, w):
    """A warp's pixels: an h x w rectangle, ``pix`` pixels a thread."""
    return [(f"constexpr int kPix = {shipped_pix};", f"constexpr int kPix = {pix};"),
            ("constexpr int kRectH = {}, kRectW = {};".format(*shipped_rect),
             f"constexpr int kRectH = {h}, kRectW = {w};")]


# kernel -> variant -> [(old line, new line), ...] of its csrc source
VARIANTS = {
    "binned_raster": {
        "1 rectangle a block": [(PART, "constexpr int kPartRects = 1;")],
        "4 rectangles a block": [(PART, "constexpr int kPartRects = 4;"),
                                 ("constexpr int kMaxThreads = 256;",
                                  "constexpr int kMaxThreads = 512;")],
        "16 warps a tile": [(TILE_WARPS, "constexpr int kTileWarps = 16;")],
        "64 warps a tile": [(TILE_WARPS, "constexpr int kTileWarps = 64;")],
        **{f"{g} group{'s' * (g > 1)}": [(GROUPS, f"int groups = {g};")] for g in (1, 2, 4)},
        "4 pixels a thread, 8 x 16": layout(BINNED_PIX, BINNED_RECT, 4, 8, 16),
        "4 pixels a thread, 32 x 4": layout(BINNED_PIX, BINNED_RECT, 4, 32, 4),
        "8 pixels a thread, 8 x 32": layout(BINNED_PIX, BINNED_RECT, 8, 8, 32) + [
            (TILE_WARPS, "constexpr int kTileWarps = 16;")],
        "8 pixels a thread, 16 x 16": layout(BINNED_PIX, BINNED_RECT, 8, 16, 16) + [
            (TILE_WARPS, "constexpr int kTileWarps = 16;")],
        "no warp skip": [(SKIP_TEST, "may = true;")],
        "reject before divide": [(DIVIDE, "hit = hit && !(__fmaf_rn(-best[k], nw, key) < 0.f && "
                                          "!(kMinTag && t < win[k])); if (hit) key = "
                                          "__fdiv_rn(key, nw);")],
        DIAGNOSTIC + "no evaluation": [(SKIP_TEST, "may = false;")],
    },
    "giant_raster": {
        "no warp skip": [(SKIP_TEST, "may = true;")],
        "2 warps": [("constexpr int kWarps = 4;", "constexpr int kWarps = 2;")],
        "8 warps": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
        "8 pixels a thread, 16 x 16": layout(GIANT_PIX, GIANT_RECT, 8, 16, 16),
        "8 pixels a thread, 4 x 64": layout(GIANT_PIX, GIANT_RECT, 8, 4, 64),
        "4 pixels a thread, 8 x 16": layout(GIANT_PIX, GIANT_RECT, 4, 8, 16) + [
            ("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
    },
}


def ptxas(label: str, source: Path) -> list[str]:
    """Registers, shared memory and spills of each kernel in ``source``."""
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                              "-o", str(Path(tmp) / "k.o"), str(source)],
                             capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
    lines = []
    for ln in res.stderr.splitlines():
        if "Compiling entry" in ln:  # the template arguments: <want_ids, ortho>
            lines.append("entry " + ln.split("kernelI")[-1].split("EEEv")[0])
        elif "registers" in ln or "spill" in ln:
            lines.append(ln.replace("ptxas info    :", "").strip())
    for ln in lines:
        print(f"[ptxas {label}] {ln}")
    return lines


def bind(label: str, name: str, text: str):
    """C entry ``name`` of a stand-alone kernel source, built and bound."""
    entry = "sweep_" + "".join(ch if ch.isalnum() else "_" for ch in label)
    text = text.replace(f'extern "C" int {name}(', f'extern "C" int {entry}(')
    fn = getattr(ctypes.PyDLL(str(_cuda.build_source(entry, text))), entry)
    fn.argtypes = _cuda.SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def shipped_source(name: str) -> str:
    """``csrc/<name>.cu`` with the headers it includes pasted in: one
    stand-alone text whose every line a variant may replace."""
    text = (_cuda.CSRC / f"{name}.cu").read_text()
    for header in _cuda.headers():
        text = text.replace(f'#include "{header.name}"', header.read_text())
    return text


def variant_sources():
    """(kernel, variant) -> source text: the shipped sources with their
    lines replaced."""
    out = {}
    for name, variants in VARIANTS.items():
        shipped = shipped_source(name)
        for label, edits in variants.items():
            text = shipped
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"{name}.cu (with its headers) no longer holds a "
                                       f"line of variant {label!r}")
                text = text.replace(old, new)
            out[(name, label)] = text
    return out


def entry_call(fn, name, args):
    """One launch of C entry ``fn`` (kernel ``name``'s signature) on a
    captured call's arguments; returns (key, id) like the wrapper."""
    stream = torch.cuda.current_stream().cuda_stream
    if name == "binned_raster":
        coef, tri_id, valid, start, count, th, tw, ntx, y_off, want_ids, ortho = args
        n_tiles = start.shape[0]
        head = (coef.data_ptr(), tri_id.data_ptr(), valid.data_ptr(), start.data_ptr(),
                count.data_ptr())
        tail = (n_tiles, coef.shape[-1], th, tw, ntx, float(y_off), int(want_ids), int(ortho))
    else:
        coef, valid, overlap, ids, th, tw, ntx, y_off, want_ids, ortho = args
        n_tiles, n_chunks = overlap.shape
        head = (coef.data_ptr(), valid.data_ptr(), overlap.data_ptr(), _cuda.ptr(ids))
        tail = (n_tiles, n_chunks, coef.shape[-1], th, tw, ntx, float(y_off), int(want_ids),
                int(ortho))
    key = torch.empty((n_tiles, th * tw), dtype=torch.float32, device=coef.device)
    ids_out = torch.empty_like(key, dtype=torch.int32) if want_ids else None
    err = fn(*head, key.data_ptr(), _cuda.ptr(ids_out), *tail, stream)
    if err:
        raise RuntimeError(f"{name}: cudaError {err}")
    return key, ids_out


def frame_calls(dev):
    """The K1 and K2 calls of one default-path frame, with their labels."""
    from ..render.deferred import deferred_frame
    from ..render.params import FrameState, RenderSettings
    from ..render.testing import synthetic_device_scene, synthetic_frame_params

    scene, data = synthetic_device_scene(340, sphere_res=(32, 24), ground=True,
                                         rich_materials=True, atlas_u8=True, device=dev)
    settings = RenderSettings(width=WIDTH, height=HEIGHT, shadow_map_size=SHADOW,
                              has_masked_models=False, combined_material=True)
    params = synthetic_frame_params(data, WIDTH, HEIGHT, device=dev)
    calls = {"binned_raster": [], "giant_raster": []}
    orig = {name: getattr(rk, name) for name in calls}

    def recorder(name):
        def rec(*args):
            calls[name].append(args)
            return orig[name](*args)
        return rec

    for name in calls:
        setattr(rk, name, recorder(name))
    try:
        deferred_frame(scene, params, FrameState.initial(WIDTH, HEIGHT, dev), settings)
        torch.cuda.synchronize()
    finally:
        for name, fn in orig.items():
            setattr(rk, name, fn)
    labelled = []
    for name, args in calls.items():
        seen = {}
        for a in args:
            view = "camera" if a[-2] else "shadow"
            level = ("fine", "mid")[seen.get(view, 0)] if name == "binned_raster" else "giant"
            seen[view] = seen.get(view, 0) + 1
            labelled.append((name, f"{view} {level}", a))
    return labelled


def centre(origin, offset):
    """Pixel centres as the kernels compute them: (origin + offset) + 0.5."""
    return (origin + offset.to(torch.float32)) + 0.5


def call_rows(name, args):
    """The rows one K1 or K2 call holds against its tiles: coefficients
    (R, 16), valid (R,) bool and the tile each row is evaluated for (R,),
    one entry per (tile, row) pair of the blocks or live chunks."""
    if name == "binned_raster":
        coef, valid, start, count = args[0], args[2], args[3].long(), args[4].long()
        tiles = torch.repeat_interleave(torch.arange(start.shape[0], device=start.device), count)
        blocks = torch.repeat_interleave(start - torch.cumsum(count, 0) + count, count) + \
            torch.arange(tiles.shape[0], device=start.device)
        return (coef[blocks].transpose(1, 2).reshape(-1, 16), valid[blocks, 0].reshape(-1) > 0,
                tiles.repeat_interleave(coef.shape[-1]))
    coef, valid, overlap = args[:3]
    tile, chunk_i = torch.nonzero(overlap != 0, as_tuple=True)
    return (coef[chunk_i].transpose(1, 2).reshape(-1, 16), valid[chunk_i].reshape(-1) > 0,
            tile.repeat_interleave(coef.shape[-1]))


def warp_rows(name, args):
    """What the warp skip of one K1 or K2 call leaves (the kernels' rule,
    ``csrc/raster_common.cuh``): (tested, kept, kept pixel rows) -- the
    (warp rectangle, valid row) pairs the call tests, those whose three
    edges may pass somewhere in the rectangle or that hold a non-finite
    edge coefficient, and the (pixel, row) pairs of the kept ones."""
    coef, valid, row_tile = call_rows(name, args)
    coef, row_tile = coef[valid], row_tile[valid].long()
    th, tw, n_tx, y_off = args[5:9] if name == "binned_raster" else args[4:8]
    rh, rw = BINNED_RECT if name == "binned_raster" else GIANT_RECT
    rx_n, ry_n = -(-tw // rw), -(-th // rh)
    rect = torch.arange(rx_n * ry_n, device=coef.device)
    rx, ry = (rect % rx_n) * rw, (rect // rx_n) * rh
    pixels = (torch.clamp(th - ry, max=rh) * torch.clamp(tw - rx, max=rw))[None, :]
    x0 = ((row_tile % n_tx) * tw).to(torch.float32)[:, None]
    y0 = ((row_tile // n_tx) * th).to(torch.float32)[:, None] + y_off
    may = torch.ones((coef.shape[0], rect.shape[0]), dtype=torch.bool, device=coef.device)
    for e in range(3):
        a, b, c = (coef[:, i][:, None] for i in (e, 3 + e, 6 + e))
        qx = torch.where(a > 0, centre(x0, rx + rw - 1), centre(x0, rx))
        qy = torch.where(b > 0, centre(y0, ry + rh - 1), centre(y0, ry))
        ev = fma(a, qx, b * qy) + c
        top_left = (a > 0) | ((a == 0) & (b > 0))
        may &= (ev > 0) | ((ev == 0) & top_left)
    may |= ~torch.isfinite(coef[:, :9]).all(1, keepdim=True)
    return int(may.numel()), int(may.sum()), int((may * pixels).sum())


def work(name, args) -> dict:
    """What one call's inputs hold."""
    tested, kept, _ = warp_rows(name, args)
    skip = 1.0 - kept / tested if tested else 0.0
    if name == "binned_raster":
        coef, valid, (start, count), (th, tw) = args[0], args[2], args[3:5], args[5:7]
        pix = th * tw
        per_block = (valid[:, 0] > 0).sum(-1)
        csum = torch.cat([per_block.new_zeros(1), torch.cumsum(per_block, 0)])
        s, c = start.long(), count.long()
        rows = csum[s + c] - csum[s]
        return {"tiles": int(s.shape[0]), "pix": pix, "chunk": int(coef.shape[-1]),
                "tile_blocks": int(c.sum()), "tiles_with_blocks": int((c > 0).sum()),
                "max_blocks_per_tile": int(c.max()), "valid_rows": int(rows.sum()),
                "pairs": pix * int(rows.sum()),
                "warp_rows": tested, "warp_skip_share": skip}
    (coef, valid, overlap), (th, tw) = args[:3], args[4:6]
    pix = th * tw
    live = overlap != 0
    per_chunk = (valid > 0).sum(-1)
    rows = (live.long() * per_chunk[None, :]).sum(1)
    return {"tiles": int(overlap.shape[0]), "pix": pix, "n_chunks": int(overlap.shape[1]),
            "chunk": int(coef.shape[-1]), "tile_chunks": int(live.sum()),
            "max_chunks_per_tile": int(live.sum(1).max()), "valid_rows": int(rows.sum()),
            "pairs": pix * int(rows.sum()),
            "warp_rows": tested, "warp_skip_share": skip}


def same(a, b) -> bool:
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v first")
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("raster sweep: needs a CUDA card")
    smi = nvidia_smi()
    result = {"device": smi, "ptxas": {}, "launches": []}
    sources = variant_sources()
    if args.ptxas:
        for name in ("binned_raster", "giant_raster"):
            result["ptxas"][name] = ptxas(name, _cuda.CSRC / f"{name}.cu")
    _cuda.library()
    fns = {key: bind(f"{key[0]} {key[1]}", key[0], text) for key, text in sources.items()}
    dev = torch.device("cuda", 0)
    for name, label, a in frame_calls(dev):
        want = getattr(rk, f"{name}_ref")(*a)
        variants = {"shipped": lambda a=a, f=getattr(rk, name): f(*a)}
        for (kernel, vname), fn in fns.items():
            if kernel == name:
                variants[vname] = lambda a=a, fn=fn: entry_call(fn, name, a)
        for vname, fn in variants.items():
            if not same(fn(), want) and not vname.startswith(DIAGNOSTIC):
                raise RuntimeError(f"{vname} {name} != plain at the {label} launch")
        times = {}
        for r in range(ROUNDS):
            order = list(variants.items())
            for vname, fn in (order if r % 2 == 0 else order[::-1]):
                times.setdefault(vname, []).append(graph_ms(fn, REPS))
        row = {"kernel": name, "launch": label, **work(name, a),
               "ms": {v: statistics.median(ts) for v, ts in times.items()},
               "ms_rounds": times}
        result["launches"].append(row)
        shown = ", ".join(f"{v} {ms:.4f}" for v, ms in row["ms"].items())
        counts = {k: v for k, v in row.items() if k not in ("kernel", "launch", "ms", "ms_rounds")}
        print(f"[{name} {label}] {counts}")
        print(f"[{name} {label}] graph ms per launch: {shown} (bit-equal to plain; {smi})")
    for name in ("binned_raster", "giant_raster"):
        rows = [r for r in result["launches"] if r["kernel"] == name]
        sums = {v: sum(r["ms"][v] for r in rows) for v in rows[0]["ms"]}
        print(f"[{name}] sum over {len(rows)} launches: "
              + ", ".join(f"{v} {ms:.4f} ms" for v, ms in sums.items()))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
