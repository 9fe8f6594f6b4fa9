#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``unclerenderer_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root: ``python3 chip_smoke.py``.

Phases (each prints its own lines; any failure raises and exits non-zero):

1. device  -- card name and power limit, torch/CUDA versions, TF32 off.
2. build   -- nvcc builds the kernels from ``unclerenderer_tpu_torch/csrc``.
3. kernels -- every kernel against its plain PyTorch version on the same
   CUDA inputs, bit-equal: on the random-triangle setups of the reference's
   raster tests (256x256) and on the inputs captured from one full-size
   frame (fine / mid / giant raster levels of the camera and the shadow map,
   the PCF fetch, the draw-mask gather), with both versions timed.
4. cross   -- a 256x256 frame (24 objects, 512^2 shadow map) rendered with
   the kernels on the card and with the plain versions on the CPU: depth and
   tri_id bit-equal, color within 1e-3.
5. slice   -- 10 carried frames of the default deferred frame at 1920x1080
   over the 263,184-triangle synthetic scene with a 4096^2 shadow map, on a
   slow orbit: every kernel launched, all drop counters 0, finite color;
   then 3 timed runs of 10 frames.

The last three lines of stdout are the kernels JSON, the card's
``nvidia-smi`` name/power-limit line, and the result JSON.  The script needs
one CUDA card and imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

WIDTH, HEIGHT, FRAMES = 1920, 1080, 10
SHADOW = 4096
N_OBJECTS, SPHERE_RES = 340, (32, 24)
COLOR_ATOL = 1e-3  # transcendental (GGX, sky, tonemap) rounding, CPU vs GPU


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok, msg: str) -> None:
    """A failed check ends the run (not an assert: those vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def as_tuple(x):
    return tuple(x) if isinstance(x, tuple) else (x,)


def compare(a, b):
    """(mismatching elements, max abs difference) over matching outputs."""
    bad, err = 0, 0.0
    for x, y in zip(as_tuple(a), as_tuple(b)):
        if x is None and y is None:
            continue
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"shape/dtype differ: {x.shape} {x.dtype} vs {y.shape} {y.dtype}")
        bad += int((x != y).sum())
        err = max(err, float((x.double() - y.double()).abs().max()) if x.numel() else 0.0)
    return bad, err


class Recorder:
    """Patches a kernel wrapper (module attribute) to record its calls."""

    def __init__(self, module, attr):
        self.module, self.attr = module, attr
        self.orig = getattr(module, attr)
        self.calls = []

    def __enter__(self):
        def rec(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.orig(*args, **kwargs)

        setattr(self.module, self.attr, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)


def to_device(obj, device):
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj) if isinstance(getattr(obj, f.name), torch.Tensor)})


def random_setup(n, seed, size, device, w=256, h=256):
    """The reference raster tests' random triangles (tests/test_pallas_kernels.py
    ``_setup``), set up by the port."""
    from unclerenderer_tpu_torch.ops.raster import CULL_NONE, triangle_setup_from_components

    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    ctr[:, 2] = rng.uniform(0.1, 0.9, n)
    d1 = rng.normal(0, size, (n, 3)).astype(np.float32)
    d2 = rng.normal(0, size, (n, 3)).astype(np.float32)
    v = torch.from_numpy(np.stack([ctr - d1, ctr + d2, ctr + d1], 1)).to(device)
    px = [(v[:, k, 0] * 0.5 + 0.5) * w for k in range(3)]
    py = [(0.5 - v[:, k, 1] * 0.5) * h for k in range(3)]
    pw = [torch.ones(n, device=device) for _ in range(3)]
    return triangle_setup_from_components(
        px[0], py[0], pw[0], px[1], py[1], pw[1], px[2], py[2], pw[2],
        v[:, 0, 2], v[:, 1, 2], v[:, 2, 2], torch.ones(n, dtype=torch.bool, device=device),
        CULL_NONE, w, h)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", type=Path, default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()

    # ---- 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False -- needs one CUDA card")

    from unclerenderer_tpu_torch.ops import _cuda
    from unclerenderer_tpu_torch.ops import raster_kernels as rk
    from unclerenderer_tpu_torch.ops import shadow as shadow_mod
    from unclerenderer_tpu_torch.ops import texture as tex_mod
    from unclerenderer_tpu_torch.ops.binning import bin_triangles
    from unclerenderer_tpu_torch.render.deferred import deferred_frame
    from unclerenderer_tpu_torch.render.params import FrameState, RenderSettings
    from unclerenderer_tpu_torch.render.testing import (
        synthetic_device_scene,
        synthetic_frame_params,
    )

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 must be off: the hat-function matmuls need full f32")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log("device", f"{smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
                  f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
                  f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build
    lib_path, build_s = _cuda.build()
    _cuda.library()
    log("build", f"{lib_path.name} built in {build_s:.1f} s from {len(_cuda.sources())} sources")

    kernels = {
        "binned_raster": dict(module=rk, ref=rk.binned_raster_ref,
                              source="unclerenderer_tpu_torch/csrc/binned_raster.cu",
                              replaces="unclerenderer_tpu/ops/pallas_raster.py:521"),
        "giant_raster": dict(module=rk, ref=rk.giant_raster_ref,
                             source="unclerenderer_tpu_torch/csrc/giant_raster.cu",
                             replaces="unclerenderer_tpu/ops/pallas_raster.py:170"),
        "shadow_select9": dict(module=shadow_mod, attr="select9", ref=shadow_mod.select9_ref,
                               source="unclerenderer_tpu_torch/csrc/shadow_select9.cu",
                               replaces="unclerenderer_tpu/ops/shadow.py:335"),
        "gather_rows": dict(module=tex_mod, ref=tex_mod.gather_rows_ref,
                            source="unclerenderer_tpu_torch/csrc/gather_rows.cu",
                            replaces="unclerenderer_tpu/ops/texture.py:105"),
    }
    for name, k in kernels.items():
        k.setdefault("attr", name)
        k.update(err=0.0, ms=0.0, plain_ms=0.0, calls=[])
    report = {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda}

    # ---- 3a. kernels vs plain on the reference tests' random setups (256^2)
    for seed, n, size in [(0, 150, 0.04), (2, 60, 0.2), (3, 40, 0.6), (5, 2000, 0.04)]:
        s = random_setup(n, seed, size, dev)
        bins = bin_triangles(s, 256, 256, 16, 64, 32)
        start, count = rk.tile_block_ranges(bins, 64)
        for want_ids in (True, False):
            a = (bins.coef, bins.tri_id, bins.valid, start, count, 16, 64, 4, 0.0, want_ids, False)
            bad, err = compare(rk.binned_raster(*a), rk.binned_raster_ref(*a))
            check(bad == 0, f"binned_raster != plain on random setup {seed}: {bad}")
            kernels["binned_raster"]["err"] = max(kernels["binned_raster"]["err"], err)
        for gtile in ((16, 64), (64, 256)):
            with Recorder(rk, "giant_raster") as r:
                rk.rasterize_giant(s, 256, 256, tile_h=gtile[0], tile_w=gtile[1], chunk=8)
            ga, gk = r.calls[0]
            bad, err = compare(rk.giant_raster(*ga, **gk), rk.giant_raster_ref(*ga, **gk))
            check(bad == 0, f"giant_raster != plain on random setup {seed}: {bad}")
            kernels["giant_raster"]["err"] = max(kernels["giant_raster"]["err"], err)
    log("kernels", "binned_raster and giant_raster bit-equal to plain on the 256^2 random setups")

    # ---- full-size scene (the slice) and its orbit
    t0 = time.perf_counter()
    scene_cpu, data = synthetic_device_scene(
        N_OBJECTS, sphere_res=SPHERE_RES, ground=True, rich_materials=True, atlas_u8=True)
    scene = to_device(scene_cpu, dev)
    n_tris = int(scene.tri_model.shape[0])
    settings = RenderSettings(width=WIDTH, height=HEIGHT, shadow_map_size=SHADOW,
                              has_masked_models=False, combined_material=True)

    def params_at(i):
        a = 0.0035 * i
        return synthetic_frame_params(data, WIDTH, HEIGHT, device=dev,
                                      camera_pos=(4.0 * np.sin(a), 1.5, -4.0 * np.cos(a)))

    params = [params_at(i) for i in range(FRAMES)]
    log("slice", f"scene: {data.num_models} models, {n_tris} triangles, atlas "
                 f"{tuple(scene.quad_img.shape)} {scene.quad_img.dtype}, built in "
                 f"{time.perf_counter() - t0:.1f} s")

    # ---- 3b. kernels vs plain on inputs captured from one full-size frame
    with contextlib.ExitStack() as stack:
        recs = [stack.enter_context(Recorder(k["module"], k["attr"])) for k in kernels.values()]
        deferred_frame(scene, params[0], FrameState.initial(WIDTH, HEIGHT, dev), settings)
        torch.cuda.synchronize()
    for (name, k), r in zip(kernels.items(), recs):
        check(r.calls, f"{name}: the frame made no call")
        wrapper = getattr(k["module"], k["attr"])
        for ca, ck in r.calls:
            bad, err = compare(wrapper(*ca, **ck), k["ref"](*ca, **ck))
            shapes = [tuple(x.shape) for x in ca if isinstance(x, torch.Tensor)]
            check(bad == 0, f"{name} != plain at frame shapes {shapes}: {bad} elements")
            ms = cuda_ms(lambda: wrapper(*ca, **ck), reps=20)
            plain_ms = cuda_ms(lambda: k["ref"](*ca, **ck), reps=1)
            k["err"] = max(k["err"], err)
            k["ms"] += ms
            k["plain_ms"] += plain_ms
            k["calls"].append({"shapes": shapes, "ms": ms, "plain_ms": plain_ms})
            log("kernels", f"{name} {shapes}: bit-equal, kernel {ms:.4f} ms, plain {plain_ms:.3f} ms")

    # ---- 4. cross-device frame: kernels on the card vs plain versions on the CPU
    small = RenderSettings(width=256, height=256, shadow_map_size=512,
                           has_masked_models=False, combined_material=True)
    sc_cpu, sdata = synthetic_device_scene(24, rich_materials=True, atlas_u8=True)
    sc_gpu = to_device(sc_cpu, dev)
    st_c = FrameState.initial(256, 256, "cpu")
    st_g = FrameState.initial(256, 256, dev)
    for i in range(2):
        pos = (4.0 * np.sin(0.05 * i), 1.5, -4.0 * np.cos(0.05 * i))
        out_c, st_c = deferred_frame(sc_cpu, synthetic_frame_params(sdata, 256, 256, camera_pos=pos),
                                     st_c, small)
        out_g, st_g = deferred_frame(sc_gpu, synthetic_frame_params(sdata, 256, 256, camera_pos=pos,
                                                                    device=dev), st_g, small)
        for key in ("depth", "tri_id", "object_id"):
            bad = int((out_g[key].cpu() != out_c[key]).sum())
            check(bad == 0, f"cross-device frame {i}: {key} differs at {bad} pixels")
        cdiff = float((out_g["color"].cpu() - out_c["color"]).abs().max())
        hdiff = float((out_g["hdr"].cpu() - out_c["hdr"]).abs().max())
        check(cdiff <= COLOR_ATOL, f"cross-device frame {i}: color differs by {cdiff}")
        log("cross", f"frame {i}: depth/tri_id/object_id bit-equal, |color| {cdiff:.2e}, "
                     f"|hdr| {hdiff:.2e}, {int((out_g['tri_id'] >= 0).sum())} covered pixels")
    report["cross_color_max_abs"] = cdiff

    # ---- 5. the slice: 10 carried frames, counted, then 3 timed runs
    def run(state):
        outs = []
        for p in params:
            out, state = deferred_frame(scene, p, state, settings)
            outs.append(out)
        return outs, state

    state = FrameState.initial(WIDTH, HEIGHT, dev)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    outs, state = run(state)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    log("slice", f"launches in {FRAMES} frames: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the main path")
    drops = {k: max(int(o["raster_stats"][k]) for o in outs) for k in outs[0]["raster_stats"]}
    log("slice", f"drop counters (max over frames): {drops}")
    for key in ("pair_overflow", "giant_truncated", "compact_overflow", "shadow_compact_overflow"):
        check(drops[key] == 0, f"drop counter {key} = {drops[key]}")
    color = outs[-1]["color"]
    check(tuple(color.shape) == (HEIGHT, WIDTH, 3), f"color shape {tuple(color.shape)}")
    check(bool(torch.isfinite(color).all()), "non-finite color")
    covered = int((outs[-1]["tri_id"] >= 0).sum())
    check(covered > 0.3 * WIDTH * HEIGHT, f"only {covered} covered pixels")
    log("slice", f"color finite {tuple(color.shape)}, mean {float(color.mean()):.4f}, "
                 f"{covered} covered pixels, visible models "
                 f"{int(outs[-1]['model_visible'].sum())}/{data.num_models}")
    del outs

    per_frame = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state = run(state)
        torch.cuda.synchronize()
        per_frame.append((time.perf_counter() - t0) * 1000.0 / FRAMES)
    med = statistics.median(per_frame)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log("slice", f"ms/frame median {med:.2f} min {min(per_frame):.2f} max {max(per_frame):.2f} "
                 f"(3 runs x {FRAMES} frames, {WIDTH}x{HEIGHT}, shadow {SHADOW}^2, {n_tris} tris) "
                 f"peak {peak_gb:.1f} GiB on {smi}")
    report.update(ms_per_frame=per_frame, launches=launches, drops=drops, peak_gib=peak_gb,
                  kernels={n: {"calls": k["calls"], "ms": k["ms"], "plain_ms": k["plain_ms"]}
                           for n, k in kernels.items()})
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))

    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": launches[n], "max_abs_err": k["err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"]}
        for n, k in kernels.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
