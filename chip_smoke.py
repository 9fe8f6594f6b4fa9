#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``unclerenderer_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root: ``python3 chip_smoke.py``.

Three paths of the port are driven: two through ``deferred_frame``,

* default -- the reference's default frame (u8 combined quad atlas), which
  runs K1 (binned raster), K2/K3 (giant raster), K4 (PCF select) and K5
  (draw-mask gather);
* packed  -- the packed-trilinear material configuration: the u8 combined
  PACKED atlas (256 lanes), a procedural seamless env cube built here, and
  the four kernel flags on, which adds K6 (HZB tail), K7 (env select), K8
  (material select) and K9 (block-index copy);

and a third through ``ops/probes.py``:

* probes  -- the rows of the reference's TPU measurement probes that hold
  its last three kernels, at the probes' 1080p shapes: a (tc, 128) record
  gather fed by K10 (merge select) or by K12 (identity copy) of a merged
  (1080, 1920) id image, a packed-atlas row gather whose rows K11 (row
  copy) copies before a bilinear blend, and the camera and shadow binning
  whose block index array K12 copies before the coefficient gather.

Phases (each prints its own lines; any failure raises and exits non-zero):

1. device  -- card name and power limit, torch/CUDA versions, TF32 off.
2. build   -- nvcc builds the kernels from ``unclerenderer_tpu_torch/csrc``
   (one nvcc per source, all at once).
3. kernels -- every kernel against its plain PyTorch version on the same
   CUDA inputs, bit-equal: on random inputs (the random-triangle setups of
   the reference's raster tests at 256x256 for K1/K2, random tables and
   parameters for K6-K9, NaN/signed-zero/equal keys for K10, odd lengths,
   misaligned views and 1-8 byte types for the K9/K11/K12 copy) and on the
   inputs captured from one full-size frame of each path, with both
   versions timed.
4. cross   -- 256x256 frames (24 objects, 512^2 shadow map) rendered with the
   kernels on the card and with the plain versions on the CPU: depth and
   tri_id bit-equal, color within 1e-3; the default path, then the packed
   path under the trilinear and the anisotropic filter.
5. slice   -- per path, 10 carried frames at 1920x1080 over the
   263,184-triangle synthetic scene with a 4096^2 shadow map, on a slow
   orbit, with the launch counts set to 0 just before and read just after:
   every kernel of the path launched, all drop counters 0, finite color;
   then 3 timed runs of 10 frames.  The packed configuration is also timed
   with the four flags off (the reference's XLA-equivalent branches).
6. probes  -- the probe rows once with the launch counts set to 0 just
   before and read just after (K10, K11 and K12 each launched); every
   output equal to the same rows with the plain versions; each kernel
   call bit-equal to its plain version; kernel, plain and library times
   per kernel and each row's time with and without its kernel.

Every kernel's bound is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations over the f32
peak of 67 TFLOP/s (H100 SXM data sheet, 700 W), from the inputs of this
run.

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
ENV_SIZE = 128  # procedural env cube faces, 8 mips
KERNEL_FLAGS = dict(hzb_pallas_tail=True, env_select_kernel=True, mat_select_kernel=True,
                    bin_mat_idx=True)
PROBE_ROWS = 786432  # the probes' packed atlas rows (256 u8 lanes)
SUM_ATOL = 1e-5  # probe-row sums, kernel vs plain: the same adds over equal inputs
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
# three edge functions per (pixel, triangle slot), each a multiply, an FMA
# (2 operations) and an add: the least a raster level evaluates
EDGE_OPS = 12


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


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn`` without the host's launch cost:
    ``reps`` calls captured in one CUDA graph, replayed, timed with CUDA
    events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = cuda_ms(graph.replay, reps=3)
    del graph
    return ms / reps


def as_tuple(x):
    return tuple(x) if isinstance(x, tuple) else (x,)


def compare(a, b):
    """(mismatching elements, max abs difference) over matching outputs; a
    NaN matches a NaN."""
    bad, err = 0, 0.0
    for x, y in zip(as_tuple(a), as_tuple(b)):
        if x is None and y is None:
            continue
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"shape/dtype differ: {x.shape} {x.dtype} vs {y.shape} {y.dtype}")
        ne = x != y
        if x.is_floating_point():
            ne &= ~(torch.isnan(x) & torch.isnan(y))
        bad += int(ne.sum())
        diff = (x.double() - y.double()).abs()
        diff = diff[~torch.isnan(diff)]
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
    return bad, err


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def distinct(idx) -> int:
    return int(torch.unique(idx.reshape(-1)).numel())


# (bytes, operations) that one call of each kernel must move and do on its
# inputs: each input read once, each output written once; a gather reads
# the distinct rows (or elements) it addresses, in the lanes one request
# needs; rasters count EDGE_OPS per (pixel, valid triangle slot) of the
# blocks or chunks the tiles really visit.


def work_binned(coef, tri_id, valid, start, count, tile_h, tile_w, n_tx, y_offset=0.0,
                want_ids=True, ortho=False):
    pix, chunk = tile_h * tile_w, coef.shape[-1]
    per_block = (valid[:, 0] > 0).sum(-1)
    csum = torch.cat([per_block.new_zeros(1), torch.cumsum(per_block, 0)])
    start, count = start.long(), count.long()
    slots = int((csum[start + count] - csum[start]).sum())
    blocks = int(count.sum())
    moved = (blocks * chunk * 4 * (16 + 1 + int(want_ids)) + nbytes(start, count)
             + start.shape[0] * pix * 4 * (1 + int(want_ids)))
    return moved, EDGE_OPS * pix * slots


def work_giant(coef, valid, overlap, ids, tile_h, tile_w, n_tx, y_offset=0.0, want_ids=True,
               ortho=False):
    pix, chunk = tile_h * tile_w, coef.shape[-1]
    live = overlap != 0
    per_chunk = (valid > 0).sum(-1)
    slots = int((live.long() * per_chunk[None, :]).sum())
    chunks = int(live.any(0).sum())
    moved = (chunks * chunk * 4 * 17 + nbytes(overlap) + (nbytes(ids) if want_ids else 0)
             + overlap.shape[0] * pix * 4 * (1 + int(want_ids)))
    return moved, EDGE_OPS * pix * slots


def work_select9(table, row, base, deltas):
    d = torch.as_tensor(deltas, device=table.device)
    el = distinct(row.long()[:, None] * table.shape[1] + base.long()[:, None] + d[None, :])
    return el * table.element_size() + nbytes(row, base) + row.shape[0] * 9 * 4, 0


def work_gather_rows(table, idx):
    n, c = idx.numel(), table.shape[1]
    return distinct(idx) * c * table.element_size() + nbytes(idx) + n * c * 4, 0


def work_hzb_tail(top, dims):
    return nbytes(top) + 4 * sum(w * h for w, h in dims), 0


def work_env_select(env, rows, params9):
    # the two taps' 2x2 footprints: 8 groups of 4 channels per request
    n = rows.shape[0]
    return distinct(rows) * 32 * env.element_size() + nbytes(rows, params9) + n * 16, 0


def work_mat_select(atlas, rows, params7):
    n, c = rows.shape[0], atlas.shape[-1] // 16
    return distinct(rows) * 8 * c * atlas.element_size() + nbytes(rows, params7) + n * c * 4, 0


def work_copy(x):
    return 2 * nbytes(x), 0


def work_merge(a, b, ka, kb):
    return nbytes(a, b, ka, kb, a), 0


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


@contextlib.contextmanager
def patched(module, attr, value):
    """Module attribute ``attr`` set to ``value`` inside the block."""
    orig = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield
    finally:
        setattr(module, attr, orig)


def to_device(obj, device):
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj) if isinstance(getattr(obj, f.name), torch.Tensor)})


def seamless_env_cube(scene, size, seed, device):
    """``scene`` with a procedural seamless env cube: 6 seeded faces (a
    smooth sky-to-ground gradient with a bright sun lobe and texel noise),
    packed like the reference's Renderer packs a real one
    (``build_pyramid_tri_atlas(cube=True)``, bf16 rows of 128 lanes).
    Returns (scene, mip count)."""
    from unclerenderer_tpu_torch.textures.atlas import build_pyramid_tri_atlas
    from unclerenderer_tpu_torch.textures.image import generate_mips

    rng = np.random.default_rng(seed)
    t = (np.arange(size, dtype=np.float32) + 0.5) / size
    yy, xx = np.meshgrid(t, t, indexing="ij")
    chains = []
    for f in range(6):
        sky = np.stack([0.3 + 0.4 * (1 - yy), 0.4 + 0.4 * (1 - yy), 0.6 + 0.6 * (1 - yy)], -1)
        sun = 4.0 * np.exp(-((xx - 0.3 - 0.1 * f) ** 2 + (yy - 0.35) ** 2) * 60.0)[..., None]
        rgb = sky * (0.6 + 0.1 * f) + sun + rng.uniform(0.0, 0.2, (size, size, 3))
        face = np.concatenate([rgb, np.ones((size, size, 1))], -1).astype(np.float32)
        chains.append(generate_mips(face))
    env, rect0 = build_pyramid_tri_atlas(chains, dtype=np.float32, cube=True)
    tail = np.stack([chain[-1][..., :4] for chain in chains])
    scene = dataclasses.replace(
        scene,
        env_quad=torch.from_numpy(env).to(device=device, dtype=torch.bfloat16),
        env_rect0=torch.from_numpy(rect0.astype(np.float32)).to(device),
        env_tail=torch.from_numpy(tail).to(device))
    return scene, len(chains[0])


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
    from unclerenderer_tpu_torch.ops import hzb as hzb_mod
    from unclerenderer_tpu_torch.ops import probes
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

    def index_select(table, idx):
        return torch.index_select(table, 0, idx.reshape(-1))

    def clone(x):
        return x.clone()

    def where(a, b, ka, kb):
        return torch.where(ka > kb, a, b)

    csrc = "unclerenderer_tpu_torch/csrc/"
    kernels = {
        "binned_raster": dict(module=rk, ref=rk.binned_raster_ref, work=work_binned,
                              source=csrc + "binned_raster.cu",
                              replaces="unclerenderer_tpu/ops/pallas_raster.py:521"),
        "giant_raster": dict(module=rk, ref=rk.giant_raster_ref, work=work_giant,
                             source=csrc + "giant_raster.cu",
                             replaces="unclerenderer_tpu/ops/pallas_raster.py:170"),
        "shadow_select9": dict(module=shadow_mod, attr="select9", ref=shadow_mod.select9_ref,
                               work=work_select9, source=csrc + "shadow_select9.cu",
                               replaces="unclerenderer_tpu/ops/shadow.py:335"),
        "gather_rows": dict(module=tex_mod, ref=tex_mod.gather_rows_ref, work=work_gather_rows,
                            library=index_select, source=csrc + "gather_rows.cu",
                            replaces="unclerenderer_tpu/ops/texture.py:105"),
        "hzb_tail": dict(module=hzb_mod, ref=hzb_mod.hzb_tail_ref, work=work_hzb_tail,
                         source=csrc + "hzb_tail.cu",
                         replaces="unclerenderer_tpu/ops/hzb.py:109"),
        "env_select": dict(module=tex_mod, ref=tex_mod.env_select_ref, work=work_env_select,
                           source=csrc + "env_select.cu",
                           replaces="unclerenderer_tpu/ops/texture.py:861"),
        "mat_select": dict(module=tex_mod, ref=tex_mod.mat_select_ref, work=work_mat_select,
                           source=csrc + "mat_select.cu",
                           replaces="unclerenderer_tpu/ops/texture.py:571"),
        "materialize_rows": dict(module=rk, ref=rk.materialize_rows_ref, work=work_copy,
                                 library=clone, source=csrc + "copy_bytes.cu",
                                 replaces="unclerenderer_tpu/ops/pallas_raster.py:266"),
        "merge_select": dict(module=probes, ref=probes.merge_select_ref, work=work_merge,
                             library=where, source=csrc + "merge_select.cu",
                             replaces="tools/prof_r5.py:219"),
        "copy_rows": dict(module=probes, ref=probes.copy_rows_ref, work=work_copy,
                          library=clone, source=csrc + "copy_bytes.cu",
                          replaces="tools/prof_tap_bisect.py:284"),
        "materialize": dict(module=probes, ref=probes.materialize_ref, work=work_copy,
                            library=clone, source=csrc + "copy_bytes.cu",
                            replaces="tools/prof_fuse.py:51"),
    }
    for name, k in kernels.items():
        k.setdefault("attr", name)
        k.setdefault("library", None)
        k.update(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, graph_ms=0.0,
                 library_graph_ms=0.0, bytes_s=0.0, ops_s=0.0, calls=[])
    check(set(kernels) == set(_cuda.LAUNCHES), "every built kernel is checked")
    default_kernels = ("binned_raster", "giant_raster", "shadow_select9", "gather_rows")
    packed_kernels = ("hzb_tail", "env_select", "mat_select", "materialize_rows")
    probe_kernels = ("merge_select", "copy_rows", "materialize")
    report = {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda}

    def versus_plain(name, *a, **kw):
        """One call of kernel ``name`` against its plain version, bit-equal."""
        k = kernels[name]
        bad, err = compare(getattr(k["module"], k["attr"])(*a, **kw), k["ref"](*a, **kw))
        check(bad == 0, f"{name} != plain: {bad} elements")
        k["err"] = max(k["err"], err)

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

    # ---- 3a. K6-K9 vs plain on random inputs
    rng = np.random.default_rng(0)
    for h, w in ((270, 480), (67, 31), (3, 2), (1, 1)):
        top = torch.from_numpy(rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)).to(dev)
        layout, _ = hzb_mod.hzb_layout(max(1, w // 2), max(1, h // 2))
        versus_plain("hzb_tail", top, [(lw, lh) for _o, lw, lh in layout])
    env = torch.from_numpy(rng.uniform(0.0, 4.0, (4096, 128)).astype(np.float32)).to(dev)
    n = 100_000
    rows = torch.from_numpy(rng.integers(0, 4096, n).astype(np.int32)).to(dev)
    params9 = torch.from_numpy(np.concatenate([
        rng.random((5, n)), rng.integers(0, 2, (2, n)), rng.integers(-1, 3, (2, n)),
    ]).astype(np.float32)).to(dev)
    for table in (env, env.to(torch.bfloat16)):
        versus_plain("env_select", table, rows, params9)
    params7 = torch.from_numpy(np.concatenate([
        rng.random((5, n)), rng.integers(0, 2, (2, n))]).astype(np.float32)).to(dev)
    atlas = torch.from_numpy(rng.integers(0, 256, (8192, 256), dtype=np.uint8)).to(dev)
    rows = torch.from_numpy(rng.integers(0, 8192, n).astype(np.int32)).to(dev)
    for table in (atlas, atlas.float() / 255.0, (atlas.float() / 255.0).to(torch.bfloat16)):
        versus_plain("mat_select", table, rows, params7)
    ids = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, 7936 * 64 + 1,
                                        dtype=np.int64).astype(np.int32)).to(dev)
    for x in (ids[:-1].reshape(7936, 64), ids[1:1002], ids[:37 * 5].reshape(37, 5)):
        versus_plain("materialize_rows", x)  # aligned, misaligned by 4 B, odd length
    log("kernels", "hzb_tail, env_select, mat_select and materialize_rows bit-equal to plain "
                   "on random inputs (mat_select: u8, f32 and bf16 atlases)")

    # ---- 3a. K10-K12 vs plain on random inputs
    special = np.array([np.nan, 0.0, -0.0, 1.0, -1.0, np.inf, -np.inf], np.float32)
    n = 1080 * 1920 + 3
    ids = [torch.from_numpy(rng.integers(0, 1 << 24, n).astype(np.int32)).to(dev) for _ in "ab"]
    for keys in ([rng.standard_normal(n), rng.standard_normal(n)],
                 [rng.choice(special, n), rng.choice(special, n)]):
        ka, kb = (torch.from_numpy(k.astype(np.float32)).to(dev) for k in keys)
        kb = torch.where(torch.from_numpy(rng.random(n) < 0.2).to(dev), ka, kb)  # equal keys
        for sl in (slice(0, n - 3), slice(1, 1002), slice(0, 37)):  # aligned, misaligned, odd
            versus_plain("merge_select", ids[0][sl], ids[1][sl], ka[sl], kb[sl])
    raw = torch.from_numpy(rng.integers(0, 256, 8 * 4100 * 16, dtype=np.uint8)).to(dev)
    for dtype in (torch.uint8, torch.int16, torch.int32, torch.float32, torch.int64):
        x = raw.view(dtype)
        for view in (x[:4096 * 16].reshape(4096, 16), x[1:1 + 999 * 8].reshape(999, 8),
                     x[:37 * 5].reshape(37, 5)):
            versus_plain("copy_rows", view)
            versus_plain("materialize", view)
    log("kernels", "merge_select (NaN, signed-zero and equal keys), copy_rows and materialize "
                   "(1-8 byte types, aligned, misaligned, odd) bit-equal to plain on random inputs")

    # ---- full-size scenes (the two paths) and their orbit
    t0 = time.perf_counter()
    scene, data = synthetic_device_scene(
        N_OBJECTS, sphere_res=SPHERE_RES, ground=True, rich_materials=True, atlas_u8=True,
        device=dev)
    n_tris = int(scene.tri_model.shape[0])
    settings = RenderSettings(width=WIDTH, height=HEIGHT, shadow_map_size=SHADOW,
                              has_masked_models=False, combined_material=True)

    def params_at(i, mips=None):
        a = 0.0035 * i
        p = synthetic_frame_params(data, WIDTH, HEIGHT, device=dev,
                                   camera_pos=(4.0 * np.sin(a), 1.5, -4.0 * np.cos(a)))
        if mips is not None:
            p.env_mip_count = torch.tensor(float(mips), device=dev)
        return p

    params = [params_at(i) for i in range(FRAMES)]
    log("slice", f"scene: {data.num_models} models, {n_tris} triangles, atlas "
                 f"{tuple(scene.quad_img.shape)} {scene.quad_img.dtype}, built in "
                 f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    packed, _ = synthetic_device_scene(
        N_OBJECTS, sphere_res=SPHERE_RES, ground=True, rich_materials=True, atlas_u8=True,
        packed_trilinear=True, device=dev)
    packed, env_mips = seamless_env_cube(packed, ENV_SIZE, 0, dev)
    packed_settings = dataclasses.replace(settings, material_packed_trilinear=True,
                                          **KERNEL_FLAGS)
    packed_params = [params_at(i, env_mips) for i in range(FRAMES)]
    log("packed", f"scene: packed atlas {tuple(packed.quad_img.shape)} {packed.quad_img.dtype}, "
                  f"env cube {tuple(packed.env_quad.shape)} {packed.env_quad.dtype} "
                  f"({env_mips} mips), built in {time.perf_counter() - t0:.1f} s")

    # ---- 3b. kernels vs plain on inputs captured from one full-size frame
    def measure(name, ca, ck):
        """One captured call: kernel vs plain bit-equal; kernel, plain and
        library times; the call's bound."""
        k = kernels[name]
        wrapper = getattr(k["module"], k["attr"])
        bad, err = compare(wrapper(*ca, **ck), k["ref"](*ca, **ck))
        shapes = [tuple(x.shape) for x in ca if isinstance(x, torch.Tensor)]
        check(bad == 0, f"{name} != plain at path shapes {shapes}: {bad} elements")
        ms = cuda_ms(lambda: wrapper(*ca, **ck), reps=20)
        plain_ms = cuda_ms(lambda: k["ref"](*ca, **ck), reps=1)
        lib_ms = (cuda_ms(lambda: k["library"](*ca, **ck), reps=20)
                  if k["library"] is not None else None)
        # the same calls replayed from a CUDA graph: the device's share alone
        dev_ms = graph_ms(lambda: wrapper(*ca, **ck), reps=10)
        lib_dev_ms = (graph_ms(lambda: k["library"](*ca, **ck), reps=10)
                      if k["library"] is not None else None)
        moved, ops = k["work"](*ca, **ck)
        bytes_s, ops_s = moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        k["err"] = max(k["err"], err)
        k["ms"] += ms
        k["plain_ms"] += plain_ms
        k["library_ms"] += lib_ms or 0.0
        k["bytes_s"] += bytes_s
        k["ops_s"] += ops_s
        k["graph_ms"] += dev_ms
        k["library_graph_ms"] += lib_dev_ms or 0.0
        k["calls"].append({"shapes": shapes, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                           "graph_ms": dev_ms, "library_graph_ms": lib_dev_ms,
                           "bytes": moved, "ops": ops, "bound_ms": 1e3 * max(bytes_s, ops_s)})
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms (graph {lib_dev_ms:.4f})"
        log("kernels", f"{name} {shapes}: bit-equal, kernel {ms:.4f} ms (graph {dev_ms:.4f}), "
                       f"plain {plain_ms:.3f} ms, library {lib}, bound "
                       f"{1e3 * max(bytes_s, ops_s):.4f} ms ({moved} B, {ops} ops)")

    def capture(names, frame_scene, frame_params, frame_settings):
        with contextlib.ExitStack() as stack:
            recs = [stack.enter_context(Recorder(kernels[n]["module"], kernels[n]["attr"]))
                    for n in names]
            deferred_frame(frame_scene, frame_params,
                           FrameState.initial(WIDTH, HEIGHT, dev), frame_settings)
            torch.cuda.synchronize()
        for name, r in zip(names, recs):
            k = kernels[name]
            check(r.calls, f"{name}: the frame made no call")
            wrapper = getattr(k["module"], k["attr"])
            for ca, ck in r.calls:
                measure(name, ca, ck)

    capture(default_kernels, scene, params[0], settings)
    capture(packed_kernels, packed, packed_params[0], packed_settings)

    # ---- 4. cross-device frames: kernels on the card vs plain versions on the CPU
    small = RenderSettings(width=256, height=256, shadow_map_size=512,
                           has_masked_models=False, combined_material=True)

    def cross(label, sc_cpu, sdata, frame_settings, mips=None):
        sc_gpu = to_device(sc_cpu, dev)
        st_c = FrameState.initial(256, 256, "cpu")
        st_g = FrameState.initial(256, 256, dev)
        for i in range(2):
            pos = (4.0 * np.sin(0.05 * i), 1.5, -4.0 * np.cos(0.05 * i))
            p_c = synthetic_frame_params(sdata, 256, 256, camera_pos=pos, device="cpu")
            p_g = synthetic_frame_params(sdata, 256, 256, camera_pos=pos, device=dev)
            if mips is not None:
                p_c.env_mip_count = torch.tensor(float(mips))
                p_g.env_mip_count = torch.tensor(float(mips), device=dev)
            out_c, st_c = deferred_frame(sc_cpu, p_c, st_c, frame_settings)
            out_g, st_g = deferred_frame(sc_gpu, p_g, st_g, frame_settings)
            for key in ("depth", "tri_id", "object_id"):
                bad = int((out_g[key].cpu() != out_c[key]).sum())
                check(bad == 0, f"cross-device {label} frame {i}: {key} differs at {bad} pixels")
            for key, v in out_c["raster_stats"].items():
                check(int(out_g["raster_stats"][key]) == int(v),
                      f"cross-device {label} frame {i}: {key} differs")
            cdiff = float((out_g["color"].cpu() - out_c["color"]).abs().max())
            hdiff = float((out_g["hdr"].cpu() - out_c["hdr"]).abs().max())
            check(cdiff <= COLOR_ATOL, f"cross-device {label} frame {i}: color differs by {cdiff}")
            log("cross", f"{label} frame {i}: depth/tri_id/object_id bit-equal, "
                         f"|color| {cdiff:.2e}, |hdr| {hdiff:.2e}, "
                         f"{int((out_g['tri_id'] >= 0).sum())} covered pixels")
        return cdiff

    sc_cpu, sdata = synthetic_device_scene(24, rich_materials=True, atlas_u8=True, device="cpu")
    report["cross_color_max_abs"] = cross("default", sc_cpu, sdata, small)
    sc_cpu, sdata = synthetic_device_scene(24, rich_materials=True, atlas_u8=True,
                                           packed_trilinear=True, device="cpu")
    sc_cpu, mips = seamless_env_cube(sc_cpu, 32, 1, "cpu")
    for filt in ("trilinear", "anisotropic"):
        report[f"cross_color_max_abs_packed_{filt}"] = cross(
            f"packed {filt}", sc_cpu, sdata,
            dataclasses.replace(small, texture_filter=filt, material_packed_trilinear=True,
                                **KERNEL_FLAGS), mips)
    del sc_cpu

    # ---- 6. the probe path (defined here, run after the default path)
    def probe_path(frame_scene, frame_params):
        """The probe rows at the probes' shapes; K10-K12 counted, checked
        against the plain versions, timed beside their rows."""
        t0 = time.perf_counter()
        cam, shadow = probes.probe_setups(frame_scene, frame_params, settings)
        tc = int(cam.coef.shape[0])
        rng = np.random.default_rng(0)  # the record probe's draws, in its order
        rec = torch.from_numpy(rng.standard_normal((tc, 128)).astype(np.float32)).to(dev)
        i1, i2 = (torch.from_numpy(rng.integers(0, tc, (HEIGHT, WIDTH)).astype(np.int32)).to(dev)
                  for _ in "12")
        k1, k2 = (torch.from_numpy(rng.standard_normal((HEIGHT, WIDTH)).astype(np.float32)).to(dev)
                  for _ in "12")
        rng = np.random.default_rng(5)  # the tap probe's draws, in its order
        n = WIDTH * HEIGHT
        table = torch.from_numpy(rng.integers(0, 255, (PROBE_ROWS, 256), dtype=np.int64)
                                 .astype(np.uint8)).to(dev)
        idx = torch.from_numpy(rng.integers(0, PROBE_ROWS, n, dtype=np.int64)
                               .astype(np.int32)).to(dev)
        fx, fy = (torch.from_numpy(rng.random((n, 1), np.float32)).to(dev) for _ in "xy")
        tri0 = torch.where(k1 > k2, i1, i2)
        bins = {
            "cam": (cam, WIDTH, HEIGHT, settings.tile_h, settings.tile_w, settings.chunk,
                    settings.bin_budget_factor, settings.bin_max_span),
            "shadow": (shadow, SHADOW, SHADOW, settings.shadow_tile_h, settings.shadow_tile_w,
                       settings.shadow_chunk, settings.shadow_bin_budget_factor,
                       settings.bin_max_span),
        }
        rows = {
            "rec_param": lambda: probes.rec_param(rec, tri0),
            "rec_pmerge": lambda: probes.rec_pmerge(rec, i1, i2, k1, k2),
            "rec_mat": lambda: probes.rec_mat(rec, i1, i2, k1, k2),
            "tap_v10_i32": lambda: probes.tap_copy_blend_i32(table, idx, fx, fy),
            "tap_v11_f32": lambda: probes.tap_copy_blend_f32(table, idx, fx, fy),
        }
        for label, b in bins.items():
            rows[f"align_gather[{label}]"] = lambda b=b: probes.align_gather(*b)
            rows[f"align_materialize_gather[{label}]"] = (
                lambda b=b: probes.align_materialize_gather(*b))
        torch.cuda.synchronize()
        log("probes", f"inputs: rec ({tc}, 128) f32, ids/keys ({HEIGHT}, {WIDTH}), table "
                      f"{tuple(table.shape)} u8 x {n} requests, setups cam {tuple(cam.coef.shape)} "
                      f"shadow {tuple(shadow.coef.shape)}; built in {time.perf_counter() - t0:.1f} s")

        # the path's run: counts set to 0 just before and read just after
        _cuda.reset_launches()
        with contextlib.ExitStack() as stack:
            recs = {name: stack.enter_context(Recorder(probes, name)) for name in probe_kernels}
            outs = {name: fn() for name, fn in rows.items()}
            torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
        log("probes", f"launches in one run of the rows: {launches}")
        for name in probe_kernels:
            check(launches[name] > 0, f"kernel {name} was not launched by the probe path")

        def plain_versions():
            stack = contextlib.ExitStack()
            for name in probe_kernels:
                stack.enter_context(patched(probes, name, kernels[name]["ref"]))
            return stack

        # the same rows with the plain versions: ids and indices bit-equal, sums close
        with plain_versions():
            plain = {name: fn() for name, fn in rows.items()}
        sum_err = 0.0
        for name, out in outs.items():
            if name.startswith("align"):
                bad, _ = compare(out, plain[name])
                check(bad == 0, f"probe row {name} != plain: {bad} elements")
            else:
                check(out.shape == plain[name].shape and bool(torch.isfinite(out).all()),
                      f"probe row {name}: shape or non-finite values")
                err = float((out - plain[name]).abs().max())
                check(err <= SUM_ATOL, f"probe row {name} differs from plain by {err}")
                sum_err = max(sum_err, err)
        merged = probes.merge_select(i1, i2, k1, k2)
        check(torch.equal(merged, tri0), "K10 merged ids != torch.where on the probe images")
        log("probes", f"every row equal to its plain-version run (index blocks bit-equal, sums "
                      f"max |diff| {sum_err:.3g} <= {SUM_ATOL})")
        for name, r in recs.items():
            for ca, ck in r.calls:
                measure(name, ca, ck)
        del recs

        # each row with its kernel and with the plain version, in turns
        # (kernel, plain, plain, kernel; 5 runs each)
        row_ms = {}
        for name, fn in rows.items():
            ms = cuda_ms(fn, reps=5)
            with plain_versions():
                plain_ms = cuda_ms(fn, reps=5) + cuda_ms(fn, reps=5)
            ms = (ms + cuda_ms(fn, reps=5)) / 2
            row_ms[name] = {"ms": ms, "plain_ms": plain_ms / 2}
            log("probes", f"row {name}: {ms:.3f} ms with its kernel, {plain_ms / 2:.3f} ms with the "
                          f"plain version (CUDA events, 2 x 5 runs each, on {smi})")
        return {"launches": launches, "rows": row_ms, "sum_max_abs_diff": sum_err}

    # ---- 5. each path at full size: 10 carried frames, counted, then 3 timed runs
    def run(frame_scene, frame_params, frame_settings, state):
        outs = []
        for p in frame_params:
            out, state = deferred_frame(frame_scene, p, state, frame_settings)
            outs.append(out)
        return outs, state

    def timed(label, frame_scene, frame_params, frame_settings, state):
        per_frame = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state = run(frame_scene, frame_params, frame_settings, state)
            torch.cuda.synchronize()
            per_frame.append((time.perf_counter() - t0) * 1000.0 / FRAMES)
        med = statistics.median(per_frame)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        log(label, f"ms/frame median {med:.2f} min {min(per_frame):.2f} max {max(per_frame):.2f} "
                   f"(3 runs x {FRAMES} frames, {WIDTH}x{HEIGHT}, shadow {SHADOW}^2, {n_tris} tris) "
                   f"peak {peak_gb:.1f} GiB on {smi}")
        return {"ms_per_frame": per_frame, "median_ms": med, "peak_gib": peak_gb}

    def counted(label, names, frame_scene, frame_params, frame_settings):
        """The main-path run of one path: counts set to 0 just before the 10
        frames and read just after; then the gates and 3 timed runs."""
        state = FrameState.initial(WIDTH, HEIGHT, dev)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        outs, state = run(frame_scene, frame_params, frame_settings, state)
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
        log(label, f"launches in {FRAMES} frames: {launches}")
        for name in names:
            check(launches[name] > 0, f"kernel {name} was not launched by the {label} path")
        drops = {k: max(int(o["raster_stats"][k]) for o in outs) for k in outs[0]["raster_stats"]}
        log(label, f"drop counters (max over frames): {drops}")
        for key in ("pair_overflow", "giant_truncated", "compact_overflow",
                    "shadow_compact_overflow"):
            check(drops[key] == 0, f"{label}: drop counter {key} = {drops[key]}")
        color = outs[-1]["color"]
        check(tuple(color.shape) == (HEIGHT, WIDTH, 3), f"color shape {tuple(color.shape)}")
        check(bool(torch.isfinite(color).all()), f"{label}: non-finite color")
        covered = int((outs[-1]["tri_id"] >= 0).sum())
        check(covered > 0.3 * WIDTH * HEIGHT, f"{label}: only {covered} covered pixels")
        log(label, f"color finite {tuple(color.shape)}, mean {float(color.mean()):.4f}, "
                   f"{covered} covered pixels, visible models "
                   f"{int(outs[-1]['model_visible'].sum())}/{data.num_models}")
        del outs
        return {"launches": launches, "drops": drops,
                **timed(label, frame_scene, frame_params, frame_settings, state)}

    report["slice"] = counted("slice", default_kernels, scene, params, settings)
    report["probes"] = probe_path(scene, params[0])
    del scene
    report["packed"] = counted("packed", default_kernels + packed_kernels, packed,
                               packed_params, packed_settings)
    flags_off = dataclasses.replace(packed_settings, **{k: False for k in KERNEL_FLAGS})
    report["packed_flags_off"] = timed("packed-flags-off", packed, packed_params, flags_off,
                                       FrameState.initial(WIDTH, HEIGHT, dev))
    log("packed", f"ms/frame median: kernel flags on {report['packed']['median_ms']:.2f}, "
                  f"off {report['packed_flags_off']['median_ms']:.2f}; default path "
                  f"{report['slice']['median_ms']:.2f} (on {smi})")

    report["kernels"] = {n: {"calls": k["calls"], "ms": k["ms"], "plain_ms": k["plain_ms"],
                             "graph_ms": k["graph_ms"], "library_ms": k["library_ms"],
                             "library_graph_ms": k["library_graph_ms"],
                             "bound_ms": 1e3 * max(k["bytes_s"], k["ops_s"])}
                         for n, k in kernels.items()}
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))

    def main_path_launches(name):
        path = ("slice" if name in default_kernels else
                "probes" if name in probe_kernels else "packed")
        return report[path]["launches"][name]

    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": main_path_launches(n), "max_abs_err": k["err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": 1e3 * max(k["bytes_s"], k["ops_s"]),
         "bound_by": "bytes" if k["bytes_s"] >= k["ops_s"] else "operations",
         "library_ms": k["library_ms"] if k["library"] is not None else None}
        for n, k in kernels.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
