#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``unclerenderer_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root: ``python3 chip_smoke.py``.

Four paths of the port are driven: three through ``deferred_frame``,

* default -- the default frame of the combined material (u8 combined quad
  atlas), which runs K1 (binned raster), K2/K3 (giant raster), K4 (PCF
  select) and K5 (draw-mask gather);
* packed  -- the packed-trilinear material configuration: the u8 combined
  PACKED atlas (256 lanes), a procedural seamless env cube built here, and
  the four kernel flags on, which adds K6 (HZB tail), K7 (env select), K8
  (material select) and K9 (block-index copy);
* masked  -- the reference's own ``RenderSettings()`` (alpha-masked models
  on, per-slot material taps) on its masked scene (every 4th model a MASK
  material; per-map quad atlas), with the Renderer's ``masked_tri_cap``:
  K1, K2, K4 and K5 over the whole table (compaction is off with masked
  models) and the masked raster in plain PyTorch (it has no kernel);

and a fourth through ``ops/probes.py``:

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
   the reference's raster tests at 256x256 for K1/K2, also at chunks the
   kernels take only after fitting -- K1 66 and 256, K2 512 --; random
   tables and parameters for K4 (block widths 4, 6, 8) and K6-K9 -- K6 at
   tops of every shape kind, three launches in a row and 10 replays of one
   CUDA graph, so a ticket counter left non-zero shows --,
   NaN/signed-zero/equal keys for K10, odd lengths, misaligned views and 1-8
   byte types for the K9/K11/K12 copy) and on the
   inputs captured from one full-size frame of the default and the packed
   path, with both versions timed (the kernel over 50 eager calls, in turns
   with its library call where it has one, and replayed from a CUDA graph; K1 and
   K2 get a line per launch with its level, its live (pixel, row) pairs
   and those its warp skip keeps, and both bounds below).
   The masked path's K1, K2, K4 and K5 calls, captured from one of its
   full-size frames (the camera raster over the whole table), are held
   bit-equal too, untimed.
   Then the launch path: every kernel wrapper's host microseconds per call
   on a tiny input (``launch_us``: 2 x 3 runs of 1000 calls, no
   synchronisation inside a run) beside ``clone`` of the same input, taken
   in turns.
4. cross   -- 256x256 frames (24 objects, 512^2 shadow map) rendered with the
   kernels on the card and with the plain versions on the CPU: depth,
   tri_id and object_id (uint32) bit-equal, color within 1e-3; the default
   path, the packed path under the trilinear and the anisotropic filter,
   and the masked path (24 objects, per-slot masked scene) at
   ``masked_tri_cap`` 0, -1 and the Renderer's value, each with more than
   50 pixels won by masked models.
5. slice   -- per path, 10 carried frames at 1920x1080 over the
   263,184-triangle synthetic scene with a 4096^2 shadow map, on a slow
   orbit, with the launch counts set to 0 just before and read just after:
   every kernel of the path launched, all drop counters 0, finite color;
   then 3 timed runs of 10 frames.  The packed configuration is also timed
   with the four flags off (the reference's XLA-equivalent branches).  The
   masked path also logs the pixels won by masked models, the masked
   raster's stage ms and its alpha tap's ms (CUDA events), the (pixel,
   candidate) pairs of each masked level, and
   the pairs and triangles the masked levels drop past their bin budgets,
   which the reference does not count (logged, not gated).
6. probes  -- the probe rows once with the launch counts set to 0 just
   before and read just after (K10, K11 and K12 each launched); every
   output equal to the same rows with the plain versions; each kernel
   call bit-equal to its plain version; kernel, plain and library times
   per kernel and each row's time with and without its kernel.

Every kernel's bound is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations over the f32
peak of 67 TFLOP/s (H100 SXM data sheet, 700 W), from the inputs of this
run.  A raster's operations are its warp skip's corner tests and the edge
tests of the (pixel, row) pairs that the skip keeps; K1 and K2 also log
and report the bound that counts every (pixel, valid row) pair
(``bound_all_pairs_ms``, the count before the kernels skipped rows).

The last three lines of stdout are the kernels JSON, the card's
``nvidia-smi`` name/power-limit line, and the result JSON.  The script needs
one CUDA card and imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from unclerenderer_tpu_torch.timing import (  # noqa: E402 (the package next to this script)
    cuda_ms,
    graph_ms,
    in_turns,
    nvidia_smi,
)

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
# three edge functions, each a multiply, an FMA (2 operations) and an add:
# a warp's corner test of a row, and a (pixel, row) pair evaluated in full
EDGE_OPS = 12
# a (pixel, row) pair that the warp skip keeps: three FMAs and adds, plus
# the three b*qy multiplies that a thread makes once for its kPix pixels
PIXEL_EDGE_OPS = 9


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok, msg: str) -> None:
    """A failed check ends the run (not an assert: those vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


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
# needs.  A raster's operations are one corner test (EDGE_OPS) per (warp
# rectangle, valid row) pair and the edge tests of the (pixel, row) pairs
# that its warp skip keeps; it also returns the live (pixel, valid row)
# pairs of the blocks or chunks the tiles visit, and the kept ones.


def skip_work(name, args):
    """(operations, kept (pixel, row) pairs) of one K1/K2 call under its
    warp skip (``sweeps.raster.warp_rows``: the kernels' rule)."""
    from unclerenderer_tpu_torch.sweeps.raster import BINNED_PIX, GIANT_PIX, warp_rows

    tested, _, kept = warp_rows(name, args)
    pix = BINNED_PIX if name == "binned_raster" else GIANT_PIX
    return EDGE_OPS * tested + PIXEL_EDGE_OPS * kept + 3 * kept // pix, kept


def work_binned(coef, tri_id, valid, start, count, tile_h, tile_w, n_tx, y_offset=0.0,
                want_ids=True, ortho=False):
    pix, chunk = tile_h * tile_w, coef.shape[-1]
    per_block = (valid[:, 0] > 0).sum(-1)
    csum = torch.cat([per_block.new_zeros(1), torch.cumsum(per_block, 0)])
    s, c = start.long(), count.long()
    slots = int((csum[s + c] - csum[s]).sum())
    moved = (int(c.sum()) * chunk * 4 * (16 + 1 + int(want_ids)) + nbytes(start, count)
             + start.shape[0] * pix * 4 * (1 + int(want_ids)))
    ops, kept = skip_work("binned_raster", (coef, tri_id, valid, start, count, tile_h, tile_w,
                                            n_tx, y_offset))
    return moved, ops, pix * slots, kept


def work_giant(coef, valid, overlap, ids, tile_h, tile_w, n_tx, y_offset=0.0, want_ids=True,
               ortho=False):
    pix, chunk = tile_h * tile_w, coef.shape[-1]
    live = overlap != 0
    per_chunk = (valid > 0).sum(-1)
    slots = int((live.long() * per_chunk[None, :]).sum())
    chunks = int(live.any(0).sum())
    moved = (chunks * chunk * 4 * 17 + nbytes(overlap) + (nbytes(ids) if want_ids else 0)
             + overlap.shape[0] * pix * 4 * (1 + int(want_ids)))
    ops, kept = skip_work("giant_raster", (coef, valid, overlap, ids, tile_h, tile_w, n_tx,
                                           y_offset))
    return moved, ops, pix * slots, kept


def work_gather_rows(table, idx):
    n, c = idx.numel(), table.shape[1]
    return distinct(idx) * c * table.element_size() + nbytes(idx) + n * c * 4, 0


def work_hzb_tail(top, dims):
    return nbytes(top) + 4 * sum(w * h for w, h in dims), 0


def work_env_select(env, rows, params9):
    # the two taps' 2x2 footprints: 8 groups of 4 channels per request
    n = rows.shape[0]
    return distinct(rows) * 32 * env.element_size() + nbytes(rows, params9) + n * 16, 0


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


def renderer_masked_cap(data) -> int:
    """The Renderer's ``masked_tri_cap``: the scene's masked triangle count
    rounded up to 64 (reference ``render/renderer.py:390-394``)."""
    return -(-int(((data.alpha_mode == 1)[data.tri_model]).sum()) // 64) * 64


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


def tiny_inputs(dev):
    """A tiny valid call of every kernel wrapper: name -> (args, kwargs)."""
    from unclerenderer_tpu_torch.ops import hzb as hzb_mod
    from unclerenderer_tpu_torch.ops import raster_kernels as rk
    from unclerenderer_tpu_torch.ops.binning import bin_triangles
    from unclerenderer_tpu_torch.ops.shadow import pcf_deltas

    s = random_setup(16, 0, 0.1, dev, w=64, h=16)
    bins = bin_triangles(s, 64, 16, 16, 64, 32)
    start, count = rk.tile_block_ranges(bins, 1)
    with Recorder(rk, "giant_raster") as r:
        rk.rasterize_giant(s, 64, 16, tile_h=16, tile_w=64, chunk=8)
    layout, _ = hzb_mod.hzb_layout(2, 2)
    rng = np.random.default_rng(0)
    i32 = torch.from_numpy(rng.integers(0, 4, (4, 4)).astype(np.int32)).to(dev)
    f32 = torch.from_numpy(rng.random((9, 4), np.float32)).to(dev)
    return {
        "binned_raster": ((bins.coef, bins.tri_id, bins.valid, start, count, 16, 64, 1), {}),
        "giant_raster": r.calls[0],
        "shadow_select9": ((torch.zeros((16, 128), dtype=torch.int16, device=dev), i32[0],
                            i32[1], pcf_deltas(8)), {}),
        "gather_rows": ((f32[:4, :2].contiguous().to(torch.bfloat16), i32[0]), {}),
        "hzb_tail": ((f32[:4].contiguous(), [(w, h) for _o, w, h in layout]), {}),
        "env_select": ((torch.zeros((4, 128), device=dev), i32[0], f32), {}),
        "mat_select": ((torch.zeros((4, 256), dtype=torch.uint8, device=dev), i32[0],
                        f32[:7].contiguous()), {}),
        "materialize_rows": ((i32,), {}),
        "merge_select": ((i32[0], i32[1], f32[0], f32[1]), {}),
        "copy_rows": ((i32,), {}),
        "materialize": ((i32,), {}),
    }


def launch_costs(kernels, dev):
    """Host us per call of every kernel wrapper on a tiny input, beside
    ``clone`` of its first input, taken in turns."""
    out = {}
    for name, (args, kw) in tiny_inputs(dev).items():
        k = kernels[name]
        wrapper = getattr(k["module"], k["attr"])
        first = next(a for a in args if isinstance(a, torch.Tensor))
        us, clone_us = in_turns(lambda: wrapper(*args, **kw), first.clone)
        k["launch_us"], k["clone_launch_us"] = us, clone_us
        out[name] = {"us": us, "clone_us": clone_us}
        log("launch", f"{name}: {us:.2f} us per call, clone of its first input "
                      f"{tuple(first.shape)} {clone_us:.2f} us (host clock, 2 x 3 x 1000 "
                      "calls each, in turns)")
    return out


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
    from unclerenderer_tpu_torch.ops.raster import normalize_ortho_setup
    from unclerenderer_tpu_torch.render import common as common_mod
    from unclerenderer_tpu_torch.render.deferred import deferred_frame
    from unclerenderer_tpu_torch.render.params import FrameState, RenderSettings
    from unclerenderer_tpu_torch.render.testing import (
        synthetic_device_scene,
        synthetic_frame_params,
    )
    from unclerenderer_tpu_torch.sweeps.select import work_mat_select, work_select9

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
                 library_graph_ms=0.0, bytes_s=0.0, ops_s=0.0, all_pairs_ops_s=0.0, calls=[],
                 launch_us=None, clone_launch_us=None)
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
    modes = [(True, False), (True, True), (False, False), (False, True)]  # (want_ids, ortho)
    for seed, n, size in [(0, 150, 0.04), (2, 60, 0.2), (3, 40, 0.6), (5, 2000, 0.04)]:
        persp = random_setup(n, seed, size, dev)
        for want_ids, ortho in modes:
            s = normalize_ortho_setup(persp) if ortho else persp
            # the frame's two levels, then tiles of partial warp rectangles, one smaller
            # than a rectangle, and widths of no whole 16-byte store
            for tile, chunk in (((16, 64), 64), ((32, 128), 32), ((24, 36), 16), ((6, 10), 4),
                                ((16, 64), 66), ((16, 64), 256)):
                n_tx = -(-256 // tile[1])
                bins = bin_triangles(s, 256, 256, *tile, chunk)
                start, count = rk.tile_block_ranges(bins, n_tx * -(-256 // tile[0]))
                a = (bins.coef, bins.tri_id, bins.valid, start, count, *tile, n_tx,
                     0.0, want_ids, ortho)
                bad, err = compare(rk.binned_raster(*a), rk.binned_raster_ref(*a))
                check(bad == 0, f"binned_raster != plain on random setup {seed}: {bad}")
                kernels["binned_raster"]["err"] = max(kernels["binned_raster"]["err"], err)
            for gtile, gchunk in (((16, 64), 8), ((32, 256), 8), ((64, 512), 8), ((24, 36), 8),
                                  ((6, 20), 8), ((32, 256), 512)):
                with Recorder(rk, "giant_raster") as r:
                    rk.rasterize_giant(s, 256, 256, tile_h=gtile[0], tile_w=gtile[1],
                                       chunk=gchunk, want_ids=want_ids, ortho=ortho)
                ga, gk = r.calls[0]
                bad, err = compare(rk.giant_raster(*ga, **gk), rk.giant_raster_ref(*ga, **gk))
                check(bad == 0, f"giant_raster != plain on random setup {seed}: {bad}")
                kernels["giant_raster"]["err"] = max(kernels["giant_raster"]["err"], err)
    log("kernels", "binned_raster and giant_raster bit-equal to plain on the 256^2 random setups "
                   "(ids and depth-only, perspective and ortho, the frame's tile sizes and "
                   "24x36, 6x10 / 6x20 tiles; K1 chunks 66 and 256, K2 chunk 512)")

    # ---- 3a. K6-K9 vs plain on random inputs
    rng = np.random.default_rng(0)
    for h, w in ((270, 480), (67, 31), (3, 2), (1, 1), (1, 7), (3, 1), (135, 240), (541, 961),
                 (1080, 1920)):
        top = torch.from_numpy(rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)).to(dev)
        layout, _ = hzb_mod.hzb_layout(max(1, w // 2), max(1, h // 2))
        dims = [(lw, lh) for _o, lw, lh in layout]
        versus_plain("hzb_tail", top, dims)
        if (h, w) not in ((270, 480), (541, 961)):
            continue
        # the ticket counter is back at 0 after each launch: in a row, and
        # replayed from one CUDA graph (on new tops)
        want = hzb_mod.hzb_tail_ref(top, dims)
        for _ in range(3):
            check(torch.equal(hzb_mod.hzb_tail(top, dims), want), "hzb_tail != plain in a row")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = hzb_mod.hzb_tail(top, dims)
        for k in range(10):
            top.copy_(torch.roll(top, k + 1, dims=0))
            graph.replay()
            torch.cuda.synchronize()
            check(torch.equal(replayed, hzb_mod.hzb_tail_ref(top, dims)),
                  f"hzb_tail != plain at graph replay {k} of a {h}x{w} top")
        del graph
    env = torch.from_numpy(rng.uniform(0.0, 4.0, (4096, 128)).astype(np.float32)).to(dev)
    n = 100_000
    rows = torch.from_numpy(rng.integers(0, 4096, n).astype(np.int32)).to(dev)
    params9 = torch.from_numpy(np.concatenate([
        rng.random((5, n)), rng.integers(0, 2, (2, n)), rng.integers(-1, 3, (2, n)),
    ]).astype(np.float32)).to(dev)
    for table in (env, env.to(torch.bfloat16)):
        versus_plain("env_select", table, rows, params9)
    atlas = torch.from_numpy(rng.integers(0, 256, (8192, 256), dtype=np.uint8)).to(dev)
    for m in (n, n + 1, 33):  # even, odd and less than one block of pixels
        params7 = torch.from_numpy(np.concatenate([
            rng.random((5, m)), rng.integers(0, 2, (2, m))]).astype(np.float32)).to(dev)
        rows = torch.from_numpy(rng.integers(0, 8192, m).astype(np.int32)).to(dev)
        rows[-1] = 8191  # the atlas's last row
        for table in (atlas, atlas.float() / 255.0, (atlas.float() / 255.0).to(torch.bfloat16)):
            versus_plain("mat_select", table, rows, params7)
    ids = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, 7936 * 64 + 1,
                                        dtype=np.int64).astype(np.int32)).to(dev)
    for x in (ids[:-1].reshape(7936, 64), ids[1:1002], ids[:37 * 5].reshape(37, 5)):
        versus_plain("materialize_rows", x)  # aligned, misaligned by 4 B, odd length
    # K4 at block widths 4, 6 and 8; receivers not a multiple of a block or of 4
    table = torch.from_numpy(rng.integers(0, 65536, (4096, 128)).astype(np.uint16)
                             .view(np.int16)).to(dev)
    for bw in (4, 6, 8):
        deltas = shadow_mod.pcf_deltas(bw)
        for m in (100_003, 257, 31):
            row = torch.from_numpy(rng.integers(0, 4096, m).astype(np.int32)).to(dev)
            base = torch.from_numpy(rng.integers(0, 128 - deltas[-1], m).astype(np.int32)).to(dev)
            row[-1], base[-1] = 4095, 127 - deltas[-1]  # the table's last lane
            versus_plain("shadow_select9", table, row, base, deltas)
    log("kernels", "hzb_tail, env_select, mat_select, materialize_rows and shadow_select9 "
                   "bit-equal to plain on random inputs (hzb_tail: tops 1x1 to 1080x1920, sides "
                   "of 1, 3 launches in a row and 10 graph replays; mat_select: u8, f32 and bf16 "
                   "atlases at "
                   "even, odd and sub-block pixel counts; shadow_select9: block widths 4, 6, 8 at "
                   "receiver counts that are no multiple of a block or of 4)")

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
    big = torch.from_numpy(rng.integers(0, 256, 24 * 2**20 + 13, dtype=np.uint8)).to(dev)
    for off in (0, 1, 2, 4, 8):  # 16-, 1-, 2-, 4- and 8-byte words over many grid strides
        versus_plain("copy_rows", big[off:].reshape(1, -1))
        versus_plain("materialize", big[off:])
    log("kernels", "merge_select (NaN, signed-zero and equal keys), copy_rows and materialize "
                   "(1-8 byte types, aligned, misaligned, odd, 24 MB at five offsets) bit-equal "
                   "to plain on random inputs")

    # ---- 3a. K5 vs plain on random inputs
    table = torch.from_numpy(rng.standard_normal((8192, 5)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 8192, 263_187).astype(np.int32)).to(dev)
    for rows in (342, 8192):  # the frame's table; one past 48 KB (C > 2, or f32 and C > 1)
        for c in (1, 2, 3, 4, 5):  # vector variants (C <= 4), one row a thread (C = 5)
            for dtype in (torch.float32, torch.bfloat16):
                t = table[:rows, :c].to(dtype).contiguous()
                for i in (idx % rows, (idx % rows)[1:], (idx % rows)[:1001]):
                    versus_plain("gather_rows", t, i)  # ragged, misaligned view, odd
    log("kernels", "gather_rows bit-equal to plain on random inputs (f32 and bf16 tables of "
                   "342 and 8192 rows, C = 1-5, ragged, misaligned and odd index arrays)")

    # ---- 3c. the launch path: host us per call of every wrapper
    report["launch"] = launch_costs(kernels, dev)

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
    def measure(name, ca, ck, label=None):
        """One captured call: kernel vs plain bit-equal; kernel, plain and
        library times; the call's bound."""
        k = kernels[name]
        wrapper = getattr(k["module"], k["attr"])
        bad, err = compare(wrapper(*ca, **ck), k["ref"](*ca, **ck))
        shapes = [tuple(x.shape) for x in ca if isinstance(x, torch.Tensor)]
        check(bad == 0, f"{name} != plain at path shapes {shapes}: {bad} elements")
        plain_ms = cuda_ms(lambda: k["ref"](*ca, **ck), reps=1)
        if k["library"] is not None:  # in turns: kernel, library, library, kernel
            ms, lib_ms = in_turns(lambda: wrapper(*ca, **ck), lambda: k["library"](*ca, **ck),
                                  lambda fn: cuda_ms(fn, reps=50))
        else:
            ms, lib_ms = cuda_ms(lambda: wrapper(*ca, **ck), reps=50), None
        # the same calls replayed from a CUDA graph: the device's share alone
        dev_ms = graph_ms(lambda: wrapper(*ca, **ck), reps=10)
        lib_dev_ms = (graph_ms(lambda: k["library"](*ca, **ck), reps=10)
                      if k["library"] is not None else None)
        moved, ops, *pairs = k["work"](*ca, **ck)  # pairs: a raster's live and kept pairs
        bytes_s, ops_s = moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        # a raster's bound that counts every live (pixel, row) pair in full
        all_pairs_ops_s = EDGE_OPS * pairs[0] / F32_OPS_PER_S if pairs else 0.0
        all_pairs_ms = 1e3 * max(bytes_s, all_pairs_ops_s) if pairs else None
        k["err"] = max(k["err"], err)
        k["ms"] += ms
        k["plain_ms"] += plain_ms
        k["library_ms"] += lib_ms or 0.0
        k["bytes_s"] += bytes_s
        k["ops_s"] += ops_s
        k["all_pairs_ops_s"] += all_pairs_ops_s
        k["graph_ms"] += dev_ms
        k["library_graph_ms"] += lib_dev_ms or 0.0
        k["calls"].append({"shapes": shapes, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                           "graph_ms": dev_ms, "library_graph_ms": lib_dev_ms,
                           "bytes": moved, "ops": ops, "bound_ms": 1e3 * max(bytes_s, ops_s),
                           "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                           "launch": label, "pairs": pairs[0] if pairs else None,
                           "kept_pairs": pairs[1] if pairs else None,
                           "bound_all_pairs_ms": all_pairs_ms})
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms (graph {lib_dev_ms:.4f})"
        log("kernels", f"{name} {shapes}: bit-equal, kernel {ms:.4f} ms (graph {dev_ms:.4f}), "
                       f"plain {plain_ms:.3f} ms, library {lib}, bound "
                       f"{1e3 * max(bytes_s, ops_s):.4f} ms ({moved} B, {ops} ops)")
        if label is not None:  # a raster launch: its level and live pairs
            binned = name == "binned_raster"
            th, tw = ca[5:7] if binned else ca[4:6]
            n_tiles = ca[3 if binned else 2].shape[0]
            log("raster", f"{name} {label}: coefficients {shapes[0]}, {n_tiles} tiles of "
                          f"{th}x{tw}, {pairs[0]} live (pixel, row) pairs, {pairs[1]} kept by the "
                          f"warp skip; eager {ms:.4f} ms, graph {dev_ms:.4f} ms, bound "
                          f"{1e3 * max(bytes_s, ops_s):.4f} ms "
                          f"({'B' if bytes_s >= ops_s else 'O'}; every pair in full: "
                          f"{all_pairs_ms:.4f} ms) (on {smi})")

    def recorded(names, frame_scene, frame_params, frame_settings):
        """The calls of kernels ``names`` in one full-size frame: name ->
        [(args, kwargs)]."""
        with contextlib.ExitStack() as stack:
            recs = [stack.enter_context(Recorder(kernels[n]["module"], kernels[n]["attr"]))
                    for n in names]
            deferred_frame(frame_scene, frame_params,
                           FrameState.initial(WIDTH, HEIGHT, dev), frame_settings)
            torch.cuda.synchronize()
        for name, r in zip(names, recs):
            check(r.calls, f"{name}: the frame made no call")
        return {name: r.calls for name, r in zip(names, recs)}

    def capture(names, frame_scene, frame_params, frame_settings):
        for name, calls in recorded(names, frame_scene, frame_params, frame_settings).items():
            seen = {}
            for ca, ck in calls:
                label = None
                if name in ("binned_raster", "giant_raster"):  # shadow first, fine before mid
                    view = "camera" if ca[-2] else "shadow"
                    level = "giant" if name == "giant_raster" else ("fine", "mid")[seen.get(view, 0)]
                    seen[view] = seen.get(view, 0) + 1
                    label = f"{view} {level}"
                measure(name, ca, ck, label)

    capture(default_kernels, scene, params[0], settings)
    capture(packed_kernels, packed, packed_params[0], packed_settings)

    # ---- 4. cross-device frames: kernels on the card vs plain versions on the CPU
    small = RenderSettings(width=256, height=256, shadow_map_size=512,
                           has_masked_models=False, combined_material=True)

    def masked_pixels(frame_scene, tri_id):
        """Pixels whose winning triangle is a masked model's."""
        am = frame_scene.alpha_mode[frame_scene.tri_model.long()] == 1
        return int(((tri_id >= 0) & am[tri_id.clamp(min=0).long()]).sum())

    def cross(label, sc_cpu, sdata, frame_settings, mips=None, masked_min=None):
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
            check(out_g["object_id"].dtype == out_c["object_id"].dtype == torch.uint32,
                  f"object_id is {out_g['object_id'].dtype}, the reference's is uint32")
            for key in ("depth", "tri_id", "object_id"):
                bad = int((out_g[key].cpu() != out_c[key]).sum())
                check(bad == 0, f"cross-device {label} frame {i}: {key} differs at {bad} pixels")
            for key, v in out_c["raster_stats"].items():
                check(int(out_g["raster_stats"][key]) == int(v),
                      f"cross-device {label} frame {i}: {key} differs")
            cdiff = float((out_g["color"].cpu() - out_c["color"]).abs().max())
            hdiff = float((out_g["hdr"].cpu() - out_c["hdr"]).abs().max())
            check(cdiff <= COLOR_ATOL, f"cross-device {label} frame {i}: color differs by {cdiff}")
            won = ""
            if masked_min is not None:
                n_won = masked_pixels(sc_gpu, out_g["tri_id"])
                check(n_won > masked_min, f"cross-device {label} frame {i}: only {n_won} pixels "
                                          "won by masked models")
                won = f", {n_won} won by masked models"
            log("cross", f"{label} frame {i}: depth/tri_id/object_id (uint32) bit-equal, "
                         f"|color| {cdiff:.2e}, |hdr| {hdiff:.2e}, "
                         f"{int((out_g['tri_id'] >= 0).sum())} covered pixels{won}")
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
    # the masked path: the reference's RenderSettings() on the per-slot
    # masked scene, exhaustive, binned over the table and compacted
    sc_cpu, sdata = synthetic_device_scene(24, with_masked=True, device="cpu")
    for cap in (0, -1, renderer_masked_cap(sdata)):
        report[f"cross_color_max_abs_masked_cap{cap}"] = cross(
            f"masked cap {cap}", sc_cpu, sdata,
            RenderSettings(width=256, height=256, shadow_map_size=512, masked_tri_cap=cap),
            masked_min=50)
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
        frames = len(frame_params)
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state = run(frame_scene, frame_params, frame_settings, state)
            torch.cuda.synchronize()
            per_frame.append((time.perf_counter() - t0) * 1000.0 / frames)
        med = statistics.median(per_frame)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        log(label, f"ms/frame median {med:.2f} min {min(per_frame):.2f} max {max(per_frame):.2f} "
                   f"(3 runs x {frames} frames, {WIDTH}x{HEIGHT}, shadow {SHADOW}^2, {n_tris} tris) "
                   f"peak {peak_gb:.1f} GiB on {smi}")
        return {"ms_per_frame": per_frame, "median_ms": med, "peak_gib": peak_gb}

    def masked_stage(frame_scene, frame_params, frame_settings):
        """One masked frame with CUDA events around the masked raster and
        around each alpha tap; the pair counts and drops of each masked
        level."""
        stage, taps = [], []  # (start, end, output, rows of the 4th argument: a tap's uv)

        def timed_call(fn, into):
            def call(*a, **kw):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **kw)
                e1.record()
                into.append((e0, e1, out, a[3].shape[0]))
                return out
            return call

        with patched(common_mod, "raster_masked_combine",
                     timed_call(functools.partial(common_mod.raster_masked_combine, stats=True),
                                stage)), \
                patched(common_mod, "_alpha_tap", timed_call(common_mod._alpha_tap, taps)):
            deferred_frame(frame_scene, frame_params, FrameState.initial(WIDTH, HEIGHT, dev),
                           frame_settings)
            torch.cuda.synchronize()
        stage_ms = sum(e0.elapsed_time(e1) for e0, e1, _, _ in stage)
        tap_ms = sum(e0.elapsed_time(e1) for e0, e1, _, _ in taps)
        tap_pairs = sum(n for _, _, _, n in taps)
        levels = [{k: int(v) for k, v in c.items()} for _, _, out, _ in stage for c in out[2]]
        for k, lv in enumerate(levels):
            log("masked", f"level {k + 1}: {lv['blocks']} live blocks, {lv['pairs']} (pixel, slot) "
                          f"pairs, {lv['candidates']} within a pixel of their triangle's bbox, "
                          f"{lv['covered']} covered and in depth range (alpha-tapped); dropped, "
                          f"not counted by the reference: {lv.get('bin_overflow', 0)} pairs past "
                          f"the bin budget" + (f", {lv['big_dropped']} triangles too big for "
                                               "level 2" if k == 1 else ""))
        log("masked", f"masked raster {stage_ms:.2f} ms of one frame, of which the alpha taps "
                      f"{tap_ms:.2f} ms for {tap_pairs} (pixel, candidate) pairs "
                      f"({1e6 * tap_ms / max(tap_pairs, 1):.3f} ns a pair; CUDA events, on {smi})")
        return {"masked_raster_ms": stage_ms, "alpha_tap_ms": tap_ms, "alpha_tap_pairs": tap_pairs,
                "levels": levels}

    def counted(label, names, frame_scene, frame_params, frame_settings, extra=None):
        """The main-path run of one path: counts set to 0 just before its
        frames and read just after; then the gates (``extra(last output)``
        adds its own and returns what it measured) and 3 timed runs."""
        state = FrameState.initial(WIDTH, HEIGHT, dev)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        outs, state = run(frame_scene, frame_params, frame_settings, state)
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
        log(label, f"launches in {len(frame_params)} frames: {launches}")
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
        more = extra(outs[-1]) if extra is not None else {}
        del outs
        return {"launches": launches, "drops": drops, **more,
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
    del packed

    # ---- 5. the masked path: the reference's RenderSettings() on its masked scene
    t0 = time.perf_counter()
    m_scene, m_data = synthetic_device_scene(N_OBJECTS, sphere_res=SPHERE_RES, ground=True,
                                             with_masked=True, device=dev)
    m_settings = RenderSettings(width=WIDTH, height=HEIGHT, shadow_map_size=SHADOW,
                                masked_tri_cap=renderer_masked_cap(m_data))
    m_params = params  # the same geometry, so the same orbit
    log("masked", f"scene: {m_data.num_models} models ({int((m_data.alpha_mode == 1).sum())} "
                  f"masked, {int(((m_data.alpha_mode == 1)[m_data.tri_model]).sum())} masked "
                  f"triangles), per-slot atlas {tuple(m_scene.quad_img.shape)} "
                  f"{m_scene.quad_img.dtype}, masked_tri_cap {m_settings.masked_tri_cap}, built in "
                  f"{time.perf_counter() - t0:.1f} s")

    # ---- 3b. the masked path's K1/K2/K4/K5 calls vs plain at its shapes
    # (bit-equal only: the kernels line keeps the default path's calls)
    m_calls = recorded(default_kernels, m_scene, m_params[0], m_settings)
    for name, calls in m_calls.items():
        for ca, ck in calls:
            versus_plain(name, *ca, **ck)
    shapes = {name: [tuple(next(x for x in ca if torch.is_tensor(x)).shape) for ca, _ in calls]
              for name, calls in m_calls.items()}
    log("kernels", f"masked 1080p frame: every call bit-equal to plain (first input of each "
                   f"call: {shapes})")
    del m_calls

    def masked_checks(out):
        n_won = masked_pixels(m_scene, out["tri_id"])
        check(n_won > 0, "masked: no pixel won by a masked model")
        log("masked", f"{n_won} pixels won by masked models")
        return {"masked_pixels": n_won, **masked_stage(m_scene, m_params[0], m_settings)}

    report["masked"] = counted("masked", default_kernels, m_scene, m_params, m_settings,
                               extra=masked_checks)
    del m_scene

    report["kernels"] = {n: {"calls": k["calls"], "ms": k["ms"], "plain_ms": k["plain_ms"],
                             "graph_ms": k["graph_ms"], "library_ms": k["library_ms"],
                             "library_graph_ms": k["library_graph_ms"],
                             "bound_ms": 1e3 * max(k["bytes_s"], k["ops_s"]),
                             "bound_all_pairs_ms": (1e3 * max(k["bytes_s"], k["all_pairs_ops_s"])
                                                    if k["all_pairs_ops_s"] else None),
                             "launch_us": k["launch_us"],
                             "clone_launch_us": k["clone_launch_us"]}
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
         "library_ms": k["library_ms"] if k["library"] is not None else None,
         "launch_us": k["launch_us"], "clone_launch_us": k["clone_launch_us"]}
        for n, k in kernels.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
