#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``unclerenderer_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root: ``python3 chip_smoke.py``.

Fourteen paths of the port are driven: five through ``deferred_frame``,

* default -- the default frame of the combined material (u8 combined quad
  atlas), which runs K1 (binned raster), K2/K3 (giant raster), K4 (PCF
  select) and K5 (draw-mask gather);
* packed  -- the packed-trilinear material configuration: the u8 combined
  PACKED atlas (256 lanes), a procedural seamless env cube built here, and
  the four kernel flags on, which adds K6 (HZB tail), K7 (env select) and K9
  (block-index copy); its resolve runs R1, T1 and T2 (``interp_attrs``,
  ``tap_footprint``, ``material_tap``, ``csrc/material_tap.cu``: not TPU
  kernels, the reference's element-wise attribute interpolation and
  quad-LOD tap), and K8 (material select) the plain tap's decode, captured
  from the frame with the plain tap forced;
* masked  -- the reference's own ``RenderSettings()`` (alpha-masked models
  on, per-slot material taps) on its masked scene (every 4th model a MASK
  material; per-map quad atlas), with the Renderer's ``masked_tri_cap``:
  K1, K2, K4 and K5 over the whole table (compaction is off with masked
  models) and the masked raster's two levels by M1 (``masked_raster``,
  ``csrc/masked_raster.cu``: not a TPU kernel, the reference's XLA masked
  raster);
* fused   -- the default path with ``fused_resolve="on"``: the camera
  raster's K1 and K2 launches emit each pixel's resolve record
  (``binned_raster_attrs``, ``giant_raster_attrs``), which the resolve takes
  in place of its record gather; the shadow map's K1/K2, K4 and K5 as on
  the default path;
* sampling -- the default geometry under the non-default sampling and
  storage settings together (``lod_derivatives="forward"``,
  ``soa_vertex=False``, ``shadow_table_u16=False``): forward-difference
  LOD, the AoS vertex stage and the f32 PCF table, which K4 reads through
  its f32 entry (``shadow_select9_f32``), with K1, K2 and K5;

one through ``ops/probes.py``, and one through the entry points a
user calls, ``render/renderer.py Renderer`` and ``python -m
unclerenderer_tpu_torch``:

* probes  -- the rows of the reference's TPU measurement probes that hold
  its last three kernels, at the probes' 1080p shapes: a (tc, 128) record
  gather fed by K10 (merge select) or by K12 (identity copy) of a merged
  (1080, 1920) id image, a packed-atlas row gather whose rows K11 (row
  copy) copies before a bilinear blend, and the camera and shadow binning
  whose block index array K12 copies before the coefficient gather;
* renderer -- the headline's geometry written as scene files
  (``render/testing.py write_scene``: scene JSON, glTF with a .bin buffer,
  six 256^2 PNG materials, an RGBA16F env cube and an RG16 BRDF LUT as
  DDS), loaded, decoded (``native/*.cpp`` built by ``textures/native.py``),
  fused into the u8 quad atlas and rendered by the Renderer at the default
  ``RendererConfig`` (stats overlay and TAA on): its cached shadow map and
  K1, K2, K4 and K5; then the same files rendered by the forward Renderer
  (``renderer_type="forward"``: ``render/forward.py forward_frame``).

and K1's debug print (``kernel_debug_print``: ``binned_raster_debug``) in a
child process, and observability on the Renderer's files.  Three more paths
run through the entry points of the last modules ported:

* cache    -- ``Renderer`` init cold and warm through the scene cache
  (``core/scenecache.py``) on the renderer cell's files;
* viewer   -- ``viewer.py run_viewer`` driven by scripted keys on the warm
  1080p Renderer: K1, K2, K4, K5;
* multichip -- ``parallel/multichip.py render_frame_multichip`` in ranks
  spawned as child processes, all on this card over gloo: K1, K2, K4, K5 on
  each rank's row slab (``y_offset``: the first row of the tile-aligned
  region around the slab), the shadow map's slabs all-gathered.

Four more paths are the JAX package's second backend, the masked frame as
a user renders it, the graft entry and the bench entry:

* xla      -- ``RenderSettings(raster_backend="xla")`` through the
  Renderer on the renderer cell's files: the exhaustive raster X1
  (``csrc/exhaustive_raster.cu``, not a TPU kernel: the reference's XLA
  ``rasterize``) for the shadow map and the camera, the per-texel f16 PCF
  table with one plain row gather a receiver, plain draw-mask gathers, and
  none of K1-K9 (M1 where masked models are on: the reference runs one
  masked raster under every backend);
* masked-program -- the headline geometry written with masked models and
  rendered by the Renderer at the default ``RendererConfig``: its masked
  frames captured and replayed as CUDA graphs (K1, K2, K4, K5 and M1);
* entry    -- the port's graft entry, ``unclerenderer_tpu_torch/
  graft_entry.py`` (the counterpart of ``__graft_entry__.py``): the
  128^2 frame of ``entry()`` captured by ``compile_check`` (K1, K2, K4,
  K5 and M1 in the graph) and ``dryrun_multichip(8)``, the row-sharded frame on
  ``raster_backend="xla"`` (X1 and M1 on every rank's slab);
* bench    -- the port's bench, ``python -m unclerenderer_tpu_torch.bench``
  (the counterpart of ``bench.py``), at the judged configuration: its two
  parity gates (X1 against K1/K2, the kernel path's frame against the xla
  frame), then the headline's chained frames as replays of one frame
  program that rasterizes the 4096^2 map in every frame (K1, K2, K4, K5)
  and its four secondary rows.

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
   path (R1 from its trilinear frame, T1 and T2 from its trilinear and
   anisotropic x4 frames with ``mat_select_kernel`` off, as the benchmark's
   cells run them), with both
   versions timed (the kernel over 50 eager calls, in turns
   with its library call where it has one, and replayed from a CUDA graph; K1 and
   K2 get a line per launch with its level, its live (pixel, row) pairs
   and those its warp skip keeps, and both bounds below).
   The masked path's K1, K2, K4 and K5 calls, captured from one of its
   full-size frames (the camera raster over the whole table), are held
   bit-equal too, untimed.
   K1 and K2 given records (the want_attrs branches) on the random setups
   at R = 1, 7 and 128 (K1 chunks 64, 66, 256, 512; K2 chunks 8, 66, 256,
   512): keys and ids those of the launch without records, records
   ``where(ids >= 0, records[ids], 0)``, bit-equal to the plain versions;
   the fused frame's three record-emitting launches timed as the others,
   and also without records and beside ``records.index_select(0, ids)`` on
   the same winner ids (their library call); the masked path's fused calls
   held bit-equal.
   M1 (``masked_raster``) on the special setups of ``render/testing.py
   masked_raster_setup`` -- coplanar ties, +0/-0 keys, slivers covering
   pixels past their boxes, alphas within ulps of the cutoff -- at 256^2,
   on quad (4-channel f32/bf16, 16-channel u8) and packed (u8, bf16, f32)
   atlases, binned and exhaustive, chunks 32-256, y_offset 0 and 48, both
   filters and misaligned tables, and on a dense setup (9,000 triangles
   at 64^2: every tile split, candidate lists that fill): key bits, ids,
   live blocks and covered pairs equal to the plain version's.
   The present's u8 conversion (``present_u8``, ``csrc/present_u8.cu``:
   not a TPU kernel, the reference converts on the host) on a random
   1080p colour with every level's half, its float32 neighbours, +-0,
   +-inf and NaN, aligned, misaligned and odd: equal to the plain version
   and to numpy's formula, and timed at 1920x1080x3 as the others.
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
   50 pixels won by masked models; every M1 call of the card's masked
   frames held bit-equal to the plain version.
5. slice   -- per path, 10 carried frames at 1920x1080 over the
   263,184-triangle synthetic scene with a 4096^2 shadow map, on a slow
   orbit, with the launch counts set to 0 just before and read just after:
   every kernel of the path launched, all drop counters 0, finite color;
   then 3 timed runs of 10 frames.  The packed configuration is also timed
   with the four flags off (the reference's XLA-equivalent branches).  The
   masked path also logs the pixels won by masked models, the masked
   raster's stage ms and M1's launches' ms (CUDA events), M1's counts of
   each masked level (live blocks, covered and alpha-tapped pairs), and
   the pairs and triangles the masked levels drop past their bin budgets,
   which the reference does not count (logged, not gated); its two M1
   calls (levels 1 and 2) are held bit-equal to the plain version and
   timed as the other kernels' (the kernels line's M1 calls), with each
   level's per-tile block counts (most, mean, tiles with none, tiles
   split), and the pairs that the plain version covers, the alpha taps the
   level needs and those M1 makes, in the level and in its busiest tile
   (``unclerenderer_tpu_torch/sweeps/masked.py level_counts``; the sweep
   times M1 against its form before the redesign).
   The fused path: one fused frame equal to the unfused frame from the same
   state (every output and the carried state bit-equal, colour exactly
   equal), on the default and the masked geometry; 10 counted fused frames
   with the gates above; then fused and unfused ms/frame in turns (3 runs of
   10 frames each) with each one's peak memory.
6. probes  -- the probe rows once with the launch counts set to 0 just
   before and read just after (K10, K11 and K12 each launched); every
   output equal to the same rows with the plain versions; each kernel
   call bit-equal to its plain version; kernel, plain and library times
   per kernel and each row's time with and without its kernel.

7. renderer -- the Renderer path: the scene written and loaded at
   1920x1080 with a 4096^2 shadow map (342 models, 263,184 triangles, the
   (768, 1024, 64) u8 atlas, no texture substituted, the native library
   built; init phases logged); 10 ``render_frame`` calls on a slow orbit
   with the launch counts set to 0 just before and read just after (K1,
   K2, K4, K5 launched; the first frame's and the cached frames' counts
   logged), then 10 frames of ``render_frames``: drop counters 0, models
   visible, finite colour, more than 30% covered; one ``render_to_u8``
   (one conversion on the card, bytes equal to numpy's conversion of the
   frame's colour); one Renderer frame held
   against ``deferred_frame`` called directly (the cached map bit-equal to
   the frame's own shadow raster; depth, ids, counters bit-equal, colour
   within 1e-3) and against the frame without the stats block (its text
   rows differ, nothing else); card and CPU Renderers at 256x256 from the
   same files, at the defaults and with the four kernel flags on the packed
   atlas (depth, ids, counters bit-equal, colour within 1e-3);
   Renderer ms/frame in turns with direct ``deferred_frame`` calls on the
   cached map and prebuilt params (host clock around
   ``torch.cuda.synchronize()``, 3 runs of 10 frames each) and peak memory;
   the CLI at 1080p, ``--frames 3`` (one ``capture:`` line, then the
   steady state over replays), ``--orbit 4`` and ``--renderer
   forward``, whose PNGs decode with the port's ``load_png``.  The forward
   Renderer on the same files at 1080p: 10 counted ``render_frame`` calls
   (K1, K2, K4, K5 launched), drop counters 0, more than 30% covered, colour
   in [0, 1], no frame state carried (also by ``render_frames``); ms/frame
   in turns with the deferred Renderer; card/CPU forward Renderers at
   256x256 with fused resolve off and on (depth, ids, counters bit-equal,
   colour within 1e-3).
8. sampling -- (run after the fused path, on its scene) every K1, K2, K4
   (f32 rows) and K5 call of one 1080p sampling frame bit-equal to its
   plain version, K4 on f32 rows timed for the kernels line (it is also
   held bit-equal, bit patterns, on random f32 tables at block widths 4-8
   in phase 3); 10 counted frames with the gates of phase 5; ms/frame and
   peak GiB in turns with the default configuration (3 pairs of 3 frames);
   the pass markers' ``record_function`` ranges a default frame, and
   ms/frame with them entered and untraced, in turns (no gate).  Phase 4
   adds 256x256 card/CPU pairs: each setting alone and all three, deferred,
   all three in the forward frame, and the anisotropic filter with
   compacted taps under forward differences (one frame each).
9. debug   -- (run after phase 4) a child process (``--k1-debug-child``:
   device printf writes to its fd 1) grows the printf FIFO, renders one
   256x256 deferred frame with ``kernel_debug_print``, and holds each debug
   launch to the plain version; the lines it printed equal the plain
   version's as a multiset, one per live block; the launches' ms with and
   without the flag.  Then a 256x256 Renderer with the flag: 3 frames
   replayed from the frame program, each printing the multiset of lines of
   the same frame op by op (from the same state), which is the plain
   version's -- each frame's live blocks, once.
10. observability -- (run after phase 7, on its files at 1080p) GpuTiming's
   "Frame" samples; ``profile_passes``' ten stages (ms > 0);
   ``profile_trace_passes`` of 2 frames (ShadowMap, VisibilityRaster and
   MaterialResolve > 0, every K1 row inside ShadowMap or VisibilityRaster;
   "(total)" logged beside the frames' CUDA-event time and the "(other)"
   share); GraphDump's op list naming every kernel its frame launched; the
   CLI with ``--trace DIR --profile-passes``.
11. cache  -- (on phase 7's files at 1080p, in a fresh
   ``UNCLERENDERER_SCENE_CACHE`` directory deleted afterwards; every other
   phase runs with the cache off) a cold ``Renderer`` init, then a warm
   one: their seconds and ``setup_phase_s``, ``scene_cache_hit`` False then
   True, every device array bit-equal, 3 carried frames from each with
   colour, depth, ids and counters bit-equal.
12. viewer -- ``run_viewer`` on the warm Renderer, its key reader replaced
   by a script and the terminal by a buffer: a move, a yaw, a slider nudge
   (tonemap exposure +0.2), a settings toggle (CAS), a screenshot and quit
   (4 frames, a 1080p PNG, the camera moved and turned); then 10 frames
   with no key, counted (K1, K2, K4, K5 launched) and timed: ms per viewer
   frame (the frame, its read-back, the overlays, the ANSI text).
13. multichip -- ranks spawned by ``run_ranks`` (the kernels are built
   already, so no rank builds them) on ``cuda:0`` over gloo, each counted
   over its frames: (a) the MULTICHIP_r05 contract, 8 ranks at 64x128 with
   a 128^2 map, every feature on (IBL, masked geometry, HZB, TAA, CAS,
   auto-exposure), 4 frames with camera motion; (b) 2 ranks at 1920x1080
   with the 4096^2 map on the headline geometry, 4 frames.  Each: tri_id,
   depth, ids, counters and HZB bit-equal to the single-device frames from
   the same states, colour within 1e-5 (seam rows logged on their own);
   every K1, K2, K4 and K5 call of one slab frame on a rank whose raster
   region starts below row 0 bit-equal to its plain version; (b) also ms/frame sharded and
   single-device in turns (3 runs of 4 frames; two ranks share one card, so
   this is no speed claim).
14. xla    -- (on phase 7's files) X1 bit-equal to its plain version on the
   256^2 random setups (ids on and off, perspective and ortho, both depth
   modes, y_offset 0 and 48, tiles 16x64, 32x128, 24x36), on the whole
   images of the headline tables -- the 1080p camera and the 4096^2 map --
   (timed as the other kernels, with their bound; the mask and tile
   kernels' device ms apart, by the profiler; the masks' bytes), and on
   64-row windows of them -- camera rows 512-575, map rows 2048-2111 --
   (each window also equal to the whole image's rows); the binned rasters
   (K1/K2, the kernel path) against X1 on the same setups, their differing
   depth and id pixels logged by class and gated at 0; the xla Renderer at
   1080p with the 4096^2 map: 10 counted ``render_frame`` calls (only X1
   launched, 11 times: the first frame also renders the cached map, and T1,
   the resolve's footprint of each slot tapped on either backend), drop
   counters 0, then 3 forward frames the same way; the PCF tables' bytes; ms/frame and peak GiB in turns with the
   default Renderer (3 runs of 10 frames each); card/CPU frames at 128^2,
   deferred (2 carried) and forward, depth, ids and counters bit-equal,
   colour within 1e-3, only X1, M1 and T1 launched.
15. program -- (on phase 7's files at 1080p with the 4096^2 map) the frame
   program (``render/program.py``: the frame captured into a CUDA graph and
   replayed): (a) one op-by-op deferred frame, one forward frame and one
   ``raster_shadow`` under ``torch.cuda.set_sync_debug_mode("error")``, no
   sync; (b) 10 carried deferred frames on the orbit replayed and again op
   by op (``program.eager``) from one start state, every output and every
   state field bit-equal; 3 forward frames the same way; ``render_frames(10)``
   against the 10 op-by-op frames; (c) the same launch counts over the 10
   frames; (d) recorded, not gated: ms/frame graph and op by op in turns
   (3 pairs of 10 frames), host ms a ``render_frame`` call, the profiler's
   device-busy share over 3 frames of each, capture seconds, graph pool
   GiB and peak GiB.
16. masked-program -- phase 15 on the headline geometry written with
   ``write_scene(..., masked=True)`` at 1080p with the 4096^2 map: the
   Renderers turn the masked raster on from the scene, and each replay
   launches M1 twice (levels 1 and 2; gated).

17. entry -- (after phase 13, on the built kernels) ``graft_entry.entry()``
   and ``compile_check``: the 128^2 frame op by op, then captured as one
   CUDA graph under ``torch.cuda.set_sync_debug_mode("error")`` and
   replayed, colour and every state field bit-equal to op by op, K1, K2,
   K4, K5 and M1 launched in the graph (counted from 0 over the check);
   every K1, K2, K4, K5 and M1 call of the check's first op-by-op frame
   held bit for bit to its plain version on the same inputs; capture
   seconds and pool MiB logged; ``dryrun_multichip(8)``: 8 ranks on
   ``cuda:0`` over gloo at 64x128 on ``raster_backend="xla"`` with IBL,
   HZB and masked models, 4 carried frames with camera motion against the
   single-device frame (tri_id bit-equal, colour within 1e-5 with the seam
   rows, exposure within 1e-4), every rank counted (X1 and M1 launched,
   none of K1-K9), and on rank 5 (``row0`` 80) every X1 and M1 call of
   those frames held bit for bit to its plain version at its
   ``y_offset``.  Each part's seconds logged.
18. bench -- (after phase 17, on the built kernels) first, in this
   process, frame 0 of the bench's ``shadow2048`` (2048^2 map) and
   ``sponza_faithful`` (``bin_mid_divisor=4``) rows op by op at 1920x1080
   on the bench's own inputs, every K1, K2, K4 and K5 call held bit for
   bit to its plain version; then ``python -m
   unclerenderer_tpu_torch.bench`` as a child process at its defaults
   (1920x1080, the 4096^2 map, 340 spheres and the ground: 263,184
   triangles, 10 frames a chain): exit 0, the last stdout line parses,
   ``value`` finite and > 0, ``triangles`` 263,184, ``pallas_parity`` and
   ``frame_parity`` true, the headline's drop counters 0, every row's
   ``*_ms`` finite (``shadow2048``, ``bilinear``, ``anisotropic``,
   ``sponza_faithful``) and no ``*_error`` key; from the child's stderr
   launch line, K1, K2, K4 and K5 launched in every timed headline replay,
   K1 and K2 at least twice (the map's raster as well as the camera's: the
   map is not cached) and X1 in the gates.  The headline is logged beside
   phase 15's replayed default Renderer ms/frame (a cached map), not
   gated.

The Renderer phases (7, 10-12, 14-16) run as users run the Renderer: on the
card its frames after the first of a (settings, scene) are replays of the
captured program, for every setting ``program.supported`` accepts; their
launch counts count each replay's kernels.

Every kernel's bound is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations over the f32
peak of 67 TFLOP/s (H100 SXM data sheet, 700 W), from the inputs of this
run.  A raster's operations are its warp skip's corner tests and the edge
tests of the (pixel, row) pairs that the skip keeps; K1 and K2 also log
and report the bound that counts every (pixel, valid row) pair
(``bound_all_pairs_ms``, the count before the kernels skipped rows).

The kernels JSON gives each kernel's ``launches`` on its path's counted run
(the record-emitting entries: the fused path's; ``shadow_select9_f32``: the
sampling path's; ``binned_raster_debug``: the debug child's frame, whose
``ms``, ``graph_ms`` and ``plain_ms`` are its launches' and
``no_debug_ms`` the same launches without the flag; ``exhaustive_raster``: the xla Renderer's, whose
``ms``, ``graph_ms``, ``plain_ms`` and ``bound_ms`` are the whole camera and
map images', and ``mask_ms``, ``tile_ms`` its two kernels' device ms in
them, ``mask_bytes`` their masks'),
``masked_raster`` (M1, ``"tpu_kernel": false``): the masked Renderer's
10 replayed frames of phase 16, its ``ms``/``graph_ms``/``plain_ms``/
``bound_ms`` the masked 1080p frame's two calls; ``renderer_launches`` on
the Renderer's, ``forward_renderer_launches`` on the forward Renderer's,
``viewer_launches`` on the viewer's 10 frames, ``multichip_launches``
on rank 1 of the 2-rank 1080p frames, ``entry_launches`` over phase 17's
compile check (two op-by-op frames and one replay),
``dryrun_launches`` summed over the 8 ranks of its dry run and
``bench_launches`` over phase 18's timed headline replays.  The last three lines of stdout
are the kernels JSON, the card's
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
import tempfile
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
# the sampling configuration: the non-default sampling and storage branches
SAMPLING = dict(lod_derivatives="forward", soa_vertex=False, shadow_table_u16=False)
DEBUG_FIFO = 64 << 20  # the debug child's device printf FIFO (grown before any launch)
REPLAY_FRAMES = 3  # the debug child's Renderer frames replayed, and again op by op
PASS_STAGES = {"GPU Culling", "ShadowMap", "VertexStage", "GBuffer(Visibility)", "Build HZB",
               "MaterialResolve", "Lighting", "TemporalAA", "Tonemap", "CAS"}
SUM_ATOL = 1e-5  # probe-row sums, kernel vs plain: the same adds over equal inputs
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
# three edge functions, each a multiply, an FMA (2 operations) and an add:
# a warp's corner test of a row, and a (pixel, row) pair evaluated in full
EDGE_OPS = 12
# a (pixel, row) pair that the warp skip keeps: three FMAs and adds, plus
# the three b*qy multiplies that a thread makes once for its kPix pixels
PIXEL_EDGE_OPS = 9
# M1: a covered (pixel, slot) pair's edge tests, its depth numerator and
# denominator (a multiply, an FMA and an add each) and their divide; a
# tapped pair's alpha test: three interpolations and divides (12), the LOD
# (a reciprocal, 4 FMAs, 8 multiplies, 2 FMAs, a max, a log2 and a multiply:
# 18), a trilinear tap's two bilinear blends and mip lerp (21 lerp
# operations and the texel coordinates, ~20) and the cutoff (3)
MASKED_PAIR_OPS = PIXEL_EDGE_OPS + 7
TAP_OPS = 74


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


def same_bits(a, b) -> bool:
    """Whether matching outputs hold the same bit patterns, signed zeros
    included (``compare`` counts -0 equal to +0); a NaN matches a NaN."""
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    for x, y in zip(as_tuple(a), as_tuple(b)):
        if x is None and y is None:
            continue
        if x.is_floating_point() or x.dtype == torch.uint32:
            ne = x.view(ints[x.element_size()]) != y.view(ints[y.element_size()])
            if x.is_floating_point():
                ne &= ~(torch.isnan(x) & torch.isnan(y))
            if bool(ne.any()):
                return False
        elif not torch.equal(x, y):
            return False
    return True


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
                want_ids=True, ortho=False, debug=False):
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


def records_work(records, ids):
    """Bytes of a record emission: the (tiles, pix, R) image written and the
    distinct winning rows read."""
    r_bytes = records.shape[1] * 4
    return ids.numel() * r_bytes + distinct(ids[ids >= 0]) * r_bytes


def work_binned_attrs(*args, records):
    """K1 with records: K1's own work plus the record emission of its ids."""
    from unclerenderer_tpu_torch.ops import raster_kernels as rk

    moved, ops, pairs, kept = work_binned(*args)
    return moved + records_work(records, rk.binned_raster(*args)[1]), ops, pairs, kept


def work_giant_attrs(*args, records):
    from unclerenderer_tpu_torch.ops import raster_kernels as rk

    moved, ops, pairs, kept = work_giant(*args)
    return moved + records_work(records, rk.giant_raster(*args)[1]), ops, pairs, kept


def index_select_records(wrapper, args, kwargs):
    """The library call of a record emission: ``records.index_select(0,
    ids)`` on the call's winner ids (found once, outside the timing; a miss
    takes row 0, which the kernel writes as zeros)."""
    ids = wrapper(*args)[1].clamp(min=0).reshape(-1)
    records = kwargs["records"]
    return lambda: torch.index_select(records, 0, ids)


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


def work_present(color):
    return nbytes(color) + color.numel(), color.numel()  # f32 in, u8 out; one product a value


# the material tap's f32 operations: T1 a pixel (the edges, the three quad
# corners' weights and uvs, four transforms, the axes and the level), T2 a
# trilinear tap (its coordinates at two mips, then per channel 8 decodes and
# 7 blends of 4 operations)
TAP_FOOTPRINT_OPS = 160
TAP_OPS = 32 + 16 * (8 + 7 * 4)
# R1 a pixel: three edges (3 coefficients of 2, then 3), the weights' sum,
# select and 3 divides, 16 lanes of 3
INTERP_ATTR_OPS = 3 * (3 * 2 + 3) + 6 + 16 * 3


def record_sectors(lanes) -> int:
    """The distinct 32-byte sectors of an f32 resolve record that ``lanes`` touch."""
    return len({4 * lane // 32 for lane in lanes})


def work_tap_footprint(full, uv, lanes, row0=0, max_aniso=0):
    """T1: the record sectors of the vertices, their uvs and the slot's
    transform and size; the centre uv; the planes written."""
    n = full.shape[0] * full.shape[1]
    lane_os, lane_rot, lane_rect = lanes
    read = [*range(9), *(19 + 16 * k + c for k in range(3) for c in range(2)),
            *range(lane_os, lane_os + 4), lane_rot, lane_rot + 1, lane_rect + 2, lane_rect + 3]
    return n * (32 * record_sectors(read) + 8 + 4 * (6 if max_aniso else 3)), \
        n * TAP_FOOTPRINT_OPS


def work_interp_attrs(full, width, row0=0):
    """R1: the record sectors of the vertices and their attributes (lanes
    0:60, its 16-byte loads); the five attributes written, 64 B a pixel."""
    n = full.shape[0] * full.shape[1]
    return n * (32 * record_sectors(range(60)) + 4 * 16), n * INTERP_ATTR_OPS


def work_material_tap(tri_flat, atlas_width, full, rect_lane, planes, n_taps=0, select=False):
    """T2: the planes, the rect's record sector, the distinct (row, lane
    group) pairs of every tap's 8 groups, the (n, 16) output."""
    from unclerenderer_tpu_torch.ops import texture as tex
    from unclerenderer_tpu_torch.ops.fma import fma

    n = planes.shape[1]
    rect0 = full[..., rect_lane:rect_lane + 4].reshape(-1, 4)
    suv = planes[0:2].t()
    l0 = tex._to_int(torch.floor(torch.clamp(planes[2], min=0.0)))
    taps = [suv] if not n_taps else [
        fma(planes[3:5].t(), (((k + 0.5) / n_taps - 0.5) * planes[5])[:, None], suv)
        for k in range(n_taps)]
    keys = []
    for uv in taps:
        x, y, w, h, _tx, _ty, _fx, _fy, ix, iy = tex._tap_coords(rect0, uv, l0)
        *_, ix2, iy2 = tex._tap_coords(rect0, uv, l0 + 1)
        rows = ((y + torch.remainder(iy, h)) * atlas_width + x + torch.remainder(ix, w)).long()
        cell = (4 + 3 * torch.clamp(iy2 - (iy >> 1) + 1, 0, 1)
                + torch.clamp(ix2 - (ix >> 1) + 1, 0, 1)).long()
        groups = torch.stack([torch.full_like(cell, g) for g in range(4)]
                             + [cell, cell + 1, cell + 3, cell + 4])
        keys.append((rows % tri_flat.shape[0])[None] * 13 + groups)
    moved = distinct(torch.cat(keys)) * 16 * tri_flat.element_size()
    return moved + n * (4 * planes.shape[0] + 32 + 64), n * len(taps) * TAP_OPS


# the warp skip that X1's bound counts: K2's rectangle (rows, columns) and pixels a thread
# (the image's need, not X1's design: csrc/exhaustive_raster.cu's warps are smaller)
X1_RECT = (8, 32)
X1_PIX = 8
BOX_OPS = 4  # a box test of a (row, tile): four compares


def work_exhaustive(setup, width, height, tile_h=32, tile_w=64, chunk=128, depth_mode=0,
                    y_offset=0.0, want_ids=True, ortho=False):
    """X1: (bytes, operations, live pairs, kept pairs).  Bytes: the table
    (coefficients, boxes, flags) read once, the images written once.
    Operations: what the image needs, not X1's walk -- a box test per live
    (row, tile) pair (``box_pairs`` finds them from each row's tile range),
    a corner test (EDGE_OPS) per (warp rectangle, live pair) and the edge
    tests of the (pixel, row) pairs that the warp skip keeps
    (raster_common.cuh's rule, as ``sweeps.raster.warp_rows``).  X1's row
    masks and per-tile scans are its design's cost, outside the bound.
    Live pairs: pixels x rows past the box test."""
    from unclerenderer_tpu_torch.ops.fma import fma
    from unclerenderer_tpu_torch.sweeps.exhaustive import box_pairs
    from unclerenderer_tpu_torch.sweeps.raster import centre

    rows, tiles = box_pairs(setup, width, height, tile_h, tile_w, y_offset)
    n_tx = -(-width // tile_w)
    rh, rw = X1_RECT
    rx_n = -(-tile_w // rw)
    rect = torch.arange(rx_n * -(-tile_h // rh), device=rows.device)
    rx, ry = (rect % rx_n) * rw, (rect // rx_n) * rh
    tested = kept = 0
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
        tested += may.numel()
        kept += int(may.sum())
    kept_pairs = rh * rw * kept
    ops = (BOX_OPS * rows.shape[0] + EDGE_OPS * tested
           + PIXEL_EDGE_OPS * kept_pairs + 3 * kept_pairs // X1_PIX)
    moved = nbytes(setup.coef, setup.bbox, setup.valid) + width * height * 4 * (1 + int(want_ids))
    return moved, ops, tile_h * tile_w * rows.shape[0], kept_pairs


def work_masked(coef, tri_id, valid, rows, start, count, arec, atlas, atlas_width, tile_h,
                tile_w, width, height, y_offset=0, full_height=None, bilinear=False,
                stats=False):
    """M1: (bytes, operations).  Bytes: the slots of the blocks the tiles
    walk (16 coefficients, flag, id, record row) and the valid slots' alpha
    records (19 floats) read once, the tile ranges, the two images written
    once, and the texels of the taps the level needs (4 a bilinear tap, 8 a
    trilinear one).  Operations: what this run's data needs, not M1's walk:
    the edge and depth tests of the covered pairs and the alpha tests of
    the taps it needs.  Both counts come from the plain version
    (``masked_needed_taps``: each pixel's covered pairs in descending key,
    then ascending id, down to its winner), not from the kernel's own."""
    from unclerenderer_tpu_torch.ops import raster_kernels as rk

    n = rk.masked_needed_taps(coef, tri_id, valid, rows, start, count, arec, atlas, atlas_width,
                              tile_h, tile_w, width, height, y_offset, full_height, bilinear)
    walked = coef.shape[0] if start is None else int(count.sum())
    slots = int((valid.reshape(coef.shape[0], -1)[:walked] > 0).sum())
    taps = n["needed"]
    moved = (walked * coef.shape[-1] * 4 * 19 + slots * 4 * 19 + nbytes(start, count)
             + height * width * 8 + taps * (4 if bilinear else 8) * atlas.element_size())
    return moved, MASKED_PAIR_OPS * n["covered"] + TAP_OPS * taps


def past_box(setup, b_id, differ, tile_h, tile_w, y_offset):
    """Of the pixels ``differ``, those whose binned winner's box misses the
    pixel's tile at X1's tile size: coverage of a sliver past its box, which
    a coarser bin level's larger tile evaluates and X1 rejects."""
    yy, xx = torch.nonzero(differ, as_tuple=True)
    w = b_id[yy, xx]
    bb = setup.bbox[:, w.clamp(min=0).long()]
    tx0 = (xx // tile_w * tile_w).to(torch.float32)
    ty0 = (yy // tile_h * tile_h).to(torch.float32) + y_offset
    over = ((bb[0] <= tx0 + (tile_w - 1)) & (bb[2] >= tx0) & (bb[1] <= ty0 + (tile_h - 1))
            & (bb[3] >= ty0))
    return int(((w >= 0) & ~over).sum())


def call_belongs(name, args, kwargs) -> bool:
    """Whether a recorded call of a wrapper shared by several kernel entries
    is entry ``name``'s: K1 with records or debug, K2 with records, K4 on
    u16 or f32 rows."""
    if name == "binned_raster_debug":
        return bool(kwargs.get("debug"))
    if kwargs.get("debug"):
        return False
    if name in ("shadow_select9", "shadow_select9_f32"):
        return (args[0].dtype == torch.float32) == name.endswith("_f32")
    return (kwargs.get("records") is not None) == name.endswith("raster_attrs")


def kernel_device_ms(fn, reps=10, attempts=5):
    """Device ms a call of ``fn``, by device kernel name: ``torch.profiler``
    over ``reps`` eager calls after a warm-up.  A trace with no device event
    (the profiler drops one now and then) is taken again; none in
    ``attempts`` fails the run."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
        if per:
            return per
    check(False, f"the profiler recorded no device event in {attempts} traces")


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
    from unclerenderer_tpu_torch.render.testing import env_cube_faces
    from unclerenderer_tpu_torch.textures.atlas import build_pyramid_tri_atlas

    chains = env_cube_faces(size, seed)
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

    from unclerenderer_tpu_torch.render.testing import (
        masked_raster_args,
        masked_raster_atlas,
        masked_raster_setup,
    )

    s = random_setup(16, 0, 0.1, dev, w=64, h=16)
    bins = bin_triangles(s, 64, 16, 16, 64, 32)
    m_setup, m_arec = masked_raster_setup("random", 0, dev, 64, 16, n=16)
    m_atlas, m_aw = masked_raster_atlas("quad16", torch.uint8, dev)
    start, count = rk.tile_block_ranges(bins, 1)
    with Recorder(rk, "giant_raster") as r:
        rk.rasterize_giant(s, 64, 16, tile_h=16, tile_w=64, chunk=8)
    rec = torch.zeros((16, 128), dtype=torch.float32, device=dev)
    layout, _ = hzb_mod.hzb_layout(2, 2)
    rng = np.random.default_rng(0)
    i32 = torch.from_numpy(rng.integers(0, 4, (4, 4)).astype(np.int32)).to(dev)
    f32 = torch.from_numpy(rng.random((9, 4), np.float32)).to(dev)
    return {
        "binned_raster": ((bins.coef, bins.tri_id, bins.valid, start, count, 16, 64, 1), {}),
        "giant_raster": r.calls[0],
        "binned_raster_attrs": ((bins.coef, bins.tri_id, bins.valid, start, count, 16, 64, 1),
                                {"records": rec}),
        "giant_raster_attrs": (r.calls[0][0], {"records": rec}),
        "shadow_select9": ((torch.zeros((16, 128), dtype=torch.int16, device=dev), i32[0],
                            i32[1], pcf_deltas(8)), {}),
        "shadow_select9_f32": ((torch.zeros((16, 128), dtype=torch.float32, device=dev), i32[0],
                                i32[1], pcf_deltas(8)), {}),
        # no live block: the launch path's cost, no line printed
        "binned_raster_debug": ((bins.coef, bins.tri_id, bins.valid, start,
                                 torch.zeros_like(count), 16, 64, 1), {"debug": True}),
        "gather_rows": ((f32[:4, :2].contiguous().to(torch.bfloat16), i32[0]), {}),
        "hzb_tail": ((f32[:4].contiguous(), [(w, h) for _o, w, h in layout]), {}),
        "env_select": ((torch.zeros((4, 128), device=dev), i32[0], f32), {}),
        "mat_select": ((torch.zeros((4, 256), dtype=torch.uint8, device=dev), i32[0],
                        f32[:7].contiguous()), {}),
        "materialize_rows": ((i32,), {}),
        "merge_select": ((i32[0], i32[1], f32[0], f32[1]), {}),
        "copy_rows": ((i32,), {}),
        "materialize": ((i32,), {}),
        "exhaustive_raster": ((s, 64, 16), {"tile_h": 16, "tile_w": 64}),
        "masked_raster": (masked_raster_args(m_setup, m_arec, m_atlas, m_aw, 64, 16, chunk=32),
                          {}),
        "present_u8": ((f32,), {}),
        "tap_footprint": ((rec.view(4, 4, 128), f32[:8].reshape(4, 4, 2), (73, 89, 97)), {}),
        "interp_attrs": ((rec.view(4, 4, 128), 4), {}),
        "material_tap": ((torch.zeros((4, 256), dtype=torch.uint8, device=dev), 2,
                          rec.view(4, 4, 128), 97, f32[:3].reshape(3, 4).repeat(1, 4)), {}),
    }


def launch_costs(kernels, dev):
    """Host us per call of every kernel wrapper on a tiny input, beside
    ``clone`` of its first input, taken in turns."""
    out = {}
    for name, (args, kw) in tiny_inputs(dev).items():
        k = kernels[name]
        wrapper = getattr(k["module"], k["attr"])
        # a setup's (X1's) coefficients stand for it
        first = next(getattr(a, "coef", a) for a in args
                     if isinstance(getattr(a, "coef", a), torch.Tensor))
        us, clone_us = in_turns(lambda: wrapper(*args, **kw), first.clone)
        k["launch_us"], k["clone_launch_us"] = us, clone_us
        out[name] = {"us": us, "clone_us": clone_us}
        log("launch", f"{name}: {us:.2f} us per call, clone of its first input "
                      f"{tuple(first.shape)} {clone_us:.2f} us (host clock, 2 x 3 x 1000 "
                      "calls each, in turns)")
    return out

def debug_phase(kernels, smi) -> dict:
    """K1's debug print: the child process's device lines (its stdout)
    equal, as a multiset, the plain version's lines for the same launches,
    and number the live blocks; the debug launches' ms with and without the
    flag, the plain version's and the bound go to ``kernels``."""
    import subprocess
    from collections import Counter

    with tempfile.TemporaryDirectory(prefix="chip_smoke_debug_") as td:
        out = Path(td) / "debug.json"
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--k1-debug-child", str(out)], cwd=ROOT, capture_output=True,
                             text=True, timeout=600)
        child_s = time.perf_counter() - t0
        check(res.returncode == 0, f"debug child failed: {res.stderr[-3000:]}")
        got = json.loads(out.read_text())
    sections, cur = {}, []
    for ln in res.stdout.splitlines():
        if ln.startswith("=== "):
            sections[ln[4:]], cur = cur, []
        elif ln.startswith("binned raster"):
            cur.append(ln)
    lines = sections["direct"]
    check(Counter(lines) == Counter(got["ref_lines"]),
          f"debug lines differ from the plain version's: {len(lines)} printed, "
          f"{len(got['ref_lines'])} expected")
    check(len(lines) == got["live_blocks"] > 0 and got["launches"] > 0,
          f"{len(lines)} debug lines for {got['live_blocks']} live blocks, "
          f"{got['launches']} launches")
    # the replayed Renderer frames: each frame's lines once, as op by op
    check(got["replay_mode"] == "graph", f"debug Renderer frames ran as {got['replay_mode']}")
    per_frame = []
    for i in range(REPLAY_FRAMES):
        g, e = sections[f"graph {i}"], sections[f"eager {i}"]
        check(e and Counter(g) == Counter(e), f"replayed debug frame {i}: {len(g)} lines, op by "
                                              f"op {len(e)} (not the same multiset)")
        per_frame.append(len(g))
    eager_lines = [ln for i in range(REPLAY_FRAMES) for ln in sections[f"eager {i}"]]
    check(Counter(eager_lines) == Counter(got["replay_ref_lines"]),
          "the op-by-op Renderer frames' debug lines differ from the plain version's")
    log("debug", f"a debug Renderer (256x256): {REPLAY_FRAMES} frames replayed from "
                 f"the frame program printed {per_frame} lines, each frame the multiset of the "
                 "same frame op by op, which is the plain version's: one line a live block, once")
    k = kernels["binned_raster_debug"]
    for c in got["calls"]:
        k["ms"] += c["ms"]
        k["graph_ms"] += c["graph_ms"]
        k["plain_ms"] += c["plain_ms"]
        k["no_debug_ms"] += c["no_debug_ms"]
        k["bytes_s"] += c["bytes"] / HBM_BYTES_PER_S
        k["ops_s"] += c["ops"] / F32_OPS_PER_S
    log("debug", f"one 256x256 frame with kernel_debug_print in a child process ({child_s:.1f} "
                 f"s): {got['launches']} debug launches printed {len(lines)} lines, the plain "
                 f"version's multiset, one per live block ({got['live_blocks']}); printf FIFO "
                 f"{got['fifo_bytes']} B; per launch (lines, ms with / without the flag, "
                 "graph ms with it): "
                 f"{[(c['lines'], round(c['ms'], 4), round(c['no_debug_ms'], 4), round(c['graph_ms'], 4)) for c in got['calls']]} "
                 f"(CUDA events, 20 launches each, in turns; graph: 10 in one CUDA graph; on "
                 f"{smi})")
    return {"lines": len(lines), "child_s": child_s, "replay_lines": per_frame,
            **{k_: v for k_, v in got.items() if k_ not in ("ref_lines", "replay_ref_lines")}}


def observability_phase(dev, smi, scene: Path) -> dict:
    """Observability on the renderer cell's files at 1080p: GpuTiming's
    "Frame" samples, ``profile_passes``' ten stages, ``profile_trace_passes``
    (the raster kernels attributed to their passes; "(total)" beside the
    frames' CUDA-event time, and the "(other)" share, logged), GraphDump's
    op list naming every kernel its frame launched, and the CLI with
    ``--trace DIR --profile-passes``.  Returns what it measured; a failed
    gate raises."""
    import os
    import re
    import subprocess

    from unclerenderer_tpu_torch.core import traceparse
    from unclerenderer_tpu_torch.core.config import RendererConfig
    from unclerenderer_tpu_torch.ops import _cuda
    from unclerenderer_tpu_torch.render.params import RenderSettings
    from unclerenderer_tpu_torch.render.renderer import Renderer

    rep = {}
    settings = RenderSettings(width=WIDTH, height=HEIGHT, shadow_map_size=SHADOW)
    r = Renderer(scene, settings=settings, config=RendererConfig(enable_gpu_timing=True),
                 device=dev)
    for _ in range(3):
        r.render_frame()
    timing = r.stats()["frame_timing"]
    check(timing and timing[0]["name"] == "Frame", f"frame_timing {timing}")
    rep["frame_timing"] = timing
    stages = r.profile_passes(iterations=1).stats()
    check({row["name"] for row in stages} == PASS_STAGES and
          all(row["avg_ms"] > 0 for row in stages), f"profile_passes stages {stages}")
    rep["profile_passes"] = {row["name"]: row["avg_ms"] for row in stages}
    log("observability", f"GpuTiming {timing}; profile_passes (ms, one run each, CUDA events): "
                         f"{ {k: round(v, 3) for k, v in rep['profile_passes'].items()} }")

    # the in-frame buckets of 2 traced frames (the first re-renders the map)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as td:
        r._shadow_key = None
        t0 = time.perf_counter()
        passes = {row["name"]: row["avg_ms"]
                  for row in r.profile_trace_passes(frames=2, trace_dir=td).stats()}
        trace_s = time.perf_counter() - t0
        rows = traceparse.scope_paths(traceparse.load_events(traceparse.find_trace_file(td)))
    for name in ("ShadowMap", "VisibilityRaster", "MaterialResolve"):
        check(passes.get(name, 0.0) > 0.0, f"profile_trace_passes: no {name} time ({passes})")
    k1 = [path for name, _d, path in rows if "binned_raster_kernel" in name]
    check(k1 and all("ShadowMap" in p or "VisibilityRaster" in p for p in k1),
          f"K1 rows outside ShadowMap/VisibilityRaster: {[p for p in k1 if 'Raster' not in p]}")
    unattributed = sum(1 for _n, _d, path in rows if not path)
    r._shadow_key = None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(2):
        r.render_frame()
    end.record()
    end.synchronize()
    frame_ms = start.elapsed_time(end) / 2
    total, other = passes.get("(total)", 0.0), passes.get("(other)", 0.0)
    rep.update(trace_passes=passes, trace_s=trace_s, device_rows=len(rows), k1_rows=len(k1),
               rows_without_range=unattributed, frame_event_ms=frame_ms)
    log("observability", f"profile_trace_passes (2 frames, {trace_s:.1f} s): "
                         f"{ {k: round(v, 3) for k, v in passes.items()} }; (total) {total:.2f} "
                         f"ms of device time a frame against {frame_ms:.2f} ms a frame between "
                         f"CUDA events, (other) {100 * other / max(total, 1e-9):.1f}% of it; "
                         f"{len(rows)} device rows, {unattributed} with no range, {len(k1)} K1 "
                         f"rows all in ShadowMap or VisibilityRaster (on {smi})")
    del r

    # GraphDump: the first frame's op list, in a scratch working directory
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dump_") as td:
        os.chdir(td)
        try:
            r = Renderer(scene, settings=settings, config=RendererConfig(enable_graph_dump=True),
                         device=dev)
            torch.cuda.synchronize()
            _cuda.reset_launches()
            r.render_frame()
            torch.cuda.synchronize()
            launched = sorted(k for k, v in _cuda.LAUNCHES.items() if v)
            dump = (Path(td) / "render_graph_dump.txt").read_text()
        finally:
            os.chdir(cwd)
    named = sorted(set(re.findall(r"\tkernel (\w+)", dump)))
    check(len(dump) > 1000 and set(launched) <= set(named),
          f"graph dump ({len(dump)} B) names {named}, the frame launched {launched}")
    rep.update(graph_dump_bytes=len(dump), graph_dump_entries=dump.count("\n") - 2,
               graph_dump_kernels=named)
    log("observability", f"render_graph_dump.txt {len(dump)} B, {dump.count(chr(10)) - 2} "
                         f"entries, names every kernel the frame launched: {named}")
    del r

    # the CLI with --trace and --profile-passes
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as td:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "unclerenderer_tpu_torch", "--scene", str(scene), "--width",
             str(WIDTH), "--height", str(HEIGHT), "--frames", "2", "--trace",
             str(Path(td) / "trace"), "--profile-passes", "--output", str(Path(td) / "o.png")],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(res.returncode == 0, f"CLI --trace --profile-passes failed: {res.stderr[-3000:]}")
        traces = list((Path(td) / "trace").glob("*.pt.trace.json"))
        logged = re.findall(r"pass (\S+(?: \S+)?)\s+avg", res.stdout + res.stderr)
        check(len(traces) == 1 and set(logged) == PASS_STAGES,
              f"CLI wrote {traces}, logged passes {logged}")
        trace_mb = traces[0].stat().st_size / 2**20
    rep.update(cli_s=cli_s, cli_trace_mib=trace_mb)
    log("observability", f"CLI --trace DIR --profile-passes at {WIDTH}x{HEIGHT}: {cli_s:.1f} s, "
                         f"one {trace_mb:.1f} MiB Chrome trace, the ten stages logged")
    return rep


RENDERER_SMALL = 256  # the card/CPU Renderer pair: 256x256, 512^2 shadow map
OVERLAY_ROWS = 80  # the stats block's four lines end above this row (origin 8, 18 rows a line)


def forward_renderer(deferred, scene, orbit, dev, smi) -> dict:
    """The forward Renderer (``renderer_type="forward"``) at 1920x1080 with
    a 4096^2 map on the scene files ``deferred`` renders: 10 counted
    ``render_frame`` calls (K1, K2, K4, K5 launched), drop counters 0, more
    than 30% covered, colour finite in [0, 1], ``render_frames`` leaving the
    frame state as it is; ms/frame in turns with the deferred Renderer;
    card/CPU pairs at 256x256 with fused resolve off and on."""
    from unclerenderer_tpu_torch.ops import _cuda
    from unclerenderer_tpu_torch.render.params import RenderSettings
    from unclerenderer_tpu_torch.render.renderer import Renderer

    rep = {}
    f = Renderer(scene, settings=RenderSettings(width=WIDTH, height=HEIGHT, shadow_map_size=SHADOW,
                                                renderer_type="forward"), device=dev)
    check(not f.settings.gpu_debug_print, "forward: the stats block is the deferred frame's")
    torch.cuda.synchronize()
    _cuda.reset_launches()
    for i in range(FRAMES):
        orbit(f, i)
        out = f.render_frame()
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    log("forward", f"launches in {FRAMES} forward render_frame calls: {launches}")
    for name in ("binned_raster", "giant_raster", "shadow_select9", "gather_rows"):
        check(launches[name] > 0, f"kernel {name} was not launched by the forward Renderer")
    color = out["color"]
    check(tuple(color.shape) == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(color).all())
          and float(color.min()) >= 0.0 and float(color.max()) <= 1.0,
          "forward color not finite in [0, 1]")
    check("hdr" not in out and int(f.frame_state.frame_index) == 0,
          "a forward frame carries no frame state")
    covered = int((out["tri_id"] >= 0).sum())
    check(covered > 0.3 * WIDTH * HEIGHT, f"forward: only {covered} covered pixels")
    st = f.stats()
    for key in ("bin_pair_overflow", "bin_giant_truncated", "compact_overflow",
                "shadow_compact_overflow"):
        check(st[key] == 0, f"forward: drop counter {key} = {st[key]}")
    state = f.frame_state
    colors = f.render_frames(FRAMES, mutate=orbit)
    check(tuple(colors.shape) == (FRAMES, HEIGHT, WIDTH, 3) and bool(torch.isfinite(colors).all())
          and f.frame_state is state and f._chain_drop_counters == {},
          "forward render_frames: colours, frame state or chain counters")
    del colors
    log("forward", f"forward frame: {covered} covered pixels, colour in [0, 1], no frame state, "
                   f"drop counters 0; render_frames({FRAMES}) leaves the state as it is")
    rep.update(launches=launches, covered=covered, stats=st)

    def run(rr):
        def frames():
            for i in range(FRAMES):
                orbit(rr, i)
                rr.render_frame()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1000.0 / FRAMES

    runs = {"forward": [], "deferred": []}
    for which in ("forward", "deferred", "deferred", "forward", "forward", "deferred"):
        runs[which].append(run(f if which == "forward" else deferred))
    med = {k: statistics.median(v) for k, v in runs.items()}
    log("forward", f"ms/frame median: forward Renderer {med['forward']:.2f} (runs "
                   f"{[round(x, 2) for x in runs['forward']]}), deferred Renderer "
                   f"{med['deferred']:.2f} (runs {[round(x, 2) for x in runs['deferred']]}); 3 "
                   f"runs x {FRAMES} frames each in turns, {WIDTH}x{HEIGHT}, shadow {SHADOW}^2, "
                   f"on {smi}")
    rep.update(ms_per_frame=runs, median_ms=med)
    del f

    # card vs CPU forward Renderers at 256^2, fused resolve off and on
    rep["cross"] = {}
    for fused in ("auto", "on"):
        settings = RenderSettings(width=RENDERER_SMALL, height=RENDERER_SMALL,
                                  shadow_map_size=512, renderer_type="forward",
                                  fused_resolve=fused)
        g = Renderer(scene, settings=settings, device=dev)
        c = Renderer(scene, settings=settings, device="cpu")
        _cuda.reset_launches()
        og, oc = g.render_frame(), c.render_frame()
        for k in ("depth", "tri_id"):
            check(torch.equal(og[k].cpu(), oc[k]), f"forward cross fused={fused}: {k}")
        check(torch.equal(og["object_id"].view(torch.int32).cpu(),
                          oc["object_id"].view(torch.int32)), f"forward cross fused={fused}: ids")
        check({k: int(v) for k, v in og["raster_stats"].items()}
              == {k: int(v) for k, v in oc["raster_stats"].items()},
              f"forward cross fused={fused}: counters")
        err = float((og["color"].cpu() - oc["color"]).abs().max())
        check(err <= COLOR_ATOL, f"forward cross fused={fused}: color err {err}")
        used = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        check((used.get("binned_raster_attrs", 0) > 0) == (fused == "on"),
              f"forward cross fused={fused}: record-emitting launches {used}")
        log("forward", f"card vs CPU forward Renderer {RENDERER_SMALL}^2, fused_resolve={fused}: "
                       f"depth/ids/counters bit-equal, color max err {err:.3g}; card launches "
                       f"{used}")
        rep["cross"][fused] = {"color_err": err, "launches": used}
        del g, c
    return rep


def renderer_phase(dev, smi, scene_dir: Path) -> dict:
    """The Renderer path (``render/renderer.py``) from scene files, as a
    user runs it: phase 7 of the module docstring.  Returns what it
    measured; any failed gate raises."""
    import subprocess

    from unclerenderer_tpu_torch.ops import _cuda
    from unclerenderer_tpu_torch.ops.present import to_u8_host
    from unclerenderer_tpu_torch.render import common as common_mod
    from unclerenderer_tpu_torch.render.deferred import deferred_frame
    from unclerenderer_tpu_torch.render.params import FrameState, RenderSettings
    from unclerenderer_tpu_torch.render.renderer import Renderer
    from unclerenderer_tpu_torch.render.testing import write_scene
    from unclerenderer_tpu_torch.textures import native
    from unclerenderer_tpu_torch.textures.png import load_png

    rep = {}
    # ---- the scene files: the headline's geometry as glTF, PNG maps, DDS env + LUT
    t0 = time.perf_counter()
    scene = write_scene(scene_dir, N_OBJECTS, sphere_res=SPHERE_RES, ground=True, n_materials=6,
                        tex_size=256, env_size=ENV_SIZE, name="headline")
    log("renderer", f"wrote {scene.relative_to(scene_dir)} with Models/headline.gltf + .bin, "
                    f"18 PNG maps and 2 DDS files in {time.perf_counter() - t0:.2f} s")

    # ---- build at full size, default RendererConfig (stats overlay and TAA on)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = Renderer(scene, settings=RenderSettings(width=WIDTH, height=HEIGHT,
                                                shadow_map_size=SHADOW), device=dev)
    init_s = time.perf_counter() - t0
    data, quad = r.scene_data, r.device_scene.quad_img
    log("renderer", f"scene: {data.num_models} models, {data.num_triangles} triangles from glTF "
                    f"(the synthetic headline scene has 342 and 263184)")
    check((data.num_models, data.num_triangles) == (342, 263184),
          f"glTF scene has {data.num_models} models, {data.num_triangles} triangles")
    log("renderer", f"init {init_s:.2f} s, phases {r.setup_phase_s}; atlas {tuple(quad.shape)} "
                    f"{quad.dtype}; env_mip_count {r.env_mip_count}; texture substitutions "
                    f"{r.texture_substitutions}; native library {native.build_info} (on {smi})")
    check(tuple(quad.shape) == (768, 1024, 64) and quad.dtype == torch.uint8,
          f"atlas {tuple(quad.shape)} {quad.dtype}, expected the (768, 1024, 64) u8 quad atlas")
    check(r.texture_substitutions == [], f"textures substituted: {r.texture_substitutions}")
    check(native.build_info.get("path"), f"textures/native.py built no library: {native.build_info}")
    check(r.env_mip_count == float(ENV_SIZE.bit_length()), f"env mips {r.env_mip_count}")
    check(r.settings.gpu_debug_print and r.settings.enable_taa, "overlay and TAA must be on")
    rep.update(scene_json=str(scene), init_s=init_s, setup_phase_s=dict(r.setup_phase_s),
               native=dict(native.build_info),
               atlas=[list(quad.shape), str(quad.dtype)], env_mip_count=r.env_mip_count)

    center = np.asarray(data.scene_center, np.float32)
    cam0 = np.asarray(r.camera.position, np.float32)

    def orbit(rr, i):
        """A slow orbit of the scene's camera about the scene centre."""
        a = 0.0035 * rr._frame_counter
        off = cam0 - center
        rr.camera.position = center + np.array(
            [off[0] * np.cos(a) - off[2] * np.sin(a), off[1], off[0] * np.sin(a) + off[2] * np.cos(a)],
            np.float32)
        rr.camera.set_look_at(center)

    def gate_stats(label):
        st = r.stats()
        for key in ("bin_pair_overflow", "bin_giant_truncated", "compact_overflow",
                    "shadow_compact_overflow"):
            check(st[key] == 0, f"renderer {label}: drop counter {key} = {st[key]}")
        check(st["models_visible"] > 0, f"renderer {label}: no model visible")
        return st

    # ---- 10 frames with render_frame: the main-path run of this phase, counted
    torch.cuda.synchronize()
    _cuda.reset_launches()
    for i in range(FRAMES):
        orbit(r, i)
        out = r.render_frame()
        if i == 0:
            first = dict(_cuda.LAUNCHES)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    cached = {k: (launches[k] - first[k]) / (FRAMES - 1) for k in launches}
    log("renderer", f"launches in {FRAMES} render_frame calls: {launches}; first frame (renders "
                    f"the shadow map) {first}; per frame after it (cached map) {cached}")
    for name in ("binned_raster", "giant_raster", "shadow_select9", "gather_rows"):
        check(launches[name] > 0, f"kernel {name} was not launched by Renderer.render_frame")
    color = out["color"]
    check(tuple(color.shape) == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(color).all()),
          f"renderer color {tuple(color.shape)} not finite")
    covered = int((out["tri_id"] >= 0).sum())
    check(covered > 0.3 * WIDTH * HEIGHT, f"renderer: only {covered} covered pixels")
    st = gate_stats("render_frame")
    log("renderer", f"render_frame: {covered} covered pixels, stats {st}")
    colors = r.render_frames(FRAMES, mutate=orbit)
    check(tuple(colors.shape) == (FRAMES, HEIGHT, WIDTH, 3) and bool(torch.isfinite(colors).all()),
          "render_frames colors")
    st_chain = gate_stats("render_frames")
    log("renderer", f"render_frames({FRAMES}): worst-frame drop counters "
                    f"{ {k: int(v) for k, v in r._chain_drop_counters.items()} }")
    rep.update(launches=launches, first_frame_launches=first, cached_frame_launches=cached,
               covered=covered, stats=st, stats_after_render_frames=st_chain)
    del colors

    # ---- the present: converted on the card, its bytes read back
    before = _cuda.LAUNCHES["present_u8"]
    img = r.render_to_u8()
    presents = _cuda.LAUNCHES["present_u8"] - before
    check(presents == 1 and np.array_equal(img, to_u8_host(r._last_out["color"].cpu().numpy())),
          f"render_to_u8: {presents} conversions, or bytes other than numpy's conversion")
    rep["present_launches"] = presents

    # ---- one Renderer frame against deferred_frame called directly
    params = r.frame_params()
    state = FrameState(**{f.name: getattr(r.frame_state, f.name).clone()
                          for f in dataclasses.fields(FrameState)})
    cached_map = r._shadow_map(params)
    opaque, masked = common_mod.tri_draw_masks(r.device_scene, params.model_visible)
    own_map, own_over = common_mod.raster_shadow(r.device_scene, params.light_view_proj,
                                                 opaque | masked, r.settings)
    check(torch.equal(cached_map, own_map) and int(own_over) == 0,
          "the cached shadow map differs from the frame's own shadow raster")
    out_r = r.render_frame()
    direct, _ = deferred_frame(r.device_scene, params, state, r.settings)
    for k in ("depth", "tri_id", "model_visible", "frustum_culled", "hzb_occluded"):
        check(torch.equal(out_r[k], direct[k]), f"renderer vs direct deferred_frame: {k} differs")
    check(torch.equal(out_r["object_id"].view(torch.int32), direct["object_id"].view(torch.int32)),
          "renderer vs direct deferred_frame: object_id differs")
    check({k: int(v) for k, v in out_r["raster_stats"].items()}
          == {k: int(v) for k, v in direct["raster_stats"].items()},
          "renderer vs direct deferred_frame: counters differ")
    color_err = float((out_r["color"] - direct["color"]).abs().max())
    check(color_err <= COLOR_ATOL, f"renderer vs direct deferred_frame: color err {color_err}")
    plain, _ = deferred_frame(r.device_scene, params, state,
                              dataclasses.replace(r.settings, gpu_debug_print=False),
                              shadow_map=cached_map)
    differ = (out_r["color"] != plain["color"]).any(-1)
    in_text = int(differ[8:OVERLAY_ROWS].sum())
    check(in_text > 100 and not bool(differ[OVERLAY_ROWS:].any()),
          f"stats overlay: {in_text} differing pixels in its rows, some below them")
    log("renderer", f"Renderer frame vs direct deferred_frame(shadow_map=None): cached map "
                    f"bit-equal to the frame's own, depth/ids/counters bit-equal, color max err "
                    f"{color_err:.3g}; overlay: {in_text} pixels of its text rows differ from the "
                    f"frame with gpu_debug_print=False, none below")
    rep.update(direct_color_err=color_err, overlay_pixels=in_text)
    del direct, plain, out_r, own_map

    # ---- card vs CPU Renderers at 256^2 from the same scene files
    small = RenderSettings(width=RENDERER_SMALL, height=RENDERER_SMALL, shadow_map_size=512)
    flags = dataclasses.replace(small, material_packed_trilinear=True, **KERNEL_FLAGS)
    rep["cross"] = {}
    for label, settings in (("defaults", small), ("kernel flags, packed atlas", flags)):
        g = Renderer(scene, settings=settings, device=dev)
        c = Renderer(scene, settings=settings, device="cpu")
        _cuda.reset_launches()
        err = 0.0
        for i in range(2):
            orbit(g, i)
            orbit(c, i)
            og, oc = g.render_frame(), c.render_frame()
            for k in ("depth", "tri_id", "model_visible"):
                check(torch.equal(og[k].cpu(), oc[k]), f"renderer cross {label} frame {i}: {k}")
            check(torch.equal(og["object_id"].view(torch.int32).cpu(),
                              oc["object_id"].view(torch.int32)),
                  f"renderer cross {label} frame {i}: object_id")
            check({k: int(v) for k, v in og["raster_stats"].items()}
                  == {k: int(v) for k, v in oc["raster_stats"].items()},
                  f"renderer cross {label} frame {i}: counters")
            err = max(err, float((og["color"].cpu() - oc["color"]).abs().max()))
        check(err <= COLOR_ATOL, f"renderer cross {label}: color err {err}")
        used = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        if settings is flags:  # the packed atlas's tap is T1 and T2, not K8
            for name in ("hzb_tail", "env_select", "interp_attrs", "tap_footprint",
                         "material_tap", "materialize_rows"):
                check(used.get(name, 0) > 0, f"renderer cross {label}: {name} not launched")
        log("renderer", f"card vs CPU Renderer {RENDERER_SMALL}^2 ({label}): 2 carried frames, "
                        f"depth/ids/counters bit-equal, color max err {err:.3g}; card launches "
                        f"{used}")
        rep["cross"][label] = {"color_err": err, "launches": used}
        del g, c

    # ---- Renderer ms/frame in turns with direct deferred_frame calls
    plist = []
    for i in range(FRAMES):
        orbit(r, i)
        plist.append(r.frame_params())
    cached_map = r._shadow_map(plist[0])

    def renderer_run():
        for i in range(FRAMES):
            orbit(r, i)
            r.render_frame()

    def direct_run():
        st = r.frame_state
        for p in plist:
            _, st = deferred_frame(r.device_scene, p, st, r.settings, shadow_map=cached_map)

    def timed_run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1000.0 / FRAMES

    runs = {"renderer": [], "direct": []}
    for which in ("renderer", "direct", "direct", "renderer", "renderer", "direct"):
        runs[which].append(timed_run(renderer_run if which == "renderer" else direct_run))
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = {k: statistics.median(v) for k, v in runs.items()}
    # what the Renderer adds to a frame on the host: its params (camera,
    # light, one pinned non-blocking copy) and the shadow-cache lookup
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        p = r.frame_params()
    params_ms = (time.perf_counter() - t0) * 10.0
    t0 = time.perf_counter()
    for _ in range(100):
        r._shadow_map(p)
    lookup_ms = (time.perf_counter() - t0) * 10.0
    torch.cuda.synchronize()
    log("renderer", f"host ms a call: frame_params {params_ms:.4f}, cached shadow-map lookup "
                    f"{lookup_ms:.4f} (100 calls each, host clock)")
    rep.update(frame_params_host_ms=params_ms, shadow_lookup_host_ms=lookup_ms)
    log("renderer", f"ms/frame median: Renderer.render_frame {med['renderer']:.2f} "
                    f"(runs {[round(x, 2) for x in runs['renderer']]}), direct deferred_frame with "
                    f"the cached map and prebuilt params {med['direct']:.2f} "
                    f"(runs {[round(x, 2) for x in runs['direct']]}); 3 runs x {FRAMES} frames "
                    f"each in turns, {WIDTH}x{HEIGHT}, shadow {SHADOW}^2; peak {peak:.2f} GiB "
                    f"since the Renderer's build, on {smi}")
    rep.update(ms_per_frame=runs, median_ms=med, peak_gib=peak)

    # ---- the forward Renderer on the same files: counted frames, gates, turns
    rep["forward"] = forward_renderer(r, scene, orbit, dev, smi)
    del r

    # ---- the CLI, as a user runs it
    out_png = scene_dir / "out.png"
    cmd = [sys.executable, "-m", "unclerenderer_tpu_torch", "--scene", str(scene),
           "--width", str(WIDTH), "--height", str(HEIGHT)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd + ["--frames", "3", "--output", str(out_png)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(res.returncode == 0, f"CLI exited {res.returncode}:\n{res.stderr[-3000:]}")
    img = load_png(out_png)
    check(img is not None and img.shape == (HEIGHT, WIDTH, 4), "CLI PNG does not decode to 1080p")
    check(len(np.unique(img[..., :3].reshape(-1, 3), axis=0)) > 100, "CLI PNG is constant")
    steady = [ln for ln in res.stderr.splitlines() if "steady-state" in ln]
    captured = [ln for ln in res.stderr.splitlines() if "capture:" in ln]
    check(len(steady) == 1 and len(captured) == 1,
          f"CLI --frames 3: {len(captured)} capture and {len(steady)} steady-state lines, "
          "expected one each (the capture before the steady state)")
    log("renderer", f"CLI --frames 3: exit 0 in {cli_s:.1f} s, {out_png.name} decodes to "
                    f"{img.shape} ({captured[0].split('] ')[-1]}; {steady[0].split('] ')[-1]})")
    t0 = time.perf_counter()
    res = subprocess.run(cmd + ["--orbit", "4", "--output", str(scene_dir / "orbit.png")],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"CLI --orbit exited {res.returncode}:\n{res.stderr[-3000:]}")
    for i in range(4):
        img = load_png(scene_dir / f"orbit_{i:03d}.png")
        check(img is not None and img.shape == (HEIGHT, WIDTH, 4), f"orbit PNG {i}")
    log("renderer", f"CLI --orbit 4: exit 0 in {time.perf_counter() - t0:.1f} s, 4 PNGs of "
                    f"{HEIGHT}x{WIDTH}")
    rep["cli_s"] = cli_s
    t0 = time.perf_counter()
    res = subprocess.run(cmd + ["--renderer", "forward", "--output", str(scene_dir / "fwd.png")],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"CLI --renderer forward exited {res.returncode}:\n"
                               f"{res.stderr[-3000:]}")
    img = load_png(scene_dir / "fwd.png")
    check(img is not None and img.shape == (HEIGHT, WIDTH, 4)
          and len(np.unique(img[..., :3].reshape(-1, 3), axis=0)) > 100,
          "CLI --renderer forward PNG")
    rep["cli_forward_s"] = time.perf_counter() - t0
    log("renderer", f"CLI --renderer forward: exit 0 in {rep['cli_forward_s']:.1f} s, fwd.png "
                    f"decodes to {img.shape}")
    return rep


MC_KERNELS = ("binned_raster", "giant_raster", "shadow_select9", "gather_rows")
ENTRY_KERNELS = MC_KERNELS + ("masked_raster",)  # the entry's 128^2 frame (masked models)
DRYRUN_KERNELS = ("exhaustive_raster", "masked_raster")  # the xla backend's
ENTRY_RECORD_RANK = 5  # the 8-rank dry run's rank whose calls are held: row0 80
# the argument index of a raster wrapper's y_offset (X1 takes it by keyword)
Y_OFFSET_AT = {"binned_raster": 8, "giant_raster": 7, "masked_raster": 13}


def kernel_targets(names) -> dict:
    """{kernel: (module, wrapper attribute, plain version)} for ``names``:
    the module attribute through which the frames call each wrapper
    (``render/common.py`` imports X1's by name), for ``Recorder``."""
    from unclerenderer_tpu_torch.ops import raster_kernels as rk
    from unclerenderer_tpu_torch.ops import shadow as shadow_mod
    from unclerenderer_tpu_torch.ops import texture as tex_mod
    from unclerenderer_tpu_torch.ops.raster import rasterize as rasterize_plain
    from unclerenderer_tpu_torch.render import common as common_mod

    every = {"binned_raster": (rk, "binned_raster", rk.binned_raster_ref),
             "giant_raster": (rk, "giant_raster", rk.giant_raster_ref),
             "shadow_select9": (shadow_mod, "select9", shadow_mod.select9_ref),
             "gather_rows": (tex_mod, "gather_rows", tex_mod.gather_rows_ref),
             "exhaustive_raster": (common_mod, "rasterize_exhaustive", rasterize_plain),
             "masked_raster": (rk, "masked_raster", rk.masked_raster_ref)}
    return {n: every[n] for n in names}


def hold_calls(where: str, recs: dict, targets: dict) -> tuple:
    """Every call that ``recs`` (``Recorder``s of ``targets``, left already)
    recorded, run again through its wrapper and its plain version on the
    same inputs: each output equal bit for bit (``same_bits``).  Fails for
    a kernel that made no call.  Returns ({kernel: calls held}, {raster
    kernel: the sorted y_offsets of its calls})."""
    held, y_offsets = {}, {}
    for name, (m, a, ref) in targets.items():
        calls = recs[name].calls
        check(calls, f"{where}: {name} made no call")
        for ca, ck in calls:
            got, want = getattr(m, a)(*ca, **ck), ref(*ca, **ck)
            bad, err = compare(got, want)
            check(bad == 0, f"{where}: {name} != plain: {bad} elements (err {err})")
            check(same_bits(got, want), f"{where}: {name}'s bit patterns differ from plain "
                                        "(signed zeros)")
        held[name] = len(calls)
        if name == "exhaustive_raster":
            y_offsets[name] = sorted({float(ck["y_offset"]) for _ca, ck in calls})
        elif name in Y_OFFSET_AT:
            y_offsets[name] = sorted({float(ca[Y_OFFSET_AT[name]]) for ca, _ck in calls})
    return held, y_offsets
SEAM_ATOL = 1e-5  # sharded vs single-device colour: the exposure grid's sum order only


def scene_cache_phase(dev, smi, scene: Path):
    """Phase 11: the scene cache (``core/scenecache.py``) on the renderer
    cell's files at 1920x1080: a cold and a warm ``Renderer`` init in a
    fresh cache directory (deleted afterwards), their ``setup_phase_s`` and
    ``scene_cache_hit``, the device arrays bit-equal, and 3 carried frames
    from each bit-equal (colour, depth, ids, counters).  Returns (report,
    the warm Renderer)."""
    import os
    import shutil

    from unclerenderer_tpu_torch.render.params import RenderSettings
    from unclerenderer_tpu_torch.render.renderer import Renderer

    settings = RenderSettings(width=WIDTH, height=HEIGHT, shadow_map_size=SHADOW)
    cache = Path(tempfile.mkdtemp(prefix="chip_smoke_scene_cache_"))
    os.environ["UNCLERENDERER_SCENE_CACHE"] = str(cache)
    try:
        inits = {}
        for which in ("cold", "warm"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = Renderer(scene, settings=settings, device=dev)
            inits[which] = (r, time.perf_counter() - t0)
        cold, warm = inits["cold"][0], inits["warm"][0]
        check(not cold.scene_cache_hit and warm.scene_cache_hit,
              f"cache: hits cold {cold.scene_cache_hit}, warm {warm.scene_cache_hit}")
        check(set(warm.setup_phase_s) == {"cache_load", "device_upload"},
              f"cache: warm phases {warm.setup_phase_s}")
        for f in dataclasses.fields(cold.device_scene):
            a, b = getattr(cold.device_scene, f.name), getattr(warm.device_scene, f.name)
            check(a.dtype == b.dtype and torch.equal(a, b), f"cache: device array {f.name}")
        check(warm.settings == cold.settings, "cache: settings differ")
        stored = sum(p.stat().st_size for p in cache.rglob("*") if p.is_file())
        for i in range(3):
            a, b = cold.render_frame(), warm.render_frame()
            for k in ("color", "hdr", "depth", "tri_id"):
                check(torch.equal(a[k], b[k]), f"cache: frame {i} {k} differs cold vs warm")
            check(torch.equal(a["object_id"].view(torch.int32), b["object_id"].view(torch.int32)),
                  f"cache: frame {i} object_id")
            check({k: int(v) for k, v in a["raster_stats"].items()}
                  == {k: int(v) for k, v in b["raster_stats"].items()}, f"cache: frame {i} counters")
        rep = {"cold_s": inits["cold"][1], "warm_s": inits["warm"][1],
               "cold_phases": dict(cold.setup_phase_s), "warm_phases": dict(warm.setup_phase_s),
               "hits": [cold.scene_cache_hit, warm.scene_cache_hit], "stored_bytes": stored}
        log("cache", f"init cold {rep['cold_s']:.2f} s {rep['cold_phases']}, warm "
                     f"{rep['warm_s']:.2f} s {rep['warm_phases']} (hits {rep['hits']}; "
                     f"{stored / 1e6:.0f} MB stored); device arrays and 3 carried frames "
                     f"bit-equal cold vs warm ({WIDTH}x{HEIGHT}, shadow {SHADOW}^2, on {smi})")
        del cold, inits
        return rep, warm
    finally:
        os.environ["UNCLERENDERER_SCENE_CACHE"] = ""
        shutil.rmtree(cache, ignore_errors=True)


def viewer_phase(r, smi) -> dict:
    """Phase 12: the terminal viewer (``viewer.py run_viewer``) on a 1080p
    Renderer, scripted keys through a stand-in for ``_RawInput`` and the
    terminal to a buffer: a move, a yaw, a slider nudge, a settings toggle,
    a screenshot and quit; then 10 frames with no key, timed (ms per
    viewer frame: the frame, its read-back, the overlays and the ANSI
    text), with the launch counts set to 0 just before and read after."""
    import io

    from unclerenderer_tpu_torch import viewer
    from unclerenderer_tpu_torch.ops import _cuda
    from unclerenderer_tpu_torch.textures.png import load_png

    def session(keys, save_path):
        keys = list(keys)

        class Scripted:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def read_keys(self):
                return keys.pop(0)

        term = io.StringIO()
        with patched(viewer, "_RawInput", Scripted), contextlib.redirect_stdout(term):
            t0 = time.perf_counter()
            frames = viewer.run_viewer(r, save_path=str(save_path), target_fps=1000.0)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        check(not keys, f"viewer: {len(keys)} key groups left unread")
        return frames, secs, term.getvalue()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_viewer_") as d:
        shot = Path(d) / "shot.png"
        pos0, fwd0 = np.array(r.camera.position), np.array(r.camera.forward)
        exposure0, cas0 = r.config.tonemap_exposure, r.settings.enable_cas
        frames, secs, text = session([["w", "arrow_left"], ["]", ".", "."], ["3"], ["p"], ["x"]],
                                     shot)
        check(frames == 4, f"viewer: {frames} frames, expected 4")
        png = load_png(shot)
        check(png is not None and png.shape == (HEIGHT, WIDTH, 4)
              and len(np.unique(png[..., :3].reshape(-1, 3), axis=0)) > 100,
              "viewer: the screenshot does not decode to a 1080p image")
        check(not np.allclose(r.camera.position, pos0) and not np.allclose(r.camera.forward, fwd0),
              "viewer: the camera did not move and turn")
        check(abs(r.config.tonemap_exposure - (exposure0 + 0.2)) < 1e-9,
              f"viewer: tonemap_exposure {r.config.tonemap_exposure}, expected {exposure0} + 0.2")
        check(r.settings.enable_cas != cas0, "viewer: '3' did not toggle CAS")
        check(text.count("\x1b[H") == 4 and "fps" in text, "viewer: terminal frames missing")
        torch.cuda.synchronize()
        _cuda.reset_launches()
        n, secs_run, text = session([[]] * FRAMES + [["x"]], shot)
        launches = dict(_cuda.LAUNCHES)
    check(n == FRAMES, f"viewer: {n} frames, expected {FRAMES}")
    for name in MC_KERNELS:
        check(launches[name] > 0, f"viewer: kernel {name} was not launched")
    rep = {"scripted_frames": frames, "scripted_s": secs, "frames": n,
           "ms_per_frame": 1e3 * secs_run / n, "launches": launches,
           "camera_moved": float(np.linalg.norm(np.array(r.camera.position) - pos0)),
           "ansi_chars": len(text)}
    log("viewer", f"scripted session (move, yaw, slider, CAS toggle, screenshot, quit): 4 frames "
                  f"in {secs:.2f} s, camera moved {rep['camera_moved']:.3f}, {WIDTH}x{HEIGHT} "
                  f"PNG; "
                  f"{n} frames with no key: {rep['ms_per_frame']:.2f} ms per viewer frame "
                  f"(frame, read-back, overlays, {len(text) // n} ANSI chars a frame); launches "
                  f"{ {k: v for k, v in launches.items() if v} } (on {smi})")
    return rep


def device_busy(trace_path) -> dict:
    """From a ``torch.profiler`` Chrome trace: the device rows' busy time
    (the union of their intervals), the span from the first row's start to
    the last row's end, and the busy share of that span."""
    from unclerenderer_tpu_torch.core import traceparse

    rows = sorted((e["ts"], e["ts"] + e.get("dur", 0.0))
                  for e in traceparse.load_events(trace_path)
                  if e.get("cat") in traceparse.DEVICE_CATS)
    check(rows, "the profiler recorded no device row")
    busy, end = 0.0, rows[0][0]
    for a, b in rows:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = end - rows[0][0]
    return {"rows": len(rows), "busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "busy_share": busy / span if span else 0.0}


def program_phase(dev, smi, scene: Path, label: str = "program") -> dict:
    """Phase 15: the frame program (``render/program.py``) on the renderer
    cell's files at 1920x1080 with the 4096^2 map.  (a) no host sync: one
    op-by-op deferred frame, one forward frame and one ``raster_shadow``
    under ``torch.cuda.set_sync_debug_mode("error")``; (b) graph = eager:
    10 carried frames on the orbit as replays and again op by op
    (``program.eager``) from one start state, every output and every state
    field bit-equal, the forward Renderer over 3 frames the same way, and
    ``render_frames(10)`` against the 10 op-by-op frames; (c) the same
    launch counts over the 10 frames; (d) recorded, not gated: ms/frame
    graph and op by op in turns (3 pairs of 10 frames), host ms a
    ``render_frame`` call, the profiler's device-busy share over 3 frames
    of each, capture seconds, graph pool GiB and peak GiB.  On a scene with
    masked models (phase 16, ``label`` "masked-program") the Renderers
    turn the masked raster on, and each replay launches M1 twice (its two
    levels)."""
    from unclerenderer_tpu_torch.ops import _cuda
    from unclerenderer_tpu_torch.render import common as common_mod
    from unclerenderer_tpu_torch.render import program
    from unclerenderer_tpu_torch.render.deferred import deferred_frame
    from unclerenderer_tpu_torch.render.forward import forward_frame
    from unclerenderer_tpu_torch.render.params import FrameState, RenderSettings
    from unclerenderer_tpu_torch.render.renderer import Renderer

    t_phase = time.perf_counter()
    rep = {}
    settings = RenderSettings(width=WIDTH, height=HEIGHT, shadow_map_size=SHADOW)
    r = Renderer(scene, settings=settings, device=dev)
    f = Renderer(scene, settings=dataclasses.replace(settings, renderer_type="forward"),
                 device=dev)
    center = np.asarray(r.scene_data.scene_center, np.float32)
    cam0 = np.asarray(r.camera.position, np.float32)

    def orbit(rr, i=0):
        a = 0.0035 * rr._frame_counter
        off = cam0 - center
        rr.camera.position = center + np.array(
            [off[0] * np.cos(a) - off[2] * np.sin(a), off[1], off[0] * np.sin(a) + off[2] * np.cos(a)],
            np.float32)
        rr.camera.set_look_at(center)

    # the warm-up frame (op by op: the kernels build), then the capture
    for rr in (r, f):
        orbit(rr)
        rr.render_frame()
        check(rr.frame_program.startswith("eager: warm-up"), f"first frame: {rr.frame_program}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for rr in (r, f):
        orbit(rr)
        rr.render_frame()
        check(rr.frame_program == "graph" and rr.stats()["frame_program"] == "graph",
              f"second frame: {rr.frame_program}")
    progs = {"deferred": r._program, "forward": f._program}
    masked = r.settings.has_masked_models
    check(masked == f.settings.has_masked_models, "the two Renderers' masked settings differ")
    if masked:
        for k, p in progs.items():
            check(p.launches["masked_raster"] == 2,
                  f"{label}: a {k} replay launches M1 {p.launches['masked_raster']} times, "
                  "expected 2 (levels 1 and 2)")
    rep["capture"] = {k: {"capture_s": p.capture_s, "pool_gib": p.pool_bytes / 2**30,
                          "launches": dict(p.launches)} for k, p in progs.items()}
    rep["masked"] = masked
    rep["masked_tri_cap"] = r.settings.masked_tri_cap
    log(label, f"captured: " + "; ".join(
        f"{k} {p.capture_s:.2f} s, pool {p.pool_bytes / 2**30:.2f} GiB, launches a replay "
        f"{ {n: c for n, c in p.launches.items() if c} }" for k, p in progs.items()))

    # (a) no host sync in the frames the programs capture
    params = r.frame_params()
    state = FrameState(**{fl.name: getattr(r.frame_state, fl.name).clone()
                          for fl in dataclasses.fields(FrameState)})
    opaque, masked = common_mod.tri_draw_masks(r.device_scene, params.model_visible, r.settings)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        deferred_frame(r.device_scene, params, state, r.settings, r._shadow_cache)
        forward_frame(f.device_scene, params, f.settings, f._shadow_cache)
        common_mod.raster_shadow(r.device_scene, params.light_view_proj, opaque | masked,
                                 r.settings)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(label, "no host sync (sync debug mode \"error\") in an op-by-op deferred frame, a "
                   "forward frame and raster_shadow at 1080p with the 4096^2 map")
    del state

    # (b) graph = eager over carried frames, (c) the same launches
    def snapshot(rr):
        st = FrameState(**{fl.name: getattr(rr.frame_state, fl.name).clone()
                           for fl in dataclasses.fields(FrameState)})
        return (st, rr._frame_counter, rr._taa_history_ready, np.array(rr.camera.position),
                np.array(rr.camera.forward), np.array(rr.camera.up))

    def restore(rr, snap):
        rr.frame_state = snap[0]
        rr._frame_counter, rr._taa_history_ready = snap[1], snap[2]
        rr.camera.position, rr.camera.forward, rr.camera.up = (x.copy() for x in snap[3:])

    def frames(rr, n, eager):
        outs, states = [], []
        torch.cuda.synchronize()
        _cuda.reset_launches()
        with program.eager() if eager else contextlib.nullcontext():
            for _ in range(n):
                orbit(rr)
                outs.append(rr.render_frame())
                states.append(snapshot(rr)[0])
        torch.cuda.synchronize()
        want = "eager: inside program.eager()" if eager else "graph"
        check(rr.frame_program == want, f"frames ran as {rr.frame_program}, expected {want}")
        return outs, states, {k: v for k, v in _cuda.LAUNCHES.items() if v}

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.uint32 else x

    def differences(a, b):
        """{name: differing elements} over two frames' outputs (or states)."""
        diff = {}
        for k in a:
            if isinstance(a[k], dict):
                diff.update({f"{k}.{n}": int(v != b[k][n]) for n, v in a[k].items()})
            else:
                diff[k] = int((bits(a[k]) != bits(b[k])).sum())
        return {k: v for k, v in diff.items() if v}

    def hold(label, ga, ea, gs=None, es=None):
        for i, (g, e) in enumerate(zip(ga, ea)):
            check(set(g) == set(e), f"{label} frame {i}: outputs {set(g)} vs {set(e)}")
            bad = differences(g, e)
            if gs is not None:
                bad.update(differences(dataclasses.asdict(gs[i]), dataclasses.asdict(es[i])))
            check(not bad, f"{label} frame {i}: graph and op-by-op frames differ in {bad}")

    start = snapshot(r)
    g_outs, g_states, g_launch = frames(r, FRAMES, eager=False)
    restore(r, start)
    e_outs, e_states, e_launch = frames(r, FRAMES, eager=True)
    hold("deferred", g_outs, e_outs, g_states, e_states)
    check(g_launch == e_launch, f"launches over {FRAMES} frames: graph {g_launch}, eager {e_launch}")
    rep["launches"] = {"graph": g_launch, "eager": e_launch}
    log(label, f"{FRAMES} carried deferred frames on the orbit, replayed and op by op from one "
                   f"start state: every output ({sorted(g_outs[0])}) and every state field "
                   f"bit-equal; launches the same: {g_launch}")
    del g_outs, g_states

    f_start = snapshot(f)
    fg, _s, fg_launch = frames(f, 3, eager=False)
    restore(f, f_start)
    fe, _s, fe_launch = frames(f, 3, eager=True)
    hold("forward", fg, fe)
    check(fg_launch == fe_launch, f"forward launches: graph {fg_launch}, eager {fe_launch}")
    log(label, f"3 forward frames replayed and op by op: every output bit-equal, launches "
                   f"the same ({fg_launch})")
    del fg, fe

    restore(r, start)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    colors = r.render_frames(FRAMES, mutate=orbit)
    torch.cuda.synchronize()
    chain_launch = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    check(r.frame_program == "graph", f"render_frames ran as {r.frame_program}")
    bad = {i: int((colors[i] != e["color"]).sum()) for i, e in enumerate(e_outs)}
    bad = {i: n for i, n in bad.items() if n}
    bad.update(differences(dataclasses.asdict(r.frame_state), dataclasses.asdict(e_states[-1])))
    check(not bad, f"render_frames({FRAMES}) vs {FRAMES} op-by-op frames differ: {bad}")
    check(chain_launch == e_launch, f"render_frames launches {chain_launch}, eager {e_launch}")
    drops = {k: int(v) for k, v in r._chain_drop_counters.items()}
    check(not any(drops.values()), f"render_frames drop counters {drops}")
    log(label, f"render_frames({FRAMES}) replayed: colours and final state bit-equal to the "
                   f"{FRAMES} op-by-op frames, launches the same, worst-frame drops {drops}")
    del colors, e_outs, e_states

    # (d) times, in turns; host ms a call; peak
    def timed(eager):
        torch.cuda.synchronize()
        host = 0.0
        t0 = time.perf_counter()
        with program.eager() if eager else contextlib.nullcontext():
            for _ in range(FRAMES):
                orbit(r)
                h0 = time.perf_counter()
                r.render_frame()
                host += time.perf_counter() - h0
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / FRAMES, host * 1e3 / FRAMES

    runs = {"graph": [], "eager": []}
    host = {"graph": [], "eager": []}
    for which in ("graph", "eager", "eager", "graph", "graph", "eager"):
        ms, h = timed(which == "eager")
        runs[which].append(ms)
        host[which].append(h)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = {k: statistics.median(v) for k, v in runs.items()}
    med_host = {k: statistics.median(v) for k, v in host.items()}
    rep.update(ms_per_frame=runs, median_ms=med, host_ms_per_call=host,
               median_host_ms=med_host, peak_gib=peak)
    log(label, f"ms/frame median: graph {med['graph']:.2f} (runs "
                   f"{[round(x, 2) for x in runs['graph']]}), op by op {med['eager']:.2f} (runs "
                   f"{[round(x, 2) for x in runs['eager']]}); host ms a render_frame call: graph "
                   f"{med_host['graph']:.3f}, op by op {med_host['eager']:.3f}; 3 runs x "
                   f"{FRAMES} frames each in turns, {WIDTH}x{HEIGHT}, shadow {SHADOW}^2; peak "
                   f"{peak:.2f} GiB since the capture (on {smi})")

    from torch.profiler import ProfilerActivity, profile

    rep["busy"] = {}
    for which in ("graph", "eager"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_busy_") as td:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                    (program.eager() if which == "eager" else contextlib.nullcontext()):
                for _ in range(3):
                    orbit(r)
                    r.render_frame()
                torch.cuda.synchronize()
            path = Path(td) / "busy.pt.trace.json"
            prof.export_chrome_trace(str(path))
            rep["busy"][which] = device_busy(path)
    log(label, "device-busy share over 3 frames (profiler rows' union over their span): " +
        "; ".join(f"{k} {100 * v['busy_share']:.1f}% ({v['busy_ms'] / 3:.2f} of "
                  f"{v['span_ms'] / 3:.2f} ms a frame, {v['rows']} rows)"
                  for k, v in rep["busy"].items()) + f" (on {smi})")
    rep["seconds"] = time.perf_counter() - t_phase
    log(label, f"phase done in {rep['seconds']:.1f} s")
    del r, f
    return rep


def multichip_rank(rank, group, spec):
    """One rank of phase 13 (``parallel/multichip.py run_ranks``; a child
    process on ``cuda:0``): the sharded frames of ``spec`` with the launch
    counts set to 0 just before and read just after, their slabs gathered
    on rank 0; on ``spec["record_rank"]`` (whose ``row0`` is not 0) every
    K1, K2, K4 and K5 call of one more sharded frame held bit for bit to its
    plain version (``hold_calls``); on rank 0 the single-device frames from
    the same state, tri_id, depth, ids, counters and HZB bit-equal, colour
    within ``SEAM_ATOL`` (seam rows too); with ``spec["turns"]`` ms/frame
    sharded and single-device in turns.  Returns this rank's report."""
    import torch.distributed as dist

    from unclerenderer_tpu_torch.ops import _cuda
    from unclerenderer_tpu_torch.parallel.dist import RowShards
    from unclerenderer_tpu_torch.parallel.multichip import (
        gather_frame,
        render_frame_multichip,
        slab_state,
    )
    from unclerenderer_tpu_torch.render.deferred import deferred_frame
    from unclerenderer_tpu_torch.render.params import FrameState, RenderSettings
    from unclerenderer_tpu_torch.render.testing import synthetic_device_scene, synthetic_frame_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(spec["device"])
    settings = RenderSettings(**spec["settings"])
    w, h = settings.width, settings.height
    t0 = time.perf_counter()
    scene, data = synthetic_device_scene(**spec["scene"], device=dev)
    params = [synthetic_frame_params(data, w, h, camera_pos=c, device=dev)
              for c in spec["cameras"]]
    rows = RowShards(group, h)
    rep = {"rank": rank, "row0": rows.row0, "slab_h": rows.slab_h,
           "backend": dist.get_backend(group), "scene_s": time.perf_counter() - t0}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def sharded_run(keep):
        state = slab_state(FrameState.initial(w, h, dev), settings, group)
        got = []
        for p in params:
            out, state = render_frame_multichip(scene, p, state, settings, group)
            if keep:
                full = gather_frame({**out, "taa_history": state.taa_history}, settings, group,
                                    keys=("color", "hdr", "depth", "tri_id", "object_id",
                                          "taa_history"))
                if full is not None:
                    got.append((full, state.exposure_ev, state.hzb))
        return got

    # the counted run
    sync()
    dist.barrier(group)
    _cuda.reset_launches()
    got = sharded_run(keep=True)
    sync()
    rep["launches"] = dict(_cuda.LAUNCHES)

    # every K1/K2/K4/K5 call of one sharded frame on the recording rank
    targets = kernel_targets(MC_KERNELS)
    record = rank == spec["record_rank"]
    with contextlib.ExitStack() as stack:
        recs = ({n: stack.enter_context(Recorder(m, a)) for n, (m, a, _r) in targets.items()}
                if record else {})
        render_frame_multichip(scene, params[0], slab_state(FrameState.initial(w, h, dev),
                                                            settings, group),
                               settings, group)
        sync()
    if record:
        check(rows.row0 > 0, "the recording rank must own a slab below the first")
        rep["held"], rep["y_offsets"] = hold_calls(f"rank {rank}", recs, targets)
        check(any(y > 0 for ys in rep["y_offsets"].values() for y in ys),
              f"rank {rank}: no raster call at a non-zero y_offset")

    # the single-device frames on rank 0 against the gathered slabs
    if rank == 0:
        state = FrameState.initial(w, h, dev)
        rep["color_err"], rep["seam_err"], rep["ev_err"] = 0.0, 0.0, 0.0
        for i, (p, (full, ev, hzb)) in enumerate(zip(params, got)):
            out, state = deferred_frame(scene, p, state, settings)
            for k in ("tri_id", "depth"):
                ne = (full[k] != out[k]).nonzero()
                check(ne.numel() == 0,
                      f"sharded frame {i}: {k} differs at {ne.shape[0]} pixels, rows "
                      f"{ne[:, 0].unique()[:40].tolist()}, first {ne[:8].tolist()}: sharded "
                      f"{full[k][ne[:8, 0], ne[:8, 1]].tolist()} single "
                      f"{out[k][ne[:8, 0], ne[:8, 1]].tolist()}; counters sharded "
                      f"{ {c: int(v) for c, v in full['raster_stats'].items()} } single "
                      f"{ {c: int(v) for c, v in out['raster_stats'].items()} }")
            check(torch.equal(full["object_id"].view(torch.int32),
                              out["object_id"].view(torch.int32)), f"sharded frame {i}: object_id")
            check({k: int(v) for k, v in full["raster_stats"].items()}
                  == {k: int(v) for k, v in out["raster_stats"].items()},
                  f"sharded frame {i}: counters {full['raster_stats']} vs {out['raster_stats']}")
            check(torch.equal(hzb, state.hzb), f"sharded frame {i}: HZB differs")
            diff = (full["color"] - out["color"]).abs()
            seams = torch.cat([diff[s * rows.slab_h - 1:s * rows.slab_h + 1]
                               for s in range(1, rows.n_dev)])
            rep["color_err"] = max(rep["color_err"], float(diff.max()))
            rep["seam_err"] = max(rep["seam_err"], float(seams.max()))
            rep["ev_err"] = max(rep["ev_err"], abs(float(ev) - float(state.exposure_ev)))
            check(rep["color_err"] <= SEAM_ATOL and rep["seam_err"] <= SEAM_ATOL,
                  f"sharded frame {i}: colour err {rep['color_err']}, seams {rep['seam_err']}")
            check(bool(torch.isfinite(full["color"]).all()), f"sharded frame {i}: colour")
        rep["covered"] = int((got[-1][0]["tri_id"] >= 0).sum())
    del got
    dist.barrier(group)

    if spec["turns"]:
        runs = {"multi": [], "single": []}
        for which in ("multi", "single", "single", "multi", "multi", "single"):
            sync()
            dist.barrier(group)
            t0 = time.perf_counter()
            if which == "multi":
                sharded_run(keep=False)
                sync()
                dist.barrier(group)
            elif rank == 0:
                state = FrameState.initial(w, h, dev)
                for p in params:
                    _out, state = deferred_frame(scene, p, state, settings)
                sync()
            runs[which].append(1e3 * (time.perf_counter() - t0) / len(params))
        rep["ms_per_frame"] = runs
    if dev.type == "cuda":
        rep["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return rep


def multichip_phase(smi) -> dict:
    """Phase 13: the row-sharded frame (``parallel/multichip.py``), every
    rank a child process on ``cuda:0`` over gloo (the kernels already
    built, so no rank builds them): (a) the MULTICHIP_r05 contract, 8 ranks
    at 64x128 with a 128^2 shadow map, every feature on, 4 frames with
    camera motion; (b) 2 ranks at 1920x1080 with the 4096^2 map on the
    headline geometry, 4 frames, then ms/frame against the single-device
    frame in turns (two ranks share one card: a smoke of the slab path,
    not a speed claim)."""
    from unclerenderer_tpu_torch.ops import _cuda
    from unclerenderer_tpu_torch.parallel.multichip import run_ranks

    check(_cuda.build()[1] == 0.0, "multichip: the kernels must be built before the ranks start")
    torch.cuda.empty_cache()
    contract = dict(width=64, height=128, shadow_map_size=128, enable_ibl=True, enable_hzb=True,
                    enable_taa=True, enable_cas=True, enable_auto_exposure=True,
                    has_masked_models=True, tile_h=8, tile_w=64, chunk=64, shadow_chunk=64)
    orbit = [(0.0, 1.5, -4.0)] + [(4.0 * np.sin(0.12 * f), 1.5, -4.0 * np.cos(0.12 * f))
                                  for f in range(1, 4)]
    cells = {
        "contract": (8, dict(device="cuda:0", settings=contract,
                             scene=dict(n_objects=8, with_masked=True), cameras=orbit,
                             record_rank=5, turns=False), 300.0),
        "full": (2, dict(device="cuda:0",
                         settings=dict(width=WIDTH, height=HEIGHT, shadow_map_size=SHADOW,
                                       has_masked_models=False, combined_material=True),
                         scene=dict(n_objects=N_OBJECTS, sphere_res=SPHERE_RES, ground=True,
                                    rich_materials=True, atlas_u8=True),
                         cameras=[(4.0 * np.sin(0.0035 * i), 1.5, -4.0 * np.cos(0.0035 * i))
                                  for i in range(4)],
                         record_rank=1, turns=True), 900.0),
    }
    rep = {}
    for cell, (n, spec, limit) in cells.items():
        with tempfile.TemporaryDirectory(prefix="chip_smoke_rendezvous_") as d:
            t0 = time.perf_counter()
            ranks = run_ranks(multichip_rank, n, f"file://{d}/rendezvous", args=(spec,),
                              device="cuda:0", timeout=limit)
            secs = time.perf_counter() - t0
        r0, rec = ranks[0], ranks[spec["record_rank"]]
        check(all(r["backend"] == "gloo" for r in ranks), "multichip: ranks not on gloo")
        for r in ranks:
            for name in MC_KERNELS:
                check(r["launches"][name] > 0, f"multichip {cell}: rank {r['rank']} launched no "
                                               f"{name}")
        s = spec["settings"]
        log("multichip", f"{cell}: {n} ranks on one card over gloo, {s['width']}x{s['height']}, "
                         f"shadow {s['shadow_map_size']}^2, {len(spec['cameras'])} frames in "
                         f"{secs:.1f} s: tri_id, depth, ids, counters, HZB bit-equal to the "
                         f"single-device frames, colour err {r0['color_err']:.3g} (seam rows "
                         f"{r0['seam_err']:.3g}), exposure err {r0['ev_err']:.3g}, "
                         f"{r0['covered']} px covered; rank {rec['rank']} (row0 {rec['row0']}) "
                         f"held {rec['held']} K1/K2/K4/K5 calls bit-equal to plain at y_offsets "
                         f"{rec['y_offsets']}")
        log("multichip", f"{cell}: launches per rank "
                         f"{[{k: v for k, v in r['launches'].items() if v} for r in ranks]}")
        rep[cell] = {"ranks": n, "seconds": secs, "per_rank": ranks}
        if spec["turns"]:
            med = {k: statistics.median(v) for k, v in r0["ms_per_frame"].items()}
            rep[cell]["median_ms"] = med
            log("multichip", f"{cell}: ms/frame median sharded {med['multi']:.2f} (runs "
                             f"{[round(x, 2) for x in r0['ms_per_frame']['multi']]}) against "
                             f"single-device {med['single']:.2f} (runs "
                             f"{[round(x, 2) for x in r0['ms_per_frame']['single']]}), "
                             f"{len(spec['cameras'])} frames a run in turns; peak GiB per rank "
                             f"{[round(r['peak_gib'], 2) for r in ranks]} (on {smi})")
    return rep


def entry_dryrun_rank(rank, group, spec) -> dict:
    """A rank of phase 17's dry run (``graft_entry.dryrun_multichip``'s
    ``rank_fn``): ``graft_entry._dryrun_rank``; on ``ENTRY_RECORD_RANK``
    every X1 and M1 call of its frames recorded, then, after its counted
    run, held bit for bit to its plain version at its ``y_offset``."""
    from unclerenderer_tpu_torch import graft_entry
    from unclerenderer_tpu_torch.parallel.dist import RowShards

    if rank != ENTRY_RECORD_RANK:
        return graft_entry._dryrun_rank(rank, group, spec)
    targets = kernel_targets(DRYRUN_KERNELS)
    with contextlib.ExitStack() as stack:
        recs = {n: stack.enter_context(Recorder(m, a)) for n, (m, a, _r) in targets.items()}
        rep = graft_entry._dryrun_rank(rank, group, spec)
    rep["row0"] = RowShards(group, spec["settings"]["height"]).row0
    check(rep["row0"] > 0, "the recording rank must own a slab below the first")
    rep["held"], rep["y_offsets"] = hold_calls(f"rank {rank}", recs, targets)
    return rep


def entry_phase(smi) -> dict:
    """Phase 17: the port's graft entry (``unclerenderer_tpu_torch/
    graft_entry.py``), the kernels built already: ``entry()`` and
    ``compile_check`` (the 128^2 frame captured as a CUDA graph with no
    host sync, replayed, bit-equal to op by op), counted from 0 over the
    check, K1, K2, K4, K5 and M1 launched in the graph; every kernel call
    of the check's first op-by-op frame recorded and held bit for bit to
    its plain version; ``dryrun_multichip(8)`` (8 gloo ranks on this card,
    ``raster_backend="xla"``, 4 carried frames against the single-device
    frame), each rank counted (X1 and M1 launched, none of K1-K9), and on
    rank 5 (``row0`` 80) every X1 and M1 call of its frames held bit for
    bit to its plain version at its ``y_offset`` (``entry_dryrun_rank``).
    Logs each part's seconds."""
    from unclerenderer_tpu_torch import graft_entry
    from unclerenderer_tpu_torch.ops import _cuda

    check(_cuda.build()[1] == 0.0, "entry: the kernels must be built before the phase")
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    rep = {"entry_s": time.perf_counter() - t0}

    targets, recs = kernel_targets(ENTRY_KERNELS), {}

    def recorded(*a):
        """``fn``; its first call (the check's first op-by-op frame) with
        every kernel call recorded."""
        if recs:
            return fn(*a)
        with contextlib.ExitStack() as stack:
            recs.update({n: stack.enter_context(Recorder(m, at))
                         for n, (m, at, _r) in targets.items()})
            return fn(*a)

    recorded.settings = fn.settings
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    got = graft_entry.compile_check(recorded, args)
    torch.cuda.synchronize()
    rep["compile_check_s"] = time.perf_counter() - t0
    rep["launches"] = dict(_cuda.LAUNCHES)
    rep.update(capture_s=got["capture_s"], graph_launches=got["launches"],
               pool_bytes=got["pool_bytes"], shape=list(got["shape"]))
    check(got["shape"] == (128, 128, 3), f"entry: colour of shape {got['shape']}")
    for name in ENTRY_KERNELS:
        check(got["launches"].get(name, 0) > 0, f"entry: the captured frame launches no {name}")
    rep["held"], _y = hold_calls("entry", recs, targets)
    log("entry", f"entry() in {rep['entry_s']:.2f} s; compile_check in "
                 f"{rep['compile_check_s']:.2f} s: entry OK {tuple(got['shape'])}, captured in "
                 f"{got['capture_s']:.3f} s with no host sync, pool "
                 f"{got['pool_bytes'] / 2**20:.1f} MiB, launches a replay {got['launches']}; "
                 "the replay bit-equal to op by op (colour and every state field); launches "
                 f"over the check (2 op-by-op frames, 1 replay) "
                 f"{ {k: v for k, v in rep['launches'].items() if v} }; the first op-by-op "
                 f"frame's {rep['held']} calls bit-equal to their plain versions")
    del fn, args, got, recs
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(8, rank_fn=entry_dryrun_rank)
    rep["dryrun"] = dry
    for r, rank in enumerate(dry["per_rank"]):
        for name in DRYRUN_KERNELS:
            check(rank["launches"][name] > 0, f"entry: dry-run rank {r} launched no {name}")
        check(not any(rank["launches"][n] for n in MC_KERNELS),
              f"entry: dry-run rank {r} launched a kernel-path kernel on the xla backend")
    rec = dry["per_rank"][ENTRY_RECORD_RANK]
    for name in DRYRUN_KERNELS:
        check(any(y > 0 for y in rec["y_offsets"][name]),
              f"entry: rank {ENTRY_RECORD_RANK} made no {name} call at a non-zero y_offset")
    rep["dryrun_s"] = time.perf_counter() - t0
    log("entry", f"dryrun_multichip(8) in {rep['dryrun_s']:.1f} s (ranks "
                 f"{dry['ranks_s']:.1f} s): 8 ranks on one card over gloo, 64x128, xla, "
                 f"{dry['frames']} frames: tri_id bit-equal, colour err {dry['color_err']:.3g} "
                 f"(seam rows {dry['seam_err']:.3g}), exposure err {dry['ev_err']:.3g}; rank "
                 f"{ENTRY_RECORD_RANK} (row0 {rec['row0']}) held {rec['held']} X1/M1 calls bit "
                 f"for bit to their plain versions at y_offsets {rec['y_offsets']}; launches per "
                 f"rank {[{k: v for k, v in r['launches'].items() if v} for r in dry['per_rank']]}")
    rep["seconds"] = time.perf_counter() - t_phase
    log("entry", f"phase done in {rep['seconds']:.1f} s")
    return rep


HEADLINE_TRIANGLES = 263184  # N_OBJECTS spheres and cubes at SPHERE_RES, and the ground
BENCH_ROWS = ("shadow2048", "bilinear", "anisotropic", "sponza_faithful")
BENCH_TIMEOUT = 600  # seconds for the bench child (it took 51 s on an H100 at 700 W)
# the bench rows whose kernel inputs no earlier phase gives: the half-size
# map, and the faithful row's mid-level budget (its geometry: the sphere
# tier without Sponza's glTF)
BENCH_HELD_ROWS = (("shadow2048", dict(shadow_map_size=SHADOW // 2), "procedural"),
                   ("sponza_faithful", dict(bin_mid_divisor=4), "sponza"))


def bench_rows_held(dev) -> dict:
    """Frame 0 of each of ``BENCH_HELD_ROWS``, rendered op by op on the
    bench's own inputs (``bench._synthetic_scene`` at its defaults), with
    every K1, K2, K4 and K5 call recorded and held bit for bit to its plain
    version (``hold_calls``).  Returns {row: {kernel: calls held}}."""
    from unclerenderer_tpu_torch import bench
    from unclerenderer_tpu_torch.render.deferred import deferred_frame
    from unclerenderer_tpu_torch.render.params import FrameState, RenderSettings

    base = RenderSettings(width=WIDTH, height=HEIGHT, renderer_type="deferred",
                          shadow_map_size=SHADOW, raster_backend="auto")
    targets, held = kernel_targets(MC_KERNELS), {}
    for name, change, geometry in BENCH_HELD_ROWS:
        scene, _data, settings, params_at = bench._synthetic_scene(
            dataclasses.replace(base, **change), N_OBJECTS, SPHERE_RES, True,
            geometry=geometry, device=dev)
        with contextlib.ExitStack() as stack:
            recs = {n: stack.enter_context(Recorder(m, at)) for n, (m, at, _r) in targets.items()}
            out, _state = deferred_frame(scene, to_device(params_at(0), dev),
                                         FrameState.initial(WIDTH, HEIGHT, dev), settings)
        check(bool(torch.isfinite(out["color"]).all()), f"bench {name}: non-finite colour")
        held[name], _y = hold_calls(f"bench {name}", recs, targets)
        del scene, out, recs
        gc_collect_cuda()
    return held


def bench_phase(smi, program_ms: float) -> dict:
    """Phase 18: the port's bench (``python -m unclerenderer_tpu_torch.bench``)
    as a child process at its defaults, the judged configuration (no
    ``BENCH_*`` override passed on), the kernels built already.  Gates: exit
    0; the last stdout line parses; ``value`` finite and > 0; 263,184
    triangles and the 4096^2 map; both parity gates true; the headline's
    drop counters all 0; every row's ``*_ms`` finite and no ``*_error``;
    from the child's launch line, K1, K2, K4 and K5 at least once a
    headline replay -- K1 and K2 at least twice, the map's raster in every
    frame (a cached map would launch K2 once a frame) -- and X1 in the
    gates.  Before the child, frame 0 of the two rows whose kernel inputs
    no earlier phase gives (``BENCH_HELD_ROWS``: the 2048^2 map, and
    ``bin_mid_divisor=4``) is rendered op by op on the bench's inputs and
    every K1, K2, K4 and K5 call held bit for bit to its plain version
    (``bench_rows_held``).  Logs the headline beside phase 15's replayed
    default Renderer (``program_ms``, whose map is cached): the difference
    is the map's cost a frame (not gated)."""
    import os
    import subprocess

    from unclerenderer_tpu_torch.bench import LAUNCH_TAG, METRIC
    from unclerenderer_tpu_torch.ops import _cuda

    check(_cuda.build()[1] == 0.0, "bench: the kernels must be built before the phase")
    t0 = time.perf_counter()
    held = bench_rows_held(torch.device("cuda"))
    rep = {"held": held, "held_s": time.perf_counter() - t0}
    log("bench", f"frame 0 of the rows {[n for n, _c, _g in BENCH_HELD_ROWS]} op by op at "
                 f"{WIDTH}x{HEIGHT} on the bench's inputs ("
                 + ", ".join(f"{n} {c}" for n, c, _g in BENCH_HELD_ROWS)
                 + f"): {held} K1/K2/K4/K5 calls bit-equal to their plain versions in "
                 f"{rep['held_s']:.1f} s")
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "unclerenderer_tpu_torch.bench"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT)
    rep.update(seconds=time.perf_counter() - t0, rc=res.returncode)
    check(res.returncode == 0, f"bench: exit {res.returncode}; stderr tail: {res.stderr[-3000:]}")
    lines = res.stdout.strip().splitlines()
    check(lines, "bench: no stdout")
    try:
        line = json.loads(lines[-1])
    except json.JSONDecodeError as e:
        raise SystemExit(f"chip_smoke: bench: the last stdout line does not parse ({e}): "
                         f"{lines[-1][:500]}")
    rep["line"] = line
    value = line.get("value")
    check(line.get("metric") == METRIC, f"bench: metric {line.get('metric')}")
    check(isinstance(value, (int, float)) and np.isfinite(value) and value > 0,
          f"bench: value {value}")
    check(line.get("triangles") == HEADLINE_TRIANGLES, f"bench: {line.get('triangles')} triangles")
    check(line.get("shadow_map_size") == SHADOW, f"bench: map {line.get('shadow_map_size')}")
    check(line.get("pallas_parity") is True and line.get("frame_parity") is True,
          f"bench: parity gates {line.get('pallas_parity')}, {line.get('frame_parity')}")
    drops = line.get("drop_counters")
    check(drops and not any(drops.values()) and line.get("dropped_work") is False,
          f"bench: headline drop counters {drops}")
    errors = [k for k in line if k.endswith("_error")]
    check(not errors, f"bench: {errors} in the line")
    for name in BENCH_ROWS:
        ms = line.get(f"{name}_ms")
        check(isinstance(ms, (int, float)) and np.isfinite(ms) and ms > 0,
              f"bench: row {name} ms {ms}")
    tagged = [ln for ln in res.stderr.splitlines() if ln.startswith(LAUNCH_TAG + " ")]
    check(len(tagged) == 1, f"bench: {len(tagged)} launch lines on stderr")
    launches = json.loads(tagged[0][len(LAUNCH_TAG) + 1:])
    rep["launches"] = launches
    frames, head = launches["headline_frames"], launches["headline"]
    check(frames > 0, "bench: no headline replay counted")
    for name in MC_KERNELS:
        check(head.get(name, 0) >= frames, f"bench: {name} launched {head.get(name, 0)} times "
                                           f"in {frames} headline replays")
    for name in ("binned_raster", "giant_raster"):
        check(head.get(name, 0) >= 2 * frames,
              f"bench: {name} launched {head.get(name, 0)} times in {frames} replays: the "
              "map is not rasterized in every frame")
    check(not head.get("exhaustive_raster"), "bench: the headline launched X1")
    check(launches["gates"].get("exhaustive_raster", 0) > 0, "bench: the gates launched no X1")
    rep["program_ms"] = program_ms
    log("bench", f"python -m unclerenderer_tpu_torch.bench: exit 0 in {rep['seconds']:.1f} s; "
                 f"headline {value} ms/frame (runs {line['value_runs']}), {line['triangles']} "
                 f"triangles, map {line['shadow_map_size']}^2 rasterized in every replay; rows "
                 + ", ".join(f"{n} {line[n + '_ms']}" for n in BENCH_ROWS)
                 + f"; gates {line['pallas_parity']}, {line['frame_parity']} (launches "
                 f"{launches['gates']}); {frames} headline replays launched {head}; setup "
                 f"{line['setup_and_compile_s']} s, kernel build {line['kernel_build_s']} s; "
                 f"phase 15's replayed Renderer (cached map) {program_ms:.2f} ms/frame, so the "
                 f"map costs {value - program_ms:.2f} ms a frame (separate processes; on {smi})")
    return rep


def gc_collect_cuda() -> None:
    """Free what this process no longer holds, so that a child process
    has the card's memory."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def k1_debug_child(out: Path) -> int:
    """The debug phase's child process (``--k1-debug-child``): device printf
    writes to this process's fd 1, which the parent reads.  Grows the printf
    FIFO before any CUDA work, renders one 256x256 deferred frame with
    ``kernel_debug_print`` (its K1 launches print; nothing else writes to
    stdout); then a Renderer with the flag on a scene written to files: its
    warm-up frame, ``REPLAY_FRAMES`` frames replayed from the
    frame program and the same frames op by op from the same state, each
    frame's lines ended by a marker line (``=== <frame>``).  Then, with fd
    1 on /dev/null, holds each direct debug launch to the plain version,
    times it with and without the flag and the plain version, and writes
    to ``out``: the plain version's lines of the direct frame and of the
    op-by-op Renderer frames, the live blocks, the launches, the replays'
    mode, the times and the bound's bytes and operations."""
    import ctypes
    import io
    import os

    from unclerenderer_tpu_torch.ops import _cuda
    from unclerenderer_tpu_torch.ops import raster_kernels as rk
    from unclerenderer_tpu_torch.render import program
    from unclerenderer_tpu_torch.render.deferred import deferred_frame
    from unclerenderer_tpu_torch.render.params import FrameState, RenderSettings
    from unclerenderer_tpu_torch.render.renderer import Renderer
    from unclerenderer_tpu_torch.render.testing import (
        synthetic_device_scene,
        synthetic_frame_params,
        write_scene,
    )

    fifo = _cuda.printf_fifo(DEBUG_FIFO)
    dev = torch.device("cuda", 0)
    scene, data = synthetic_device_scene(24, rich_materials=True, atlas_u8=True, device=dev)
    settings = RenderSettings(width=256, height=256, shadow_map_size=512, has_masked_models=False,
                              combined_material=True, kernel_debug_print=True)
    params = synthetic_frame_params(data, 256, 256, device=dev)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    with Recorder(rk, "binned_raster") as r_direct:
        deferred_frame(scene, params, FrameState.initial(256, 256, dev), settings)
        torch.cuda.synchronize()  # flushes the device lines to fd 1
    launches = _cuda.LAUNCHES["binned_raster_debug"]
    libc = ctypes.CDLL(None)

    def mark(tag):
        """Ends a section of fd 1: the device lines so far flushed (the
        synchronize hands them to C's stdout, fflush writes them), then a
        marker line."""
        torch.cuda.synchronize()
        libc.fflush(None)
        sys.stdout.flush()
        print(f"=== {tag}", flush=True)

    mark("direct")
    # the Renderer's debug frames as program replays, then the same frames
    # op by op from the same state (a fixed camera: the cached map is not
    # re-rendered, so each frame prints its camera raster's fine level)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_debug_scene_") as td:
        r = Renderer(write_scene(td, 24, sphere_res=(12, 8), n_materials=3, tex_size=64),
                     settings=RenderSettings(width=256, height=256, shadow_map_size=512,
                                             kernel_debug_print=True), device=dev)
        r.render_frame()  # the warm-up frame, op by op
        mark("warm-up")
        start = (FrameState(**{f.name: getattr(r.frame_state, f.name).clone()
                               for f in dataclasses.fields(FrameState)}),
                 r._frame_counter, r._taa_history_ready)
        for i in range(REPLAY_FRAMES):
            r.render_frame()
            mark(f"graph {i}")
        replay_mode = r.frame_program
        r.frame_state = start[0]
        r._frame_counter, r._taa_history_ready = start[1], start[2]
        with program.eager(), Recorder(rk, "binned_raster") as rec:
            for i in range(REPLAY_FRAMES):
                r.render_frame()
                mark(f"eager {i}")
        del r
    sys.stdout.flush()
    null = os.open(os.devnull, os.O_WRONLY)
    os.dup2(null, 1)  # the measurements' own lines go nowhere
    replay_ref = []
    for ca, ck in (c for c in rec.calls if c[1].get("debug")):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rk.binned_raster_ref(*ca, **ck)
        replay_ref += text.getvalue().split("\n")[:-1]
    calls = [c for c in r_direct.calls if c[1].get("debug")]
    ref_lines, live, per_call = [], 0, []
    for ca, ck in calls:
        plain = functools.partial(rk.binned_raster_ref, *ca, **ck)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            want = plain()
        ref_lines += text.getvalue().split("\n")[:-1]
        live += int(ca[4].sum())
        bad, _ = compare(rk.binned_raster(*ca, **ck), want)
        check(bad == 0, f"binned_raster_debug != plain: {bad} elements")
        no_debug = {k: v for k, v in ck.items() if k != "debug"}
        ms_on, ms_off = in_turns(lambda: rk.binned_raster(*ca, **ck),
                                 lambda: rk.binned_raster(*ca, **no_debug),
                                 lambda fn: cuda_ms(fn, reps=20))
        moved, ops, *_pairs = work_binned(*ca, **ck)
        per_call.append({"shape": list(ca[0].shape), "tiles": int(ca[3].shape[0]),
                         "lines": int(ca[4].sum()), "ms": ms_on, "no_debug_ms": ms_off,
                         "graph_ms": graph_ms(lambda: rk.binned_raster(*ca, **ck), reps=10),
                         "plain_ms": cuda_ms(plain, reps=1), "bytes": moved, "ops": ops})
    out.write_text(json.dumps({"fifo_bytes": fifo, "launches": launches, "live_blocks": live,
                               "ref_lines": ref_lines, "calls": per_call,
                               "replay_mode": replay_mode, "replay_ref_lines": replay_ref}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", type=Path, default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--k1-debug-child", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.k1_debug_child is not None:
        return k1_debug_child(args.k1_debug_child)

    # ---- 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False -- needs one CUDA card")
    # every phase but the cache's builds its scenes cold and writes no cache
    import os

    os.environ["UNCLERENDERER_SCENE_CACHE"] = ""

    from unclerenderer_tpu_torch.ops import _cuda
    from unclerenderer_tpu_torch.ops import hzb as hzb_mod
    from unclerenderer_tpu_torch.ops import present as present_mod
    from unclerenderer_tpu_torch.ops import probes
    from unclerenderer_tpu_torch.ops import raster_kernels as rk
    from unclerenderer_tpu_torch.ops import shadow as shadow_mod
    from unclerenderer_tpu_torch.ops import texture as tex_mod
    from unclerenderer_tpu_torch.ops.binning import bin_triangles
    from unclerenderer_tpu_torch.ops.raster import DEPTH_MAX, DEPTH_MIN, normalize_ortho_setup
    from unclerenderer_tpu_torch.ops.raster import rasterize as rasterize_plain
    from unclerenderer_tpu_torch.render import common as common_mod
    from unclerenderer_tpu_torch.render.deferred import deferred_frame
    from unclerenderer_tpu_torch.render.forward import forward_frame
    from unclerenderer_tpu_torch.render.params import FrameState, RenderSettings
    from unclerenderer_tpu_torch.render.testing import (
        MASKED_CASES,
        masked_raster_args,
        masked_raster_atlas,
        masked_raster_setup,
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
        # the want_attrs branches (fused resolve): the same wrappers given records
        "binned_raster_attrs": dict(module=rk, attr="binned_raster", ref=rk.binned_raster_ref,
                                    work=work_binned_attrs, library_for=index_select_records,
                                    source=csrc + "binned_raster.cu",
                                    replaces="unclerenderer_tpu/ops/pallas_raster.py:610"),
        "giant_raster_attrs": dict(module=rk, attr="giant_raster", ref=rk.giant_raster_ref,
                                   work=work_giant_attrs, library_for=index_select_records,
                                   source=csrc + "giant_raster.cu",
                                   replaces="unclerenderer_tpu/ops/pallas_raster.py:242"),
        "shadow_select9": dict(module=shadow_mod, attr="select9", ref=shadow_mod.select9_ref,
                               work=work_select9, source=csrc + "shadow_select9.cu",
                               replaces="unclerenderer_tpu/ops/shadow.py:335"),
        # K4's f32 rows (shadow_table_u16=False) and K1's debug print
        # (kernel_debug_print): the same wrappers given an f32 table, debug=True
        "shadow_select9_f32": dict(module=shadow_mod, attr="select9", ref=shadow_mod.select9_ref,
                                   work=work_select9, source=csrc + "shadow_select9.cu",
                                   replaces="unclerenderer_tpu/ops/shadow.py:335"),
        "binned_raster_debug": dict(module=rk, attr="binned_raster", ref=rk.binned_raster_ref,
                                    work=work_binned, source=csrc + "binned_raster.cu",
                                    replaces="unclerenderer_tpu/ops/pallas_raster.py:572"),
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
        # X1 (raster_backend="xla"): not a TPU kernel; it computes the
        # reference's XLA raster, which no PyTorch call computes
        "exhaustive_raster": dict(module=rk, attr="rasterize_exhaustive", ref=rasterize_plain,
                                  work=work_exhaustive, source=csrc + "exhaustive_raster.cu",
                                  replaces="unclerenderer_tpu/ops/raster.py:502"),
        # M1: not a TPU kernel either; the reference's XLA masked raster
        # (_rasterize_alpha_binned's eval_level :766, and _rasterize_alpha :552
        # at masked_tri_cap 0), which no PyTorch call computes
        "masked_raster": dict(module=rk, ref=rk.masked_raster_ref, work=work_masked,
                              source=csrc + "masked_raster.cu",
                              replaces="unclerenderer_tpu/render/common.py:689"),
        # the present's u8 conversion: not a TPU kernel either; the reference
        # converts on the host (render_to_u8's numpy formula), no PyTorch call
        # computes it
        "present_u8": dict(module=present_mod, ref=present_mod.present_u8_ref, work=work_present,
                           source=csrc + "present_u8.cu",
                           replaces="unclerenderer_tpu/render/renderer.py:779"),
        # the resolve's attributes R1 and material tap T1 and T2: not TPU
        # kernels either; the reference's XLA element-wise resolve (InterpAttr;
        # the quad corners and footprint; the packed trilinear tap, once or
        # max_anisotropy times)
        "interp_attrs": dict(module=tex_mod, ref=tex_mod.interp_attrs_ref,
                             work=work_interp_attrs, source=csrc + "material_tap.cu",
                             replaces="unclerenderer_tpu/render/common.py:1048"),
        "tap_footprint": dict(module=tex_mod, ref=tex_mod.tap_footprint_ref,
                              work=work_tap_footprint, source=csrc + "material_tap.cu",
                              replaces="unclerenderer_tpu/render/common.py:1071"),
        "material_tap": dict(module=tex_mod, ref=tex_mod.material_tap_ref,
                             work=work_material_tap, source=csrc + "material_tap.cu",
                             replaces="unclerenderer_tpu/ops/texture.py:452"),
    }
    for name, k in kernels.items():
        k.setdefault("attr", name)
        k.setdefault("library", None)
        k.setdefault("library_for", None)
        k.update(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, graph_ms=0.0,
                 library_graph_ms=0.0, bytes_s=0.0, ops_s=0.0, all_pairs_ops_s=0.0, calls=[],
                 launch_us=None, clone_launch_us=None, no_records_ms=0.0,
                 no_records_graph_ms=0.0, no_debug_ms=0.0, frame=None)
    check(set(kernels) == set(_cuda.LAUNCHES), "every built kernel is checked")
    default_kernels = ("binned_raster", "giant_raster", "shadow_select9", "gather_rows")
    attr_kernels = ("binned_raster_attrs", "giant_raster_attrs")
    packed_kernels = ("hzb_tail", "env_select", "mat_select", "materialize_rows")
    tap_kernels = ("tap_footprint", "material_tap")
    # the packed frame's path: its attributes are R1's, its material tap T1
    # and T2, K8 only the plain tap's decode
    packed_path = ("hzb_tail", "env_select", "materialize_rows", "interp_attrs") + tap_kernels
    probe_kernels = ("merge_select", "copy_rows", "materialize")
    sampling_kernels = ("binned_raster", "giant_raster", "shadow_select9_f32", "gather_rows")
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

    # ---- 3a. the want_attrs branches: K1 and K2 given records
    def versus_records(name, a, records):
        """Kernel ``name`` with records: bit-equal to its plain version, keys
        and ids those of the launch without records, the records those of
        ``where(ids >= 0, records[ids], 0)``."""
        wrapper = getattr(rk, kernels[name]["attr"])
        got, (key, ids) = wrapper(*a, records=records), wrapper(*a)
        check(torch.equal(got[0], key) and torch.equal(got[1], ids),
              f"{name}: keys or ids differ from the launch without records")
        check(torch.equal(got[2], rk.records_ref(records, ids)),
              f"{name}: records != where(ids >= 0, records[ids], 0)")
        versus_plain(name, *a, records=records)

    gen = torch.Generator().manual_seed(0)
    for seed, n, size in [(0, 150, 0.04), (3, 40, 0.6), (5, 2000, 0.04)]:
        s = random_setup(n, seed, size, dev)
        for r_cols in (1, 7, 128):
            records = torch.randn((n, r_cols), generator=gen).to(dev)
            for chunk in (64, 66, 256, 512):
                bins = bin_triangles(s, 256, 256, 16, 64, chunk)
                start, count = rk.tile_block_ranges(bins, 64)
                versus_records("binned_raster_attrs",
                               (bins.coef, bins.tri_id, bins.valid, start, count, 16, 64, 4),
                               records)
            gids = torch.randperm(n, generator=gen).to(dev)
            for gchunk in (8, 66, 256, 512):
                with Recorder(rk, "giant_raster") as r:
                    rk.rasterize_giant(s, 256, 256, tile_h=32, tile_w=256, chunk=gchunk, ids=gids)
                versus_records("giant_raster_attrs", r.calls[0][0], records)
    log("kernels", "binned_raster_attrs and giant_raster_attrs bit-equal to plain on the 256^2 "
                   "random setups (R = 1, 7, 128; K1 chunks 64, 66, 256, 512; K2 chunks 8, 66, "
                   "256, 512 over a permuted id map): keys and ids those of the launch without "
                   "records, records where(ids >= 0, records[ids], 0)")

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
    # K4 on f32 rows at every block width, with -0, inf and the table's last lane
    table = torch.from_numpy(rng.standard_normal((4096, 128)).astype(np.float32)).to(dev)
    table.view(-1)[::13] = -0.0
    table.view(-1)[3::29] = float("inf")
    for bw in range(4, 9):
        deltas = shadow_mod.pcf_deltas(bw)
        for m in (100_003, 257, 31):
            row = torch.from_numpy(rng.integers(0, 4096, m).astype(np.int32)).to(dev)
            base = torch.from_numpy(rng.integers(0, 128 - deltas[-1], m).astype(np.int32)).to(dev)
            row[-1], base[-1] = 4095, 127 - deltas[-1]
            row[0], base[0] = 0, 0  # the first lane
            got = shadow_mod.select9(table, row, base, deltas)
            want = shadow_mod.select9_ref(table, row, base, deltas)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"shadow_select9_f32 != plain (bit patterns) at bw {bw}, {m} receivers")
    log("kernels", "shadow_select9_f32 bit-equal to plain (bit patterns: -0 read as +0, inf "
                   "kept) on random f32 tables at block widths 4-8, rows and bases at the "
                   "table's first and last lanes, 31-100,003 receivers")
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

    # ---- 3a. the present's u8 conversion vs plain: a 1080p colour with every level's half
    # (k + 0.5) / 255, its float32 neighbours and the special values scattered over it
    n = HEIGHT * WIDTH * 3 + 3
    colour = rng.uniform(-0.5, 1.5, n).astype(np.float32)
    halves = ((np.arange(255) + 0.5) / 255).astype(np.float32)
    near = [halves] + [np.nextafter(halves, np.float32(d * np.inf)) for d in (1, -1)]
    picks = np.concatenate(near + [special, np.array([3.4e38, -3.4e38], np.float32)])
    colour[rng.choice(n, picks.size, replace=False)] = picks
    colour = torch.from_numpy(colour).to(dev)
    for sl in (slice(0, n - 3), slice(1, 1002), slice(0, 37)):  # aligned, misaligned, odd
        versus_plain("present_u8", colour[sl])
    with np.errstate(invalid="ignore", over="ignore"):
        want = np.clip(np.rint(colour.cpu().numpy() * 255.0), 0, 255).astype(np.uint8)
    check(np.array_equal(present_mod.present_u8(colour).cpu().numpy(), want),
          "present_u8 != numpy's formula")
    log("kernels", "present_u8 bit-equal to plain and to numpy's formula (halves and their "
                   "neighbours, +-0, +-inf, NaN, the largest floats; aligned, misaligned, odd)")

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

    # ---- 3a. M1 vs plain on the special setups
    def masked_versus_plain(args, label):
        """One M1 call with its counts against the plain version's: key bits,
        ids, live blocks and covered pairs equal, tapped pairs at most the
        covered ones; the frame's call (no counts) gives the same images.
        Returns the kernel's counts."""
        args = args[:16]  # a frame's recorded call also passes its stats flag
        got = rk.masked_raster(*args, stats=True)
        want = rk.masked_raster_ref(*args, stats=True)
        check(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
              and torch.equal(got[1], want[1]), f"masked_raster != plain ({label}): "
              f"{compare(got[:2], want[:2])[0]} elements")
        n = {k: int(v) for k, v in got[2].items()}
        check(n["blocks"] == int(want[2]["blocks"]) and n["covered"] == int(want[2]["covered"])
              and n["tapped"] <= n["covered"], f"masked_raster counts {n} vs plain "
              f"{ {k: int(v) for k, v in want[2].items()} } ({label})")
        plain = rk.masked_raster(*args)
        check(plain[2] is None and torch.equal(plain[0], got[0]) and torch.equal(plain[1], got[1]),
              f"masked_raster without counts differs ({label})")
        return n

    m1_calls, m1_taps = 0, 0
    for case in MASKED_CASES:
        m_setup, m_arec = masked_raster_setup(case, 3, dev)
        for layout, dtype in (("quad4", torch.float32), ("quad4", torch.bfloat16),
                              ("quad16", torch.uint8), ("packed", torch.uint8),
                              ("packed", torch.bfloat16), ("packed", torch.float32)):
            m_atlas, m_aw = masked_raster_atlas(layout, dtype, dev, seed=4)
            for form in ("binned", "exhaustive"):
                for chunk, y0, bilinear, misaligned in ((64, 0, False, False),
                                                        (32, 48, True, True),
                                                        (256, 0, False, True),
                                                        (128, 48, False, False)):
                    m_args = masked_raster_args(m_setup, m_arec, m_atlas, m_aw, 256, 256 - y0,
                                                form, chunk, y_offset=y0, full_height=256,
                                                bilinear=bilinear, misaligned=misaligned)
                    m1_taps += masked_versus_plain(
                        m_args, f"{case} {layout} {dtype} {form} chunk {chunk} y_offset {y0}")[
                            "tapped"]
                    m1_calls += 1
    m_setup, m_arec = masked_raster_setup("random", 5, dev, 64, 64, n=9000)
    m_atlas, m_aw = masked_raster_atlas("packed", torch.uint8, dev, seed=3)
    for form in ("binned", "exhaustive"):
        m1_taps += masked_versus_plain(
            masked_raster_args(m_setup, m_arec, m_atlas, m_aw, 64, 64, form, 32),
            f"dense {form}")["tapped"]
        m1_calls += 1
    log("kernels", f"masked_raster bit-equal to plain on {m1_calls} calls ({m1_taps} alpha taps) "
                   f"over the special setups {MASKED_CASES} (coplanar ties, +0/-0 keys, slivers "
                   "past their boxes, alphas within ulps of the cutoff) at 256^2: quad atlases "
                   "(4 channels f32/bf16, 16 u8) and packed ones (u8, bf16, f32), binned and "
                   "exhaustive, chunks 32-256, y_offset 0 and 48, both filters, misaligned "
                   "tables; live blocks and covered pairs equal, tapped <= covered")

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
        shapes = [tuple(getattr(x, "coef", x).shape) for x in ca
                  if isinstance(getattr(x, "coef", x), torch.Tensor)]  # a setup: its coefficients
        check(bad == 0, f"{name} != plain at path shapes {shapes}: {bad} elements")
        plain_ms = cuda_ms(lambda: k["ref"](*ca, **ck), reps=1)
        library = (k["library_for"](wrapper, ca, ck) if k["library_for"] is not None else
                   None if k["library"] is None else lambda: k["library"](*ca, **ck))
        if library is not None:  # in turns: kernel, library, library, kernel
            ms, lib_ms = in_turns(lambda: wrapper(*ca, **ck), library,
                                  lambda fn: cuda_ms(fn, reps=50))
        else:
            ms, lib_ms = cuda_ms(lambda: wrapper(*ca, **ck), reps=50), None
        # the same calls replayed from a CUDA graph: the device's share alone
        dev_ms = graph_ms(lambda: wrapper(*ca, **ck), reps=10)
        lib_dev_ms = graph_ms(library, reps=10) if library is not None else None
        base = {}
        if ck.get("records") is not None:  # the same launch without records
            base = {"no_records_ms": cuda_ms(lambda: wrapper(*ca), reps=50),
                    "no_records_graph_ms": graph_ms(lambda: wrapper(*ca), reps=10)}
            k["no_records_ms"] += base["no_records_ms"]
            k["no_records_graph_ms"] += base["no_records_graph_ms"]
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
                           "bound_all_pairs_ms": all_pairs_ms, **base})
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms (graph {lib_dev_ms:.4f})"
        log("kernels", f"{name} {shapes}: bit-equal, kernel {ms:.4f} ms (graph {dev_ms:.4f}), "
                       f"plain {plain_ms:.3f} ms, library {lib}, bound "
                       f"{1e3 * max(bytes_s, ops_s):.4f} ms ({moved} B, {ops} ops)")
        if base:
            log("raster", f"{name} {label}: without records eager {base['no_records_ms']:.4f} "
                          f"ms, graph {base['no_records_graph_ms']:.4f} ms; with records "
                          f"{ms:.4f} / {dev_ms:.4f}; index_select of its winner ids {lib} "
                          f"(on {smi})")
        if label is not None:  # a raster launch: its level and live pairs
            binned = name.startswith("binned_raster")
            th, tw = ca[5:7] if binned else ca[4:6]
            n_tiles = ca[3 if binned else 2].shape[0]
            log("raster", f"{name} {label}: coefficients {shapes[0]}, {n_tiles} tiles of "
                          f"{th}x{tw}, {pairs[0]} live (pixel, row) pairs, {pairs[1]} kept by the "
                          f"warp skip; eager {ms:.4f} ms, graph {dev_ms:.4f} ms, bound "
                          f"{1e3 * max(bytes_s, ops_s):.4f} ms "
                          f"({'B' if bytes_s >= ops_s else 'O'}; every pair in full: "
                          f"{all_pairs_ms:.4f} ms) (on {smi})")

    # the present's conversion at the frame's size (its main path is render_to_u8, phase 7)
    measure("present_u8", (colour[:HEIGHT * WIDTH * 3].view(HEIGHT, WIDTH, 3),), {})
    del colour

    def recorded(names, frame_scene, frame_params, frame_settings):
        """The calls of kernels ``names`` in one full-size frame: name ->
        [(args, kwargs)]."""
        with contextlib.ExitStack() as stack:
            # one recorder a wrapper; its calls sorted by entry (call_belongs)
            recs = {}
            for n in names:
                key = (kernels[n]["module"], kernels[n]["attr"])
                if key not in recs:
                    recs[key] = stack.enter_context(Recorder(*key))
            deferred_frame(frame_scene, frame_params,
                           FrameState.initial(WIDTH, HEIGHT, dev), frame_settings)
            torch.cuda.synchronize()
        calls = {name: [c for c in recs[(kernels[name]["module"], kernels[name]["attr"])].calls
                        if call_belongs(name, *c)] for name in names}
        for name, c in calls.items():
            check(c, f"{name}: the frame made no call")
        return calls

    def capture(names, frame_scene, frame_params, frame_settings):
        for name, calls in recorded(names, frame_scene, frame_params, frame_settings).items():
            seen = {}
            for ca, ck in calls:
                label = None
                if name in ("binned_raster", "giant_raster") + attr_kernels:
                    # shadow first, fine before mid
                    view = "camera" if ca[-2] else "shadow"
                    level = ("giant" if name.startswith("giant") else
                             ("fine", "mid")[seen.get(view, 0)])
                    seen[view] = seen.get(view, 0) + 1
                    label = f"{view} {level}"
                measure(name, ca, ck, label)

    capture(default_kernels, scene, params[0], settings)
    # K8 in the plain tap at T1's footprint (the rule forced off, T2 not taken)
    with patched(common_mod, "tap_kernels_engage", lambda *a: False):
        capture(packed_kernels, packed, packed_params[0], packed_settings)
    # R1, T1 and T2 as the cells run them (mat_select_kernel off): trilinear,
    # anisotropic x4 (R1 once: its call is the same under either filter)
    for filt in ("trilinear", "anisotropic"):
        capture(tap_kernels + (("interp_attrs",) if filt == "trilinear" else ()), packed,
                packed_params[0],
                dataclasses.replace(packed_settings, texture_filter=filt, mat_select_kernel=False))

    # ---- 4. cross-device frames: kernels on the card vs plain versions on the CPU
    small = RenderSettings(width=256, height=256, shadow_map_size=512,
                           has_masked_models=False, combined_material=True)

    def masked_pixels(frame_scene, tri_id):
        """Pixels whose winning triangle is a masked model's."""
        am = frame_scene.alpha_mode[frame_scene.tri_model.long()] == 1
        return int(((tri_id >= 0) & am[tri_id.clamp(min=0).long()]).sum())

    def cross(label, sc_cpu, sdata, frame_settings, mips=None, masked_min=None, frames=2,
              frame="deferred", size=256):
        """Card frames against CPU frames; with masked models on, every M1
        call of the card's frames held bit-equal to the plain version too."""
        sc_gpu = to_device(sc_cpu, dev)
        m1_held = 0
        st_c = FrameState.initial(size, size, "cpu")
        st_g = FrameState.initial(size, size, dev)
        for i in range(frames):
            pos = (4.0 * np.sin(0.05 * i), 1.5, -4.0 * np.cos(0.05 * i))
            p_c = synthetic_frame_params(sdata, size, size, camera_pos=pos, device="cpu")
            p_g = synthetic_frame_params(sdata, size, size, camera_pos=pos, device=dev)
            if mips is not None:
                p_c.env_mip_count = torch.tensor(float(mips))
                p_g.env_mip_count = torch.tensor(float(mips), device=dev)
            with Recorder(rk, "masked_raster") as m1:
                if frame == "forward":
                    out_g = forward_frame(sc_gpu, p_g, frame_settings)
                else:
                    out_g, st_g_next = deferred_frame(sc_gpu, p_g, st_g, frame_settings)
            for ca, ck in m1.calls:
                versus_plain("masked_raster", *ca, **ck)
            m1_held += len(m1.calls)
            if frame == "forward":
                out_c = forward_frame(sc_cpu, p_c, frame_settings)
                out_c["hdr"], out_g["hdr"] = out_c["color"], out_g["color"]
            else:
                out_c, st_c = deferred_frame(sc_cpu, p_c, st_c, frame_settings)
                st_g = st_g_next
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
        if frame_settings.has_masked_models:
            check(m1_held > 0, f"cross-device {label}: no M1 call")
            log("cross", f"{label}: {m1_held} masked_raster (M1) calls of the card's frames "
                         "bit-equal to plain")
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
    # the sampling and storage settings alone and together, deferred and
    # forward, and the anisotropic filter with compacted taps under forward
    # differences (one frame each)
    sc_cpu, sdata = synthetic_device_scene(24, rich_materials=True, atlas_u8=True, device="cpu")
    sampling_pairs = [(f"{k}={v}", {k: v}, "deferred") for k, v in SAMPLING.items()]
    sampling_pairs += [("sampling", SAMPLING, "deferred"), ("sampling forward", SAMPLING, "forward"),
                       ("forward LOD anisotropic compact 0.25",
                        dict(lod_derivatives="forward", texture_filter="anisotropic",
                             aniso_compact_frac=0.25), "deferred")]
    for label, override, frame in sampling_pairs:
        report[f"cross_color_max_abs_{label}"] = cross(
            label, sc_cpu, sdata, dataclasses.replace(small, **override), frames=1, frame=frame)
    del sc_cpu

    # ---- 9. K1's debug print: one 256^2 frame in a child process
    report["debug"] = debug_phase(kernels, smi)

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
        around each M1 launch; M1's counts and the drops of each masked
        level."""
        stage, taps = [], []  # (start event, end event, output) of each call

        def timed_call(fn, into):
            def call(*a, **kw):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **kw)
                e1.record()
                into.append((e0, e1, out))
                return out
            return call

        with patched(common_mod, "raster_masked_combine",
                     timed_call(functools.partial(common_mod.raster_masked_combine, stats=True),
                                stage)), \
                patched(rk, "masked_raster", timed_call(rk.masked_raster, taps)):
            deferred_frame(frame_scene, frame_params, FrameState.initial(WIDTH, HEIGHT, dev),
                           frame_settings)
            torch.cuda.synchronize()
        stage_ms = sum(e0.elapsed_time(e1) for e0, e1, _ in stage)
        m1_ms = [e0.elapsed_time(e1) for e0, e1, _ in taps]
        levels = [{k: int(v) for k, v in c.items()} for _, _, out in stage for c in out[2]]
        for k, lv in enumerate(levels):
            log("masked", f"level {k + 1}: {lv['blocks']} live blocks, {lv['covered']} covered "
                          f"(pixel, slot) pairs, {lv['tapped']} alpha-tapped (those that could "
                          f"change their pixel's winner); dropped, not counted by the reference: "
                          f"{lv.get('bin_overflow', 0)} pairs past the bin budget"
                          + (f", {lv['big_dropped']} triangles too big for level 2" if k == 1
                             else ""))
        log("masked", f"masked raster {stage_ms:.2f} ms of one op-by-op frame, of which M1's "
                      f"{len(m1_ms)} launches {sum(m1_ms):.3f} ms "
                      f"({[round(x, 3) for x in m1_ms]}; CUDA events around each call, host "
                      f"included, on {smi})")
        return {"masked_raster_ms": stage_ms, "m1_ms": m1_ms, "levels": levels}

    def counted(label, names, frame_scene, frame_params, frame_settings, extra=None,
                time_it=True):
        """The main-path run of one path: counts set to 0 just before its
        frames and read just after; then the gates (``extra(last output)``
        adds its own and returns what it measured) and, with ``time_it``,
        3 timed runs."""
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
        if time_it:
            more.update(timed(label, frame_scene, frame_params, frame_settings, state))
        return {"launches": launches, "drops": drops, **more}

    def timed_turns(variants, frame_scene, frame_params):
        """ms/frame of (label, settings) variants a and b in turns (a b b a
        a b), each run 10 carried frames from the variant's own carried
        state; peak GiB of each variant's runs."""
        runs = {label: [] for label, _ in variants}
        peak = {label: 0.0 for label, _ in variants}
        states = {label: FrameState.initial(WIDTH, HEIGHT, dev) for label, _ in variants}
        for i in (0, 1, 1, 0, 0, 1):
            label, frame_settings = variants[i]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _, states[label] = run(frame_scene, frame_params, frame_settings, states[label])
            torch.cuda.synchronize()
            runs[label].append((time.perf_counter() - t0) * 1000.0 / len(frame_params))
            peak[label] = max(peak[label], torch.cuda.max_memory_allocated() / 2**30)
        return {label: {"ms_per_frame": runs[label], "median_ms": statistics.median(runs[label]),
                        "peak_gib": peak[label]} for label in runs}

    def same_frames(label, frame_scene, frame_params, a_settings, b_settings):
        """One frame of each settings from the same state: every output and
        the carried state bit-equal (colour exactly equal)."""
        st = FrameState.initial(WIDTH, HEIGHT, dev)
        a_out, a_state = deferred_frame(frame_scene, frame_params, st, a_settings)
        b_out, b_state = deferred_frame(frame_scene, frame_params, st, b_settings)
        for k, v in a_out.items():
            if isinstance(v, dict):  # raster_stats, tap_counts
                check({n: int(x) for n, x in v.items()} == {n: int(x) for n, x in b_out[k].items()},
                      f"{label}: counters differ")
            else:
                check(torch.equal(v.view(torch.int32) if v.dtype == torch.uint32 else v,
                                  b_out[k].view(torch.int32) if v.dtype == torch.uint32
                                  else b_out[k]), f"{label}: {k} differs")
        for f in dataclasses.fields(FrameState):
            check(torch.equal(getattr(a_state, f.name), getattr(b_state, f.name)),
                  f"{label}: carried {f.name} differs")
        log(label, f"fused frame == unfused frame: {sorted(k for k in a_out)} and the carried "
                   f"state bit-equal, colour exactly equal")

    def sampling_path(frame_scene, frame_params, frame_settings):
        """The sampling configuration at full width: every K1/K2/K4/K5 call
        of one frame bit-equal to its plain version, K4 on f32 rows timed
        for the kernels line, the counted run with its gates, and ms/frame
        and peak in turns with the default configuration (3 pairs of 3
        frames)."""
        s_settings = dataclasses.replace(frame_settings, **SAMPLING)
        calls = recorded(sampling_kernels, frame_scene, frame_params[0], s_settings)
        for name, cs in calls.items():
            for ca, ck in cs:
                versus_plain(name, *ca, **ck)
        table = calls["shadow_select9_f32"][0][0][0]
        log("sampling", f"{ {n: len(c) for n, c in calls.items()} } calls of one frame bit-equal to "
                        f"plain; the PCF table {tuple(table.shape)} {table.dtype} "
                        f"({table.nbytes / 2**20:.0f} MiB)")
        capture(["shadow_select9_f32"], frame_scene, frame_params[0], s_settings)
        rep = counted("sampling", sampling_kernels, frame_scene, frame_params, s_settings,
                      time_it=False)
        turns = timed_turns([("sampling", s_settings), ("default", frame_settings)], frame_scene,
                            frame_params[:3])
        rep["turns"] = turns
        log("sampling", f"ms/frame in turns (3 pairs of 3 frames): sampling "
                        f"{[round(x, 2) for x in turns['sampling']['ms_per_frame']]} (median "
                        f"{turns['sampling']['median_ms']:.2f}), default "
                        f"{[round(x, 2) for x in turns['default']['ms_per_frame']]} (median "
                        f"{turns['default']['median_ms']:.2f}); peak GiB sampling "
                        f"{turns['sampling']['peak_gib']:.2f}, default "
                        f"{turns['default']['peak_gib']:.2f} ({WIDTH}x{HEIGHT}, shadow "
                        f"{SHADOW}^2, on {smi})")
        return rep

    def marker_cost(frame_scene, frame_params, frame_settings):
        """The pass markers' record_function calls in one default frame, and
        ms/frame with the markers' ranges entered (as while a profiler
        records) and with the markers as they run untraced, in turns (on off
        off on on off, 3 frames each).  No gate."""
        from unclerenderer_tpu_torch.core import passes as passes_mod

        prof = torch.autograd.profiler
        on = prof.record_function
        n_calls = [0]

        def counting(name):
            n_calls[0] += 1
            return on(name)

        with patched(prof, "record_function", counting), \
                patched(passes_mod, "tracing", lambda: True):
            run(frame_scene, frame_params[:1], frame_settings,
                FrameState.initial(WIDTH, HEIGHT, dev))
        runs = {"on": [], "off": []}
        state = FrameState.initial(WIDTH, HEIGHT, dev)
        for label in ("on", "off", "off", "on", "on", "off"):
            with patched(passes_mod, "tracing", passes_mod.tracing if label == "off"
                         else lambda: True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, state = run(frame_scene, frame_params[:3], frame_settings, state)
                torch.cuda.synchronize()
            runs[label].append((time.perf_counter() - t0) * 1000.0 / 3)
        log("markers", f"{n_calls[0]} record_function ranges a default frame; ms/frame with the "
                       f"ranges entered {[round(x, 2) for x in runs['on']]}, untraced "
                       f"{[round(x, 2) for x in runs['off']]} (in turns, 3 frames each, on {smi})")
        return {"ranges_per_frame": n_calls[0], "ms_per_frame": runs}

    report["slice"] = counted("slice", default_kernels, scene, params, settings)
    report["probes"] = probe_path(scene, params[0])

    # ---- 5. the fused path: the default settings with fused_resolve="on"
    fused_settings = dataclasses.replace(settings, fused_resolve="on")
    fused_kernels = attr_kernels + default_kernels  # K1/K2 without records: the shadow map
    same_frames("fused", scene, params[0], fused_settings, settings)
    capture(attr_kernels, scene, params[0], fused_settings)
    report["fused"] = counted("fused", fused_kernels, scene, params, fused_settings,
                              time_it=False)
    turns = timed_turns([("fused", fused_settings), ("unfused", settings)], scene, params)
    report["fused"]["turns"] = turns
    log("fused", f"ms/frame median in turns: fused {turns['fused']['median_ms']:.2f} (runs "
                 f"{[round(x, 2) for x in turns['fused']['ms_per_frame']]}), unfused "
                 f"{turns['unfused']['median_ms']:.2f} (runs "
                 f"{[round(x, 2) for x in turns['unfused']['ms_per_frame']]}); peak GiB fused "
                 f"{turns['fused']['peak_gib']:.2f}, unfused {turns['unfused']['peak_gib']:.2f} "
                 f"({WIDTH}x{HEIGHT}, shadow {SHADOW}^2, on {smi})")

    # ---- 8. the sampling path: forward LOD, AoS vertex stage, f32 PCF table
    report["sampling"] = sampling_path(scene, params, settings)
    report["markers"] = marker_cost(scene, params, settings)
    del scene
    report["packed"] = counted("packed", default_kernels + packed_path, packed,
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

    # ---- 3b. M1 on the masked 1080p frame's own level-1 and level-2 inputs:
    # bit-equal, timed, its bound (the kernels line's M1 calls)
    from unclerenderer_tpu_torch.sweeps import masked as masked_sweep

    m1_calls = recorded(["masked_raster"], m_scene, m_params[0], m_settings)["masked_raster"]
    check(len(m1_calls) == 2, f"the masked frame made {len(m1_calls)} M1 calls, expected 2")
    for level, (ca, ck) in enumerate(m1_calls, 1):
        n = masked_versus_plain(ca, f"1080p level {level}")
        measure("masked_raster", ca, ck)
        call = kernels["masked_raster"]["calls"][-1]
        call.update(launch=f"level {level}", counts=n)
        log("masked", f"M1 level {level} ({ca[9]}x{ca[10]} tiles, {ca[0].shape[0]} block slots of "
                      f"{ca[0].shape[-1]}): {n['blocks']} live blocks, {n['covered']} covered "
                      f"pairs, {n['tapped']} tapped; bit-equal to plain; eager {call['ms']:.4f} ms, "
                      f"graph {call['graph_ms']:.4f} ms, plain {call['plain_ms']:.2f} ms, bound "
                      f"{call['bound_ms']:.4f} ms ({call['bytes']} B, {call['ops']} ops, "
                      f"{call['bound_by']}) (on {smi})")
        # what the level holds: per-tile block counts, the taps it needs
        # and M1's own, in the level and in its busiest tile alone
        call["level_counts"] = masked_sweep.level_counts(ca[:16], ck)
        log("masked", f"M1 level {level} counts: {call['level_counts']}")
    del m1_calls

    def masked_checks(out):
        n_won = masked_pixels(m_scene, out["tri_id"])
        check(n_won > 0, "masked: no pixel won by a masked model")
        log("masked", f"{n_won} pixels won by masked models")
        return {"masked_pixels": n_won, **masked_stage(m_scene, m_params[0], m_settings)}

    report["masked"] = counted("masked", default_kernels + ("masked_raster",), m_scene, m_params,
                               m_settings, extra=masked_checks)
    # fused resolve on the masked path: masked-won pixels take their records
    # from the compacted masked list; the record-emitting calls vs plain
    m_fused = dataclasses.replace(m_settings, fused_resolve="on")
    same_frames("masked-fused", m_scene, m_params[0], m_fused, m_settings)
    for name, calls in recorded(attr_kernels, m_scene, m_params[0], m_fused).items():
        for ca, ck in calls:
            versus_plain(name, *ca, **ck)
    log("kernels", "masked fused 1080p frame: every record-emitting K1/K2 call bit-equal to plain")
    del m_scene

    # ---- 14. the xla path (defined here, run on the Renderer's files)
    def xla_path(scene_json):
        """raster_backend="xla": X1 against its plain version, the binned
        rasters against X1, the headline Renderer counted and timed, and
        card/CPU frames at 128^2 (phase 14 of the module docstring)."""
        from unclerenderer_tpu_torch.render.deferred import pack_table
        from unclerenderer_tpu_torch.render.renderer import Renderer

        rep = {}
        t_phase = time.perf_counter()
        # (a) X1 vs plain on the reference tests' random setups
        n_calls = 0
        for seed, n, size in [(0, 150, 0.04), (2, 60, 0.2), (3, 40, 0.6), (5, 2000, 0.04)]:
            persp = random_setup(n, seed, size, dev)
            for want_ids, ortho in modes:
                s = normalize_ortho_setup(persp) if ortho else persp
                for depth_mode in (DEPTH_MAX, DEPTH_MIN):
                    for y_offset in (0.0, 48.0):
                        for th, tw in ((16, 64), (32, 128), (24, 36)):
                            versus_plain("exhaustive_raster", s, 256, 256, tile_h=th, tile_w=tw,
                                         depth_mode=depth_mode, y_offset=y_offset,
                                         want_ids=want_ids, ortho=ortho)
                            n_calls += 1
        log("xla", f"exhaustive_raster bit-equal to plain on {n_calls} calls over the 256^2 "
                   "random setups (ids and depth-only, perspective and ortho, both depth modes, "
                   "y_offset 0 and 48, tiles 16x64, 32x128 and 24x36)")

        # (c) the headline geometry through the Renderer: 10 counted frames
        xs = RenderSettings(width=WIDTH, height=HEIGHT, shadow_map_size=SHADOW,
                            raster_backend="xla")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r = Renderer(scene_json, settings=xs, device=dev)
        center = np.asarray(r.scene_data.scene_center, np.float32)
        cam0 = np.asarray(r.camera.position, np.float32)

        def orbit(rr):
            a = 0.0035 * rr._frame_counter
            off = cam0 - center
            rr.camera.position = center + np.array(
                [off[0] * np.cos(a) - off[2] * np.sin(a), off[1],
                 off[0] * np.sin(a) + off[2] * np.cos(a)], np.float32)
            rr.camera.set_look_at(center)

        def gate(rr, out, label, frames):
            launches = dict(_cuda.LAUNCHES)
            used = {k: v for k, v in launches.items() if v}
            # the first frame renders the shadow map (a second X1 launch); R1
            # takes each resolve's attributes and T1 the quad-LOD footprint of
            # each slot tapped on either backend
            slots = int(out["tap_counts"]["tap_pixels"]) // max(int((out["tri_id"] >= 0).sum()), 1)
            check(used == {"exhaustive_raster": frames + 1, "interp_attrs": frames,
                           "tap_footprint": frames * slots},
                  f"xla {label}: launches {used}, expected only X1, {frames + 1} times, R1, "
                  f"{frames} times, and T1, {frames * slots} times")
            st = rr.stats()
            for key in ("bin_pair_overflow", "bin_giant_truncated", "compact_overflow",
                        "shadow_compact_overflow"):
                check(st[key] == 0, f"xla {label}: drop counter {key} = {st[key]}")
            color = out["color"]
            check(tuple(color.shape) == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(color).all()),
                  f"xla {label}: colour {tuple(color.shape)} not finite")
            covered = int((out["tri_id"] >= 0).sum())
            check(covered > 0.3 * WIDTH * HEIGHT, f"xla {label}: only {covered} covered pixels")
            log("xla", f"{label}: launches in {frames} render_frame calls {launches}; drop "
                       f"counters 0; {covered} covered pixels, colour finite; M1 (the masked "
                       f"raster, not one of K1-K9) {launches['masked_raster']} launches: the "
                       "scene has no masked model")
            return launches

        torch.cuda.synchronize()
        _cuda.reset_launches()
        for _ in range(FRAMES):
            orbit(r)
            out = r.render_frame()
        torch.cuda.synchronize()
        rep["launches"] = gate(r, out, "deferred Renderer", FRAMES)
        # the Renderer's settings: xs synced to the scene (no masked models)
        xs = r.settings
        check(xs.raster_backend == "xla" and not xs.has_masked_models,
              f"xla Renderer settings {xs}")
        kernel_path = dataclasses.replace(xs, raster_backend="auto")
        tables = {label: pack_table(r._shadow_cache, st).nbytes
                  for label, st in (("f16 per-texel", xs), ("u16 superblock", kernel_path))}
        log("xla", f"PCF table bytes: {tables}")
        rep["pcf_table_bytes"] = tables

        # the frame's two X1 calls and its two _raster calls, recorded
        params = r.frame_params()
        with Recorder(common_mod, "rasterize_exhaustive") as rx, \
                Recorder(common_mod, "_raster") as rr:
            deferred_frame(r.device_scene, params, FrameState.initial(WIDTH, HEIGHT, dev), xs)
            torch.cuda.synchronize()
        check(len(rx.calls) == 2 and len(rr.calls) == 2, "a deferred frame makes two X1 calls")

        # (a) the whole images against the plain version (bit-equal), timed with
        # their bounds; the mask and tile kernels' device ms apart; 64-row windows
        # against the plain version and against the images' rows
        rep["frame"] = {}
        x1 = kernels["exhaustive_raster"]
        for (ca, ck), label, y0 in zip(rx.calls, ("shadow", "camera"), (2048, 512)):
            check((ck["depth_mode"] == DEPTH_MIN) == (label == "shadow"), "call order")
            measure("exhaustive_raster", ca, ck)
            call = x1["calls"][-1]
            wa, wk = (ca[0], ca[1], 64), dict(ck, y_offset=float(y0))
            versus_plain("exhaustive_raster", *wa, **wk)
            *full, masks = rk.rasterize_exhaustive(*ca, **ck, want_masks=True)
            win = rk.rasterize_exhaustive(*wa, **wk)
            check(all(a is None and b is None or torch.equal(a[y0:y0 + 64], b)
                      for a, b in zip(full, win)), f"{label} window != the image's rows")
            split = kernel_device_ms(lambda: rk.rasterize_exhaustive(*ca, **ck))
            mask_ms = sum(v for n, v in split.items() if "exhaustive_masks" in n)
            tile_ms = sum(v for n, v in split.items() if "exhaustive_raster_kernel" in n)
            check(mask_ms > 0 and tile_ms > 0 and len(split) == 2,
                  f"X1 {label}: device kernels {split}, expected its mask and tile kernels")
            moved, ops, pairs, kept = work_exhaustive(*ca, **ck)
            rows = int(ca[0].coef.shape[0])
            rep["frame"][label] = {"ms": call["ms"], "graph_ms": call["graph_ms"],
                                   "plain_ms": call["plain_ms"], "bound_ms": call["bound_ms"],
                                   "bound_by": call["bound_by"], "mask_ms": mask_ms,
                                   "tile_ms": tile_ms, "mask_bytes": masks.nbytes,
                                   "bytes": moved, "ops": ops, "pairs": pairs, "kept": kept,
                                   "rows": rows, "valid_rows": int(ca[0].valid.sum())}
            log("xla", f"X1 {label} {ca[1]}x{ca[2]} over {rows} rows ({int(ca[0].valid.sum())} "
                       f"valid): the whole image bit-equal to plain (plain {call['plain_ms']:.1f} "
                       f"ms), window rows {y0}-{y0 + 63} bit-equal to plain and to the image's "
                       f"rows; the image eager {call['ms']:.4f} ms, graph {call['graph_ms']:.4f} "
                       f"ms, bound {call['bound_ms']:.4f} ms ({moved} B, {ops} ops; {pairs} live "
                       f"(pixel, row) pairs, {kept} kept by the warp skip), "
                       f"{100 * call['bound_ms'] / call['graph_ms']:.2f}% of it; device ms "
                       f"(profiler, eager): mask kernel {mask_ms:.4f}, tile kernel {tile_ms:.4f}; "
                       f"masks {tuple(masks.shape)} {masks.nbytes} B (on {smi})")
            del full, masks, win
        x1["frame"] = {k: sum(v[k] for v in rep["frame"].values())
                       for k in ("ms", "graph_ms", "bound_ms", "mask_ms", "tile_ms",
                                 "mask_bytes")}

        # (b) the binned rasters (kernel path) against X1 on the same setups
        rep["binned_vs_x1"] = {}
        for (ra, rkw), label in zip(rr.calls, ("shadow", "camera")):
            setup, th, tw = ra[0], ra[3], ra[4]
            b = common_mod._raster(*ra[:7], kernel_path, **rkw)
            x = common_mod._raster(*ra[:7], xs, **rkw)
            row = {"depth_pixels": int((b[0] != x[0]).sum())}
            if b[1] is None:  # the depth-only map: again with ids, for the classes
                b = common_mod._raster(*ra[:7], kernel_path, **dict(rkw, want_ids=True))
                x = common_mod._raster(*ra[:7], xs, **dict(rkw, want_ids=True))
            check(int(b[2]["pair_overflow"]) == 0 and int(b[2]["giant_truncated"]) == 0,
                  f"binned {label}: drops {b[2]}")
            differ = (b[0] != x[0]) | (b[1] != x[1])
            row.update(id_pixels=int((b[1] != x[1]).sum()), pixels=int(differ.sum()),
                       past_box=past_box(setup, b[1], differ, th, tw, 0.0))
            row["other"] = row["pixels"] - row["past_box"]
            rep["binned_vs_x1"][label] = row
            check(row["pixels"] == 0 and row["depth_pixels"] == 0,
                  f"binned (K1/K2) vs X1, {label}: {row} differing pixels")
            log("xla", f"binned (K1/K2) vs X1, {label} {ra[1]}x{ra[2]}: {row} -- past_box: the "
                       f"binned winner's box misses the pixel's {th}x{tw} tile (a sliver's coverage "
                       f"past its box that a coarser bin level's tile keeps); other: any other "
                       f"(gated at 0 pixels; on {smi})")

        # forward frames on the same Renderer (its settings change drops the cached map)
        r.update_settings(renderer_type="forward")
        torch.cuda.synchronize()
        _cuda.reset_launches()
        for _ in range(3):
            orbit(r)
            out = r.render_frame()
        torch.cuda.synchronize()
        rep["forward_launches"] = gate(r, out, "forward Renderer", 3)
        check(float(out["color"].min()) >= 0.0 and float(out["color"].max()) <= 1.0,
              "xla forward colour outside [0, 1]")
        r.update_settings(renderer_type="deferred")

        # ms/frame in turns with the default (kernel path) Renderer; peak GiB
        d = Renderer(scene_json, settings=RenderSettings(width=WIDTH, height=HEIGHT,
                                                         shadow_map_size=SHADOW), device=dev)
        runs = {"xla": [], "default": []}
        peak = {"xla": 0.0, "default": 0.0}
        extra = {"xla": 0.0, "default": 0.0}
        for which in ("xla", "default", "default", "xla", "xla", "default"):
            rr_ = r if which == "xla" else d
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(FRAMES):
                orbit(rr_)
                rr_.render_frame()
            torch.cuda.synchronize()
            runs[which].append((time.perf_counter() - t0) * 1000.0 / FRAMES)
            top = torch.cuda.max_memory_allocated()
            peak[which] = max(peak[which], top / 2**30)
            extra[which] = max(extra[which], (top - base) / 2**30)
        med = {k: statistics.median(v) for k, v in runs.items()}
        log("xla", f"ms/frame median: xla Renderer {med['xla']:.2f} (runs "
                   f"{[round(x, 2) for x in runs['xla']]}), default Renderer {med['default']:.2f} "
                   f"(runs {[round(x, 2) for x in runs['default']]}); 3 runs x {FRAMES} frames "
                   f"each in turns, {WIDTH}x{HEIGHT}, shadow {SHADOW}^2; peak GiB xla "
                   f"{peak['xla']:.2f}, default {peak['default']:.2f} (both Renderers resident; "
                   f"above the run's start: xla {extra['xla']:.2f}, default "
                   f"{extra['default']:.2f}) on {smi}")
        rep.update(ms_per_frame=runs, median_ms=med, peak_gib=peak, frame_extra_gib=extra)
        del r, d

        # (d) card vs CPU frames at 128^2, deferred and forward
        sc_cpu, sdata = synthetic_device_scene(24, with_masked=True, device="cpu")
        small_x = RenderSettings(width=128, height=128, shadow_map_size=256, raster_backend="xla")
        _cuda.reset_launches()
        rep["cross_color_max_abs"] = cross("xla 128", sc_cpu, sdata, small_x, size=128,
                                           masked_min=0)
        rep["cross_color_max_abs_forward"] = cross("xla 128 forward", sc_cpu, sdata, small_x,
                                                   size=128, frames=1, frame="forward")
        used = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        # the masked scene's frames also run M1, the masked raster of both
        # backends, and R1 and T1, the resolve's attributes and footprint on
        # both backends
        check(set(used) == {"exhaustive_raster", "masked_raster", "interp_attrs",
                            "tap_footprint"},
              f"xla cross frames launched {used}")
        log("xla", f"128^2 card frames: launches {used} (X1, M1 for the masked models: the "
                   "reference runs one masked raster under every backend; R1 for the "
                   "attributes, T1 for the footprints; none of K1-K9)")
        rep["seconds"] = time.perf_counter() - t_phase
        log("xla", f"phase done in {rep['seconds']:.1f} s")
        return rep

    # ---- 7. the Renderer path from scene files, and the CLI
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scene_") as scene_dir:
        report["renderer"] = renderer_phase(dev, smi, Path(scene_dir))
        # ---- 10. observability on the same files
        report["observability"] = observability_phase(dev, smi, Path(report["renderer"]
                                                                     ["scene_json"]))
        # ---- 11. the scene cache and 12. the viewer, on the same files
        report["cache"], warm = scene_cache_phase(dev, smi, Path(report["renderer"]["scene_json"]))
        report["viewer"] = viewer_phase(warm, smi)
        del warm
        # ---- 14. the xla path on the same files
        report["xla"] = xla_path(Path(report["renderer"]["scene_json"]))
        # ---- 15. the frame program on the same files
        report["program"] = program_phase(dev, smi, Path(report["renderer"]["scene_json"]))
    # ---- 16. the masked frame program: the headline geometry with masked models
    with tempfile.TemporaryDirectory(prefix="chip_smoke_masked_scene_") as masked_dir:
        from unclerenderer_tpu_torch.render.testing import write_scene

        t0 = time.perf_counter()
        m_json = write_scene(masked_dir, N_OBJECTS, sphere_res=SPHERE_RES, ground=True,
                             n_materials=6, tex_size=256, env_size=ENV_SIZE, masked=True,
                             name="masked")
        log("masked-program", f"wrote the headline geometry with masked models (every 4th "
                              f"object from 1 an alpha-checker MASK material) in "
                              f"{time.perf_counter() - t0:.2f} s")
        report["masked_program"] = program_phase(dev, smi, m_json, "masked-program")
        check(report["masked_program"]["masked"], "the masked scene's Renderer runs no masked "
                                                  "raster")

    # ---- 13. the row-sharded frame in ranks on this card
    report["multichip"] = multichip_phase(smi)
    # ---- 17. the graft entry: the captured 128^2 frame and the xla dry run
    report["entry"] = entry_phase(smi)
    # ---- 18. the bench entry, a child process at the judged configuration
    report["bench"] = bench_phase(smi, report["program"]["median_ms"]["graph"])

    report["kernels"] = {n: {"calls": k["calls"], "ms": k["ms"], "plain_ms": k["plain_ms"],
                             "graph_ms": k["graph_ms"], "library_ms": k["library_ms"],
                             "library_graph_ms": k["library_graph_ms"],
                             "bound_ms": 1e3 * max(k["bytes_s"], k["ops_s"]),
                             "bound_all_pairs_ms": (1e3 * max(k["bytes_s"], k["all_pairs_ops_s"])
                                                    if k["all_pairs_ops_s"] else None),
                             "launch_us": k["launch_us"],
                             "clone_launch_us": k["clone_launch_us"],
                             "no_records_ms": k["no_records_ms"],
                             "no_records_graph_ms": k["no_records_graph_ms"],
                             "frame": k["frame"]}
                         for n, k in kernels.items()}
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))

    def main_path_launches(name):
        if name == "binned_raster_debug":
            return report["debug"]["launches"]
        if name == "present_u8":  # one render_to_u8 of the Renderer phase
            return report["renderer"]["present_launches"]
        path = ("slice" if name in default_kernels else "fused" if name in attr_kernels else
                "sampling" if name == "shadow_select9_f32" else
                "probes" if name in probe_kernels else
                "xla" if name == "exhaustive_raster" else "packed")
        if name == "masked_raster":  # the masked Renderer's 10 replayed frames
            return report["masked_program"]["launches"]["graph"][name]
        return report[path]["launches"][name]

    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": main_path_launches(n), "max_abs_err": k["err"], "ms": k["ms"],
         "graph_ms": k["graph_ms"],
         "plain_ms": k["plain_ms"], "bound_ms": 1e3 * max(k["bytes_s"], k["ops_s"]),
         "bound_by": "bytes" if k["bytes_s"] >= k["ops_s"] else "operations",
         "library_ms": (k["library_ms"] if k["library"] is not None or k["library_for"]
                        is not None else None),
         "launch_us": k["launch_us"], "clone_launch_us": k["clone_launch_us"],
         "renderer_launches": report["renderer"]["launches"][n],
         "forward_renderer_launches": report["renderer"]["forward"]["launches"][n],
         "viewer_launches": report["viewer"]["launches"][n],
         "multichip_launches": report["multichip"]["full"]["per_rank"][1]["launches"][n],
         "entry_launches": report["entry"]["launches"][n],
         "dryrun_launches": sum(r["launches"][n] for r in report["entry"]["dryrun"]["per_rank"]),
         "bench_launches": report["bench"]["launches"]["headline"].get(n, 0),
         **({"no_records_ms": k["no_records_ms"]} if n in attr_kernels else {}),
         **({"no_debug_ms": k["no_debug_ms"]} if n == "binned_raster_debug" else {}),
         # X1's line times the whole map and camera images; its two kernels apart
         **({"mask_ms": k["frame"]["mask_ms"], "tile_ms": k["frame"]["tile_ms"],
             "mask_bytes": k["frame"]["mask_bytes"], "tpu_kernel": False}
            if n == "exhaustive_raster" else {}),
         **({"tpu_kernel": False} if n in ("masked_raster", "present_u8", "interp_attrs",
                                           "tap_footprint", "material_tap") else {})}
        for n, k in kernels.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
