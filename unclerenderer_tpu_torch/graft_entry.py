"""The graft entry points of the port: the counterpart of the repository's
``__graft_entry__.py``.

* ``entry(device="cuda") -> (fn, args)``: the deferred frame of a 128^2
  synthetic scene at the reference entry's settings, as a function of
  ``(scene, params, state)`` returning ``(color, new_state)``, with its
  arguments.  On the card its frame runs the kernel path: K1, K2, K4, K5.
* ``compile_check(fn, args) -> dict``: the counterpart of
  ``jax.jit(fn)(*args)``.  The port's compiled frame is a CUDA graph
  (``render/program.py``): one op-by-op call (the kernels build, the
  frame's constants are made), then ``fn(*args)`` captured with no host
  sync allowed, replayed once and held bit for bit against a second
  op-by-op call.  The card only: CPU tensors raise ``ValueError``.
* ``dryrun_multichip(n_ranks, device="cuda")``: the row-sharded frame
  (``parallel/multichip.py``) in ``n_ranks`` spawned ranks on
  ``raster_backend="xla"`` with every feature on, 4 frames with camera
  motion and carried state, against the single-device frame: tri_id bit
  for bit, colour within 1e-5 (the slab seams too), the final exposure
  within 1e-4.  On a one-card host every rank shares the card over gloo.

``python -m unclerenderer_tpu_torch.graft_entry [--device cpu] [--n 8]``
runs ``entry``, ``compile_check`` (on the card; op by op on the CPU) and
``dryrun_multichip``; it exits non-zero on any failure, and without a
visible card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import sys
import tempfile
import time

import numpy as np
import torch

from . import interop
from .core import passes
from .ops import _cuda
from .parallel.multichip import run_ranks
from .render import program
from .render.deferred import deferred_frame
from .render.params import FrameState, RenderSettings
from .render.testing import sharded_frames, synthetic_device_scene, synthetic_frame_params

ENTRY_SIZE = 128
DRYRUN_ATOL = 1e-5  # colour: the sharded exposure grid's sum order
DRYRUN_EV_ATOL = 1e-4
DRYRUN_FRAMES = 4
DRYRUN_TIMEOUT = 600.0  # seconds for the ranks' collectives and the join


def _device(device) -> torch.device:
    """``device`` as a torch device; RuntimeError for a card that is not
    there (no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{dev} asked for, but no CUDA card is visible; pass device='cpu' "
                           "to run on the CPU")
    return dev


def entry(device="cuda"):
    """``(fn, (scene, params, state))``: the reference entry's 128^2
    deferred frame (``__graft_entry__.py entry``) on ``device``.
    ``raster_backend="auto"`` is the kernel path on either device."""
    dev = _device(device)
    settings = RenderSettings(
        width=ENTRY_SIZE,
        height=ENTRY_SIZE,
        shadow_map_size=ENTRY_SIZE,
        raster_backend="auto",
        enable_ibl=False,
        tile_h=16,
        tile_w=64,
        chunk=64,
        shadow_chunk=64,
    )
    scene, data = synthetic_device_scene(4, device=dev)
    params = synthetic_frame_params(data, settings.width, settings.height, device=dev)
    state = FrameState.initial(settings.width, settings.height, dev)

    def fn(scene, params, state):
        out, new_state = deferred_frame(scene, params, state, settings)
        return out["color"], new_state

    fn.settings = settings
    return fn, (scene, params, state)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor as integers, so that equality is bit for bit (signed zeros
    and NaN payloads included)."""
    return t.view(torch.int32) if t.dtype in (torch.float32, torch.uint32) else t


def _differing(a: tuple, b: tuple) -> dict:
    """{output name: differing elements} of two ``(color, FrameState)``."""
    pairs = [("color", a[0], b[0])] + [(f.name, getattr(a[1], f.name), getattr(b[1], f.name))
                                       for f in dataclasses.fields(FrameState)]
    diff = {k: int((_bits(x) != _bits(y)).sum()) for k, x, y in pairs}
    return {k: v for k, v in diff.items() if v}


def compile_check(fn, args) -> dict:
    """``fn(*args)`` (``entry``'s) as one CUDA graph: an op-by-op call
    first (the kernels build and ``ops/consts.py`` makes its inputs), then
    the capture under ``torch.cuda.set_sync_debug_mode("error")`` (a host
    sync fails it), one replay, and the replayed colour and every new
    state field bit-equal to a second op-by-op call.  Returns the shape,
    the capture seconds, the kernel launches a replay (recorded at
    capture) and the graph pool's bytes.  CPU tensors raise
    ``ValueError``: nothing falls back to op by op."""
    devices = {v.device for a in args
               for v in (vars(a).values() if dataclasses.is_dataclass(a) else (a,))
               if isinstance(v, torch.Tensor)}
    if any(d.type != "cuda" for d in devices):
        raise ValueError(f"compile_check: the arguments lie on {sorted(map(str, devices))}: "
                         f"{program.CPU_REASON}")
    settings = getattr(fn, "settings", None)
    if settings is not None:
        ok, why = program.supported(settings)
        if not ok:
            raise ValueError(f"compile_check: the frame cannot be captured: {why}")
    fn(*args)  # op by op: builds the kernels, makes the frame's constants
    want = fn(*args)
    torch.cuda.synchronize()

    def body():
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    graph, launches = torch.cuda.CUDAGraph(), collections.Counter()
    spans = passes.DeviceSpans("compile_check")
    device = next(iter(devices))
    got, capture_s, pool_bytes = program._capture(graph, body, launches, spans, device)
    program._replay(graph, launches, spans)
    torch.cuda.synchronize()
    diff = _differing(got, want)
    if diff:
        raise AssertionError(f"compile_check: the replay differs from op by op: {diff}")
    return {"shape": tuple(got[0].shape), "capture_s": capture_s,
            "launches": {k: v for k, v in launches.items() if v}, "pool_bytes": pool_bytes}


def dryrun_settings(n_ranks: int) -> dict:
    """The dry run's ``RenderSettings`` keywords (``__graft_entry__.py``'s):
    64 columns, 16 rows a rank, the XLA backend, IBL, HZB and masked
    models on."""
    return dict(width=64, height=16 * n_ranks, shadow_map_size=16 * n_ranks,
                raster_backend="xla", enable_ibl=True, enable_hzb=True, has_masked_models=True,
                tile_h=8, tile_w=64, chunk=64, shadow_chunk=64)


def dryrun_cameras() -> list:
    """Frame f's camera at ``(4 sin a, 1.5, -4 cos a)``, ``a = 0.12 (f - 1)``;
    frame 1's is the synthetic default ``(0, 1.5, -4)``."""
    return [(4.0 * np.sin(0.12 * i), 1.5, -4.0 * np.cos(0.12 * i))
            for i in range(DRYRUN_FRAMES)]


def _dryrun_rank(rank, group, spec) -> dict:
    """A rank of the dry run: ``sharded_frames`` with its kernel launches
    counted.  Returns ``{"frames": rank 0's gathered frames or None,
    "launches": the launches}``."""
    _cuda.reset_launches()
    frames = sharded_frames(rank, group, spec)
    return {"frames": frames, "launches": dict(_cuda.LAUNCHES)}


def dryrun_multichip(n_ranks: int, device="cuda", rank_fn=_dryrun_rank) -> dict:
    """The row-sharded frame in ``n_ranks`` ranks on ``device`` against the
    single-device frame (``__graft_entry__.py dryrun_multichip``): 4
    carried frames with camera motion (TAA history, exposure and the HZB's
    one-frame latency), tri_id bit-equal every frame, colour finite and
    within ``DRYRUN_ATOL`` (the seam rows on their own), the last exposure
    within ``DRYRUN_EV_ATOL``.  A failure raises AssertionError naming the
    frame (and the seam).  On the card the kernels are built here first,
    so that the ranks do not race to build them.  ``rank_fn(rank, group,
    spec)`` is what each rank runs (a module-level function, for the
    spawned ranks): ``_dryrun_rank`` or a wrapper of it that adds keys to
    its dict.  Prints the OK line and returns the errors, seconds and each
    rank's dict without its frames (``per_rank``: the kernel launches and
    what ``rank_fn`` added)."""
    dev = _device(device)
    if dev.type == "cuda":
        _cuda.build()
    kw = dryrun_settings(n_ranks)
    settings = RenderSettings(**kw)
    w, h = settings.width, settings.height
    cams = dryrun_cameras()
    spec = dict(device=str(dev), settings=kw, scene=dict(n_objects=8, with_masked=True),
                cameras=cams)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as d:
        ranks = run_ranks(rank_fn, n_ranks, f"file://{d}/rendezvous", args=(spec,),
                          device=str(dev), timeout=DRYRUN_TIMEOUT)
    ranks_s = time.perf_counter() - t0

    scene, data = synthetic_device_scene(8, with_masked=True, device=dev)
    state = FrameState.initial(w, h, dev)
    slab_h = h // n_ranks
    color_err = seam_err = 0.0
    for f, (cam, got) in enumerate(zip(cams, ranks[0]["frames"]), start=1):
        params = synthetic_frame_params(data, w, h, camera_pos=cam, device=dev)
        out, state = deferred_frame(scene, params, state, settings)
        want = interop.to_numpy(out)
        color = got["color"]
        if color.shape != (h, w, 3) or not np.isfinite(color).all():
            raise AssertionError(f"frame {f}: colour of shape {color.shape}, finite "
                                 f"{bool(np.isfinite(color).all())}")
        np.testing.assert_array_equal(got["tri_id"], want["tri_id"],
                                      err_msg=f"frame {f} tri_id (HZB latency path)")
        np.testing.assert_allclose(color, want["color"], rtol=0, atol=DRYRUN_ATOL,
                                   err_msg=f"frame {f} color")
        color_err = max(color_err, float(np.abs(color - want["color"]).max()))
        for s in range(1, n_ranks):
            seam = slice(s * slab_h - 1, s * slab_h + 1)
            np.testing.assert_allclose(color[seam], want["color"][seam], rtol=0,
                                       atol=DRYRUN_ATOL, err_msg=f"frame {f} seam {s}")
            seam_err = max(seam_err, float(np.abs(color[seam] - want["color"][seam]).max()))
    ev = float(got["exposure_ev"])
    ev_err = abs(ev - float(state.exposure_ev))
    if not ev_err < DRYRUN_EV_ATOL:
        raise AssertionError(f"frame {f}: exposure {ev} against {float(state.exposure_ev)}")
    print(f"dryrun_multichip OK: {n_ranks} ranks, color {color.shape}, ev={ev:.3f}; "
          "single-device parity held (tri_id bit-equal, color atol<=1e-5 incl. seam rows, "
          f"{len(cams)} frames with camera motion + HZB latency + carried TAA/exposure state)",
          flush=True)
    return {"ranks": n_ranks, "device": str(dev), "frames": len(cams), "shape": color.shape,
            "ranks_s": ranks_s, "seconds": time.perf_counter() - t0, "color_err": color_err,
            "seam_err": seam_err, "ev_err": ev_err,
            "per_rank": [{k: v for k, v in r.items() if k != "frames"} for r in ranks]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m unclerenderer_tpu_torch.graft_entry",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' runs the kernels' plain versions "
                         "and the frame op by op)")
    ap.add_argument("--n", type=int, default=8, help="ranks of the dry run (default: 8)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"graft_entry: no CUDA card is visible for --device {args.device}; pass "
              "--device cpu to run on the CPU", file=sys.stderr)
        return 2
    fn, fn_args = entry(args.device)
    if torch.device(args.device).type == "cuda":
        rep = compile_check(fn, fn_args)
        print("entry OK:", rep["shape"], f"(captured in {rep['capture_s']:.3f} s, launches a "
              f"replay {rep['launches']}, pool {rep['pool_bytes'] / 2**20:.1f} MiB; the replay "
              "bit-equal to op by op)", flush=True)
    else:
        color, _state = fn(*fn_args)
        print("entry OK:", tuple(color.shape), f"(op by op: {program.CPU_REASON})", flush=True)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
