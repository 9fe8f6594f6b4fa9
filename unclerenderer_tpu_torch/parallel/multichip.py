"""The row-sharded frame (``unclerenderer_tpu/parallel/multichip.py``): the
viewport's rows split over the ranks of a ``torch.distributed`` process
group.

The frame is ``render.deferred.deferred_frame`` -- the same body as on one
device, every feature on (IBL, alpha-masked geometry, HZB occlusion, the
kernels) -- run in each rank with ``parallel.dist.RowShards`` hooks:

* geometry, material tables and atlases are replicated; each rank owns a
  horizontal slab of the viewport (H/n rows), rasterized in global pixel
  coordinates (the kernels' ``y_offset``) over the region of whole raster
  tiles around it, so its pixels are the single-device frame's bit for
  bit wherever the slab boundary cuts a tile (``render/common.py _slab``);
* the shadow map is rasterized in row slabs, then all-gathered;
* the HZB is built on every rank from the all-gathered depth, so the next
  frame's occlusion culling sees the whole screen;
* auto-exposure sums each slab's partial sums of the global 16x16 grid;
* TAA and CAS take the neighbours' edge rows at the slab seams;
* the TAA history stays with its slab; image outputs come back as slabs
  (``gather_frame`` assembles them), scalars, the HZB and ``tri_remap``
  are the same on every rank.

``init_render_group`` starts the process group (the counterpart of the
reference's ``make_render_mesh``): gloo for CPU tensors and for several
ranks on one card, NCCL when each rank has a card of its own.
``run_ranks`` spawns the ranks of one call and joins them within a time
limit.
"""

from __future__ import annotations

import dataclasses
import datetime
import queue
import time
import traceback

import torch
import torch.distributed as dist

from ..render.deferred import deferred_frame
from ..render.params import DeviceScene, FrameParams, FrameState, RenderSettings
from .dist import RowShards

# image outputs of deferred_frame: one slab per rank
SLAB_KEYS = ("color", "hdr", "depth", "tri_id", "object_id")


def init_render_group(rank: int, world_size: int, init_method: str, device="cuda",
                      timeout: float = 120.0):
    """Join the process group of ``world_size`` ranks at ``init_method``
    (e.g. ``file:///tmp/x/rendezvous``, a path no earlier group used) and
    return it: NCCL when ``device`` is a card (the default) and the host has
    a card for every rank (rank r then renders on ``cuda:r``), else gloo
    (``device="cpu"`` asks for it).  Every collective waits at most
    ``timeout`` seconds."""
    dev = torch.device(device)
    own_card = dev.type == "cuda" and torch.cuda.device_count() >= world_size
    backend = "nccl" if own_card else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout))
    return dist.group.WORLD


def render_frame_multichip(scene: DeviceScene, params: FrameParams, state: FrameState,
                           settings: RenderSettings, group=None, shadow_map=None):
    """This rank's slab of one deferred frame over ``group`` (None: the
    default group).  ``state.taa_history`` is the rank's slab
    (``slab_state``).  Returns ``(out, new_state)``: the image outputs
    (``SLAB_KEYS``) and the new history are the slab's rows; the rest is
    the same on every rank."""
    return deferred_frame(scene, params, state, settings, shadow_map,
                          RowShards(group, settings.height))


def slab_state(state: FrameState, settings: RenderSettings, group=None) -> FrameState:
    """This rank's share of a whole-frame state: its rows of the TAA
    history."""
    d = RowShards(group, settings.height)
    return dataclasses.replace(
        state, taa_history=state.taa_history[d.row0:d.row0 + d.slab_h].clone())


def gather_frame(out: dict, settings: RenderSettings, group=None, keys=SLAB_KEYS):
    """The slabs of ``out[keys]`` assembled into whole-frame images on rank
    0 (every rank must call it): ``out`` with those images there, None on
    the other ranks."""
    d = RowShards(group, settings.height)
    full = dict(out)
    for k in keys:
        v = out[k]
        if v.dtype == torch.uint32:  # ids below 2^24: gathered as their int32 bits
            full[k] = d.all_gather_rows(v.view(torch.int32)).view(torch.uint32)
        else:
            full[k] = d.all_gather_rows(v)
    return full if d.rank == 0 else None


def _rank_entry(rank, world_size, init_method, device, timeout, results, fn, args):
    """One spawned rank: join the group, run ``fn(rank, group, *args)`` and
    report its result (or its traceback) to the parent."""
    try:
        group = init_render_group(rank, world_size, init_method, device, timeout)
        try:
            results.put((rank, "ok", fn(rank, group, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 -- reported to the parent, which raises
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_ranks(fn, world_size: int, init_method: str, args=(), device="cuda",
              timeout: float = 300.0):
    """Spawn ``world_size`` processes, each joining the group at
    ``init_method`` (``init_render_group`` with ``device``: the card by
    default, ``"cpu"`` for gloo on the host) and running ``fn(rank, group,
    *args)`` (a module-level function); return their results in rank order.
    Raises RuntimeError when a rank fails or the ranks are not done within
    ``timeout`` seconds; no rank outlives the call."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(r, world_size, init_method, str(device), timeout, results,
                               fn, args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"run_ranks: {world_size - len(got)} of {world_size} ranks "
                                   f"not done within {timeout} s")
            try:
                rank, status, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(f"run_ranks: a rank exited with code {dead[0]} "
                                       "without a result") from None
                continue
            if status == "error":
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
    return [got[r] for r in range(world_size)]
