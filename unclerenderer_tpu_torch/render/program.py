"""The frame as one device program: the counterpart of the reference's
compiled frame (``unclerenderer_tpu/render/renderer.py:510-513``:
``jax.jit(deferred_frame)`` and ``jax.jit(forward_frame)``; ``:633-643``,
the jitted shadow raster; ``:695-763``, ``render_frames``' ``lax.scan``
with the frame state carried on the device).

On the card a frame is captured once into a CUDA graph
(``torch.cuda.CUDAGraph``) and then replayed: one launch of the whole
frame from the host, where the op-by-op frame makes thousands.

* ``FrameProgram``: one ``deferred_frame`` or ``forward_frame`` of (scene,
  settings).  Its inputs live in static buffers that the graph reads: the
  frame parameters packed into one f32 vector (``flat``, laid out by
  ``params_layout``), the ``FrameState`` fields (deferred) and the shadow
  map.  The graph ends by copying the new state into the state buffers,
  after the frame's last read of them, so a replay carries the state with
  no host step, as the reference donates its scan carry.  ``run()``
  replays and returns clones of the outputs, so what a caller keeps does
  not change at the next replay (the reference returns fresh arrays).
* ``ShadowProgram``: ``render/common.py raster_shadow`` of the casters the
  parameters make visible, captured to write the map into the frame
  program's static map buffer.
* ``supported(settings, dist)``: whether a frame runs with no host
  synchronisation and no data-dependent shape, which capture needs; else
  the reason.  Every setting is; the one refusal left is a row-sharded
  ``dist``, whose frames run op by op.
* ``eager()``: inside it the Renderer runs the card's frames op by op
  (the counterpart of ``jax.disable_jit``); the comparisons and the
  measurement paths use it.

Each program records its spans as timing events in its graph
(``core/passes.py DeviceSpans``: the first and last node, the top-level
passes, the resolve's sub-scopes), read after a replay where tracing is
on, and counts its replays read and unread.

The kernels' wrappers launch on PyTorch's current stream
(``ops/_cuda.py launch``), so they are captured with the rest; the
launches recorded at capture are added to ``_cuda.LAUNCHES`` at every
replay, so the counts say what the card ran.  The kernels build at their
first launch and some inputs are made once (``ops/consts.py``, K6's ticket
counter), so a program is captured only after one frame of the same
settings has run op by op: the Renderer's first frame, a real one, so that
no frame runs that the caller did not ask for.  Capture and replay
failures raise: nothing falls back to the op-by-op frame.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import time

import numpy as np
import torch

from ..core import passes
from ..ops import _cuda
from . import common
from .deferred import deferred_frame
from .forward import forward_frame
from .params import FrameParams, FrameState, RenderSettings

KINDS = ("deferred", "forward")
CPU_REASON = "the CPU runs frames op by op (CUDA graphs are the card's)"

_EAGER = [0]


@contextlib.contextmanager
def eager():
    """Inside the block the Renderer runs the card's frames op by op, as
    without a program (the counterpart of ``jax.disable_jit``)."""
    _EAGER[0] += 1
    try:
        yield
    finally:
        _EAGER[0] -= 1


def eager_active() -> bool:
    return _EAGER[0] > 0


def supported(settings: RenderSettings, dist=None) -> tuple[bool, str]:
    """``(True, "")`` when a frame of ``settings`` can be captured: it makes
    no host synchronisation and every shape is static -- every setting
    (the masked raster, the anisotropic tap compaction and K1's debug
    print included).  A row-sharded ``dist`` is refused, with
    its reason.  ``tests/test_torch_program.py`` holds every setting to a
    trace with no forbidden op."""
    if dist is not None and dist.n_dev > 1:
        return False, "the row-sharded frame runs host-driven collectives (parallel/dist.py)"
    return True, ""


def params_layout(fields: dict) -> tuple:
    """((name, shape), ...) of FrameParams host values, in order: the layout
    of the packed f32 vector ``pack_params`` makes."""
    return tuple((k, np.shape(v)) for k, v in fields.items())


def pack_params(fields: dict) -> np.ndarray:
    """FrameParams host values -> one f32 vector (``model_visible`` as 0/1)."""
    return np.concatenate([np.asarray(v, np.float32).reshape(-1) for v in fields.values()])


def unpack_params(flat: torch.Tensor, layout: tuple) -> FrameParams:
    """The FrameParams views of a packed vector; ``model_visible`` becomes
    bool on the vector's device."""
    out, at = {}, 0
    for name, shape in layout:
        n = int(np.prod(shape, dtype=np.int64))
        out[name] = flat[at:at + n].view(shape)
        at += n
    out["model_visible"] = out["model_visible"] != 0
    return FrameParams(**out)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _replay(graph: torch.cuda.CUDAGraph, counts: collections.Counter,
            spans: passes.DeviceSpans) -> None:
    """Replay ``graph`` (its spans' previous replay read first) and count
    the launches its capture recorded."""
    spans.launch()
    graph.replay()
    for name, n in counts.items():
        _cuda.LAUNCHES[name] += n


def _capture(graph: torch.cuda.CUDAGraph, body, counts: collections.Counter,
             spans: passes.DeviceSpans, device):
    """``body()`` captured into ``graph`` between ``spans``' first and last
    events; the kernel launches it records go to ``counts`` (they run at
    each replay, not now).  Returns (what ``body`` returns, the capture's
    seconds, the device memory reserved meanwhile)."""
    # capture frees the allocator's cached blocks first; freed here, the
    # memory it reserves after is the graph's private pool
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    prev, _cuda.CAPTURED = _cuda.CAPTURED, counts
    t0 = time.perf_counter()
    try:
        # thread-local: the Renderer's background scene reload may use the
        # card from another thread meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"), spans.capturing():
            out = body()
    finally:
        _cuda.CAPTURED = prev
    seconds = time.perf_counter() - t0
    return out, seconds, torch.cuda.memory_reserved(device) - reserved


class FrameProgram:
    """``deferred_frame`` (``kind="deferred"``) or ``forward_frame``
    (``"forward"``) of ``scene`` and ``settings`` as one CUDA graph.

    ``flat``: the first frame's packed parameters (``pack_params`` on the
    device, ``params_layout`` ``layout``), copied into the static ``flat``
    buffer.  ``state`` (deferred): the frame state to start from, cloned
    into the static ``state`` buffers.  ``shadow_map``: the map the frames
    read, taken as the static map buffer itself (the Renderer's cached
    map); None renders the map inside each frame (or none without
    shadows).  A frame of these settings has run op by op before (module
    docstring).

    ``pool_bytes`` is the device memory the capture reserved (the graph's
    private pool), ``capture_s`` the capture's seconds."""

    def __init__(self, scene, settings: RenderSettings, kind: str, flat: torch.Tensor,
                 layout: tuple, state: FrameState | None = None,
                 shadow_map: torch.Tensor | None = None):
        if kind not in KINDS:
            raise ValueError(f"FrameProgram: kind must be one of {KINDS}, got {kind!r}")
        if flat.device.type != "cuda":
            raise ValueError(f"CUDA graphs run on the card, not on {flat.device}: {CPU_REASON}")
        if (kind == "deferred") != (state is not None):
            raise ValueError("FrameProgram: a deferred frame carries a state, a forward one none")
        self.scene, self.settings, self.kind, self.layout = scene, settings, kind, layout
        self.flat = flat.clone()
        self.state = (None if state is None else
                      FrameState(**{f.name: getattr(state, f.name).clone()
                                    for f in dataclasses.fields(FrameState)}))
        self.shadow_map = shadow_map
        self.launches: collections.Counter = collections.Counter()
        self.graph = torch.cuda.CUDAGraph()
        self.spans = passes.DeviceSpans("FrameProgram")
        with passes.scope("FrameProgram.capture"):
            self.out, self.capture_s, self.pool_bytes = _capture(
                self.graph, self._frame, self.launches, self.spans, flat.device)

    def _frame(self) -> dict:
        params = unpack_params(self.flat, self.layout)
        if self.kind == "forward":
            return forward_frame(self.scene, params, self.settings, self.shadow_map)
        out, new = deferred_frame(self.scene, params, self.state, self.settings, self.shadow_map)
        # after the frame's last read of the state (TAA history, HZB)
        for f in dataclasses.fields(FrameState):
            getattr(self.state, f.name).copy_(getattr(new, f.name))
        return out

    def load_params(self, flat: torch.Tensor) -> None:
        """Copy the next frame's packed parameters into the static buffer,
        on the stream (a pinned host vector copies without blocking)."""
        self.flat.copy_(flat, non_blocking=True)

    def replay(self) -> dict:
        """One frame: the graph replayed and its launches counted.  Returns
        the static outputs, which the next replay overwrites."""
        with passes.scope("FrameProgram.replay"):
            _replay(self.graph, self.launches, self.spans)
        return self.out

    def run(self) -> dict:
        """One frame, its outputs cloned: they stay as they are when the
        next frame replays."""
        out = self.replay()
        with passes.scope("FrameProgram.clone"):
            return _clone(out)


class ShadowProgram:
    """``raster_shadow`` of the casters of ``program``'s parameters
    (``model_visible``'s draw masks, ``light_view_proj``), read from its
    static ``flat`` buffer, as one CUDA graph that writes the map into the
    program's static ``shadow_map`` buffer and the dropped-caster count
    into ``overflow``.  The map has been rendered op by op before (the
    Renderer's first frame)."""

    def __init__(self, program: FrameProgram):
        if program.shadow_map is None:
            raise ValueError("ShadowProgram: the frame program reads no shadow map buffer")
        self.program = program
        self.overflow = torch.zeros((), dtype=torch.int32, device=program.flat.device)
        self.launches: collections.Counter = collections.Counter()
        self.graph = torch.cuda.CUDAGraph()
        self.spans = passes.DeviceSpans("ShadowProgram")
        with passes.scope("ShadowProgram.capture"):
            _, self.capture_s, self.pool_bytes = _capture(
                self.graph, self._raster, self.launches, self.spans, program.flat.device)

    def _raster(self) -> None:
        p = self.program
        params = unpack_params(p.flat, p.layout)
        opaque, masked = common.tri_draw_masks(p.scene, params.model_visible, p.settings)
        depth, overflow = common.raster_shadow(p.scene, params.light_view_proj, opaque | masked,
                                               p.settings)
        p.shadow_map.copy_(depth)
        self.overflow.copy_(overflow)

    def run(self) -> torch.Tensor:
        """Render the map into the frame program's buffer; returns the
        (device) dropped-caster count."""
        _replay(self.graph, self.launches, self.spans)
        return self.overflow
