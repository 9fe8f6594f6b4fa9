"""Readers of the spans the port records inside its frame
(``unclerenderer_tpu_torch/core/passes.py``).

Two sources: the host spans (``Renderer.present.u8``, ...) are
``record_function`` ranges in the traced frames' profiler trace
(``ctx["frames"]["events"]``: the frames driven through the cell's own
entry), and the replays' device spans are the records ``passes.STORE``
read from the timing events each captured program records (only a
profiled phase fills it, and the op-by-op phase replays nothing).  Where
the program records neither (a port without them), each reader returns
None and the metric is left out of the line.

Every reading is taken under the profiler, whose device tracing slows a
kernel by a few microseconds: a replay reads 3.5-4.3 ms (of 77) above an
untraced one on an H100, and a span of many small kernels more than its
share (the masked raster +35%, the shadow map's redraw +58-73%).  So a
``program.*`` or ``shadow.*`` span here compares with readings under the
profiler, never with ``program.frame_device_ms`` or
``shadow.map_device_ms`` of the untraced window; and a change that cuts
kernels moves it by their tracing cost too.
"""

from __future__ import annotations

from . import trace


def _store():
    """The port's span store, its pending replays read; None where the
    port has none."""
    try:
        from unclerenderer_tpu_torch.core import passes
    except ImportError:
        return None
    if not hasattr(passes, "STORE") or not hasattr(passes, "collect"):
        return None
    passes.collect()
    return passes.STORE


def replay_ms(program: str, name: str | None = None):
    """Device ms of the span ``name`` (a pass or sub-scope; None: the
    program's first-to-last span) in a replay of ``program``
    ("FrameProgram", "ShadowProgram"), the ms of a name that recurs in a
    replay summed; the mean over the replays read."""

    def read(ctx):
        store = _store()
        if store is None:
            return None
        key = name or program
        ms = [spans[key] for spans in store.spans(program).values() if key in spans]
        return sum(ms) / len(ms) if ms else None

    return read


def _card_frames(ctx):
    """The traced frames' context where they ran on a card (device rows in
    the trace), else None: on the CPU a read-back copies nothing and the
    host does the device's work too."""
    frames = ctx["frames"]
    return frames if frames["rows"] and frames["frames"] else None


def host_ms(span: str):
    """Host ms a frame in the range ``span``: the durations of its ranges in
    the traced frames, over the frames."""

    def read(ctx):
        frames = _card_frames(ctx)
        if frames is None:
            return None
        us = [float(e.get("dur", 0.0)) for e in frames["events"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e.get("name") == span]
        return sum(us) / 1e3 / frames["frames"] if us else None

    return read


def device_ms_in(span: str):
    """Device ms a frame of the rows whose launch lies in the range ``span``
    (``trace.scope_paths``), over the traced frames."""

    def read(ctx):
        frames = _card_frames(ctx)
        if frames is None:
            return None
        us = [dur for _name, dur, path in trace.scope_paths(frames["events"])
              if span in path.split("/")]
        return sum(us) / 1e3 / frames["frames"] if us else None

    return read
