"""The arithmetic of every metric, end to end and per layer.  Each
``metrics/<name>.py`` binds its ``read`` to one of these functions, so
that two metrics of the same arithmetic in different cells (``frame_ms``
and ``clip_frame_ms``, a per-layer metric and its ``.clip`` twin) share
one body.

An end-to-end reader takes the run's context ``{"timeline": {"t_start",
"presents", "frames"}, "peak_bytes", "setup_s"}``; a per-layer reader the
traced run's ``{"window", "frames", "eager"}`` (``run.traced_phases``).
A reader returns a number, or None where it finds nothing to read (the
metric is then left out of the line).
"""

from __future__ import annotations

from . import roofline, timeline, trace

# -- end to end --------------------------------------------------------------


def frame_ms(ctx):
    """The window's wall ms over the frames presented in it."""
    t = ctx["timeline"]
    return timeline.frame_ms(t["t_start"], t["presents"], t["frames"])


def frame_ms_p95(ctx):
    """95th percentile of every present-to-present interval of the window."""
    t = ctx["timeline"]
    return timeline.frame_ms_p95(t["t_start"], t["presents"])


def peak_gib(ctx):
    """``torch.cuda.max_memory_reserved()`` over set-up and window, in GiB."""
    return ctx["peak_bytes"] / 2**30


def setup_s(ctx):
    """Process start to the first timed frame, in seconds."""
    return ctx["setup_s"]


# -- per layer ---------------------------------------------------------------


def _mean(ms):
    return sum(ms) / len(ms) if ms else None


def call_host_ms(ctx):
    """Host ms of a ``Renderer.render_frame`` call (``render_frames`` over
    its frames in a clip cell), by the host's clock around each call in
    the traced window; the mean over the window's frames."""
    return _mean(ctx["window"]["call_host_ms"])


def frame_device_ms(ctx):
    """Device ms a frame, by CUDA events on the stream before and after each
    ``render_frame`` call (``render_frames`` over its frames) in the traced
    window; the mean.  The span holds the frame program's replay and the
    device's wait for the host's launch of it."""
    return _mean(ctx["window"]["frame_device_ms"])


def map_device_ms(ctx):
    """Device ms of a shadow map redraw, by CUDA events around each
    ``ShadowProgram.run`` in the traced window; the mean (nothing where the
    window redraws no map)."""
    return _mean(ctx["window"]["map_device_ms"])


def pass_ms(name: str):
    """Device ms a frame in the pass ``name``: the profiled op-by-op frames'
    device rows, each tied to the pass ranges around its launch
    (``trace.pass_times``)."""

    def read(ctx):
        eager = ctx["eager"]
        return trace.pass_times(eager["events"], eager["frames"]).get(name)

    return read


def device_idle_pct(ctx):
    """Percent of the traced frames' span (frames driven through the cell's
    own entry, under ``torch.profiler``) in which no device row ran: 100
    minus the union of the rows over the span."""
    frames = ctx["frames"]
    if not frames["rows"] or not frames["span_us"]:
        return None
    return 100.0 * (1.0 - frames["busy_us"] / frames["span_us"])


BINNED_CALLS = {"binned_raster": ("unclerenderer_tpu_torch.ops.raster_kernels", "binned_raster")}


def binned_raster_roofline(ctx):
    """K1's share of its roofline, in percent: the least time the chip could
    take for the K1 calls of the profiled op-by-op frames (the larger of
    their bytes over the memory bandwidth and their operations over the
    f32 rate, ``roofline.work_binned``), over K1's device time in the same
    trace."""
    eager = ctx["eager"]
    calls = eager["calls"].get("binned_raster", [])
    rows = [e for e in eager["events"] if e.get("ph") == "X" and e.get("cat") == "kernel"
            and "binned_raster_kernel" in str(e.get("name"))]
    if not calls or not rows:
        return None
    bound = sum(roofline.bound_s(*roofline.work_binned(*args, **kwargs)) for args, kwargs in calls)
    return 100.0 * bound / (sum(float(e["dur"]) for e in rows) / 1e6)
