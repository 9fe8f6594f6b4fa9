"""Readers of the device counters the port sums over the traced frames
(``unclerenderer_tpu_torch/core/passes.py COUNTERS``: the Renderer adds a
frame's counters while a profiler records, so the store holds the traced
run's profiled frames and nothing of the untimed set-up or the window).
Where the port keeps no such store, or the run had no card, each reader
returns None and the metric is left out of the line."""

from __future__ import annotations


def _totals():
    """The port's counter sums, or None where it keeps none."""
    try:
        from unclerenderer_tpu_torch.core import passes
    except ImportError:
        return None
    store = getattr(passes, "COUNTERS", None)
    return None if store is None else store.totals()


def ratio(num: str, den: str, scale: float = 1.0):
    """``scale`` times the summed counter ``num`` over the summed ``den``,
    over the traced frames on a card."""

    def read(ctx):
        frames = ctx["frames"]
        if not (frames["rows"] and frames["frames"]):
            return None
        totals = _totals()
        if not totals or not totals.get(den):
            return None
        return scale * totals.get(num, 0) / totals[den]

    return read
