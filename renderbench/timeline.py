"""End-to-end metrics from the window's timeline, on the host's clock.

A frame counts when its colour is on the host.  ``presents`` holds the
host time of each step of the client (one frame, or a clip's frames, which
arrive together) and ``frames`` how many frames each step brought.
"""

from __future__ import annotations

import numpy as np


def frame_ms(t_start: float, presents: list, frames: list) -> float:
    """The window's wall time over the frames presented in it."""
    return (presents[-1] - t_start) * 1e3 / sum(frames)


def frame_ms_p95(t_start: float, presents: list) -> float:
    """95th percentile of the present-to-present intervals of every frame,
    the first from the window's start (numpy's linear interpolation)."""
    intervals = np.diff(np.concatenate([[t_start], presents])) * 1e3
    return float(np.percentile(intervals, 95))
