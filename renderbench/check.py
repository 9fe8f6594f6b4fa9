"""The comparison that decides ``correct``: the frames the program presented
against the reference's frames of the same camera, sun, settings and frame
state, and the program's carried frame state against the reference's.

Frames are compared as presented, (H, W, 3) bytes, without the pixels of
the Renderer's stats block (``overlay_boxes``: it prints counters of the
program's own culling, which the reference does not count).  Each
frame reading is over every compared frame together:

* ``px_off_pct``: the share of pixels, in percent, of which some channel
  lies more than ``OFF_LEVELS`` bytes from the reference's;
* ``mean_abs_level``: the mean absolute byte difference over all
  channels;
* ``max_level``: the largest byte difference (printed, not held: one
  pixel at a silhouette decides it).

The state readings, at the carried run's position: ``history_gap_pct``,
the mean absolute difference of the TAA history over the mean of the
reference's, in percent, and ``ev_gap``, the absolute difference of the
exposure values (infinite where one side has the field and the other
not).

A configuration file's ``"check"`` names the readings held and their
limits; ``correct`` is true when every held reading is at or under its
limit and every frame due for comparison was compared.
"""

from __future__ import annotations

import math

import numpy as np

OFF_LEVELS = 2


def overlay_boxes(height: int, width: int, n_models: int) -> list:
    """The (rows, columns) of each line of the Renderer's stats block
    (GpuDebugPrintStats): "MODELS: v/t", "CULLED: v", "OCCL: v", "EV: -ii.ff",
    counts as wide as the model count, in 12 x 16-pixel cells (the 5x7 font
    at twice its size, 18 rows a line) from (8, 8); a line that does not
    fit the frame is not drawn."""
    d = len(str(n_models))
    boxes = []
    for i, cells in enumerate((8 + d + 1 + d, 8 + d, 6 + d, 10)):
        y0, x1 = 8 + 18 * i, 8 + 12 * cells
        if y0 + 16 <= height and x1 <= width:
            boxes.append((slice(y0, y0 + 16), slice(8, x1)))
    return boxes


def to_u8(color: np.ndarray) -> np.ndarray:
    """(H, W, 3) float colour as the UNORM backbuffer stores it (the
    Renderer's ``render_to_u8`` conversion)."""
    return np.clip(np.rint(color * 255.0), 0, 255).astype(np.uint8)


def comparable(img: np.ndarray, n_models: int) -> np.ndarray:
    """A presented frame (u8, or float colour) with the stats block zeroed."""
    out = (img if img.dtype == np.uint8 else to_u8(img)).copy()
    for box in overlay_boxes(*out.shape[:2], n_models):
        out[box] = 0
    return out


def readings(pairs, n_models: int) -> dict:
    """The frame readings over ``pairs`` of (program, reference) u8 frames
    of a scene of ``n_models`` models."""
    off = total = 0
    abs_sum = 0.0
    channels = 0
    worst = 0
    for prog, ref in pairs:
        if prog.shape != ref.shape:
            raise ValueError(f"frame shapes differ: {prog.shape} vs {ref.shape}")
        d = np.abs(comparable(prog, n_models).astype(np.int16)
                   - comparable(ref, n_models).astype(np.int16))
        per_px = d.max(axis=-1)
        off += int((per_px > OFF_LEVELS).sum())
        total += per_px.size
        abs_sum += float(d.sum(dtype=np.float64))
        channels += d.size
        worst = max(worst, int(per_px.max()))
    return {"px_off_pct": 100.0 * off / max(total, 1),
            "mean_abs_level": abs_sum / max(channels, 1),
            "max_level": float(worst)}


def state_readings(prog, ref) -> dict:
    """The state readings of the program's frame state ``prog`` against the
    reference's ``ref`` (both ``reference.frames.State``)."""
    def gap(a, b, rel):
        if a is None or b is None:
            return 0.0 if a is None and b is None else math.inf
        d = float((a.double() - b.double()).abs().mean())
        return 100.0 * d / max(float(b.double().abs().mean()), 1e-30) if rel else d

    return {"history_gap_pct": gap(prog.history, ref.history, True),
            "ev_gap": gap(prog.ev, ref.ev, False)}


def verdict(values: dict, limits: dict, due: int, compared: int) -> tuple[bool, dict]:
    """(correct, the compared numbers each beside its limit): every held
    reading and the count of frames due but not compared at or under
    their limits."""
    shown = {k: {"value": values.get(k, math.inf), "limit": lim} for k, lim in limits.items()}
    shown["frames_missing"] = {"value": due - compared, "limit": 0}
    return all(v["value"] <= v["limit"] for v in shown.values()), shown
