"""Debug text overlay, host side (``unclerenderer_tpu/core/debugprint.py``).

The D3D12 renderer's shaders append glyphs into a device buffer that a
draw pass rasterizes (``Renderer.cpp:474-884``, ``GpuDebugPrint*.hlsl``).
The in-frame stats block is ``ops/overlay.py`` on the frame's device; this
module holds the 5x7 bitmap font both use and rasterizes the overlays that
are host concepts (the picked model's box and name, the axis gizmo, timing
tables, and the stats block when the in-frame one is off) into a float
image.
"""

from __future__ import annotations

import numpy as np

# 5x7 font for the printable stats characters (columns LSB = top row).
_GLYPHS = {}


def _g(ch, rows):
    _GLYPHS[ch] = np.array(
        [[1 if c == "#" else 0 for c in row.ljust(5)] for row in rows], np.uint8
    )


_g("0", ["0####", "#...#", "#..##", "#.#.#", "##..#", "#...#", "####0"])
_g("1", ["..#..", ".##..", "..#..", "..#..", "..#..", "..#..", ".###."])
_g("2", [".###.", "#...#", "....#", "...#.", "..#..", ".#...", "#####"])
_g("3", [".###.", "#...#", "....#", "..##.", "....#", "#...#", ".###."])
_g("4", ["...#.", "..##.", ".#.#.", "#..#.", "#####", "...#.", "...#."])
_g("5", ["#####", "#....", "####.", "....#", "....#", "#...#", ".###."])
_g("6", [".###.", "#....", "####.", "#...#", "#...#", "#...#", ".###."])
_g("7", ["#####", "....#", "...#.", "..#..", ".#...", ".#...", ".#..."])
_g("8", [".###.", "#...#", ".###.", "#...#", "#...#", "#...#", ".###."])
_g("9", [".###.", "#...#", "#...#", ".####", "....#", "....#", ".###."])
_g(":", [".....", "..#..", ".....", ".....", "..#..", ".....", "....."])
_g(".", [".....", ".....", ".....", ".....", ".....", "..#..", "..#.."])
_g("/", ["....#", "...#.", "...#.", "..#..", ".#...", ".#...", "#...."])
_g("-", [".....", ".....", ".....", "#####", ".....", ".....", "....."])
_g(" ", [".....", ".....", ".....", ".....", ".....", ".....", "....."])
for ch, rows in {
    "A": [".###.", "#...#", "#...#", "#####", "#...#", "#...#", "#...#"],
    "C": [".###.", "#...#", "#....", "#....", "#....", "#...#", ".###."],
    "D": ["####.", "#...#", "#...#", "#...#", "#...#", "#...#", "####."],
    "E": ["#####", "#....", "####.", "#....", "#....", "#....", "#####"],
    "F": ["#####", "#....", "####.", "#....", "#....", "#....", "#...."],
    "G": [".###.", "#....", "#....", "#.###", "#...#", "#...#", ".###."],
    "I": [".###.", "..#..", "..#..", "..#..", "..#..", "..#..", ".###."],
    "L": ["#....", "#....", "#....", "#....", "#....", "#....", "#####"],
    "M": ["#...#", "##.##", "#.#.#", "#...#", "#...#", "#...#", "#...#"],
    "N": ["#...#", "##..#", "#.#.#", "#..##", "#...#", "#...#", "#...#"],
    "O": [".###.", "#...#", "#...#", "#...#", "#...#", "#...#", ".###."],
    "P": ["####.", "#...#", "#...#", "####.", "#....", "#....", "#...."],
    "R": ["####.", "#...#", "#...#", "####.", "#.#..", "#..#.", "#...#"],
    "S": [".####", "#....", ".###.", "....#", "....#", "#...#", ".###."],
    "T": ["#####", "..#..", "..#..", "..#..", "..#..", "..#..", "..#.."],
    "U": ["#...#", "#...#", "#...#", "#...#", "#...#", "#...#", ".###."],
    "V": ["#...#", "#...#", "#...#", "#...#", ".#.#.", ".#.#.", "..#.."],
    "Z": ["#####", "....#", "...#.", "..#..", ".#...", "#....", "#####"],
    "B": ["####.", "#...#", "#...#", "####.", "#...#", "#...#", "####."],
    "H": ["#...#", "#...#", "#...#", "#####", "#...#", "#...#", "#...#"],
    "J": ["..###", "...#.", "...#.", "...#.", "...#.", "#..#.", ".##.."],
    "K": ["#...#", "#..#.", "#.#..", "##...", "#.#..", "#..#.", "#...#"],
    "Q": [".###.", "#...#", "#...#", "#...#", "#.#.#", "#..#.", ".##.#"],
    "W": ["#...#", "#...#", "#...#", "#...#", "#.#.#", "##.##", "#...#"],
    "X": ["#...#", "#...#", ".#.#.", "..#..", ".#.#.", "#...#", "#...#"],
    "Y": ["#...#", "#...#", ".#.#.", "..#..", "..#..", "..#..", "..#.."],
}.items():
    _g(ch, rows)


def draw_text(image: np.ndarray, x: int, y: int, text: str, color=(1.0, 1.0, 0.2), scale: int = 2) -> np.ndarray:
    """Rasterize text onto an (H, W, 3) float image (in place; returns it).

    Prefers the antialiased TTF atlas baked by the native ttf_bake
    (core/fontbake.py -- the reference's stb_truetype DebugPrintFont analog,
    ``DebugPrintFont.cpp:37-93``); falls back to the built-in 5x7 bitmap
    font when the native library or a system .ttf is unavailable."""
    from .fontbake import bake_font, draw_text_ttf

    font = bake_font(pixel_height=9.0 * scale)
    if font is not None:
        return draw_text_ttf(image, x, y, text, font, color=color)
    h, w = image.shape[:2]
    col = np.asarray(color, image.dtype)
    cx = x
    for ch in text.upper():
        glyph = _GLYPHS.get(ch)
        if glyph is None:
            cx += 6 * scale
            continue
        gs = np.repeat(np.repeat(glyph, scale, 0), scale, 1)
        gh, gw = gs.shape
        y1, x1 = min(y + gh, h), min(cx + gw, w)
        if y1 > y and x1 > cx:
            region = image[y : y1, cx : x1]
            mask = gs[: y1 - y, : x1 - cx, None].astype(bool)
            region[...] = np.where(mask, col, region)
        cx += 6 * scale
    return image


def draw_line(image: np.ndarray, x0: float, y0: float, x1: float, y1: float,
              color=(1.0, 0.9, 0.1)) -> np.ndarray:
    """Rasterize a 1-px line onto an (H, W, 3) float image (in place)."""
    h, w = image.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
    xs = np.rint(np.linspace(x0, x1, n)).astype(np.int64)
    ys = np.rint(np.linspace(y0, y1, n)).astype(np.int64)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    image[ys[keep], xs[keep]] = np.asarray(color, image.dtype)
    return image


# AABB corner pairs forming the 12 wireframe edges (bit i of the corner index
# selects min/max on axis i) -- same box the reference draws for the picked
# model (``Application.cpp:754-820``).
_BOX_EDGES = [
    (0, 1), (2, 3), (4, 5), (6, 7),  # x edges
    (0, 2), (1, 3), (4, 6), (5, 7),  # y edges
    (0, 4), (1, 5), (2, 6), (3, 7),  # z edges
]


def project_aabb_corners(bounds_min, bounds_max, view_proj, width: int, height: int):
    """Project the 8 world-space AABB corners to pixel coords.

    Returns (pts (8, 2) f32, ok (8,) bool) -- ok is False behind the camera
    (w <= 0); edges with either endpoint not ok are skipped (the reference
    skips the whole box in that case, ``Application.cpp:779-789``)."""
    bmin = np.asarray(bounds_min, np.float32)
    bmax = np.asarray(bounds_max, np.float32)
    corners = np.array(
        [
            [bmax[0] if i & 1 else bmin[0],
             bmax[1] if i & 2 else bmin[1],
             bmax[2] if i & 4 else bmin[2], 1.0]
            for i in range(8)
        ],
        np.float32,
    )
    clip = corners @ np.asarray(view_proj, np.float32)
    ok = clip[:, 3] > 1e-6
    w_safe = np.where(ok, clip[:, 3], 1.0)
    ndc = clip[:, :2] / w_safe[:, None]
    px = (ndc[:, 0] * 0.5 + 0.5) * width
    py = (0.5 - ndc[:, 1] * 0.5) * height
    return np.stack([px, py], 1), ok


def selection_overlay(image: np.ndarray, bounds_min, bounds_max, view_proj,
                      name: str = "", color=(1.0, 0.85, 0.1)) -> np.ndarray:
    """Draw the picked model's projected AABB wireframe + its name (the
    reference's selection overlay, ``Application.cpp:754-820``)."""
    h, w = image.shape[:2]
    pts, ok = project_aabb_corners(bounds_min, bounds_max, view_proj, w, h)
    for a, b in _BOX_EDGES:
        if ok[a] and ok[b]:
            draw_line(image, pts[a, 0], pts[a, 1], pts[b, 0], pts[b, 1], color)
    if name and ok.any():
        top = pts[ok].min(axis=0)
        draw_text(image, int(top[0]), max(int(top[1]) - 18, 0), name, color)
    return image


def axis_gizmo(image: np.ndarray, view, size: int = 40, margin: int = 16) -> np.ndarray:
    """Screen-corner world-axis gizmo (``Application.cpp:59-96``): the world
    X/Y/Z directions rotated into view space, drawn bottom-left with RGB
    colors and labels; axes pointing away from the camera draw dimmed."""
    h, _w = image.shape[:2]
    ox, oy = margin + size, h - margin - size
    rot = np.asarray(view, np.float32)[:3, :3]  # row-vector convention
    colors = [(1.0, 0.25, 0.25), (0.3, 1.0, 0.3), (0.35, 0.55, 1.0)]
    for i, label in enumerate(("X", "Y", "Z")):
        v = rot[i]  # view-space direction of world axis i
        dx, dy = v[0] * size, -v[1] * size
        c = colors[i] if v[2] >= 0.0 else tuple(x * 0.45 for x in colors[i])
        draw_line(image, ox, oy, ox + dx, oy + dy, c)
        draw_text(image, int(ox + dx * 1.25) - 4, int(oy + dy * 1.25) - 6,
                  label, c, scale=1)
    return image


def timing_overlay(image: np.ndarray, rows: list, origin=(8, 100)) -> np.ndarray:
    """Composite a rolling per-pass timing table (the reference's in-UI
    GPU-timing block, ``Application.cpp:1439-1472``).  ``rows`` is
    PassTimingStats.stats() output."""
    x, y = origin
    draw_text(image, x, y, "PASS MS AVG/MAX", (0.4, 1.0, 1.0))
    for i, s in enumerate(rows[:10]):
        line = f"{s['name'][:14]}: {s['avg_ms']:.1f}/{s['max_ms']:.1f}"
        draw_text(image, x, y + (i + 1) * 18, line, (0.4, 1.0, 1.0))
    return image


def stats_overlay(image: np.ndarray, stats: dict, origin=(8, 8)) -> np.ndarray:
    """Composite the reference's debug-print stats block (FRUSTUM/OCCLUDE
    counters, model counts -- GpuDebugPrintStats.hlsl:33-47) onto a frame."""
    x, y = origin
    lines = [
        f"MODELS: {stats.get('models_visible', 0)}/{stats.get('models_total', 0)}",
        f"CULLED: {stats.get('models_culled', 0)}",
        f"TRIS: {stats.get('triangles_total', 0)}",
    ]
    if "exposure_ev" in stats:
        lines.append(f"EV: {stats['exposure_ev']:.2f}")
    out = np.array(image, copy=True)
    for i, line in enumerate(lines):
        draw_text(out, x, y + i * 18, line)
    return out
