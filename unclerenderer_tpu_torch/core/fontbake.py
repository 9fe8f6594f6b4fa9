"""TrueType atlas baking for the debug-print overlay
(``unclerenderer_tpu/core/fontbake.py``).

The D3D12 renderer bakes a 512x512 R8 atlas of chars 32..127 from a .ttf
(``DebugPrintFont.cpp:37-93``).  The bake is the repository's own C++
(``native/ttf.cpp``), built by ``textures/native.py`` and bound with
ctypes; without the library or a system .ttf, callers fall back to the
built-in 5x7 bitmap font (``core/debugprint.py``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import numpy as np

FIRST_CHAR = 32
CHAR_COUNT = 96  # 32..127, like the reference

# system monospace candidates (the fonts-dejavu package's files)
_FONT_CANDIDATES = (
    "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
)


@dataclass
class BakedFont:
    atlas: np.ndarray      # (H, W) u8 coverage
    glyphs: np.ndarray     # (96, 9) f32: u0 v0 u1 v1 w h xoff yoff advance
    pixel_height: float
    ascent_px: float       # baseline offset from the line top


_cache: dict = {}


def bake_font(
    pixel_height: float = 18.0,
    atlas_size: int = 512,
    font_path: str | Path | None = None,
) -> BakedFont | None:
    """Bake (and cache) the ASCII atlas; None if no native lib or no font."""
    key = (float(pixel_height), int(atlas_size), str(font_path))
    if key in _cache:
        return _cache[key]
    from ..textures.native import get_native

    lib = get_native()
    result = None
    if lib is not None:
        paths = [font_path] if font_path else _FONT_CANDIDATES
        for p in paths:
            p = Path(p)
            if not p.is_file():
                continue
            data = np.frombuffer(p.read_bytes(), np.uint8)
            atlas = np.zeros((atlas_size, atlas_size), np.uint8)
            glyphs = np.zeros((CHAR_COUNT, 9), np.float32)
            rc = lib.ttf_bake(
                data.ctypes.data_as(ctypes.c_void_p), data.size,
                ctypes.c_float(pixel_height),
                atlas.ctypes.data_as(ctypes.c_void_p), atlas_size, atlas_size,
                FIRST_CHAR, CHAR_COUNT,
                glyphs.ctypes.data_as(ctypes.c_void_p),
            )
            if rc == 0 and atlas.any():
                # glyph tops sit at yoff (negative, relative to baseline);
                # the line's ascent in pixels = -min(yoff over inked glyphs)
                inked = glyphs[:, 5] > 0
                ascent = float(-glyphs[inked, 7].min()) if inked.any() else pixel_height
                result = BakedFont(atlas, glyphs, pixel_height, ascent)
                break
    _cache[key] = result
    return result


def draw_text_ttf(
    image: np.ndarray, x: int, y: int, text: str, font: BakedFont,
    color=(1.0, 1.0, 0.2), scale: float = 1.0,
) -> np.ndarray:
    """Alpha-composite antialiased text onto an (H, W, 3) float image in
    place; (x, y) is the top-left of the line box (matching the 5x7 path)."""
    h, w = image.shape[:2]
    col = np.asarray(color, np.float32)
    pen_x = float(x)
    base_y = y + font.ascent_px * scale
    aw = font.atlas.shape[1]
    ah = font.atlas.shape[0]
    for ch in text:
        code = ord(ch)
        if not (FIRST_CHAR <= code < FIRST_CHAR + CHAR_COUNT):
            code = ord("?")
        g = font.glyphs[code - FIRST_CHAR]
        gw, gh = int(g[4]), int(g[5])
        if gw > 0 and gh > 0:
            sx0 = int(round(g[0] * aw))
            sy0 = int(round(g[1] * ah))
            patch = font.atlas[sy0:sy0 + gh, sx0:sx0 + gw].astype(np.float32) / 255.0
            if scale != 1.0:
                ys = np.clip((np.arange(int(gh * scale)) / scale).astype(int), 0, gh - 1)
                xs = np.clip((np.arange(int(gw * scale)) / scale).astype(int), 0, gw - 1)
                patch = patch[ys][:, xs]
            dy0 = int(round(base_y + g[7] * scale))
            dx0 = int(round(pen_x + g[6] * scale))
            py0, px0 = max(-dy0, 0), max(-dx0, 0)
            py1 = min(patch.shape[0], h - dy0)
            px1 = min(patch.shape[1], w - dx0)
            if py1 > py0 and px1 > px0:
                a = patch[py0:py1, px0:px1, None]
                region = image[dy0 + py0:dy0 + py1, dx0 + px0:dx0 + px1]
                region[:] = region * (1.0 - a) + col * a
        pen_x += g[8] * scale
    return image
