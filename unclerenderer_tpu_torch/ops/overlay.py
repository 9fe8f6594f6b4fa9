"""The in-frame debug-print overlay (``unclerenderer_tpu/ops/overlay.py``):
the GpuDebugPrint draw pass of the D3D12 renderer
(``GpuDebugPrint.hlsl:42-124``, ``Renderer.cpp:824-884``) as tensor ops
on the frame's device.

The glyph atlas of the 5x7 bitmap font (``core/debugprint.py``) lives on
the device; counter values are split into digit glyph indices there, one
small row gather pulls the glyphs, and the strip alpha-blends onto the
colour image.  No value is read back to the host: ``deferred_frame``
returns the frame with the stats text in it (``gpu_debug_print``).
"""

from __future__ import annotations

import numpy as np
import torch

# glyph cell: the 5x7 font with a 6-column advance and one blank row
_CELL_W = 6
_CELL_H = 8

_atlas_cache: dict = {}
_device_cache: dict = {}


def bake_overlay_font(scale: int = 2):
    """(atlas (n_glyphs, 8*scale, 6*scale) f32 numpy, char -> glyph index).

    Digits are contiguous ('0'..'9' sort adjacently), so digit d is glyph
    ``char_index['0'] + d``."""
    if scale in _atlas_cache:
        return _atlas_cache[scale]
    from ..core.debugprint import _GLYPHS

    chars = sorted(_GLYPHS)
    cells = []
    for c in chars:
        cell = np.zeros((_CELL_H, _CELL_W), np.float32)
        cell[:7, :5] = _GLYPHS[c]
        cells.append(np.repeat(np.repeat(cell, scale, 0), scale, 1))
    atlas = np.stack(cells)
    char_index = {c: i for i, c in enumerate(chars)}
    _atlas_cache[scale] = (atlas, char_index)
    return atlas, char_index


def text_indices(text: str, char_index: dict, device) -> torch.Tensor:
    """Static text -> (N,) int64 glyph indices (unknown chars: space)."""
    space = char_index[" "]
    return torch.tensor([char_index.get(c, space) for c in text.upper()], dtype=torch.int64,
                        device=device)


def int_indices(value: torch.Tensor, width: int, char_index: dict) -> torch.Tensor:
    """Device scalar, a non-negative int -> (width,) glyph indices,
    right-aligned with leading zeros blanked (printf ``%*d``)."""
    v = torch.clamp(value.to(torch.int64), min=0)
    d0, space = char_index["0"], char_index[" "]
    idx = []
    for k in reversed(range(width)):
        p = 10 ** k
        digit = torch.remainder(torch.div(v, p, rounding_mode="floor"), 10)
        blank = (v < p) if k > 0 else torch.zeros_like(v, dtype=torch.bool)
        idx.append(torch.where(blank, torch.full_like(v, space), d0 + digit))
    return torch.stack(idx)


def fixed_indices(value: torch.Tensor, int_width: int, frac: int,
                  char_index: dict) -> torch.Tensor:
    """Device f32 scalar -> glyph indices "[-]iii.ff": sign cell, integer
    digits, point, fraction digits (half to even, as the reference)."""
    neg = value < 0
    scaled = torch.round(torch.abs(value) * float(10 ** frac)).to(torch.int32).to(torch.int64)
    ip = torch.div(scaled, 10 ** frac, rounding_mode="floor")
    fp = torch.remainder(scaled, 10 ** frac)
    sign = torch.where(neg, torch.full_like(ip, char_index["-"]),
                       torch.full_like(ip, char_index[" "]))[None]
    d0 = char_index["0"]
    fdigits = [d0 + torch.remainder(torch.div(fp, 10 ** k, rounding_mode="floor"), 10)
               for k in reversed(range(frac))]
    point = torch.full((1,), char_index["."], dtype=torch.int64, device=value.device)
    return torch.cat([sign, int_indices(ip, int_width, char_index), point, torch.stack(fdigits)])


def blend_text_line(color: torch.Tensor, atlas: torch.Tensor, idx: torch.Tensor, x0: int,
                    y0: int, rgb=(1.0, 1.0, 0.2)) -> torch.Tensor:
    """Alpha-blend one glyph strip onto an (H, W, 3) image at a static
    origin; a line that does not fit is dropped, as the reference's
    screen-bounds test on glyph quads."""
    h, w = color.shape[:2]
    n = int(idx.shape[0])
    gh, gw = int(atlas.shape[1]), int(atlas.shape[2])
    if y0 + gh > h or x0 + n * gw > w or y0 < 0 or x0 < 0:
        return color
    glyphs = atlas[idx]  # (N, gh, gw)
    a = glyphs.permute(1, 0, 2).reshape(gh, n * gw).to(color.dtype)
    region = color[y0:y0 + gh, x0:x0 + n * gw]
    out = color.clone()
    out[y0:y0 + gh, x0:x0 + n * gw] = torch.stack(
        [region[..., c] * (1.0 - a) + rgb[c] * a for c in range(3)], dim=-1)
    return out


def _static_parts(scale: int, models_total: int, device):
    """The glyph atlas and the static text of the stats block as tensors on
    ``device``, made once per (scale, model count, device): the frame then
    copies nothing from the host."""
    key = (scale, models_total, str(device))
    if key not in _device_cache:
        atlas_np, cmap = bake_overlay_font(scale)
        _device_cache[key] = (
            torch.from_numpy(atlas_np).to(device),
            [text_indices(t, cmap, device)
             for t in ("MODELS: ", f"/{models_total}", "CULLED: ", "OCCL: ", "EV: ")])
    return _device_cache[key]


def device_stats_overlay(color: torch.Tensor, *, models_visible: torch.Tensor,
                         models_total: int, frustum_culled: torch.Tensor,
                         hzb_occluded: torch.Tensor, exposure_ev: torch.Tensor,
                         scale: int = 2, origin=(8, 8)) -> torch.Tensor:
    """The GpuDebugPrintStats block (``GpuDebugPrintStats.hlsl:33-47``:
    MODELS visible/total, CULLED, OCCL, EV) rasterized onto the frame from
    device scalars."""
    _atlas_np, cmap = bake_overlay_font(scale)
    atlas, (t_models, t_total, t_culled, t_occl, t_ev) = _static_parts(
        scale, models_total, color.device)
    x0, y0 = origin
    dy = _CELL_H * scale + 2
    width = max(len(str(models_total)), 1)
    lines = [
        torch.cat([t_models, int_indices(models_visible.reshape(()), width, cmap), t_total]),
        torch.cat([t_culled, int_indices(frustum_culled.reshape(()), width, cmap)]),
        torch.cat([t_occl, int_indices(hzb_occluded.reshape(()), width, cmap)]),
        torch.cat([t_ev, fixed_indices(exposure_ev.reshape(()), 2, 2, cmap)]),
    ]
    for i, line in enumerate(lines):
        color = blend_text_line(color, atlas, line, x0, y0 + i * dy)
    return color
