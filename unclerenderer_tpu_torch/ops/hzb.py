"""Hierarchical-Z buffer (``unclerenderer_tpu/ops/hzb.py``): min-depth mip
pyramid at half resolution, packed into one flat buffer with static
per-mip offsets.  Min-reductions are exact, so the pyramid is bit-equal to
the reference's."""

from __future__ import annotations

import torch


def hzb_layout(width: int, height: int):
    """Static [(offset, w, h)] per mip for a pyramid starting at
    (height, width), and the total length."""
    layout = []
    off = 0
    w, h = width, height
    while True:
        layout.append((off, w, h))
        off += w * h
        if w == 1 and h == 1:
            break
        w, h = max(1, w // 2), max(1, h // 2)
    return layout, off


def _reduce_level(cur: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """One 2x2 min-downsample with the HLSL's clamped-edge / crop rules."""
    ch, cw = cur.shape
    th, tw = h * 2, w * 2
    if ch < th:
        cur = torch.cat([cur, cur[-1:, :]], dim=0)
    elif ch > th:
        cur = cur[:th, :]
    if cw < tw:
        cur = torch.cat([cur, cur[:, -1:]], dim=1)
    elif cw > tw:
        cur = cur[:, :tw]
    return cur.reshape(h, 2, w, 2).amin(dim=(1, 3))


def build_hzb(depth: torch.Tensor, layout) -> torch.Tensor:
    """Full-res reverse-Z depth (H, W) -> packed min-depth pyramid."""
    parts = []
    cur = depth
    for _off, w, h in layout:
        cur = _reduce_level(cur, w, h)
        parts.append(cur.reshape(-1))
    return torch.cat(parts)


def hzb_load(pyramid, layout, mip, x, y):
    """Point-load pyramid[mip][y, x] with per-element mip/coords."""
    dev = pyramid.device
    offsets = torch.tensor([o for o, _w, _h in layout], dtype=torch.int64, device=dev)
    widths = torch.tensor([w for _o, w, _h in layout], dtype=torch.int64, device=dev)
    heights = torch.tensor([h for _o, _w, h in layout], dtype=torch.int64, device=dev)
    mip = torch.clamp(mip.long(), 0, len(layout) - 1)
    w = widths[mip]
    h = heights[mip]
    xi = torch.minimum(torch.clamp(x.long(), min=0), w - 1)
    yi = torch.minimum(torch.clamp(y.long(), min=0), h - 1)
    return pyramid[offsets[mip] + yi * w + xi]
