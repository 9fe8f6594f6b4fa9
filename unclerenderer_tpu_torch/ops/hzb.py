"""Hierarchical-Z buffer (``unclerenderer_tpu/ops/hzb.py``): min-depth mip
pyramid at half resolution, packed into one flat buffer with static
per-mip offsets.  Min-reductions are exact, so the pyramid is bit-equal to
the reference's.  ``hzb_tail`` is K6 (``csrc/hzb_tail.cu``): every level
past the first two in one launch, under ``RenderSettings.hzb_pallas_tail``."""

from __future__ import annotations

import functools

import torch

from ..core.passes import named_pass
from . import _cuda
from .consts import device_constant


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


def hzb_tail_ref(top: torch.Tensor, dims) -> torch.Tensor:
    """Plain version of K6: the min cascade from ``top`` (h, w) through the
    levels ``dims`` [(w, h), ...], flattened and concatenated."""
    parts = []
    cur = top
    for w, h in dims:
        cur = _reduce_level(cur, w, h)
        parts.append(cur.reshape(-1))
    return torch.cat(parts)


@functools.lru_cache(maxsize=64)
def tail_dims(top_h: int, top_w: int, n_levels: int) -> tuple:
    """The ``n_levels`` (w, h) after a (top_h, top_w) level by
    ``hzb_layout``'s halving rule, the only levels K6 derives."""
    dims, w, h = [], top_w, top_h
    for _ in range(n_levels):
        w, h = max(1, w // 2), max(1, h // 2)
        dims.append((w, h))
    return tuple(dims)


def hzb_tail(top: torch.Tensor, dims) -> torch.Tensor:
    """K6 wrapper (same contract as ``hzb_tail_ref``) for the levels that
    follow ``top`` by the halving rule (``tail_dims``); others are refused
    on both devices."""
    if top.dim() != 2 or not dims or tuple(map(tuple, dims)) != tail_dims(*top.shape, len(dims)):
        raise ValueError("hzb_tail: dims must be the halving-rule levels after top (h, w)")
    if _cuda.on_cpu("hzb_tail", top):
        return hzb_tail_ref(top, dims)
    if top.dtype != torch.float32:
        raise ValueError("hzb_tail: top must be f32")
    if not top.is_contiguous():
        top = top.contiguous()
    dev = _cuda.check_cuda("hzb_tail", top)
    out = torch.empty(sum(w * h for w, h in dims), dtype=torch.float32, device=top.device)
    _cuda.launch("hzb_tail", dev, top.data_ptr(), out.data_ptr(), top.shape[0], top.shape[1],
                 len(dims))
    return out


@named_pass("BuildHZB")
def build_hzb(depth: torch.Tensor, layout, pallas_tail: bool = False) -> torch.Tensor:
    """Full-res reverse-Z depth (H, W) -> packed min-depth pyramid.
    ``pallas_tail``: the first two levels as plain reductions, the rest in
    one K6 launch (the reference's ``build_hzb(pallas_tail=True)``)."""
    n_plain = min(2, len(layout)) if pallas_tail else len(layout)
    parts = []
    cur = depth
    for _off, w, h in layout[:n_plain]:
        cur = _reduce_level(cur, w, h)
        parts.append(cur.reshape(-1))
    if n_plain < len(layout):
        parts.append(hzb_tail(cur, [(w, h) for _off, w, h in layout[n_plain:]]))
    return torch.cat(parts)


def hzb_load(pyramid, layout, mip, x, y):
    """Point-load pyramid[mip][y, x] with per-element mip/coords."""
    dev = pyramid.device
    offsets, widths, heights = (device_constant(tuple(v), dev, torch.int64)
                                for v in zip(*layout))
    mip = torch.clamp(mip.long(), 0, len(layout) - 1)
    w = widths[mip]
    h = heights[mip]
    xi = torch.minimum(torch.clamp(x.long(), min=0), w - 1)
    yi = torch.minimum(torch.clamp(y.long(), min=0), h - 1)
    return pyramid[offsets[mip] + yi * w + xi]
