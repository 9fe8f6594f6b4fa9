"""The chip's peaks and the work of a kernel call, for roofline shares.

A call's bound is the larger of its bytes over the memory bandwidth and
its operations over the f32 rate: the least time the chip could take.
``work_binned`` is a frozen copy of ``chip_smoke.py work_binned`` with the
warp-skip count it uses (``unclerenderer_tpu_torch/sweeps/raster.py
warp_rows``, ``call_rows``, ``centre``): K1's bytes (each block's rows and
ids read once, each tile's key and id written once) and operations (a
corner test per (warp rectangle, valid row) pair, the edge tests of the
(pixel, row) pairs the skip keeps).
"""

from __future__ import annotations

import numpy as np
import torch


def fma(a, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` with one rounding, as the kernels issue it (a copy
    of ``unclerenderer_tpu_torch/ops/fma.py``): the f64 product of two f32
    values is exact, the f64 sum is rounded to odd, and rounding that to
    f32 is a single correct rounding."""
    a, b, c = (x.double() if isinstance(x, torch.Tensor) else float(np.float32(x))
               for x in (a, b, c))
    u, v = a * b, c
    if isinstance(u, torch.Tensor) and isinstance(v, torch.Tensor):
        u, v = torch.broadcast_tensors(u, v)
    s = u + v
    bp = s - u
    err = (u - (s - bp)) + (v - bp)
    even = (s.contiguous().view(torch.int64) & 1) == 0
    bump = (err != 0) & even & torch.isfinite(s)
    inf = torch.full_like(s, float("inf"))
    return torch.where(bump, torch.nextafter(s, torch.where(err > 0, inf, -inf)), s).float()

#: NVIDIA H100 SXM, published (dense, no sparsity), at its 700 W limit
PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12}
# three edge functions, each a multiply, an FMA (2 operations) and an add
EDGE_OPS = 12
# a kept (pixel, row) pair: three FMAs and adds, plus the three b*qy
# multiplies that a thread makes once for its pixels
PIXEL_EDGE_OPS = 9
BINNED_PIX, BINNED_RECT = 4, (16, 8)


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAKS["hbm_bytes_per_s"], ops / PEAKS["f32_ops_per_s"])


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _centre(origin, offset):
    """Pixel centres as the kernels compute them: (origin + offset) + 0.5."""
    return (origin + offset.to(torch.float32)) + 0.5


def _call_rows(coef, valid, start, count):
    """Coefficients (R, 16), valid (R,) and the tile of each (tile, row)
    pair of the blocks a K1 call visits."""
    start, count = start.long(), count.long()
    tiles = torch.repeat_interleave(torch.arange(start.shape[0], device=start.device), count)
    blocks = torch.repeat_interleave(start - torch.cumsum(count, 0) + count, count) + \
        torch.arange(tiles.shape[0], device=start.device)
    return (coef[blocks].transpose(1, 2).reshape(-1, 16), valid[blocks, 0].reshape(-1) > 0,
            tiles.repeat_interleave(coef.shape[-1]))


def warp_rows(coef, valid, start, count, th, tw, n_tx, y_off):
    """(tested, kept, kept pixel rows) of K1's warp skip: the (warp
    rectangle, valid row) pairs a call tests, those whose three edges may
    pass somewhere in the rectangle (or hold a non-finite coefficient), and
    the (pixel, row) pairs of the kept ones."""
    coef, ok, row_tile = _call_rows(coef, valid, start, count)
    coef, row_tile = coef[ok], row_tile[ok]
    rh, rw = BINNED_RECT
    rx_n, ry_n = -(-tw // rw), -(-th // rh)
    rect = torch.arange(rx_n * ry_n, device=coef.device)
    rx, ry = (rect % rx_n) * rw, (rect // rx_n) * rh
    pixels = (torch.clamp(th - ry, max=rh) * torch.clamp(tw - rx, max=rw))[None, :]
    x0 = ((row_tile % n_tx) * tw).to(torch.float32)[:, None]
    y0 = ((row_tile // n_tx) * th).to(torch.float32)[:, None] + y_off
    may = torch.ones((coef.shape[0], rect.shape[0]), dtype=torch.bool, device=coef.device)
    for e in range(3):
        a, b, c = (coef[:, i][:, None] for i in (e, 3 + e, 6 + e))
        qx = torch.where(a > 0, _centre(x0, rx + rw - 1), _centre(x0, rx))
        qy = torch.where(b > 0, _centre(y0, ry + rh - 1), _centre(y0, ry))
        ev = fma(a, qx, b * qy) + c
        top_left = (a > 0) | ((a == 0) & (b > 0))
        may &= (ev > 0) | ((ev == 0) & top_left)
    may |= ~torch.isfinite(coef[:, :9]).all(1, keepdim=True)
    return int(may.numel()), int(may.sum()), int((may * pixels).sum())


def work_binned(coef, tri_id, valid, start, count, tile_h, tile_w, n_tx, y_offset=0.0,
                want_ids=True, *_rest, **_kw):
    """(bytes, operations) of one K1 call (``binned_raster``'s positional
    arguments)."""
    pix, chunk = tile_h * tile_w, coef.shape[-1]
    moved = (int(count.long().sum()) * chunk * 4 * (16 + 1 + int(want_ids))
             + _nbytes(start, count) + start.shape[0] * pix * 4 * (1 + int(want_ids)))
    tested, _kept, kept_px = warp_rows(coef, valid, start, count, tile_h, tile_w, n_tx, y_offset)
    ops = EDGE_OPS * tested + PIXEL_EDGE_OPS * kept_px + 3 * kept_px // BINNED_PIX
    return moved, ops
