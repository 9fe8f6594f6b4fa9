"""GPU-driven culling (``unclerenderer_tpu/ops/cull.py``): frustum and HZB
occlusion tests over per-model AABBs, as boolean draw masks.  The sums
follow the reference's XLA:CPU accumulation so the booleans match it."""

from __future__ import annotations

import torch

from .consts import device_constant
from .fma import fma
from .hzb import hzb_load
from .shadow import hom_dot4

# the eight corners of a box, as 0/1 weights of its max over its min
_CORNERS = tuple((x, y, z) for x in (0.0, 1.0) for y in (0.0, 1.0) for z in (0.0, 1.0))


def frustum_cull(bounds_min, bounds_max, planes):
    """Positive-vertex test.  bounds_* (M, 3); planes (6, 4).  True =
    visible."""
    pv = torch.where(planes[None, :, :3] >= 0.0, bounds_max[:, None, :], bounds_min[:, None, :])
    n = planes[None, :, :3]
    # 3-term contraction accumulated like the reference's reduction
    dist = fma(pv[..., 2], n[..., 2], fma(pv[..., 1], n[..., 1], pv[..., 0] * n[..., 0]))
    dist = dist + planes[None, :, 3]
    return (dist >= 0.0).all(dim=1)


def occlusion_cull(bounds_min, bounds_max, view_proj, hzb_pyramid, layout,
                   hzb_width: int, hzb_height: int):
    """HZB occlusion test (``CullIndirectArgs.hlsl``).  True = OCCLUDED."""
    dev = bounds_min.device
    sel = device_constant(_CORNERS, dev)
    corners = bounds_min[:, None, :] + (bounds_max - bounds_min)[:, None, :] * sel[None]
    cx, cy, cz, w = hom_dot4(corners, view_proj)
    any_behind = (w <= 0.0).any(dim=1)
    w_safe = torch.where(w > 0.0, w, torch.ones_like(w))
    ndc_x, ndc_y, ndc_z = cx / w_safe, cy / w_safe, cz / w_safe
    uv_x = ndc_x * 0.5 + 0.5
    uv_y = 1.0 - (ndc_y * 0.5 + 0.5)

    min_u = uv_x.amin(dim=1)
    max_u = uv_x.amax(dim=1)
    min_v = uv_y.amin(dim=1)
    max_v = uv_y.amax(dim=1)
    max_depth = ndc_z.amax(dim=1)

    off_screen = (max_u < 0.0) | (max_v < 0.0) | (min_u > 1.0) | (min_v > 1.0)
    min_u, max_u = min_u.clamp(0.0, 1.0), max_u.clamp(0.0, 1.0)
    min_v, max_v = min_v.clamp(0.0, 1.0), max_v.clamp(0.0, 1.0)

    ext_x = (max_u - min_u) * hzb_width
    ext_y = (max_v - min_v) * hzb_height
    max_dim = torch.maximum(ext_x, ext_y)
    n_mips = len(layout)
    mip = torch.where(
        max_dim > 1.0,
        torch.clamp(torch.floor(torch.log2(torch.clamp(max_dim, min=1.0))), 0.0, n_mips - 1.0),
        torch.zeros_like(max_dim),
    ).to(torch.int64)

    mip_w = torch.clamp(hzb_width >> mip, min=1)
    mip_h = torch.clamp(hzb_height >> mip, min=1)
    min_cx = torch.minimum((min_u * mip_w).to(torch.int64), mip_w - 1)
    max_cx = torch.minimum((max_u * mip_w).to(torch.int64), mip_w - 1)
    min_cy = torch.minimum((min_v * mip_h).to(torch.int64), mip_h - 1)
    max_cy = torch.minimum((max_v * mip_h).to(torch.int64), mip_h - 1)

    def load(xx, yy):
        return hzb_load(hzb_pyramid, layout, mip, xx, yy)

    d = torch.minimum(torch.minimum(load(min_cx, min_cy), load(max_cx, min_cy)),
                      torch.minimum(load(min_cx, max_cy), load(max_cx, max_cy)))
    occluded = max_depth < d
    return occluded & ~any_behind & ~off_screen
