"""Post-processing (``unclerenderer_tpu/ops/post.py``): TAA, auto-exposure,
PBR-neutral tonemap, CAS -- ports of the reference's HLSL passes."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.passes import named_pass

LUM_WEIGHTS = (0.2126, 0.7152, 0.0722)


def _luma(x):
    w = torch.tensor(LUM_WEIGHTS, dtype=torch.float32, device=x.device)
    return (x * w).sum(dim=-1)


def edge_pad(img):
    """(H, W, C) -> (H+2, W+2, C), edge padding."""
    return F.pad(img.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")[0].permute(1, 2, 0)


@named_pass("TemporalAA")
def temporal_aa(current, history, history_weight, use_history, pad_fn=None):
    """3x3 neighbourhood min/max clamp of history, then
    lerp(current, clamped_history, weight).  (H, W, 3).  ``pad_fn(img)`` ->
    (H+2, W+2, 3) gives the 1-pixel border, edge padding by default; a row
    slab passes its halo exchange (``parallel/dist.py``) so its seams see
    their true neighbours."""
    pad = edge_pad(current) if pad_fn is None else pad_fn(current)
    h, w = current.shape[:2]
    mn = current
    mx = current
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            mn = torch.minimum(mn, n)
            mx = torch.maximum(mx, n)
    clamped = torch.minimum(torch.maximum(history, mn), mx)
    wgt = torch.clamp(history_weight, 0.0, 1.0)
    blended = current + (clamped - current) * wgt
    return torch.where(use_history, blended, current)


@named_pass("AutoExposure")
def auto_exposure_ev(hdr, prev_ev, use_history, key, ev_min, ev_max,
                     speed_up, speed_down, delta_time):
    """256-sample log2-luminance average (16x16 block mean) -> target EV,
    clamped, exponentially adapted."""
    h, w = hdr.shape[:2]
    gh, gw = min(16, h), min(16, w)
    ph, pw = h - h % gh, w - w % gw
    pooled = hdr[:ph, :pw].reshape(gh, ph // gh, gw, pw // gw, 3).mean(dim=(1, 3))
    lum = _luma(torch.clamp(pooled, min=0.0))
    log_avg = torch.log2(torch.clamp(lum, min=1e-4)).mean()
    return ev_adapt(log_avg, prev_ev, use_history, key, ev_min, ev_max,
                    speed_up, speed_down, delta_time)


def ev_adapt(log_avg, prev_ev, use_history, key, ev_min, ev_max,
             speed_up, speed_down, delta_time):
    key_ev = torch.log2(torch.clamp(key, min=1e-4))
    target = key_ev - log_avg
    lo = torch.log2(torch.clamp(ev_min, min=1e-4))
    hi = torch.log2(torch.clamp(ev_max, min=1e-4))
    target = torch.minimum(torch.maximum(target, lo), hi)
    speed = torch.where(target > prev_ev, speed_up, speed_down)
    alpha = torch.clamp(1.0 - torch.exp(-delta_time * speed), 0.0, 1.0)
    adapted = prev_ev + (target - prev_ev) * alpha
    return torch.where(use_history, adapted, target)


def pooled_log_luminance_slab(hdr_slab, row0: int, full_h: int, psum_fn):
    """``auto_exposure_ev``'s pooling over a row slab: each rank adds its
    rows to the global 16x16 cell grid (cells may straddle slabs),
    ``psum_fn`` sums the grid over the ranks, then the same mean-log2
    reduction runs on every rank.  hdr_slab (slab_h, W, 3); ``row0`` the
    slab's first global row.  Returns the log-average, equal to the
    single-device pooling up to the order of the sums."""
    slab_h, w = hdr_slab.shape[:2]
    dev = hdr_slab.device
    gh, gw = min(16, full_h), min(16, w)
    cell_h = full_h // gh
    ph, pw = gh * cell_h, w - w % gw
    r_global = row0 + torch.arange(slab_h, device=dev)
    cell_of_row = torch.clamp(r_global // cell_h, 0, gh - 1)
    w_rows = ((cell_of_row[None, :] == torch.arange(gh, device=dev)[:, None])
              & (r_global[None, :] < ph)).to(torch.float32)  # (gh, slab_h)
    rowsum = torch.einsum("gs,swc->gwc", w_rows, hdr_slab[:, :pw])
    cellsum = rowsum.reshape(gh, gw, pw // gw, 3).sum(dim=2)
    pooled = psum_fn(cellsum) / float(cell_h * (pw // gw))
    lum = _luma(torch.clamp(pooled, min=0.0))
    return torch.log2(torch.clamp(lum, min=1e-4)).mean()


def pbr_neutral_tonemap(color):
    """Khronos PBR Neutral."""
    start_compression = 0.8 - 0.04
    desaturation = 0.15
    x = color.amin(dim=-1, keepdim=True)
    offset = torch.where(x < 0.08, x - 6.25 * x * x, torch.full_like(x, 0.04))
    c = color - offset
    peak = c.amax(dim=-1, keepdim=True)
    d = 1.0 - start_compression
    new_peak = 1.0 - d * d / (peak + d - start_compression)
    compressed = c * (new_peak / torch.clamp(peak, min=1e-4))
    g = 1.0 - 1.0 / (desaturation * (peak - new_peak) + 1.0)
    desat = compressed + (new_peak - compressed) * g
    return torch.where(peak < start_compression, c, desat)


@named_pass("Tonemap")
def tonemap(hdr, exposure, exposure_ev, enable_tonemap: bool,
            enable_auto_exposure: bool, gamma):
    """exposure (x exp2(EV)) -> PBR neutral -> saturate -> gamma."""
    final_exposure = exposure
    if enable_auto_exposure:
        final_exposure = final_exposure * torch.exp2(exposure_ev)
    color = hdr * final_exposure
    if enable_tonemap:
        color = pbr_neutral_tonemap(color)
    color = torch.clamp(color, 0.0, 1.0)
    return color ** (1.0 / torch.clamp(gamma, min=1e-3))


@named_pass("CAS")
def cas_sharpen(color, sharpness, pad_fn=None):
    """AMD RCAS-style cross-tap luma sharpening on (H, W, 3) in [0, 1];
    ``pad_fn`` as in ``temporal_aa``."""
    rcas_inv_peak = 1.0 / (8.0 - 3.0)
    eps = 0.0001
    pad = edge_pad(color) if pad_fn is None else pad_fn(color)
    h, w = color.shape[:2]
    c = color
    n = pad[0:h, 1:1 + w]
    s = pad[2:2 + h, 1:1 + w]
    wv = pad[1:1 + h, 0:w]
    e = pad[1:1 + h, 2:2 + w]
    cl, nl, wl, el, sl = _luma(c), _luma(n), _luma(wv), _luma(e), _luma(s)
    min_rgb = torch.minimum(torch.minimum(torch.minimum(n, wv), torch.minimum(e, s)), c)
    max_rgb = torch.maximum(torch.maximum(torch.maximum(n, wv), torch.maximum(e, s)), c)
    inv_max = 1.0 / (max_rgb + eps)
    amp = torch.clamp(torch.minimum(min_rgb, 2.0 - max_rgb) * inv_max, 0.0, 1.0)
    amp = torch.rsqrt(amp + eps)
    wgt = -rcas_inv_peak / _luma(amp)
    sum_l = nl + wl + el + sl
    inv_den = 1.0 / (4.0 * wgt + 1.0)
    sharp_l = torch.clamp((sum_l * wgt + cl) * inv_den, 0.0, 1.0)
    chroma = c - cl[..., None]
    sharp_color = chroma + sharp_l[..., None]
    return c + (sharp_color - c) * sharpness
