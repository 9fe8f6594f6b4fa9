"""Sky / atmosphere (``unclerenderer_tpu/ops/sky.py``, a port of
``SkyAtmosphere.hlsl``), evaluated on the pixels the geometry left empty."""

from __future__ import annotations

import torch

from ..core.passes import named_pass
from .consts import device_constant

PI = 3.14159265


def rayleigh_phase(cos_theta):
    k = 3.0 / (16.0 * PI)
    return k * (1.0 + cos_theta * cos_theta)


def mie_phase(cos_theta, g):
    g2 = g * g
    denom = (1.0 + g2 - 2.0 * g * cos_theta) ** 1.5
    return (1.0 - g2) / (4.0 * PI * torch.clamp(denom, min=1e-3))


def _normalize(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-20)


@named_pass("SkyAtmosphere")
def apply_atmosphere(view_dir, camera_pos, light_dir, light_color):
    """``ApplyAtmosphere``.  view_dir (..., 3) normalized; camera_pos,
    light_dir (toward the light), light_color: (3,)."""
    dev = view_dir.device
    horizon_falloff = torch.clamp(
        (1.0 - torch.clamp(view_dir[..., 1] * 0.5 + 0.5, 0.0, 1.0)) ** 3.0, 0.0, 1.0)
    zenith = device_constant((0.05, 0.12, 0.22), dev)
    horizon = device_constant((0.52, 0.68, 0.86), dev)
    base_sky = zenith + (horizon - zenith) * horizon_falloff[..., None]

    l = _normalize(light_dir)
    cos_sun_view = (view_dir * l).sum(dim=-1)
    cos_sun_up = l[1]

    view_height = torch.clamp(camera_pos[1], min=0.0)
    rayleigh_density = torch.exp(-view_height / 8000.0)
    mie_density = torch.exp(-view_height / 1200.0)

    r_phase = rayleigh_phase(cos_sun_view)
    m_phase = mie_phase(cos_sun_view, 0.76)

    rayleigh_color = device_constant((0.650, 0.570, 0.475), dev)
    scattered = rayleigh_color * (rayleigh_density * r_phase)[..., None]
    scattered = scattered + light_color * (mie_density * m_phase * 0.8)[..., None]
    sun_attenuation = torch.clamp(
        torch.exp(-torch.clamp(1.0 - cos_sun_up, min=0.0) * 2.0), 0.0, 1.0)
    return base_sky + scattered * sun_attenuation


def sky_view_directions(width: int, height: int, camera_pos, view, proj, row0: int = 0,
                        out_h: int | None = None):
    """Per-pixel world-space view direction through each pixel center
    (analytic inverse of the viewport + projection).  ``row0``/``out_h``
    select a row slab of the ``height``-row viewport; the default is the
    whole frame."""
    dev = view.device
    out_h = height if out_h is None else out_h
    yy = (torch.arange(out_h, dtype=torch.float32, device=dev)[:, None] + row0 + 0.5) / height
    xx = (torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5) / width
    ndc_x = xx * 2.0 - 1.0
    ndc_y = 1.0 - yy * 2.0
    vx = ndc_x / proj[0, 0]
    vy = ndc_y / proj[1, 1]
    ones = torch.ones((out_h, width), dtype=torch.float32, device=dev)
    view_ray = torch.stack([vx * ones, vy * ones, ones], dim=-1)
    world_ray = view_ray @ view[:3, :3].T
    return _normalize(world_ray)
