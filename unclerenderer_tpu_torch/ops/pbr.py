"""PBR shading math (``unclerenderer_tpu/ops/pbr.py``, a port of
``PBRCommon.hlsl``): diffuse NOT divided by pi, k = (r+1)^2/8 Schlick-GGX,
denominators clamped at 1e-4 -- the reference's quirks, kept."""

from __future__ import annotations

import torch

from ..core.passes import named_pass
from .consts import device_constant
from .fma import fma

PI = 3.14159265


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def _dot(a, b):
    return (a * b).sum(dim=-1)


def normalize(v, eps=1e-20):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)


def distribution_ggx(n_dot_h, alpha):
    alpha2 = alpha * alpha
    denom = (n_dot_h * n_dot_h) * (alpha2 - 1.0) + 1.0
    return alpha2 / torch.clamp(PI * denom * denom, min=1e-4)


def geometry_schlick_ggx(n_dot_x, k):
    return n_dot_x / (n_dot_x * (1.0 - k) + k)


def fresnel_schlick(v_dot_h, f0):
    return f0 + (1.0 - f0) * (1.0 - v_dot_h[..., None]) ** 5


def evaluate_pbr(albedo, metallic, roughness, f0, n, v, l):
    """``EvaluatePBR``: (diffuse + specular) * NdotL."""
    h = normalize(v + l)
    n_dot_l = saturate(_dot(n, l))
    n_dot_v = saturate(_dot(n, v))
    n_dot_h = saturate(_dot(n, h))
    v_dot_h = saturate(_dot(v, h))
    alpha = roughness * roughness
    d = distribution_ggx(n_dot_h, alpha)
    k = roughness + 1.0
    k = (k * k) / 8.0
    g = geometry_schlick_ggx(n_dot_v, k) * geometry_schlick_ggx(n_dot_l, k)
    f = fresnel_schlick(v_dot_h, f0)
    specular = (d * g)[..., None] * f / torch.clamp(4.0 * n_dot_l * n_dot_v, min=1e-4)[..., None]
    kd = (1.0 - f) * (1.0 - metallic[..., None])
    diffuse = kd * albedo
    return (diffuse + specular) * n_dot_l[..., None]


def reconstruct_normal_z(rg):
    """Two-channel (BC5) normal map Z reconstruction."""
    z2 = 1.0 - fma(rg[..., 1], rg[..., 1], rg[..., 0] * rg[..., 0])
    return torch.sqrt(saturate(z2))


def _dot3_fma(a, b):
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def apply_normal_map(vertex_normal, tangent4, tangent_normal):
    """TBN normal mapping: Gram-Schmidt tangent, bitangent from cross *
    handedness, degenerate tangent-space normal -> (0, 0, 1).  The dot, the
    Gram-Schmidt step and the TBN sum carry the reference's XLA:CPU
    contractions (a grazing pixel's specular term turns a 1-ulp normal
    difference into ~1e-3 of HDR)."""
    n = normalize(vertex_normal)
    t_raw = tangent4[..., :3]
    t = normalize(fma(-n, _dot3_fma(n, t_raw)[..., None], t_raw))
    b = normalize(torch.linalg.cross(n, t, dim=-1)) * tangent4[..., 3:4]
    tn_len = torch.linalg.vector_norm(tangent_normal, dim=-1, keepdim=True)
    flat = device_constant((0.0, 0.0, 1.0), tangent_normal.device)
    tn = torch.where(tn_len < 1e-5, flat, tangent_normal)
    world = fma(tn[..., 2:3], n, fma(tn[..., 0:1], t, tn[..., 1:2] * b))
    return normalize(world)


@named_pass("IBLAmbient")
def ibl_ambient(albedo, metallic, f0, n_world, v_world, env_sample_fn,
                brdf_lut_sample_fn, env_mip_count, roughness, env_sample_level_fn=None):
    """Split-sum IBL: prefiltered env at mip = roughness * (mips-1) for
    specular, the last mip as irradiance for diffuse, BRDF LUT scale/bias."""
    reflection = 2.0 * _dot(n_world, v_world)[..., None] * n_world - v_world
    max_mip = torch.clamp(env_mip_count - 1.0, min=0.0)
    mip = roughness * max_mip
    prefiltered = env_sample_fn(reflection, mip)
    n_dot_v = saturate(_dot(n_world, v_world))
    brdf = brdf_lut_sample_fn(torch.stack([n_dot_v, roughness], dim=-1))
    specular_ibl = prefiltered * (f0 * brdf[..., 0:1] + brdf[..., 1:2])
    if env_sample_level_fn is not None:
        level = torch.broadcast_to(max_mip, roughness.shape).to(torch.int32)
        irradiance = env_sample_level_fn(n_world, level)
    else:
        irradiance = env_sample_fn(n_world, torch.broadcast_to(max_mip, roughness.shape))
    diffuse_ibl = irradiance * albedo * (1.0 - metallic[..., None])
    return diffuse_ibl + specular_ibl
