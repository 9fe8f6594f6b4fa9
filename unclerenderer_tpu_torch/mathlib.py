"""Host-side scene math (``unclerenderer_tpu/mathlib.py``), the part the
port's synthetic scenes use.

Conventions of the reference renderer's DirectXMath:

* row vectors: points transform as ``v_row @ M``; "first A then B" is
  ``A @ B``;
* left-handed view space, +Z forward (``XMMatrixLookToLH``);
* reverse-Z infinite-far projection: the near plane maps to z_ndc = 1,
  infinity to 0.

Plain NumPy, float32 end to end, with the reference's numbers exactly.
"""

from __future__ import annotations

import numpy as np


def _f(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def normalize(v) -> np.ndarray:
    v = _f(v)
    n = np.linalg.norm(v)
    if n > 0.0:
        return (v / n).astype(np.float32)
    return v


def translation(t) -> np.ndarray:
    """Row-vector translation (XMMatrixTranslation)."""
    t = _f(t)
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = t
    return m


def rotation_y(a: float) -> np.ndarray:
    c, s = np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = c, -s
    m[2, 0], m[2, 2] = s, c
    return m


def look_to_lh(eye, direction, up) -> np.ndarray:
    """XMMatrixLookToLH: view matrix from eye, forward direction and up."""
    eye, direction, up = _f(eye), _f(direction), _f(up)
    zaxis = normalize(direction)
    xaxis = normalize(np.cross(up, zaxis))
    yaxis = np.cross(zaxis, xaxis)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = [xaxis[0], yaxis[0], zaxis[0]]
    m[1, :3] = [xaxis[1], yaxis[1], zaxis[1]]
    m[2, :3] = [xaxis[2], yaxis[2], zaxis[2]]
    m[3, :3] = [-np.dot(xaxis, eye), -np.dot(yaxis, eye), -np.dot(zaxis, eye)]
    return m


def look_at_lh(eye, focus, up) -> np.ndarray:
    """XMMatrixLookAtLH."""
    return look_to_lh(eye, _f(focus) - _f(eye), up)


def perspective_reverse_z_infinite(fov_y: float, aspect: float, near: float) -> np.ndarray:
    """Reverse-Z infinite-far perspective: z_clip = near (constant),
    w_clip = z_view; so z_ndc = near / z_view: 1 at the near plane, -> 0 at
    infinity."""
    y_scale = 1.0 / np.tan(fov_y * 0.5)
    x_scale = y_scale / aspect
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = x_scale
    m[1, 1] = y_scale
    m[2, 3] = 1.0
    m[3, 2] = near
    return m


def orthographic_lh(width: float, height: float, z_near: float, z_far: float) -> np.ndarray:
    """XMMatrixOrthographicLH (the directional light's projection); z maps
    near -> 0, far -> 1."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 2.0 / width
    m[1, 1] = 2.0 / height
    m[2, 2] = 1.0 / (z_far - z_near)
    m[3, 2] = -z_near / (z_far - z_near)
    return m


def transform_aabb(bounds_min, bounds_max, world: np.ndarray):
    """World-space AABB of a transformed local AABB via its 8 corners."""
    bmin, bmax = _f(bounds_min), _f(bounds_max)
    corners = np.array(
        [[x, y, z] for x in (bmin[0], bmax[0]) for y in (bmin[1], bmax[1]) for z in (bmin[2], bmax[2])],
        dtype=np.float32,
    )
    hom = np.concatenate([corners, np.ones((8, 1), dtype=np.float32)], axis=1)
    out = hom @ world
    pts = out[:, :3]
    return pts.min(axis=0).astype(np.float32), pts.max(axis=0).astype(np.float32)


def build_directional_light_view_proj(scene_center, scene_radius: float, light_dir) -> np.ndarray:
    """The reference's ``BuildDirectionalLightViewProjection``: an
    orthographic light looking at the scene centre from 2.5 radii away."""
    center = _f(scene_center)
    d = normalize(light_dir)
    light_pos = center + d * (scene_radius * 2.5)
    view = look_at_lh(light_pos, center, [0.0, 1.0, 0.0])
    proj = orthographic_lh(scene_radius * 2.0, scene_radius * 2.0, 0.1, scene_radius * 5.0)
    return (view @ proj).astype(np.float32)


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 decode, what D3D does when sampling an _SRGB view."""
    c = np.asarray(c, dtype=np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)
