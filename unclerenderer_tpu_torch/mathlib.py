"""Host-side scene math (``unclerenderer_tpu/mathlib.py``), with the
reference's numbers exactly.

Conventions of the reference renderer's DirectXMath:

* row vectors: points transform as ``v_row @ M``; "first A then B" is
  ``A @ B``;
* left-handed view space, +Z forward (``XMMatrixLookToLH``);
* reverse-Z infinite-far projection: the near plane maps to z_ndc = 1,
  infinity to 0.

Plain NumPy, float32 end to end; the Renderer turns the results into
tensors on its device.
"""

from __future__ import annotations

import numpy as np

Float = np.float32


def _f(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def normalize(v) -> np.ndarray:
    v = _f(v)
    n = np.linalg.norm(v)
    if n > 0.0:
        return (v / n).astype(np.float32)
    return v


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def translation(t) -> np.ndarray:
    """Row-vector translation (XMMatrixTranslation)."""
    t = _f(t)
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = t
    return m


def scaling(s) -> np.ndarray:
    s = _f(s)
    if s.ndim == 0:
        s = np.array([s, s, s], dtype=np.float32)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotation_x(a: float) -> np.ndarray:
    """XMMatrixRotationX for row vectors."""
    c, s = np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2] = c, s
    m[2, 1], m[2, 2] = -s, c
    return m


def rotation_y(a: float) -> np.ndarray:
    c, s = np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = c, -s
    m[2, 0], m[2, 2] = s, c
    return m


def rotation_z(a: float) -> np.ndarray:
    c, s = np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1] = c, s
    m[1, 0], m[1, 1] = -s, c
    return m


def rotation_roll_pitch_yaw(pitch: float, yaw: float, roll: float) -> np.ndarray:
    """XMMatrixRotationRollPitchYaw: roll (Z) then pitch (X) then yaw (Y)."""
    return rotation_z(roll) @ rotation_x(pitch) @ rotation_y(yaw)


def quaternion_to_matrix(q) -> np.ndarray:
    """Rotation matrix for quaternion (x, y, z, w), row-vector convention.

    Matches XMMatrixRotationQuaternion and the reference glTF loader's
    MatrixFromQuaternion (``Source/Scene/GltfLoader.cpp``).
    """
    x, y, z, w = _f(q)
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 1 - 2 * (y * y + z * z)
    m[0, 1] = 2 * (x * y + z * w)
    m[0, 2] = 2 * (x * z - y * w)
    m[1, 0] = 2 * (x * y - z * w)
    m[1, 1] = 1 - 2 * (x * x + z * z)
    m[1, 2] = 2 * (y * z + x * w)
    m[2, 0] = 2 * (x * z + y * w)
    m[2, 1] = 2 * (y * z - x * w)
    m[2, 2] = 1 - 2 * (x * x + y * y)
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
    """XMMatrixLookAtLH (used by the directional-light view,
    ``Source/Render/RendererUtils.cpp:1130``)."""
    return look_to_lh(eye, _f(focus) - _f(eye), up)


def perspective_reverse_z_infinite(fov_y: float, aspect: float, near: float) -> np.ndarray:
    """Reverse-Z infinite-far perspective (``Source/Scene/Camera.cpp:35-47``).

    z_clip = near (constant), w_clip = z_view; so z_ndc = near / z_view:
    1 at the near plane, -> 0 at infinity.
    """
    y_scale = 1.0 / np.tan(fov_y * 0.5)
    x_scale = y_scale / aspect
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = x_scale
    m[1, 1] = y_scale
    m[2, 3] = 1.0
    m[3, 2] = near
    return m


def orthographic_lh(width: float, height: float, z_near: float, z_far: float) -> np.ndarray:
    """XMMatrixOrthographicLH (directional-light projection,
    ``Source/Render/RendererUtils.cpp:1133-1135``). z maps near->0, far->1."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 2.0 / width
    m[1, 1] = 2.0 / height
    m[2, 2] = 1.0 / (z_far - z_near)
    m[3, 2] = -z_near / (z_far - z_near)
    return m


def frustum_planes_from_view_proj(view_proj: np.ndarray) -> np.ndarray:
    """Extract 6 normalized frustum planes (left,right,bottom,top,near,far).

    A point p is inside when ``dot(plane[:3], p) + plane[3] >= 0`` for all
    planes.  Matches ``RendererUtils::BuildFrustumPlanesFromMatrix``
    (``Source/Render/RendererUtils.cpp:1153-1218``); note near plane uses the
    raw third column (reverse-Z: z_ndc >= 0 is "in front of infinity") and the
    far plane is w - z (z_ndc <= 1, the near geometric plane).
    """
    m = np.asarray(view_proj, dtype=np.float32)
    c = [m[:, i] for i in range(4)]  # columns of the row-vector matrix
    planes = np.stack(
        [
            c[3] + c[0],  # left
            c[3] - c[0],  # right
            c[3] + c[1],  # bottom
            c[3] - c[1],  # top
            c[2],         # "near" (reverse-Z: actually the infinite far side)
            c[3] - c[2],  # "far"  (reverse-Z: the geometric near plane)
        ],
        axis=0,
    ).astype(np.float32)
    norms = np.linalg.norm(planes[:, :3], axis=1, keepdims=True)
    norms = np.where(norms > 0, norms, 1.0)
    return (planes / norms).astype(np.float32)


def aabb_vs_frustum(planes: np.ndarray, bounds_min, bounds_max) -> bool:
    """Positive-vertex AABB test (``RendererUtils::IsAabbInCameraFrustum``)."""
    bmin, bmax = _f(bounds_min), _f(bounds_max)
    for p in planes:
        v = np.where(p[:3] >= 0.0, bmax, bmin)
        if float(np.dot(p[:3], v) + p[3]) < 0.0:
            return False
    return True


def transform_aabb(bounds_min, bounds_max, world: np.ndarray):
    """World-space AABB of a transformed local AABB via its 8 corners
    (``Source/Render/RendererUtils.cpp:420-470``)."""
    bmin, bmax = _f(bounds_min), _f(bounds_max)
    corners = np.array(
        [[x, y, z] for x in (bmin[0], bmax[0]) for y in (bmin[1], bmax[1]) for z in (bmin[2], bmax[2])],
        dtype=np.float32,
    )
    hom = np.concatenate([corners, np.ones((8, 1), dtype=np.float32)], axis=1)
    out = hom @ world
    pts = out[:, :3]
    return pts.min(axis=0).astype(np.float32), pts.max(axis=0).astype(np.float32)


def halton(index: int, base: int) -> float:
    """Halton low-discrepancy sequence (``DeferredRenderer.cpp:47-59``)."""
    result = 0.0
    fraction = 1.0 / base
    current = index
    while current > 0:
        result += (current % base) * fraction
        current //= base
        fraction /= base
    return result


def taa_jitter(sample_index: int) -> np.ndarray:
    """Halton(2,3) jitter in [-0.5, 0.5] (``DeferredRenderer.cpp:61-67``)."""
    i = sample_index + 1
    return np.array([halton(i, 2) - 0.5, halton(i, 3) - 0.5], dtype=np.float32)


def jittered_projection(proj: np.ndarray, jitter_px: np.ndarray, width: int, height: int) -> np.ndarray:
    """Inject a sub-pixel TAA jitter into the projection matrix the way the
    reference does (``DeferredRenderer.cpp:414-421``): _31 += 2*jx/W,
    _32 += 2*jy/H (z_view-proportional NDC offset)."""
    m = np.array(proj, dtype=np.float32, copy=True)
    m[2, 0] += 2.0 * jitter_px[0] / float(width)
    m[2, 1] += 2.0 * jitter_px[1] / float(height)
    return m


def direction_from_euler_degrees(rotation_euler) -> np.ndarray:
    """Light 'rotation' euler -> direction
    (``SceneJsonLoader.cpp:257-269``): (cosP*sinY, sinP, cosP*cosY)."""
    pitch, yaw = np.radians(_f(rotation_euler)[:2])
    return np.array(
        [np.cos(pitch) * np.sin(yaw), np.sin(pitch), np.cos(pitch) * np.cos(yaw)],
        dtype=np.float32,
    )


def forward_from_pitch_yaw(pitch: float, yaw: float) -> np.ndarray:
    """(0,0,1) transformed by RotationRollPitchYaw(pitch, yaw, 0):
    (cosP*sinY, -sinP, cosP*cosY).  Used for both camera forward and the
    renderer-facing light vector (``Application.cpp:1225-1230``)."""
    return np.array(
        [np.cos(pitch) * np.sin(yaw), -np.sin(pitch), np.cos(pitch) * np.cos(yaw)],
        dtype=np.float32,
    )


def light_vector_from_scene_direction(direction) -> np.ndarray:
    """The reference converts the scene JSON light 'direction' to pitch/yaw
    (``Application.cpp:235-242``) and regenerates the shading vector with
    ``forward_from_pitch_yaw`` (``Application.cpp:1225-1230``) -- the net
    effect is a Y-flip: the stored vector points *toward* the light."""
    d = normalize(direction)
    return np.array([d[0], -d[1], d[2]], dtype=np.float32)


def build_directional_light_view_proj(scene_center, scene_radius: float, light_dir) -> np.ndarray:
    """``RendererUtils::BuildDirectionalLightViewProjection``
    (``Source/Render/RendererUtils.cpp:1117-1137``)."""
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


def linear_to_srgb(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, dtype=np.float32)
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055).astype(np.float32)
