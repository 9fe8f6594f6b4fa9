"""Camera (``unclerenderer_tpu/scene/camera.py``): left-handed look-to view
and reverse-Z infinite projection, as the D3D12 renderer's ``Camera``.
"""

from __future__ import annotations

import numpy as np

from .. import mathlib as m


class Camera:
    def __init__(self) -> None:
        self.position = np.array([0.0, 0.0, -5.0], dtype=np.float32)
        self.forward = np.array([0.0, 0.0, 1.0], dtype=np.float32)
        self.up = np.array([0.0, 1.0, 0.0], dtype=np.float32)
        self.fov_y = np.pi / 4.0
        self.aspect_ratio = 16.0 / 9.0
        self.near_clip = 0.1
        self.far_clip = 1000.0

    def set_perspective(self, fov_y: float, aspect: float, near: float, far: float) -> None:
        self.fov_y = float(fov_y)
        self.aspect_ratio = float(aspect)
        self.near_clip = float(near)
        self.far_clip = float(far)

    def view_matrix(self) -> np.ndarray:
        return m.look_to_lh(self.position, self.forward, self.up)

    def projection_matrix(self) -> np.ndarray:
        return m.perspective_reverse_z_infinite(self.fov_y, self.aspect_ratio, self.near_clip)

    def set_look_at(self, target) -> None:
        self.forward = m.normalize(np.asarray(target, np.float32) - self.position)
        self._recompute_up()

    def set_rotation_euler_degrees(self, rotation) -> None:
        """Forward from pitch/yaw/roll degrees (``Application.cpp:895-902``)."""
        pitch, yaw, roll = np.radians(np.asarray(rotation, np.float32))
        rot = m.rotation_roll_pitch_yaw(pitch, yaw, roll)
        fwd = np.array([0.0, 0.0, 1.0, 0.0], dtype=np.float32) @ rot
        self.forward = m.normalize(fwd[:3])
        self._recompute_up()

    def _recompute_up(self) -> None:
        """The reference recomputes up from the pitch/yaw of forward with zero
        roll (``Application.cpp:911-918``)."""
        pitch = -np.arcsin(np.clip(self.forward[1], -1.0, 1.0))
        yaw = np.arctan2(self.forward[0], self.forward[2])
        rot = m.rotation_roll_pitch_yaw(pitch, yaw, 0.0)
        up = np.array([0.0, 1.0, 0.0, 0.0], dtype=np.float32) @ rot
        self.up = m.normalize(up[:3])
