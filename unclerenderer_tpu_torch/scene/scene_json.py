"""Scene-description JSON loader (``unclerenderer_tpu/scene/scene_json.py``):
models (path / translate / rotate_euler / scale / visible / texture
overrides), one directional light (direction or rotation euler) and the
camera (position and look_at, or rotation euler, and fov_y), with the
semantics of the D3D12 renderer's ``SceneJsonLoader``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from .. import mathlib as m
from ..core.logging import log_error


@dataclasses.dataclass
class SceneModelDesc:
    mesh_path: str = ""
    name: str = ""
    position: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    rotation_euler: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    scale: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3, np.float32))
    visible: bool = True
    base_color_texture_override: str = ""


@dataclasses.dataclass
class SceneLightDesc:
    # Direction points *toward* the light once converted for shading
    # (mathlib.light_vector_from_scene_direction); this field stores the raw
    # JSON direction (pointing away from the light) like the reference does.
    direction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([-0.5, -1.0, 0.2], np.float32)
    )
    intensity: float = 1.0
    color: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3, np.float32))


@dataclasses.dataclass
class SceneCameraDesc:
    position: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    look_at: np.ndarray | None = None
    rotation_euler: np.ndarray | None = None
    fov_y_degrees: float = 45.0


def _vec(value, default, n=3) -> np.ndarray:
    if value is None:
        return np.asarray(default, np.float32)
    a = np.asarray(value, np.float32).reshape(-1)
    out = np.asarray(default, np.float32).copy()
    out[: min(n, a.size)] = a[: min(n, a.size)]
    return out


def load_scene_json(path: str | Path):
    """Returns (models, light, camera); light/camera may be None when absent."""
    p = Path(path)
    try:
        data = json.loads(p.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError) as e:
        log_error(f"Failed to read scene JSON file: {p}: {e}")
        return [], None, None

    models: list[SceneModelDesc] = []
    for entry in data.get("models", []):
        desc = SceneModelDesc()
        desc.mesh_path = entry.get("path", "")
        desc.name = entry.get("id", entry.get("name", ""))
        desc.position = _vec(entry.get("translate"), np.zeros(3, np.float32))
        desc.rotation_euler = _vec(entry.get("rotate_euler"), np.zeros(3, np.float32))
        desc.scale = _vec(entry.get("scale"), np.ones(3, np.float32))
        desc.visible = bool(entry.get("visible", True))
        desc.base_color_texture_override = entry.get("texture", entry.get("base_color_texture", ""))
        if desc.mesh_path:
            models.append(desc)

    light = None
    lights = data.get("lights", [])
    if lights:
        entry = lights[0]  # the reference only supports one directional light
        light = SceneLightDesc()
        light.intensity = float(entry.get("intensity", light.intensity))
        light.color = _vec(entry.get("color"), light.color)
        rotation = entry.get("rotation", entry.get("rotation_euler"))
        if rotation is not None:
            light.direction = m.direction_from_euler_degrees(_vec(rotation, np.zeros(3, np.float32)))
        else:
            light.direction = _vec(entry.get("direction"), light.direction)

    camera = None
    cam = data.get("camera")
    if cam is not None:
        camera = SceneCameraDesc()
        camera.position = _vec(cam.get("position"), camera.position)
        if "look_at" in cam:
            camera.look_at = _vec(cam.get("look_at"), np.zeros(3, np.float32))
        rotation = cam.get("rotation", cam.get("rotation_euler"))
        if rotation is not None:
            camera.rotation_euler = _vec(rotation, np.zeros(3, np.float32))
        camera.fov_y_degrees = float(cam.get("fov_y", camera.fov_y_degrees))

    return models, light, camera
