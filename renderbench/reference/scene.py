"""The reference's scene, made from the generator's data (``scenegen.
scene_content``) in float64 on the device: world-space triangles, the
models' boxes and materials, each material's combined texel chain in the
Renderer's storage format, the env cube, the BRDF LUT and the light.

Storage formats are part of what the Renderer draws, so the texels are
quantised as it stores them (``RenderSettings.material_atlas_u8``, the
default): a base colour byte is decoded from sRGB and kept on a gamma-2.0
byte curve (``round(sqrt(linear) * 255)``), every other map channel as
its byte; env texels are float16 in the file and bfloat16 in the
Renderer's env atlas, the irradiance level float32.  Each level is the
map's own mip of that size, as the files ship them.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 decode (what D3D does when it samples an sRGB view)."""
    c = np.asarray(c, np.float64)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _gamma2_byte(linear: np.ndarray) -> np.ndarray:
    """A linear value as the u8 material atlas stores a colour channel,
    decoded again: (round(sqrt(v) * 255) / 255)^2."""
    q = np.round(np.sqrt(np.clip(linear, 0.0, 1.0)) * 255.0)
    return (q / 255.0) ** 2


def _byte(v: np.ndarray) -> np.ndarray:
    return np.round(np.clip(v, 0.0, 1.0) * 255.0) / 255.0


# combined channels the frame reads: base rgba 0:4, roughness 4, metallic 5,
# normal rg 6:8; neutral where a material has no such map
NEUTRAL = np.array([1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.5, 0.5])


def material_chain(maps: dict) -> list:
    """The combined texel chain of one material's RGBA8 map chains: one
    (h, w, 8) array a level, in the atlas's storage, decoded."""
    size = max(ch[0].shape[0] for ch in maps.values())
    levels = int(np.log2(size)) + 1
    out = []
    for lv in range(levels):
        s = max(size >> lv, 1)
        img = np.tile(_byte(NEUTRAL), (s, s, 1))
        img[..., 0:3] = _gamma2_byte(NEUTRAL[:3])
        for slot, chain in maps.items():
            shift = int(np.log2(size)) - int(np.log2(chain[0].shape[0]))
            src = chain[min(max(lv - shift, 0), len(chain) - 1)].astype(np.float64) / 255.0
            if src.shape[0] != s:
                raise ValueError("reference: a map chain has no level of the combined size")
            if slot == "base":
                img[..., 0:3] = _gamma2_byte(srgb_to_linear(src[..., 0:3]))
                img[..., 3] = src[..., 3]
            elif slot == "mr":
                img[..., 4], img[..., 5] = src[..., 1], src[..., 2]
            elif slot == "normal":
                img[..., 6:8] = src[..., 0:2]
        out.append(img)
    return out


class Scene:
    """``content`` (``scenegen.scene_content``) on ``device`` in float64;
    ``bf16_vertices`` (the control of the comparison) rounds every vertex
    input -- position, normal, tangent, texture coordinates -- to
    bfloat16."""

    def __init__(self, content: dict, device, bf16_vertices: bool = False):
        dev = self.device = torch.device(device)
        data = content["data"]

        def t(a, dtype=F64):
            return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

        n_tri = data.position.shape[0] // 3
        self.pos = t(data.position).reshape(n_tri, 3, 3)
        self.nrm = t(data.normal).reshape(n_tri, 3, 3)
        self.tan = t(data.tangent).reshape(n_tri, 3, 4)
        self.uv = t(data.uv).reshape(n_tri, 3, 2)
        if bf16_vertices:
            self.pos, self.nrm, self.tan, self.uv = (
                a.to(torch.bfloat16).to(F64) for a in (self.pos, self.nrm, self.tan, self.uv))
        self.tri_model = t(data.tri_model, torch.int64)
        self.box_min = t(np.stack([m.bounds_min for m in data.models]))
        self.box_max = t(np.stack([m.bounds_max for m in data.models]))
        self.n_models = len(data.models)
        # the scene's bounds as the renderer takes them (UpdateSceneBounds):
        # the box around every model's bounding sphere, whose centre and
        # half-diagonal (at least 1) place the light
        c = np.stack([m.center for m in data.models]).astype(np.float64)
        r = np.array([m.radius for m in data.models], np.float64)[:, None]
        lo, hi = (c - r).min(0), (c + r).max(0)
        self.center = (lo + hi) * 0.5
        self.radius = max(float(np.linalg.norm(hi - lo) * 0.5), 1.0)

        mats = content["materials"]
        self.model_material = t(content["model_material"], torch.int64)
        self.tri_material = self.model_material[self.tri_model]
        self.chains = [[t(lv) for lv in material_chain(m["maps"])] for m in mats]
        self.has_normal_map = t([("normal" in m["maps"]) for m in mats], torch.bool)
        self.alpha_mask = t([m["alpha_mask"] for m in mats], torch.bool)
        self.base_factor = t([m["base_color_factor"] for m in mats])
        self.metallic = t([m["metallic"] for m in mats])
        self.roughness = t([m["roughness"] for m in mats])
        self.cutoff = t([m["alpha_cutoff"] for m in mats])

        # env cube: each level (6, s, s, 3) as the env atlas stores it; the
        # last level (the irradiance fetch) as float32
        faces = content["env_faces"]
        n_levels = len(faces[0])
        self.env_mip_count = float(n_levels)
        self.env = []
        for lv in range(n_levels):
            f16 = torch.as_tensor(np.stack([f[lv][..., :3] for f in faces]).astype(np.float16)
                                  .astype(np.float32), device=dev)
            self.env.append(f16.to(torch.bfloat16).to(F64))
        self.env_tail = torch.as_tensor(
            np.stack([f[-1][..., :3] for f in faces]).astype(np.float16).astype(np.float64),
            device=dev)
        self.brdf = t(content["lut"].astype(np.float64) / 65535.0)  # (32, 128, 2)
        light = content["light"]
        self.light_direction = np.asarray(light["direction"], np.float64)
        self.light_intensity = float(light["intensity"])
        self.light_color = t(light["color"])
        cam = content["camera"]
        self.fov_y = np.radians(float(cam["fov_y"]))
        self.background = t(content["background"])
