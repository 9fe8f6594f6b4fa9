"""The reference's frames: ``ReferenceScene`` renders frame ``n`` of a
traffic mix from a frame state, with the pipeline of ``frame.py`` on the
scene of ``scene.py``.

It imports nothing of the program and takes nothing the program made: the
scene comes from the generator's data (``scenegen.scene_content``), the
camera and sun from the traffic, the settings and constants from the
configuration file.  ``DRAWS`` says which settings it follows and which
values of each it draws; the harness refuses a cell whose configuration
or traffic asks for anything else (``run.py refusal``).  A state is the
reference's own (``initial_state``, carried frame to frame) or a snapshot
of the program's (``state_from_program``: TAA history and exposure; the
reference then culls nothing by the hierarchical Z on that first frame,
having no depth of the frame before).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import frame as fr
from .scene import Scene

F64 = torch.float64

#: the Renderer's defaults (``core/config.py RendererConfig``) that the frame reads
CONFIG_DEFAULTS = {
    "shadow_bias": 0.002, "tonemap_exposure": 1.0, "tonemap_gamma": 2.2,
    "cas_sharpness": 0.5, "taa_history_weight": 0.9, "auto_exposure_key": 0.3,
    "auto_exposure_min": 0.1, "auto_exposure_max": 5.0, "auto_exposure_speed_up": 3.0,
    "auto_exposure_speed_down": 1.0,
}
#: the ``RenderSettings`` switches the reference follows, with their defaults
SWITCHES = {"enable_shadows": True, "enable_sky": True, "enable_ibl": True,
            "enable_tonemap": True, "enable_auto_exposure": True, "enable_taa": True,
            "enable_cas": True, "enable_gpu_culling": True, "enable_hzb": True}
#: the material samplers drawn (``RenderSettings.texture_filter``)
FILTERS = ("trilinear", "anisotropic")
DELTA_TIME = 1.0 / 60.0


def _flag(v) -> bool:
    return isinstance(v, bool)


def _count(lo: int):
    def ok(v) -> bool:
        return isinstance(v, int) and not isinstance(v, bool) and v >= lo
    return ok


def _number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _one_of(*values):
    return lambda v: isinstance(v, str) and v in values


_PER_FRAME = {**{k: _flag for k in SWITCHES}, "texture_filter": _one_of(*FILTERS),
              "max_anisotropy": _count(1)}
#: ``RenderSettings`` keys that only choose between implementations with
#: identical output (``render/params.py``'s docstring: the TPU choices, the
#: kernel flags, the one kernel path under ``"auto"`` and ``"pallas"``), and
#: the tile, chunk and cap sizes, whose drops a run counts in ``failed``
_SAME_IMAGE = {
    **{k: _flag for k in ("pallas_interpret", "bin_align_scatter", "env_matmul_gather",
                          "hzb_pallas_tail", "env_select_kernel", "mat_select_kernel",
                          "bin_mat_idx")},
    "compact_mode": lambda v: isinstance(v, str), "raster_backend": _one_of("auto", "pallas"),
    **{k: _count(1) for k in ("tile_h", "tile_w", "chunk", "giant_tile_h", "giant_tile_w",
                              "bin_giant_chunk", "shadow_chunk", "shadow_tile_h",
                              "shadow_tile_w", "shadow_big_tile_h", "shadow_big_tile_w",
                              "shadow_giant_tile_h", "shadow_giant_tile_w")},
    **{k: _count(-1) for k in ("masked_tri_cap", "compact_cap", "shadow_compact_cap")},
    **{k: _number for k in ("bin_budget_factor", "shadow_bin_budget_factor")},
}
#: What the reference draws, by where a setting comes from: for each key it
#: follows, a test of the values it draws.  A configuration's
#: ``render_settings`` and ``renderer_config`` and each value of its
#: traffic's ``settings_cycle`` may set a key outside these only to the
#: program's default.  A settings cycle changes no size: the reference
#: reads those once, from the configuration.
DRAWS = {
    "render_settings": {"width": _count(1), "height": _count(1),
                        "shadow_map_size": _count(1), **_PER_FRAME, **_SAME_IMAGE},
    "settings_cycle": {**_PER_FRAME, **_SAME_IMAGE},
    # the Renderer's constants, and what changes no byte compared: its
    # timing, its task system, the stats block (left out of the comparison)
    "renderer_config": {**{k: _number for k in CONFIG_DEFAULTS},
                        **{k: _flag for k in ("enable_gpu_timing", "use_task_system",
                                              "enable_gpu_debug_print")}},
}


@dataclasses.dataclass
class State:
    history: torch.Tensor | None = None  # (H, W, 3) after TAA
    ev: torch.Tensor | None = None       # () adapted exposure value
    depth: torch.Tensor | None = None    # (H, W) last frame's depth, for the HZB
    frames: int = 0                      # frames rendered since the history began


class ReferenceScene:
    """The scene of ``content`` at ``settings`` (``RenderSettings`` keyword
    values: ``width``, ``height``, ``shadow_map_size``, the ``SWITCHES``,
    ``texture_filter`` and ``max_anisotropy``) and ``config``
    (``RendererConfig`` keyword values), on ``device``; ``bf16_vertices``:
    ``Scene``'s (the control)."""

    def __init__(self, content: dict, settings: dict, config: dict, device,
                 bf16_vertices: bool = False):
        self.scene = Scene(content, device, bf16_vertices)
        self.width, self.height = int(settings["width"]), int(settings["height"])
        self.map_size = int(settings.get("shadow_map_size", 4096))
        self.switches = {k: bool(settings.get(k, v)) for k, v in SWITCHES.items()}
        self.sampler = {"texture_filter": settings.get("texture_filter", FILTERS[0]),
                        "max_anisotropy": int(settings.get("max_anisotropy", 4))}
        self.cfg = dict(CONFIG_DEFAULTS)
        self.cfg.update({k: v for k, v in config.items() if k in CONFIG_DEFAULTS})
        if not self.cfg["shadow_bias"]:
            self.cfg["shadow_bias"] = 0.002
        self._map_key, self._map = None, None

    def initial_state(self) -> State:
        return State()

    def state_from_program(self, fields: dict) -> State:
        """A snapshot of the program's frame state (``taa_history``,
        ``taa_valid``, ``exposure_ev``, ``exposure_valid``) as a reference
        state."""
        taa = bool(fields["taa_valid"])
        ev = bool(fields["exposure_valid"])
        return State(history=fields["taa_history"].to(self.scene.device, F64) if taa else None,
                     ev=fields["exposure_ev"].to(self.scene.device, F64) if ev else None,
                     depth=None, frames=1)

    def _shadow_map(self, light_vp, key, shown) -> torch.Tensor:
        if self._map is None or key != self._map_key:
            s = self.scene
            self._map = fr.shadow_map(s, fr._t(s, light_vp), shown[s.tri_model], self.map_size)
            self._map_key = key
        return self._map

    def frame(self, n: int, view: dict, state: State, settings: dict | None = None,
              shown=None, changed: bool = False):
        """Frame ``n`` at ``view`` (``camera_pos``, ``look_at``,
        ``light_direction``) from ``state``, with the ``SWITCHES`` and the
        sampler of ``settings`` over the configuration's, the models
        ``shown`` (all by default); ``changed``: the settings changed just
        before it (the TAA history restarts).  Returns ((H, W, 3) bytes, the
        new state)."""
        s, cfg = self.scene, self.cfg
        settings = settings or {}
        sw = {**self.switches, **{k: bool(v) for k, v in settings.items() if k in SWITCHES},
              **self.sampler, **{k: v for k, v in settings.items() if k in self.sampler}}
        if changed:
            state = dataclasses.replace(state, history=None, frames=0)
        w, h = self.width, self.height
        taa_on = sw["enable_taa"]
        p = fr.frame_params(s, n, view, w, h, jitter=taa_on and state.frames > 0)
        vp, vp_cull = fr._t(s, p["vp"]), fr._t(s, p["vp_cull"])
        shown = (torch.ones(s.n_models, dtype=torch.bool, device=s.device) if shown is None
                 else torch.as_tensor(np.asarray(shown, bool), device=s.device))
        visible = shown.clone()
        if sw["enable_gpu_culling"]:
            visible &= fr.in_frustum(s, vp_cull)
            if sw["enable_hzb"] and state.depth is not None:
                visible &= ~fr.hzb_occluded(s, vp_cull, fr.hzb_pyramid(state.depth))
        depth, ids, tri = fr.visibility(s, vp, visible[s.tri_model], w, h)

        valid = ids.reshape(-1) >= 0
        pix = valid.nonzero(as_tuple=True)[0]
        t = ids.reshape(-1)[pix]
        x, y = pix % w, torch.div(pix, w, rounding_mode="floor")
        hdr = torch.empty(h * w, 3, dtype=F64, device=s.device)
        if pix.numel():
            hdr[pix] = self._shade(p, sw, shown, tri, t, x, y)
        if sw["enable_sky"]:
            empty = (~valid).nonzero(as_tuple=True)[0]
            hdr[empty] = fr.sky(self._view_dirs(p, empty), p["eye"][1],
                                fr._t(s, p["to_light"]), s.light_color)
        else:
            hdr[~valid] = s.background
        hdr = hdr.reshape(h, w, 3)

        history = state.history
        if taa_on:
            if history is not None:
                hdr = fr.taa(hdr, history, min(max(cfg["taa_history_weight"], 0.0), 1.0))
            history = hdr
        else:
            history = None
        ev = state.ev
        if sw["enable_auto_exposure"]:
            ev = fr.exposure(hdr, ev, ev is not None, cfg, DELTA_TIME)
        color = hdr * cfg["tonemap_exposure"]
        if sw["enable_auto_exposure"]:
            color = color * torch.exp2(ev)
        if sw["enable_tonemap"]:
            color = fr.pbr_neutral(color)
        color = color.clamp(0, 1) ** (1.0 / max(cfg["tonemap_gamma"], 1e-3))
        if sw["enable_cas"]:
            color = fr.rcas(color, cfg["cas_sharpness"]).clamp(0, 1)
        new = State(history=history, ev=ev if sw["enable_auto_exposure"] else None,
                    depth=depth if sw["enable_hzb"] else None,
                    frames=state.frames + 1 if taa_on else 0)
        img = torch.round(color * 255).clamp(0, 255).to(torch.uint8)
        return img.cpu().numpy(), new

    def _view_dirs(self, p, pix):
        """World directions through the centres of pixels ``pix``
        (unjittered)."""
        s, w, h = self.scene, self.width, self.height
        x = (pix % w).to(F64) + 0.5
        y = torch.div(pix, w, rounding_mode="floor").to(F64) + 0.5
        proj, view = p["proj"], fr._t(s, p["view"])
        ray = torch.stack([(x / w * 2 - 1) / proj[0, 0], (1 - y / h * 2) / proj[1, 1],
                           torch.ones_like(x)], -1)
        return fr._unit(ray @ view[:3, :3].T)

    def _shade(self, p, sw, shown, tri, t, x, y):
        """The lit HDR colour (n, 3) of the pixels (x, y) that show triangle
        ``t``, under the switches and sampler ``sw``, the models ``shown``
        casting shadows."""
        s, cfg = self.scene, self.cfg
        a, b, c = tri.edges(t)

        def bary(qx, qy):
            e = a * qx[:, None] + b * qy[:, None] + c
            d = e.sum(1, keepdim=True)
            return e / torch.where(d != 0, d, torch.ones_like(d))

        def interp(wts, attr):
            return (wts[..., None] * attr).sum(1)

        wts = bary(x.to(F64) + 0.5, y.to(F64) + 0.5)
        pos = interp(wts, s.pos[t])
        vn = interp(wts, s.nrm[t])
        tan = interp(wts, s.tan[t])
        uv = interp(wts, s.uv[t])
        # the 2x2 quad's derivatives, from the pixel's own triangle
        bx, by = (x - x % 2).to(F64), (y - y % 2).to(F64)
        uv_tl = interp(bary(bx + 0.5, by + 0.5), s.uv[t])
        d_dx = interp(bary(bx + 1.5, by + 0.5), s.uv[t]) - uv_tl
        d_dy = interp(bary(bx + 0.5, by + 1.5), s.uv[t]) - uv_tl
        mat = s.tri_material[t]
        size = fr.material_size(s, mat)[:, None]
        if sw["texture_filter"] == "anisotropic":
            tex = fr.sample_materials_aniso(s, mat, uv, d_dx, d_dy, size, sw["max_anisotropy"])
        else:
            tex = fr.sample_materials(s, mat, uv, fr.footprint_lod(d_dx, d_dy, size))

        albedo = s.base_factor[mat, :3] * tex[:, 0:3]
        rough = s.roughness[mat] * tex[:, 4]
        metal = s.metallic[mat] * tex[:, 5]
        n = fr._unit(vn)
        rg = tex[:, 6:8] * 2 - 1
        tn = torch.cat([rg, (1 - (rg * rg).sum(1, keepdim=True)).clamp(0, 1).sqrt()], 1)
        tn = torch.where(tn.norm(dim=1, keepdim=True) < 1e-5,
                         torch.tensor([0.0, 0.0, 1.0], dtype=F64, device=s.device), tn)
        tt = fr._unit(tan[:, :3] - n * fr._dot(n, tan[:, :3])[:, None])
        bt = fr._unit(torch.linalg.cross(n, tt, dim=-1)) * tan[:, 3:4]
        mapped = fr._unit(tn[:, 0:1] * tt + tn[:, 1:2] * bt + tn[:, 2:3] * n)
        n = torch.where(s.has_normal_map[mat][:, None], mapped, n)

        eye = fr._t(s, p["eye"])
        v = fr._unit(eye - pos)
        l = fr._unit(fr._t(s, p["to_light"]))
        f0 = 0.04 + (albedo - 0.04) * metal[:, None]
        if sw["enable_shadows"]:
            key = (tuple(p["to_light"].tolist()), tuple(shown.tolist()))
            shadow = fr.pcf(self._shadow_map(p["light_vp"], key, shown), fr._t(s, p["light_vp"]),
                            pos, cfg["shadow_bias"])
        else:
            shadow = torch.ones_like(rough)
        direct = (fr.ggx(albedo, metal, rough, f0, n, v, l) * s.light_intensity
                  * s.light_color * shadow[:, None])
        if not sw["enable_ibl"]:
            return direct
        refl = 2 * fr._dot(n, v)[:, None] * n - v
        mip = rough * max(s.env_mip_count - 1, 0.0)
        pref = fr.cube_trilinear(s.env, refl, mip)
        brdf = fr.bilinear_clamp(s.brdf, torch.stack([fr._sat(fr._dot(n, v)), rough], -1))
        face, _uv = fr.cube_face_uv(n)
        irradiance = s.env_tail[face, 0, 0]
        ambient = irradiance * albedo * (1 - metal)[:, None] + \
            pref * (f0 * brdf[:, 0:1] + brdf[:, 1:2])
        return direct + ambient

