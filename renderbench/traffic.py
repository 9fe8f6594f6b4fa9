"""The general traffic generator: what a traffic file's parameters make of
each frame, and the two ways a client takes frames.

A traffic file (``traffic/<name>.json``) holds:

* ``mode``: ``"present"``, the viewer's loop: one ``Renderer.render_to_u8``
  a frame, each frame on the host before the next is asked for; or
  ``"clip"``: ``Renderer.render_frames(clip_frames)``, the clip's stacked
  colour read back to the host once;
* ``orbit``: the camera on a circle about ``centre`` (default the origin),
  ``radius`` and ``height`` in metres, ``step_rad`` a frame from a start
  angle drawn from the seed in ``start_rad`` [lo, hi], looking at
  ``look_at`` (default the scene's camera target);
* ``sun``: null keeps the scene's light; else its direction at
  ``elevation_rad``, the azimuth stepping ``step_rad`` a frame from a start
  drawn from the seed in ``start_azimuth_rad`` (a clip keeps its first
  frame's sun: ``render_frames`` holds the light);
* ``settings_cycle`` (optional): ``{"every": N, "values": [{...}, ...]}``,
  each value the same ``RenderSettings`` keys (those the configuration's
  reference draws in a cycle, its ``DRAWS["settings_cycle"]``; a run
  refuses others, ``run.py refusal``): frames kN .. kN + N - 1 render
  at ``values[k % len(values)]``, set by ``Renderer.update_settings`` before
  the first frame and wherever they change (present mode);
* ``hide_cycle`` (optional): ``{"every": N, "stride": k}``: from frame jN
  the models whose index is ``j % k`` modulo ``k`` are hidden, the others
  shown;
* ``scene_cache`` (optional, default false): the Renderer's scene cache on,
  in a fixed directory of the checkout, with the scene written to a fixed
  directory there too, so that a second run of the same cell and seed
  starts warm;
* ``warmup_frames``: frames rendered in set-up (the first runs op by op,
  the second captures the frame program);
* ``check``: which frames are compared with the reference: the first
  ``start_frames`` of set-up; one run of ``run_frames`` frames that the
  reference carries on from there to a window position among the first
  ``carry_within`` frames of the window, where the program's frame state
  is compared too; and ``samples`` runs of ``run_frames`` frames from
  positions spread over the whole window, each from the program's frame
  state there, all drawn from the seed.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from torch.profiler import record_function


class Traffic:
    def __init__(self, spec: dict, scene_json: Path, seed: int):
        self.spec = spec
        self.mode = spec["mode"]
        if self.mode not in ("present", "clip"):
            raise ValueError(f"traffic mode must be 'present' or 'clip', not {self.mode!r}")
        self.clip = int(spec.get("clip_frames", 1)) if self.mode == "clip" else 1
        for key in ("settings_cycle", "hide_cycle"):
            if key in spec and self.mode != "present":
                raise ValueError(f"traffic {key} needs mode 'present'")
        doc = json.loads(Path(scene_json).read_text())
        orbit = spec["orbit"]
        self.target = np.asarray(orbit.get("look_at", doc["camera"]["look_at"]), np.float32)
        self.centre = np.asarray(orbit.get("centre", (0.0, 0.0, 0.0)), np.float32)
        self.scene_light = np.asarray(doc["lights"][0]["direction"], np.float32)
        rng = np.random.default_rng([seed, 0])
        self.a0 = float(rng.uniform(*orbit["start_rad"]))
        sun = spec.get("sun")
        self.az0 = float(rng.uniform(*sun["start_azimuth_rad"])) if sun else 0.0
        self.sample_rng = np.random.default_rng([seed, 1])

    def view(self, n: int) -> dict:
        """Frame ``n``'s camera position, target and light direction."""
        orbit = self.spec["orbit"]
        a = self.a0 + orbit["step_rad"] * n
        pos = self.centre + np.array([orbit["radius"] * np.sin(a), orbit["height"],
                                      -orbit["radius"] * np.cos(a)], np.float32)
        sun = self.spec.get("sun")
        if sun:
            k = n - n % self.clip
            az, el = self.az0 + sun["step_rad"] * k, sun["elevation_rad"]
            light = np.array([np.cos(el) * np.cos(az), -np.sin(el), np.cos(el) * np.sin(az)],
                             np.float32)
        else:
            light = self.scene_light
        return {"camera_pos": pos.astype(np.float32), "look_at": self.target,
                "light_direction": light}

    def settings(self, n: int) -> dict:
        """The ``RenderSettings`` changes in force at frame ``n``."""
        cyc = self.spec.get("settings_cycle")
        if not cyc:
            return {}
        return dict(cyc["values"][(n // cyc["every"]) % len(cyc["values"])])

    def settings_changed(self, n: int) -> bool:
        """Whether the client changes the settings just before frame ``n``
        (after the first)."""
        return n > 0 and self.settings(n) != self.settings(n - 1)

    def visible(self, n: int, n_models: int) -> np.ndarray:
        """The models shown at frame ``n``."""
        shown = np.ones(n_models, bool)
        cyc = self.spec.get("hide_cycle")
        if cyc:
            phase = (n // cyc["every"]) % cyc["stride"]
            shown[np.arange(n_models) % cyc["stride"] == phase] = False
        return shown

    def apply(self, renderer, n: int) -> None:
        """Put frame ``n``'s camera, light, settings and visibility into
        ``renderer``."""
        v = self.view(n)
        renderer.camera.position = v["camera_pos"]
        renderer.camera.set_look_at(v["look_at"])
        renderer.light.direction = v["light_direction"]
        if self.settings(n) and (n == 0 or self.settings_changed(n)):
            renderer.update_settings(**self.settings(n))
        if "hide_cycle" in self.spec:
            mask = renderer.scene_data.visible_mask
            mask[:] = self.visible(n, mask.shape[0])

    def step(self, renderer, n: int) -> list:
        """Frames ``n`` .. ``n + clip - 1`` as the client gets them: a list
        of (H, W, 3) arrays on the host, u8 (``present``) or f32
        (``clip``).  The calls are named ranges, so that a profiler trace
        says what the host was doing."""
        if self.mode == "present":
            self.apply(renderer, n)
            with record_function("Renderer.render_to_u8"):
                return [renderer.render_to_u8()]
        with record_function("Renderer.render_frames"):
            colors = renderer.render_frames(self.clip, mutate=lambda r, i: self.apply(r, n + i))
        with record_function("clip read-back"):
            return list(colors.cpu().numpy())

    def draw_checks(self) -> tuple[int, list]:
        """(the carried run's position among the window's first frames, the
        sampled runs' positions as fractions of the window), from the
        seed.  Positions are client steps (a clip's first frame)."""
        chk = self.spec["check"]
        carry = int(self.sample_rng.integers(0, max(chk["carry_within"] // self.clip, 1)))
        fractions = sorted(float(f) for f in self.sample_rng.uniform(0.0, 1.0, chk["samples"]))
        return carry * self.clip, fractions
