"""Interactive terminal viewer (``unclerenderer_tpu/viewer.py``): the
headless analog of the reference's window and camera-input loop
(``Source/App/Application.cpp:352-587``), on the Renderer's device.

The reference moves the camera with WASD/QE and mouse-look inside a Win32
message pump; here the frame renders into the terminal as 24-bit ANSI
half-block cells (two pixels per character row) and a raw-mode stdin loop
drives the same camera controls:

  w/s   forward / back          arrows  yaw / pitch (mouse-look analog)
  a/d   strafe left / right     + / -   move speed
  q/e   down / up               p       save screenshot PNG
  g     toggle stats overlay    r       reload scene (async, like F5)
  ESC/x quit

Live settings panel (the reference's ImGui toggles,
``Application.cpp:1506-1797``; each key flips a RenderSettings field via
``Renderer.update_settings``):

  1 shadows   2 TAA      3 CAS        4 auto-exposure   5 tonemap
  6 sky       7 IBL      8 culling    9 cycle texture filter
  0 deferred/forward     t  per-pass timing overlay
  c pick model at screen center (selection AABB overlay)   v clear pick

Float sliders (the panel's DragFloat rows, ``Application.cpp:1524-1700``):
``[`` / ``]`` cycle the active parameter (shadow bias, tonemap
exposure/gamma, CAS sharpness, TAA weight, auto-exposure key/min/max,
light intensity), ``,`` / ``.`` nudge it.  They live on
``renderer.config`` / ``renderer.light`` and feed the frame's parameters
every frame.

Every frame runs the renderer's full pipeline (TAA accumulates across
interactive frames as in the reference's swapchain loop); its colour is read
back from the device once per frame.
"""

from __future__ import annotations

import os
import select
import sys
import time

import numpy as np

from .core.logging import log_info

ESC = "\x1b"


def _term_size():
    try:
        sz = os.get_terminal_size()
        return sz.columns, sz.lines
    except OSError:
        return 80, 24


def _downsample(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Box-ish downsample by nearest stride (cheap; preview only)."""
    H, W, _ = img.shape
    ys = (np.arange(h) * H // h).clip(0, H - 1)
    xs = (np.arange(w) * W // w).clip(0, W - 1)
    return img[ys[:, None], xs[None, :]]


def frame_to_ansi(color: np.ndarray, cols: int, rows: int) -> str:
    """(H, W, 3) float [0,1] -> ANSI truecolor half-block string."""
    img = (np.clip(color, 0.0, 1.0) * 255.0).astype(np.uint8)
    img = _downsample(img, cols, rows * 2)
    out = []
    for y in range(rows):
        top = img[2 * y]
        bot = img[2 * y + 1]
        row = []
        for x in range(cols):
            tr, tg, tb = top[x]
            br, bg, bb = bot[x]
            row.append(f"{ESC}[38;2;{tr};{tg};{tb}m{ESC}[48;2;{br};{bg};{bb}m▀")
        out.append("".join(row) + f"{ESC}[0m")
    return "\n".join(out)


class _RawInput:
    """Raw non-blocking stdin (the message-pump analog)."""

    def __enter__(self):
        import termios
        import tty

        self.fd = sys.stdin.fileno()
        self.old = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        return self

    def __exit__(self, *exc):
        import termios

        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.old)

    def read_keys(self) -> list:
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch == ESC:
                # arrow keys arrive as ESC [ A/B/C/D
                if select.select([sys.stdin], [], [], 0.01)[0]:
                    seq = sys.stdin.read(1)
                    if seq == "[" and select.select([sys.stdin], [], [], 0.01)[0]:
                        keys.append("arrow_" + {"A": "up", "B": "down",
                                                "C": "right", "D": "left"}
                                    .get(sys.stdin.read(1), "?"))
                        continue
                keys.append("esc")
            else:
                keys.append(ch)
        return keys


def _camera_basis(cam):
    from . import mathlib as m

    fwd = np.asarray(cam.forward, np.float32)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    right = m.normalize(np.cross(up, fwd))  # LH
    return fwd, right


def run_viewer(renderer, save_path="screenshot.png", target_fps=30.0) -> int:
    """Drive the renderer interactively until quit.  Returns frame count."""
    from .textures.png import save_png

    cam = renderer.camera
    yaw = float(np.arctan2(cam.forward[0], cam.forward[2]))
    pitch = float(-np.arcsin(np.clip(cam.forward[1], -1.0, 1.0)))
    speed = 2.0
    turn = np.radians(4.0)
    show_stats = bool(getattr(renderer, "debug_print_enabled", True))
    show_timing = False
    timing_rows: list = []
    frames = 0

    # live settings panel: key -> RenderSettings bool field
    toggles = {
        "1": "enable_shadows",
        "2": "enable_taa",
        "3": "enable_cas",
        "4": "enable_auto_exposure",
        "5": "enable_tonemap",
        "6": "enable_sky",
        "7": "enable_ibl",
        "8": "enable_gpu_culling",
    }
    filters = ["bilinear", "trilinear", "anisotropic"]
    # float sliders: (label, getter-object attr, step, lo, hi); values live
    # on renderer.config / renderer.light and feed FrameParams every frame
    sliders = [
        ("shadow_bias", "config", 0.0005, 0.0, 0.05),
        ("tonemap_exposure", "config", 0.1, 0.05, 8.0),
        ("tonemap_gamma", "config", 0.1, 1.0, 4.0),
        ("cas_sharpness", "config", 0.05, 0.0, 1.0),
        ("taa_history_weight", "config", 0.02, 0.0, 0.99),
        ("auto_exposure_key", "config", 0.02, 0.01, 2.0),
        ("auto_exposure_min", "config", 0.05, 0.0, 4.0),
        ("auto_exposure_max", "config", 0.25, 0.5, 16.0),
        ("intensity", "light", 0.25, 0.0, 20.0),
    ]
    slider_i = 0
    sys.stdout.write(f"{ESC}[2J")  # clear
    t_prev = time.monotonic()
    with _RawInput() as raw:
        while True:
            t_now = time.monotonic()
            dt = min(t_now - t_prev, 0.1)
            t_prev = t_now
            move = np.zeros(3, np.float32)
            for k in raw.read_keys():
                fwd, right = _camera_basis(cam)
                if k in ("esc", "x"):
                    sys.stdout.write(f"{ESC}[0m\n")
                    return frames
                elif k == "w":
                    move += fwd
                elif k == "s":
                    move -= fwd
                elif k == "a":
                    move -= right
                elif k == "d":
                    move += right
                elif k == "e":
                    move += np.array([0, 1, 0], np.float32)
                elif k == "q":
                    move -= np.array([0, 1, 0], np.float32)
                elif k == "arrow_left":
                    yaw -= turn
                elif k == "arrow_right":
                    yaw += turn
                elif k == "arrow_up":
                    # forward.y = -sin(pitch) (camera.py _recompute_up)
                    pitch = max(pitch - turn, -1.5)
                elif k == "arrow_down":
                    pitch = min(pitch + turn, 1.5)
                elif k == "+":
                    speed *= 1.5
                elif k == "-":
                    speed /= 1.5
                elif k == "g":
                    show_stats = not show_stats
                elif k == "p":
                    save_png(save_path, renderer.render_to_u8())
                    log_info(f"saved {save_path}")
                elif k == "r":
                    # async reload of the same scene (F5 analog)
                    renderer.reload_scene(renderer.scene_path, background=True)
                elif k in toggles:
                    field = toggles[k]
                    renderer.update_settings(
                        **{field: not getattr(renderer.settings, field)}
                    )
                elif k == "9":
                    cur = (
                        filters.index(renderer.settings.texture_filter)
                        if renderer.settings.texture_filter in filters else -1
                    )
                    renderer.update_settings(
                        texture_filter=filters[(cur + 1) % len(filters)]
                    )
                elif k == "0":
                    renderer.update_settings(
                        renderer_type="forward"
                        if renderer.settings.renderer_type == "deferred"
                        else "deferred"
                    )
                elif k == "t":
                    show_timing = not show_timing
                    if show_timing and renderer.settings.renderer_type == "deferred":
                        # in-frame attribution from one device trace of the
                        # frame; the stage-by-stage profile on the CPU, whose
                        # trace has no device rows
                        timing_rows = renderer.profile_trace_passes(frames=2).stats()
                        if not timing_rows:
                            timing_rows = renderer.profile_passes(iterations=1).stats()
                elif k == "c":
                    oid, name = renderer.pick(
                        renderer.settings.width // 2, renderer.settings.height // 2
                    )
                    log_info(f"picked object {oid} {name!r}")
                elif k == "v":
                    renderer.selected_object_id = 0
                    renderer.selected_name = ""
                elif k == "[":
                    slider_i = (slider_i - 1) % len(sliders)
                elif k == "]":
                    slider_i = (slider_i + 1) % len(sliders)
                elif k in (",", "."):
                    name, holder, step, lo, hi = sliders[slider_i]
                    obj = getattr(renderer, holder)
                    val = float(getattr(obj, name))
                    val += step if k == "." else -step
                    setattr(obj, name, min(hi, max(lo, val)))
            if np.any(move):
                cam.position = cam.position + move * speed * max(dt, 1.0 / 60.0)
            cam.set_rotation_euler_degrees(
                np.degrees([pitch, yaw, 0.0])
            )

            renderer.poll_reload()
            out = renderer.render_frame(delta_time=dt)
            frames += 1
            cols, lines = _term_size()
            rows = max(4, lines - 2)
            img = np.clip(out["color"].cpu().numpy(), 0.0, 1.0)
            renderer.composite_overlays(img)
            if show_timing and timing_rows:
                from .core.debugprint import timing_overlay

                timing_overlay(img, timing_rows)
            text = frame_to_ansi(img, min(cols, 200), rows)
            sys.stdout.write(f"{ESC}[H" + text + "\n")
            if show_stats:
                st = renderer.stats()
                s = renderer.settings
                flags = "".join(
                    name if on else "-"
                    for name, on in [
                        ("S", s.enable_shadows), ("T", s.enable_taa),
                        ("C", s.enable_cas), ("E", s.enable_auto_exposure),
                        ("M", s.enable_tonemap), ("K", s.enable_sky),
                        ("I", s.enable_ibl), ("G", s.enable_gpu_culling),
                    ]
                )
                hbm = ""
                if "hbm_bytes_in_use" in st:
                    hbm = f"  hbm {st['hbm_bytes_in_use'] / 1e9:.1f}"
                    if "hbm_bytes_limit" in st:
                        hbm += f"/{st['hbm_bytes_limit'] / 1e9:.0f}G"
                sname, sholder, _st_, _lo, _hi = sliders[slider_i]
                sval = float(getattr(getattr(renderer, sholder), sname))
                sys.stdout.write(
                    f"{ESC}[0m{1.0 / max(dt, 1e-6):5.1f} fps  "
                    f"pos=({cam.position[0]:.1f},{cam.position[1]:.1f},{cam.position[2]:.1f})  "
                    f"vis {st['models_visible']}/{st['models_total']}  "
                    f"frustum {st['frustum_culled']} hzb {st['hzb_occluded']}  "
                    f"[{flags}|{s.renderer_type[:3]}|{s.texture_filter[:3]}]{hbm}  "
                    f"[]{sname}={sval:.3g}  "
                    f"[1-9/0 toggles, [],. sliders, t timing, c pick, x quit]{ESC}[K"
                )
            sys.stdout.flush()
            # frame pacing
            budget = 1.0 / target_fps - (time.monotonic() - t_now)
            if budget > 0:
                time.sleep(budget)
