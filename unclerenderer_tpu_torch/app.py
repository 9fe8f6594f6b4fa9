"""Headless CLI renderer (``unclerenderer_tpu/app.py``): scene JSON -> PNG,
on the card unless ``--device cpu`` is given (no fallback to the CPU).

Usage::

    python -m unclerenderer_tpu_torch --scene Assets/Scenes/Duck.json \\
        --width 512 --height 512 --output out.png

``--renderer forward`` renders with the forward renderer
(``render/forward.py``), ``deferred`` (the config's default) with the
deferred one.  ``--orbit N`` renders an N-frame camera orbit with
``Renderer.render_frames`` and writes ``out_000.png`` .. ``out_<N-1>.png``.  PNGs are written with the
stdlib (``textures/png.py save_png``).  ``--trace DIR`` writes a
``torch.profiler`` Chrome trace of ``max(1, frames - 1)`` frames after the
first into DIR (open it in Perfetto).  ``--frames N`` logs the first
frame's time (the kernel build included) and the steady state's ms/frame
over N - 1 more frames; on the card, where the frame after the first
captures the frame program (``render/program.py``), that frame is rendered
before the steady state and logged on its own ``capture:`` line, so the
steady state times replays only; ``--profile-passes`` logs the deferred
stages' times (``Renderer.profile_passes``; deferred only, as the
reference's).  ``--interactive`` runs the terminal viewer
(``viewer.py run_viewer``) on the Renderer, and ``--output`` names its
screenshot.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

from .core.config import load_config
from .core.logging import log_info, log_warning, set_log_level
from .render.params import RenderSettings
from .textures.png import save_png


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="UncleRenderer headless renderer (PyTorch + CUDA)")
    ap.add_argument("--scene", required=True, help="scene JSON path")
    ap.add_argument("--config", default=None, help="RendererConfig.ini path")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--output", default="out.png")
    ap.add_argument("--renderer", choices=["forward", "deferred"], default=None)
    ap.add_argument("--frames", type=int, default=1, help="render N frames (timing)")
    ap.add_argument(
        "--orbit", type=int, default=0, metavar="N",
        help="render an N-frame camera orbit around the scene with Renderer.render_frames "
             "and write out_000.png..; also prints the chained ms/frame",
    )
    ap.add_argument("--no-shadows", action="store_true")
    ap.add_argument("--shadow-size", type=int, default=4096)
    ap.add_argument("--no-sky", action="store_true")
    ap.add_argument("--no-ibl", action="store_true")
    ap.add_argument("--log-level", default="info")
    ap.add_argument("--profile-passes", action="store_true",
                    help="log the deferred stages' times (Renderer.profile_passes)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the frames after the first "
                         "into DIR")
    ap.add_argument("--interactive", action="store_true",
                    help="terminal viewer with WASD/arrow camera controls "
                         "(Application.cpp input-loop analog)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda; 'cpu' runs the kernels' "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    set_log_level(args.log_level)
    from .render.renderer import Renderer

    cfg = load_config(args.config)
    if args.renderer:
        cfg.renderer_type = args.renderer
    width = args.width or cfg.window_width
    height = args.height or cfg.window_height
    settings = RenderSettings(
        width=width,
        height=height,
        renderer_type=cfg.renderer_type,
        enable_shadows=cfg.enable_shadows and not args.no_shadows,
        shadow_map_size=args.shadow_size,
        enable_sky=not args.no_sky,
        enable_ibl=not args.no_ibl,
        enable_tonemap=cfg.enable_tonemap,
        enable_auto_exposure=cfg.enable_auto_exposure,
        enable_taa=cfg.enable_taa,
        enable_cas=cfg.enable_cas,
        enable_gpu_culling=cfg.enable_indirect_draw,
    )
    renderer = Renderer(args.scene, settings=settings, config=cfg, device=args.device)

    if args.interactive:
        from .viewer import run_viewer

        frames = run_viewer(renderer, save_path=args.output)
        log_info(f"viewer exited after {frames} frames")
        return 0

    def sync():
        if renderer.device.type == "cuda":
            import torch

            torch.cuda.synchronize(renderer.device)

    if args.orbit > 0:
        c = np.asarray(renderer.scene_data.scene_center)
        rad = 2.5 * float(renderer.scene_data.scene_radius)

        def orbit(r, i):
            a = 2.0 * np.pi * r._frame_counter / max(args.orbit, 1)
            r.camera.position = (c[0] + rad * np.sin(a), c[1] + 0.4 * rad, c[2] - rad * np.cos(a))
            r.camera.set_look_at(c)

        t0 = time.monotonic()
        colors = renderer.render_frames(args.orbit, mutate=orbit).cpu().numpy()
        total = time.monotonic() - t0
        stem = Path(args.output)
        for i, frame in enumerate(colors):
            u8 = np.clip(np.rint(frame * 255.0), 0, 255).astype(np.uint8)
            save_png(stem.with_name(f"{stem.stem}_{i:03d}{stem.suffix}"), u8)
        log_info(
            f"orbit: {args.orbit} frames, {total / args.orbit * 1e3:.2f} ms/frame incl. the "
            f"first frame's kernel build; wrote {stem.stem}_000{stem.suffix}.."
            f"{stem.stem}_{args.orbit - 1:03d}{stem.suffix}"
        )
        drops = {k: int(v) for k, v in (renderer._chain_drop_counters or {}).items()}
        if any(v > 0 for v in drops.values()):
            log_warning(f"orbit dropped work (worst frame): {drops}")
        else:
            log_info(f"orbit drop counters (worst frame): {drops}")
        return 0

    t0 = time.monotonic()
    img = renderer.render_to_u8()
    log_info(f"first frame (incl. the kernel build): {(time.monotonic() - t0) * 1e3:.1f} ms")
    if args.trace:
        renderer.profile_trace(args.trace, frames=max(1, args.frames - 1))
    if args.profile_passes and settings.renderer_type == "deferred":
        for row in renderer.profile_passes(iterations=1).stats():
            log_info(f"pass {row['name']:<22} avg {row['avg_ms']:7.2f} ms  "
                     f"min {row['min_ms']:7.2f}  max {row['max_ms']:7.2f}")
    if args.frames > 1:
        if renderer.will_capture():
            # this frame captures the frame program: timed on its own line,
            # so that the steady state below times replays only
            t0 = time.monotonic()
            renderer.render_frame()
            sync()
            log_info(f"capture: {(time.monotonic() - t0) * 1e3:.1f} ms (one frame captured into "
                     "the frame program, not in the steady state)")
        t0 = time.monotonic()
        for _ in range(args.frames - 1):
            renderer.render_frame()
        sync()
        per_frame = (time.monotonic() - t0) / (args.frames - 1)
        log_info(f"steady-state: {per_frame * 1e3:.2f} ms/frame on {renderer.device}")
    save_png(args.output, img)
    log_info(f"wrote {args.output} ({width}x{height})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
