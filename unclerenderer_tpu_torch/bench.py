"""The port's bench: the counterpart of the repository's ``bench.py`` (which
stays JAX), run as ``python -m unclerenderer_tpu_torch.bench [--device
cuda|cpu]``.

Headline: the Sponza-class synthetic tier -- 340 sphere models and the
ground, 263,184 triangles, Sponza's real material set where
``UNCLERENDERER_ASSETS`` names the reference's assets, else the six
procedural 256^2 materials -- at 1920x1080 with the 4096^2 shadow map,
rendered as ``FRAMES`` chained frames on a slow orbit.  On the card the
frames are replays of one captured frame program
(``render/program.py FrameProgram``) with no shadow map passed in, so that
every frame rasterizes the map as the reference's scan does; each frame's
parameters come from a stack packed on the device beforehand, with no host
synchronisation between frames.  The CPU runs the same frames op by op.

Before the headline two parity gates run on the card: the exhaustive
raster (X1) against the binned one (K1/K2) on a 256^2 frame, depth and
ids bit-equal; and a 256^2 deferred frame on ``raster_backend="pallas"``
(the kernel path) against ``"xla"``: tri_id and the shadow raster
bit-equal, colour within 1e-5.  After it the secondary rows (``shadow2048``,
``bilinear``, ``anisotropic`` and, unless ``BENCH_GEOMETRY`` is set,
``sponza_faithful``, whose geometry falls back to the sphere tier without
the assets) and the pica_pica row through the Renderer (skipped without
its scene).

Prints ONE JSON line with the reference's keys (``metric``, ``value`` in
ms/frame, ``vs_baseline`` = 60 / value, the spread, the rows, the drop
counters), with ``device`` the card's ``nvidia-smi`` name and power limit,
``on_gpu`` for ``on_tpu`` and ``kernel_build_s`` (the seconds this process
spent building the kernels; 0.0 when the library was current) for
``jit_cache_new_entries``.  The launch counts of the gates and of the
headline's timed replays go to stderr on a line of their own
(``bench launches {...}``).

Nothing falls back: a failed gate prints its counts to stderr and the line
with ``value`` null and an ``error``; a row that raises leaves its
``*_error`` key in the line; either way the exit code is non-zero.  Without
a visible card (and no ``--device cpu``) the line carries ``"error": "no
CUDA device"`` and the exit code is 1.

The env overrides ``BENCH_W``, ``BENCH_H``, ``BENCH_FRAMES``,
``BENCH_OBJECTS``, ``BENCH_SHADOW`` and ``BENCH_GEOMETRY`` (the reference's
names and defaults) exist for scaled-down runs; the judged configuration is
the default.  They are read when the bench runs, not at import.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .core.paths import reference_asset
from .ops import _cuda
from .ops.raster import CULL_BACK, DEPTH_MAX, triangle_setup_expanded, viewport_homogeneous
from .ops.raster_kernels import rasterize_binned, rasterize_exhaustive
from .render import common, program
from .render.deferred import deferred_frame
from .render.params import FrameParams, FrameState, RenderSettings
from .render.renderer import Renderer
from .render.testing import sponza_material_chains, synthetic_device_scene, synthetic_frame_params
from .timing import nvidia_smi

BASELINE_MS = 60.0
METRIC = "sponza_class_263k_1080p_deferred_full_pipeline_ms_per_frame"
# the reference's names and defaults (bench.py:34-38)
ENV_DEFAULTS = {"BENCH_W": 1920, "BENCH_H": 1080, "BENCH_FRAMES": 10, "BENCH_OBJECTS": 340,
                "BENCH_SHADOW": 4096}
FRAME_ATOL = 1e-5  # the frame gate's colour: only fp reassociation differs
FRAME_GATE_SIZE = 256  # the frame gate's frame and map: the reference's 256^2
LAUNCH_TAG = "bench launches"
PICA_SCENE = "Scenes/pica_pica.json"  # under the reference's assets


def env_int(name: str) -> int:
    """The env override ``name`` (``ENV_DEFAULTS``), read now."""
    return int(os.environ.get(name, ENV_DEFAULTS[name]))


def _measure(render, frames: int, repeats: int = 3):
    """Steady-state ms a ``render()`` call: the first call is the setup
    (``setup_s``); then ``repeats`` blocks of ``frames`` calls, each frame's
    colour mean kept on the device and one host read a block forcing every
    frame (finite, or RuntimeError), each block on the host clock.  Returns
    ``({"n_runs", "median", "min", "max"}, setup_s)``, ms rounded to 0.01
    as the reference rounds them."""
    t_setup = time.monotonic()
    out = render()
    float(out["color"].mean())
    setup_s = time.monotonic() - t_setup
    samples = []
    for _rep in range(repeats):
        t0 = time.monotonic()
        sums = []
        for _ in range(frames):
            out = render()
            sums.append(out["color"].mean())
        total = float(torch.stack(sums).sum())  # forces every frame
        if not math.isfinite(total):
            raise RuntimeError(f"_measure: the frames' colour sums to {total}")
        samples.append((time.monotonic() - t0) / frames * 1e3)
    stats = {"n_runs": len(samples), "median": round(float(np.median(samples)), 2),
             "min": round(min(samples), 2), "max": round(max(samples), 2)}
    return stats, setup_s


def _host_fields(params: FrameParams) -> dict:
    """FrameParams on the CPU -> its host values by field (``program.pack_params``)."""
    return {f.name: getattr(params, f.name).numpy() for f in dataclasses.fields(FrameParams)}


def _synthetic_scene(settings: RenderSettings, n_objects: int, sphere_res, ground: bool,
                     rich_materials: bool = True, geometry: str | None = None, device="cuda"):
    """The inputs of ``_synthetic_runner``'s chain: ``(scene, data,
    settings, params_at)``, the settings as the chain renders them and
    ``params_at(i)`` frame ``i``'s FrameParams on the CPU."""
    dev = torch.device(device)
    if geometry is None:
        geometry = os.environ.get("BENCH_GEOMETRY", "procedural")
    scene, data = synthetic_device_scene(
        n_objects, sphere_res=sphere_res, ground=ground, rich_materials=rich_materials,
        atlas_u8=settings.material_atlas_u8, packed_trilinear=settings.material_packed_trilinear,
        texture_source="sponza", geometry_source=geometry, device=dev)
    faithful = getattr(data, "sponza_chain_of_model", None) is not None
    # the synthetic scene has no MASK materials; rich_materials takes the
    # Renderer's combined material path
    settings = dataclasses.replace(
        settings, has_masked_models=False,
        combined_material=rich_materials and settings.enable_combined_material)
    w, h = settings.width, settings.height

    def params_at(i):
        a = 0.0035 * i  # slow orbit/pan: ~0.2 deg a frame
        if faithful:
            # the reference sponza.json camera, inside the atrium, panning
            pos = (14.327, 0.762, 0.571)
            c = np.asarray(data.scene_center)
            look = (c[0] - 10.0 * np.cos(a), c[1] + 1.0, c[2] + 10.0 * np.sin(a))
            return synthetic_frame_params(data, w, h, camera_pos=pos, look_at=look, device="cpu")
        pos = (4.0 * np.sin(a), 1.5, -4.0 * np.cos(a))
        return synthetic_frame_params(data, w, h, camera_pos=pos, device="cpu")

    return scene, data, settings, params_at


def _synthetic_runner(settings: RenderSettings, n_objects: int, sphere_res, ground: bool,
                      rich_materials: bool = True, geometry: str | None = None, device="cuda"):
    """``FRAMES`` chained deferred frames of the synthetic tier with camera
    motion, as the reference's one-dispatch ``lax.scan``.  Returns
    ``(render, n_tris, settings, drop_counters, atlas_info)``: ``render()``
    runs the chain and returns ``{"color": each frame's colour mean,
    "last": the last frame's output}``; ``drop_counters()`` the worst frame
    of the last chain per ``raster_stats`` counter.

    On the card the first ``render()`` renders frame 0 op by op (the
    kernels build, the frame's constants are made) and captures the frame
    program from its state with no shadow map, so the map is rasterized
    inside every replay; frames 1.. and every later chain are replays, each
    loading its parameters from the stack packed on the device beforehand.
    On the CPU every frame runs op by op.  The state is carried across
    chains, as the reference donates its scan carry."""
    dev = torch.device(device)
    n_frames = env_int("BENCH_FRAMES")
    scene, data, settings, params_at = _synthetic_scene(
        settings, n_objects, sphere_res, ground, rich_materials, geometry, dev)
    faithful = getattr(data, "sponza_chain_of_model", None) is not None
    w, h = settings.width, settings.height

    fields = [_host_fields(params_at(i)) for i in range(n_frames)]
    layout = program.params_layout(fields[0])
    stack = torch.from_numpy(np.stack([program.pack_params(f) for f in fields])).to(dev)
    state = [FrameState.initial(w, h, dev)]
    prog: list = [None]
    drops_box = [None]

    def render():
        means, drops, last = [], None, None

        def keep(out):
            nonlocal drops, last
            last = out
            means.append(out["color"].mean())
            rs = out["raster_stats"]
            drops = ({k: v.clone() for k, v in rs.items()} if drops is None else
                     {k: torch.maximum(drops[k], v) for k, v in rs.items()})

        first = 0
        if dev.type == "cuda" and prog[0] is None:
            out, new = deferred_frame(scene, program.unpack_params(stack[0], layout), state[0],
                                      settings)
            keep(out)
            prog[0] = program.FrameProgram(scene, settings, "deferred", stack[0], layout, new)
            state[0], first = None, 1  # the program's buffers carry it now
        for i in range(first, n_frames):
            if prog[0] is not None:
                prog[0].load_params(stack[i])
                keep(prog[0].replay())
            else:
                out, state[0] = deferred_frame(scene, program.unpack_params(stack[i], layout),
                                               state[0], settings)
                keep(out)
        drops_box[0] = drops
        return {"color": torch.stack(means), "last": last}

    def drop_counters():
        # the honesty gate: a non-zero counter means the measured frames
        # dropped geometry (compaction caps, bin budgets)
        if drops_box[0] is None:
            return {}
        return {k: int(v) for k, v in sorted(drops_box[0].items())}

    cap = int(os.environ.get("UNCLE_SPONZA_CAP", "512"))
    sp = sponza_material_chains(max_dim=cap)
    atlas_info = {
        "material_atlas_dtype": str(scene.quad_img.dtype).removeprefix("torch."),
        # the layout read off the atlas (256 lanes: packed rows)
        "material_atlas_layout": ("packed_trilinear" if int(scene.quad_img.shape[-1]) == 256
                                  else "quad"),
        "texture_source": (f"sponza_dds_{len(sp[0])}_materials_{cap}cap" if sp is not None
                           else "procedural"),
        "geometry_source": "sponza_gltf_aabb_sheets" if faithful else "procedural_spheres",
    }
    return render, int(data.tri_model.shape[0]), settings, drop_counters, atlas_info


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _differing(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((_bits(a) != _bits(b)).sum())


def _pallas_parity_gate(device) -> bool:
    """The raster gate: the exhaustive raster (the reference's XLA
    ``rasterize``; X1 on the card) against the binned raster (K1/K2) on one
    256^2 frame of the 24-object scene at ``DEPTH_MAX``: depth and ids bit
    for bit.  Prints the differing pixels to stderr on a failure."""
    dev = torch.device(device)
    w = h = 256
    scene, data = synthetic_device_scene(24, sphere_res=(12, 10), ground=True, device=dev)
    params = synthetic_frame_params(data, w, h, device=dev)
    mask = torch.ones(scene.position.shape[0] // 3, dtype=torch.bool, device=dev)
    pos = scene.position
    clip = torch.cat([pos, torch.ones_like(pos[..., :1])], dim=-1) @ params.view_proj
    setup = triangle_setup_expanded(viewport_homogeneous(clip, w, h), clip[:, 2], mask,
                                    CULL_BACK, w, h)
    dx, tx = rasterize_exhaustive(setup, w, h, depth_mode=DEPTH_MAX)
    dp, tp, _stats = rasterize_binned(setup, w, h, depth_mode=DEPTH_MAX)[:3]
    n_depth, n_ids = _differing(dx, dp), _differing(tx, tp)
    if n_depth or n_ids:
        print(f"PALLAS PARITY FAILURE: {n_depth} depth and {n_ids} id pixels of the binned "
              "raster differ from the exhaustive raster", file=sys.stderr)
    return not (n_depth or n_ids)


def _frame_parity_gate(device) -> bool:
    """The frame gate: one ``FRAME_GATE_SIZE``^2 deferred frame of the
    24-object rich scene on ``raster_backend="pallas"`` (the kernel path)
    and on ``"xla"``: tri_id bit for bit; the shadow raster of the draw
    masks (a map of the same size), with shadows on, bit for bit; colour
    (shadows off: the two paths' PCF tables differ by design) within
    ``FRAME_ATOL``.  Prints the failure to stderr."""
    dev = torch.device(device)
    w = h = FRAME_GATE_SIZE
    base = RenderSettings(width=w, height=h, renderer_type="deferred", shadow_map_size=w,
                          has_masked_models=False, combined_material=True, tile_h=16, tile_w=64,
                          chunk=64, shadow_chunk=64, enable_shadows=False)
    scene, data = synthetic_device_scene(24, sphere_res=(12, 10), ground=True,
                                         rich_materials=True, atlas_u8=base.material_atlas_u8,
                                         packed_trilinear=base.material_packed_trilinear,
                                         device=dev)
    params = synthetic_frame_params(data, w, h, device=dev)

    def run(backend):
        s = dataclasses.replace(base, raster_backend=backend)
        out, _state = deferred_frame(scene, params, FrameState.initial(w, h, dev), s)
        sh = dataclasses.replace(s, enable_shadows=True)
        opaque, _masked = common.tri_draw_masks(scene, params.model_visible, sh)
        shadow, _ovf = common.raster_shadow(scene, params.light_view_proj, opaque, sh)
        return out["color"], out["tri_id"], shadow

    c_p, t_p, s_p = run("pallas")
    c_x, t_x, s_x = run("xla")
    if _differing(t_p, t_x):
        print(f"FRAME PARITY FAILURE: {_differing(t_p, t_x)} tri_id pixels differ pallas vs XLA",
              file=sys.stderr)
        return False
    if _differing(s_p, s_x):
        print(f"FRAME PARITY FAILURE: {_differing(s_p, s_x)} shadow-map texels differ pallas vs "
              "XLA", file=sys.stderr)
        return False
    max_diff = float((c_p - c_x).abs().max())
    if not max_diff <= FRAME_ATOL:
        print(f"FRAME PARITY FAILURE: max |color| diff {max_diff:.3e} pallas vs XLA",
              file=sys.stderr)
        return False
    return True


def _pica_row(scene_json: Path, settings: RenderSettings, extra: dict, device="cuda") -> None:
    """The real-scene row: pica_pica on an orbit through the Renderer's
    ``render_frames`` (replays on the card); nothing when the scene file is
    absent."""
    if not scene_json.is_file():
        return
    n_frames = env_int("BENCH_FRAMES")
    t0 = time.monotonic()
    renderer = Renderer(scene_json, settings=settings, device=device)

    def orbit(r, i):
        # ~0.2 deg a frame, like the synthetic tier
        a = 0.0035 * r._frame_counter
        c = np.asarray(r.scene_data.scene_center)
        rad = 2.5 * float(r.scene_data.scene_radius)
        r.camera.position = (c[0] + rad * np.sin(a), c[1] + 0.4 * rad, c[2] - rad * np.cos(a))
        r.camera.set_look_at(c)

    def render_chain():
        colors = renderer.render_frames(n_frames, mutate=orbit)
        return {"color": colors.mean(dim=(1, 2, 3))}

    t_build = time.monotonic() - t0
    stats, compile_s = _measure(render_chain, frames=1)
    runs = _per_frame(stats, n_frames)
    extra.update(
        pica_pica_ms=runs["median"],
        pica_pica_runs=runs,
        pica_pica_setup_s=round(t_build + compile_s, 1),
        pica_scene_cache_hit=bool(renderer.scene_cache_hit),
        pica_setup_phases={**renderer.setup_phase_s,
                           "first_render_compile": round(compile_s, 2)},
    )
    if renderer.texture_substitutions:
        extra["texture_substitutions"] = [str(Path(p).name)
                                          for p in renderer.texture_substitutions]


def _per_frame(stats: dict, frames: int) -> dict:
    """A chain's stats scaled to ms a frame (each call renders ``frames``)."""
    return {k: (round(v / frames, 2) if k != "n_runs" else v) for k, v in stats.items()}


def _free(device) -> None:
    """Return a dropped row's memory (its scene, its program's graph pool)
    before the next row builds."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _launches() -> dict:
    return {k: v for k, v in _cuda.LAUNCHES.items() if v}


def _error_line(error: str, **keys) -> str:
    return json.dumps({"metric": METRIC, "value": None, "unit": "ms", "vs_baseline": None,
                       **keys, "error": error})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m unclerenderer_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' runs the frames op by op on the "
                         "kernels' plain versions and skips the parity gates)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    on_gpu = dev.type == "cuda"
    if on_gpu and not torch.cuda.is_available():
        print(_error_line("no CUDA device"))
        return 1
    width, height = env_int("BENCH_W"), env_int("BENCH_H")
    frames, n_objects, shadow_size = (env_int("BENCH_FRAMES"), env_int("BENCH_OBJECTS"),
                                      env_int("BENCH_SHADOW"))
    kernel_build_s = 0.0
    if on_gpu:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kernel_build_s = _cuda.build()[1]

    # the gates first, on the card (the CPU runs the plain versions, which
    # the tests hold to the reference)
    _cuda.reset_launches()
    pallas_parity = _pallas_parity_gate(dev) if on_gpu else "skipped_cpu"
    frame_parity = _frame_parity_gate(dev) if on_gpu else "skipped_cpu"
    gate_launches = _launches()
    if pallas_parity is False or frame_parity is False:
        print(f"{LAUNCH_TAG} {json.dumps({'gates': gate_launches})}", file=sys.stderr)
        print(_error_line("parity gate failed: the kernel path differs from the XLA path",
                          pallas_parity=pallas_parity, frame_parity=frame_parity))
        return 1

    settings = RenderSettings(width=width, height=height, renderer_type="deferred",
                              shadow_map_size=shadow_size, raster_backend="auto")
    # headline: the Sponza-class tier at the reference's 4096^2 map; each
    # render() is FRAMES chained frames
    render, n_tris, eff, drop_counters, atlas_info = _synthetic_runner(
        settings, n_objects=n_objects, sphere_res=(32, 24), ground=True, device=dev)
    calls = [0]

    def counted():
        # the launches of the timed replays: counted from the first timed call
        if calls[0] == 1:
            _cuda.reset_launches()
        calls[0] += 1
        return render()

    stats_hl, setup_s = _measure(counted, frames=3)
    headline_launches = _launches()
    run_stats = _per_frame(stats_hl, frames)
    ms = run_stats["median"]
    print(f"{LAUNCH_TAG} " + json.dumps({"gates": gate_launches, "headline": headline_launches,
                                        "headline_frames": (calls[0] - 1) * frames}),
          file=sys.stderr)
    # checkpoint: if a later row dies, the headline survives in the log
    print(f"HEADLINE ms_per_frame={ms:.2f} {run_stats} (checkpoint)", file=sys.stderr)

    extra = {}
    drops = drop_counters()
    if drops:
        extra["drop_counters"] = drops
        extra["dropped_work"] = any(v > 0 for v in drops.values())
    del render, counted, drop_counters
    _free(dev)

    def row(name, row_settings, geometry=None):
        r_render, _nt, _eff, r_drops, _ai = _synthetic_runner(
            row_settings, n_objects=n_objects, sphere_res=(32, 24), ground=True,
            geometry=geometry, device=dev)
        st, _setup = _measure(r_render, frames=2)
        extra[f"{name}_ms"] = _per_frame(st, frames)["median"]
        extra[f"{name}_runs"] = _per_frame(st, frames)
        rd = r_drops()
        if any(v > 0 for v in rd.values()):
            extra[f"{name}_drop_counters"] = rd

    try:
        # each row's scene and program are dropped before the next builds
        half_shadow = 2048 if shadow_size == 4096 else max(64, shadow_size // 2)
        row("shadow2048", dataclasses.replace(settings, shadow_map_size=half_shadow))
        _free(dev)
        row("bilinear", dataclasses.replace(settings, texture_filter="bilinear"))
        _free(dev)
        row("anisotropic", dataclasses.replace(settings, texture_filter="anisotropic",
                                               max_anisotropy=4))
        _free(dev)
        if "BENCH_GEOMETRY" not in os.environ:
            # the geometry-faithful tier (the sphere tier without the glTF),
            # with the reference's wider mid capacity
            row("sponza_faithful", dataclasses.replace(settings, bin_mid_divisor=4),
                geometry="sponza")
            _free(dev)
    except Exception as e:  # noqa: BLE001 -- recorded in the line, and the exit is non-zero
        print(f"secondary synthetic rows failed: {e!r}", file=sys.stderr)
        extra["secondary_rows_error"] = str(e)[:200]
        _free(dev)

    pica = reference_asset(PICA_SCENE)
    try:
        if pica:
            _pica_row(Path(pica), settings, extra, dev)
    except Exception as e:  # noqa: BLE001 -- recorded in the line, and the exit is non-zero
        print(f"pica row failed: {e!r}", file=sys.stderr)
        extra["pica_row_error"] = str(e)[:200]

    print(json.dumps({
        "metric": METRIC,
        "value": round(ms, 2),
        "unit": "ms",
        "vs_baseline": round(BASELINE_MS / ms, 3),
        "value_runs": run_stats,
        "triangles": n_tris,
        "shadow_map_size": shadow_size,
        "texture_filter": eff.texture_filter,
        "rich_materials": True,
        "combined_material": eff.combined_material,
        "pallas_parity": pallas_parity,
        "frame_parity": frame_parity,
        **atlas_info,
        "device": nvidia_smi() if on_gpu else str(dev),
        "on_gpu": on_gpu,
        "frames": frames,
        "setup_and_compile_s": round(setup_s, 1),
        "kernel_build_s": round(kernel_build_s, 3),
        **extra,
    }))
    return 1 if "secondary_rows_error" in extra or "pica_row_error" in extra else 0


if __name__ == "__main__":
    sys.exit(main())
