"""The Renderer shell (``unclerenderer_tpu/render/renderer.py``): scene load,
texture decode, material fuse, atlas and device-scene build, then frames.

The analog of the D3D12 renderer's ``FApplication`` and renderer
``Initialize`` (scene build, texture loads, descriptor heap), with the frame
loop replaced by calls to ``deferred_frame`` or, under
``renderer_type="forward"``, ``forward_frame`` on the Renderer's device (the
card unless the caller names another).

Deliberately not carried over from the reference:

* the forward fallback ladder (``renderer.py:662-681``: a first deferred
  frame that raises is re-rendered by the forward renderer).  Here it would
  hide a kernel that fails to build or launch; a failing frame raises.
* the lowered frame graph of ``enable_graph_dump``: eager PyTorch lowers
  nothing, so ``render_graph_dump.txt`` holds the first deferred frame's
  ordered op list instead (every aten op with its shapes and dtypes, and
  every kernel launch of ``ops/_cuda.py``, each under its pass), and a
  failing dump raises where the reference logs and goes on.

Observability (the reference's): ``enable_gpu_timing`` fills
``stats()["frame_timing"]``: a replayed frame's ``"Frame"`` and per-pass
samples from the timing events its program records
(``core/passes.py DeviceSpans``), read at the next replay or at
``stats()`` (which waits for the last), and an op-by-op frame's from events
recorded around it on the card, by the host clock on the CPU;
``profile_passes`` times the deferred stages one by one
(``render/framegraph.py``); ``profile_trace`` writes a ``torch.profiler``
Chrome trace of rendered frames and ``profile_trace_passes`` buckets its
device time by pass (``core/traceparse.py``).  A call's parts are host
spans there (``core/passes.py scope``): ``Renderer.frame`` (its
``Renderer.params``, ``Renderer.shadow`` with the drop count's read
``Renderer.shadow.drop_read``, ``FrameProgram.replay`` and
``FrameProgram.clone``), the present's ``Renderer.present.readback`` and
``Renderer.present.u8``, and ``Renderer.frames`` (a replay and a
``Renderer.frames.gather`` a frame).

The built scene goes through the on-disk cache (``core/scenecache.py``) as
the reference's does: a warm start maps the stored host arrays and uploads
them (``setup_phase_s["cache_load"]``, ``["device_upload"]``) where a cold
one builds them (``["scene_build"]``, ``["build_and_upload"]``) and stores
them; ``scene_cache_hit`` says which.  ``reload_scene`` goes through it too.

Host vectors are never read back from the device per frame: the shadow-map
cache is keyed on the host light vector and visibility, the frame's
parameters travel in one non-blocking copy, and ``render_frames`` keeps
the worst-frame drop counters on the device.

On the card the frames run as programs (``render/program.py``), as the
reference's run compiled: the first frame of a (settings, scene) runs op by
op and builds the kernels, the next captures the frame into a CUDA graph
(and the shadow raster into another at the first map it re-renders), and
every later frame replays it.  The frame state then lives in the program's
static buffers (``frame_state`` is them; assigning it copies into them),
and each frame's outputs are clones the next replay leaves alone.  A
changed ``settings`` or scene (``update_settings``, ``reload_scene``)
drops the programs, where the reference recompiles.  Every setting is
captured (``program.supported``); the CPU, ``program.eager()`` blocks,
``profile_trace`` and the graph dump run op by op;
``stats()["frame_program"]`` says how the last frame ran.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from .. import mathlib as m
from ..core import passes, scenecache
from ..core.config import RendererConfig
from ..core.logging import log_error, log_info, log_warning
from ..core.tasks import parallel_map, schedule_task, set_task_system_enabled
from ..ops.present import present_u8, to_u8_host
from ..scene.build import SceneData, build_scene
from ..scene.camera import Camera
from ..scene.scene_json import SceneLightDesc, load_scene_json
from ..textures.atlas import build_pyramid_quad_atlas, build_pyramid_tri_atlas
from ..textures.dds import load_dds
from ..textures.image import (
    TextureCache,
    combined_chain,
    encode_combined_u8,
    generate_mips,
    solid_color_texture,
)
from . import common
from .deferred import deferred_frame
from .forward import forward_frame
from .packing import M_UVOS, M_UVROT, pack_model_record, pack_tri_geo, pack_tri_mrec
from .packing import scene_host_arrays
from .framegraph import PassTimingStats
from . import program
from .params import (
    PACKED_TRI_AUTO_MATERIALS,
    DeviceScene,
    FrameParams,
    FrameState,
    RenderSettings,
    resolve_packed_trilinear,
    upload_scene,
)

_SLOT_SRGB = (True, False, False, True)  # base, mr, normal, emissive
DEBUG_PRINTF_FIFO = 64 << 20  # device printf FIFO under kernel_debug_print


def _signature(x) -> str:
    """``f32[1080,1920]`` for a tensor, the tuple of them for a sequence,
    ``repr`` for anything else."""
    if isinstance(x, torch.Tensor):
        dtype = str(x.dtype).replace("torch.", "")
        return f"{dtype}[{','.join(map(str, x.shape))}]"
    if isinstance(x, (list, tuple)):
        return "(" + ", ".join(_signature(v) for v in x) + ")"
    return repr(x)


@contextlib.contextmanager
def record_graph(path: Path | None):
    """The GraphDump analog: run the block with every aten op (a
    ``TorchDispatchMode`` sees them, with their argument and result shapes
    and dtypes) and every kernel launch of ``ops/_cuda.py`` (the dispatcher
    does not see those; on the CPU, each dispatch to a kernel's plain
    version) written, in order, to ``path`` -- each line under the pass and
    sub-scope path open at the time (``core/passes.py``).  ``path`` None
    runs the block as it is."""
    if path is None:
        yield
        return
    from torch.utils._python_dispatch import TorchDispatchMode

    from ..ops import _cuda

    lines = []

    class _Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            lines.append(f"{passes.scope_path() or '-'}\top {func} "
                         f"{_signature(list(args))} -> {_signature(out)}")
            return out

    def launch(name, what):
        lines.append(f"{passes.scope_path() or '-'}\t{what} {name}")

    _cuda.LAUNCH_LOG = launch
    try:
        with _Ops():
            yield
    finally:
        _cuda.LAUNCH_LOG = None
    kernels = sorted({ln.split()[-1] for ln in lines if "\tkernel " in ln})
    head = [f"# render graph: {len(lines)} entries (aten ops and kernel launches, in order; "
            "pass path, then the entry)",
            f"# kernels launched: {', '.join(kernels) or 'none'}"]
    path.write_text("\n".join(head + lines) + "\n")


def _build_device_scene(
    data: SceneData, assets_root: Path, allow_combined: bool = True,
    packed_trilinear: bool | str = False, substitutions_out: list | None = None,
    files_out: list | None = None, host_out: dict | None = None,
    atlas_u8: bool = False, device="cuda",
) -> tuple[DeviceScene, float, bool]:
    """Every device array of a scene: geometry, material tables, atlases,
    the env cube and the BRDF LUT, on ``device``.  Returns (scene, env mip
    count, whether the combined material was built).

    ``substitutions_out`` receives the paths of textures that fell back to
    the default grid; ``files_out`` every asset file the build read;
    ``host_out`` the host arrays (``packing.scene_host_arrays``, bf16 as
    uint16 bits), byte-equal to the reference's.  Atlases are built in
    float32 or u8 and cast to bf16 by torch at the end (round to nearest
    even, as the reference's ``ml_dtypes`` stores)."""
    cache = TextureCache()
    chains = [generate_mips(solid_color_texture([1.0, 1.0, 1.0, 1.0], 1))]  # 0 = white
    path_to_id: dict[str, int] = {}
    n_models = data.num_models
    tex_ids = np.zeros((n_models, 4), np.int32)
    has_map = np.zeros((n_models, 4), bool)

    # unique (path, srgb) requests, decoded in parallel on the task pool
    # (LoadTexturesParallel, TextureLoader.cpp:746-841), atlas slots
    # assigned in request order
    requests: list[tuple[str, bool]] = []
    for slots in data.texture_paths:
        for si, path in enumerate(slots):
            if path and (path, _SLOT_SRGB[si]) not in requests:
                requests.append((path, _SLOT_SRGB[si]))
    decoded = parallel_map(lambda req: cache.load_or_default(req[0], srgb=req[1]), requests)
    for (path, srgb), mips in zip(requests, decoded):
        path_to_id[f"{path}|{srgb}"] = len(chains)
        chains.append(mips)
    if substitutions_out is not None:
        substitutions_out.extend(sorted(cache.substitutions))
    if files_out is not None:
        files_out.extend(p for (p, _s) in requests if p and Path(p).is_file())

    for mi, slots in enumerate(data.texture_paths):
        for si, path in enumerate(slots):
            if not path:
                continue
            tex_ids[mi, si] = path_to_id[f"{path}|{_SLOT_SRGB[si]}"]
            has_map[mi, si] = True

    def _pow2ify(mips):
        """Power-of-two guard for the pyramid layout: odd sizes get a
        nearest resample."""
        h, w = mips[0].shape[:2]
        if (w & (w - 1)) == 0 and (h & (h - 1)) == 0:
            return mips
        nw = 1 << int(np.ceil(np.log2(max(w, 1))))
        nh = 1 << int(np.ceil(np.log2(max(h, 1))))
        yi = (np.arange(nh) * h // nh).clip(0, h - 1)
        xi = (np.arange(nw) * w // nw).clip(0, w - 1)
        return generate_mips(mips[0][yi][:, xi])

    chains = [_pow2ify(c) for c in chains]

    # environment cube (prefiltered mip chain): packed-trilinear rows with
    # the seamless cross-face borders baked in
    env_path = assets_root / "Textures" / "output_pmrem.dds"
    env_mip_count = 1.0
    env_dds = load_dds(env_path) if env_path.is_file() else None
    if files_out is not None and env_path.is_file():
        files_out.append(str(env_path))
    if env_dds is not None and env_dds.is_cube:
        env_mip_count = float(env_dds.mip_count)
        face_chains = [[lvl.astype(np.float32) for lvl in env_dds.mips[face]]
                       for face in range(6)]
        env_img, env_rect0 = build_pyramid_tri_atlas(face_chains, cube=True)
        env_tail = np.stack([chain[-1][..., :4] for chain in face_chains])
    else:
        if env_dds is None:
            log_warning(f"environment cube not found at {env_path}; IBL will be flat")
        env_img = np.full((8, 128, 128), 0.1, np.float32)
        env_rect0 = np.zeros((6, 4), np.int32)
        env_rect0[:, 2:] = 1
        env_tail = np.full((6, 1, 1, 4), 0.1, np.float32)

    lut_path = assets_root / "Textures" / "PreintegratedGF.dds"
    lut_dds = load_dds(lut_path) if lut_path.is_file() else None
    if files_out is not None and lut_path.is_file():
        files_out.append(str(lut_path))
    if lut_dds is not None:
        brdf_img = lut_dds.mips[0][0].astype(np.float32)
    else:
        log_warning(f"BRDF LUT not found at {lut_path}; using analytic fallback")
        # Karis' analytic approximation keeps IBL usable without the asset
        nv = np.linspace(0.0, 1.0, 128, dtype=np.float32)[None, :]
        rough = np.linspace(0.0, 1.0, 32, dtype=np.float32)[:, None]
        a = rough * rough
        brdf_img = np.zeros((32, 128, 4), np.float32)
        brdf_img[..., 0] = 1.0 - a * 0.5 - 0.25 * (1.0 - nv)
        brdf_img[..., 1] = a * 0.25 * nv

    # combined-material eligibility: every model's present slots share one
    # KHR texture transform (one tap, one uv); otherwise per-slot taps
    ut, ur = data.uv_transform, data.uv_rotation
    combined = allow_combined and bool(has_map.any())
    shared_os = np.tile(np.array([0, 0, 1, 1], np.float32), (n_models, 1))
    shared_rot = np.tile(np.array([1, 0], np.float32), (n_models, 1))
    for mi in range(n_models):
        slots = np.nonzero(has_map[mi])[0]
        if len(slots) == 0:
            continue
        s0 = slots[0]
        shared_os[mi], shared_rot[mi] = ut[mi, s0], ur[mi, s0]
        if any(
            not (np.allclose(ut[mi, s], ut[mi, s0]) and np.allclose(ur[mi, s], ur[mi, s0]))
            for s in slots[1:]
        ):
            combined = False

    if combined:
        # one fused 16-channel chain per distinct slot-id combination
        combo_of: dict[tuple, int] = {}
        model_combo = np.zeros(n_models, np.int32)
        combo_keys: list[tuple] = []
        for mi in range(n_models):
            key = tuple(int(tex_ids[mi, s]) if has_map[mi, s] else -1 for s in range(4))
            if key not in combo_of:
                combo_of[key] = len(combo_keys)
                combo_keys.append(key)
            model_combo[mi] = combo_of[key]
        combo_chains = parallel_map(
            lambda key: combined_chain([chains[key[s]] if key[s] >= 0 else None
                                        for s in range(4)]),
            combo_keys,
        )
        mat_dtype = np.float32  # stored bf16 (scene_host_arrays)
        if atlas_u8:
            combo_chains = parallel_map(lambda ch: [encode_combined_u8(lv) for lv in ch],
                                        combo_chains)
            mat_dtype = np.uint8
        build = (build_pyramid_tri_atlas
                 if resolve_packed_trilinear(packed_trilinear, len(combo_chains))
                 else build_pyramid_quad_atlas)
        quad_img, rect0 = build(combo_chains, wrap=True, dtype=mat_dtype)
        slot_rect0 = np.repeat(rect0[model_combo].astype(np.float32)[:, None, :], 4, axis=1)
    else:
        quad_img, rect0 = build_pyramid_quad_atlas(chains, wrap=True)
        # per-(model, slot) base rects; absent slots point at the white texture
        slot_rect0 = rect0[tex_ids].astype(np.float32)

    model_rec = pack_model_record(data, has_map, slot_rect0)
    if combined:
        # the combined resolve reads slot 0's transform as the shared one
        model_rec[:, M_UVOS:M_UVOS + 4] = shared_os
        model_rec[:, M_UVROT:M_UVROT + 2] = shared_rot
    host = scene_host_arrays(data, tex_ids, has_map, quad_img, pack_tri_geo(data),
                             pack_tri_mrec(data, model_rec), brdf_img, env_img, env_rect0,
                             env_tail)
    if host_out is not None:
        host_out.update(host)
    return upload_scene(host, device), env_mip_count, combined


def scene_cache_key(scene_path: Path, settings: RenderSettings, assets_root: Path) -> str:
    """The scene cache's key of a build (reference
    ``render/renderer.py:336-365``): the scene JSON and model files, and the
    resolved atlas layout -- the atlas settings, the material count at which
    "auto" picks the packed atlas, and the assets root."""
    return scenecache.scene_key(
        scene_path, scenecache.model_files_of(scene_path),
        (settings.enable_combined_material, settings.material_packed_trilinear,
         PACKED_TRI_AUTO_MATERIALS, settings.material_atlas_u8, str(assets_root)))


def _host_params(fields: dict, device) -> torch.Tensor:
    """FrameParams host values packed into one float32 vector
    (``program.pack_params``), pinned on the card so that its copy to the
    device does not block: the host never waits for the frames already
    queued."""
    flat = torch.from_numpy(program.pack_params(fields))
    return flat.pin_memory() if device.type == "cuda" else flat


def _params_on_device(fields: dict, device) -> FrameParams:
    """FrameParams from host values, copied in one transfer;
    ``model_visible`` travels as 0/1 and becomes bool on the device."""
    flat = _host_params(fields, device).to(device, non_blocking=True)
    return program.unpack_params(flat, program.params_layout(fields))


class Renderer:
    """Owns the device scene, camera, light, settings and frame state, on
    ``device`` (the card unless the caller names another: there is no
    fallback to the CPU)."""

    def __init__(
        self,
        scene_path: str | Path,
        settings: RenderSettings | None = None,
        config: RendererConfig | None = None,
        assets_root: str | Path | None = None,
        device="cuda",
    ):
        scene_path = Path(scene_path)
        self.scene_path = scene_path
        self.device = torch.device(device)
        # the frame programs (render/program.py) of the current settings and
        # scene, and the settings and scene whose op-by-op frame warmed them
        self._program = None
        self._shadow_program = None
        self._warm = None
        self.frame_program = "eager: no frame rendered yet"
        cfg = config or RendererConfig()
        if settings is None:
            settings = RenderSettings(
                width=cfg.window_width,
                height=cfg.window_height,
                renderer_type=cfg.renderer_type,
                enable_shadows=cfg.enable_shadows,
                enable_tonemap=cfg.enable_tonemap,
                enable_auto_exposure=cfg.enable_auto_exposure,
                enable_taa=cfg.enable_taa,
                enable_cas=cfg.enable_cas,
                # IndirectDraw: the reference's GPU-driven culled draws; here
                # the frame's frustum and HZB culling mask
                enable_gpu_culling=cfg.enable_indirect_draw,
            )
        self.settings = settings
        self.config = cfg
        self._apply_config_side_effects(cfg)
        if settings.kernel_debug_print and self.device.type == "cuda":
            # room for K1's lines: the FIFO grows only before any kernel runs
            from ..ops import _cuda

            _cuda.printf_fifo(DEBUG_PRINTF_FIFO)

        if assets_root is None:
            assets_root = scene_path.parent.parent
        self.assets_root = Path(assets_root)

        t0 = time.monotonic()
        # per-phase init seconds (module docstring)
        self.setup_phase_s: dict[str, float] = {}
        built = self._load_or_build(scene_path, settings, self.setup_phase_s)
        self.scene_data, self.device_scene, self.env_mip_count, combined = built[:4]
        self.texture_substitutions, self.scene_cache_hit = built[4:]
        self._sync_scene_settings()

        _models, light, camera_desc = load_scene_json(scene_path)
        self.light = light or SceneLightDesc()
        self.camera = Camera()
        self.camera.set_perspective(np.radians(60.0), settings.width / settings.height, 0.1,
                                    1000.0)
        if camera_desc is not None:
            self.camera.position = camera_desc.position
            self.camera.set_perspective(np.radians(camera_desc.fov_y_degrees),
                                        settings.width / settings.height, 0.1, 1000.0)
            if camera_desc.look_at is not None:
                self.camera.set_look_at(camera_desc.look_at)
            elif camera_desc.rotation_euler is not None:
                self.camera.set_rotation_euler_degrees(camera_desc.rotation_euler)

        try:
            doc = json.loads(Path(scene_path).read_text())
            self.background = np.asarray(
                doc.get("environment", {}).get("background", [0.1, 0.1, 0.15]), np.float32)
        except (OSError, ValueError):
            self.background = np.array([0.1, 0.1, 0.15], np.float32)

        self._sync_atlas_settings(combined)
        self.frame_state = FrameState.initial(self.settings.width, self.settings.height,
                                              self.device)
        log_info(
            f"renderer init: {self.scene_data.num_models} models, "
            f"{self.scene_data.num_triangles} triangles in {time.monotonic() - t0:.2f}s "
            f"on {self.device}"
        )
        self._taa_history_ready = False
        self._frame_counter = 0
        self._shadow_cache = None
        self._shadow_overflow = 0
        self._shadow_key = None
        self._chain_drop_counters = None
        self._last_out = None
        self._present_u8 = None  # the card's present: the u8 frame before its read-back
        self._pending_reload = None
        self.selected_object_id = 0
        self.selected_name = ""

    def _load_or_build(self, scene_path: Path, settings: RenderSettings, phases: dict,
                       fallback: bool = True):
        """The scene and its device arrays from the scene cache, or built
        (and stored) when the cache misses: ``(scene_data, device_scene,
        env_mip_count, combined, texture_substitutions, cache_hit)``, under
        ``scene_cache_key``; ``phases`` receives the seconds of each init
        phase.  A scene that fails to load falls back to the
        procedural default scene (``DeferredRenderer.cpp:259-293``), which
        is never cached, or raises ValueError without ``fallback``."""
        key = scene_cache_key(scene_path, settings, self.assets_root)
        t = time.monotonic()
        cached = scenecache.load(key)
        phases["cache_load"] = round(time.monotonic() - t, 2)
        if cached is not None:
            data, arrays, meta = cached
            t = time.monotonic()
            # copied out of the read-only maps: a CPU tensor shares its array
            dev = upload_scene({k: np.array(v) for k, v in arrays.items()}, self.device)
            self._sync_device()
            phases["device_upload"] = round(time.monotonic() - t, 2)
            return (data, dev, meta["env_mip_count"], bool(meta["combined"]),
                    list(meta["substitutions"]), True)
        t = time.monotonic()
        data = build_scene(scene_path, self.assets_root)
        phases["scene_build"] = round(time.monotonic() - t, 2)
        if data is None and not fallback:
            raise ValueError(f"failed to load scene {scene_path}")
        if data is None:
            log_error(f"failed to load scene {scene_path}; falling back to the "
                      "procedural default scene")
            from .testing import synthetic_scene_data

            data, key = synthetic_scene_data(4), None
        subs, consumed, host = [], [], {}
        t = time.monotonic()
        dev, mips, combined = _build_device_scene(
            data, self.assets_root, settings.enable_combined_material,
            packed_trilinear=settings.material_packed_trilinear, substitutions_out=subs,
            files_out=consumed, host_out=host, atlas_u8=settings.material_atlas_u8,
            device=self.device)
        self._sync_device()
        phases["build_and_upload"] = round(time.monotonic() - t, 2)
        if key is not None:
            scenecache.store(key, data, host, {"env_mip_count": mips, "combined": combined,
                                               "substitutions": subs}, consumed)
        return data, dev, mips, combined, subs, False

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sync_scene_settings(self) -> None:
        """Settings that follow the scene (renderer.py:387-410): the masked
        raster only when a model needs it, compacted to the exact masked
        triangle count rounded up to 64, and the slots any model maps."""
        data = self.scene_data
        masked_model = data.alpha_mode == 1
        has_masked = bool(masked_model.any())
        masked_cap = -(-int(masked_model[data.tri_model].sum()) // 64) * 64 if has_masked else 0
        slot_enabled = tuple(bool(any(tp[si] for tp in data.texture_paths)) for si in range(4))
        s = self.settings
        if (s.has_masked_models, s.slot_enabled, s.masked_tri_cap) != (
                has_masked, slot_enabled, masked_cap):
            self.settings = dataclasses.replace(s, has_masked_models=has_masked,
                                                slot_enabled=slot_enabled,
                                                masked_tri_cap=masked_cap)

    def _sync_atlas_settings(self, combined: bool) -> None:
        """Packed-trilinear rows and u8 storage exist only for the combined
        atlas; the packed choice ("auto" included) is read off the atlas
        itself, whose packed rows carry 256 lanes (renderer.py:486-502)."""
        s = self.settings
        packed = combined and int(self.device_scene.quad_img.shape[-1]) == 256
        u8 = s.material_atlas_u8 and combined
        if (s.combined_material, s.material_packed_trilinear, s.material_atlas_u8) != (
                combined, packed, u8):
            self.settings = dataclasses.replace(s, combined_material=combined,
                                                material_packed_trilinear=packed,
                                                material_atlas_u8=u8)

    def _apply_config_side_effects(self, cfg: RendererConfig) -> None:
        """Honour, refuse or log every RendererConfig key: no toggle silently
        does nothing."""
        set_task_system_enabled(cfg.use_task_system)
        # GpuTiming: a "Frame" sample per frame, and one per pass of a
        # frame on the card (stats()["frame_timing"])
        self._gpu_timing = bool(cfg.enable_gpu_timing)
        self._frame_times = PassTimingStats() if self._gpu_timing else None
        self._eager_spans = passes.DeviceSpans("EagerFrame")
        self._eager_spans.sink = self._add_frame_timing if self._gpu_timing else None
        # GraphDump: the first deferred frame's op list, once
        self._graph_dump_pending = bool(cfg.enable_graph_dump)
        # GpuDebugPrint (RendererConfig.h:38): the stats block drawn inside
        # the deferred frame (ops/overlay.py) plus the host overlays of
        # render_overlay_u8
        self.debug_print_enabled = bool(cfg.enable_gpu_debug_print)
        if self.debug_print_enabled and self.settings.renderer_type == "deferred":
            self.settings = dataclasses.replace(self.settings, gpu_debug_print=True)
        inherent = {
            "FramesInFlight": "a frame's kernels queue on one CUDA stream ahead of the device",
            "FrameOverlap": "a frame's kernels queue on one CUDA stream ahead of the device",
            "LogResourceBarriers": "one CUDA stream orders every kernel; there are no barriers",
            "UseDepthPrepass": "the visibility raster is a fused depth prepass",
        }
        for key, why in inherent.items():
            log_info(f"config {key}: inherent in the CUDA port ({why}); value ignored")

    @property
    def frame_state(self) -> FrameState:
        """The carried frame state; with a deferred program, its static
        buffers, which each replay overwrites (clone what you keep)."""
        return self._frame_state

    @frame_state.setter
    def frame_state(self, state: FrameState) -> None:
        """Copied into the program's state buffers where the program has
        them and the shapes agree; otherwise the programs are dropped."""
        prog = self._program
        if prog is not None and prog.state is not None:
            if state is prog.state:
                return
            fields = [f.name for f in dataclasses.fields(FrameState)]
            if all(getattr(state, f).shape == getattr(prog.state, f).shape
                   and getattr(state, f).dtype == getattr(prog.state, f).dtype for f in fields):
                for f in fields:
                    getattr(prog.state, f).copy_(getattr(state, f))
                return
            self._drop_programs()
        self._frame_state = state

    def _drop_programs(self) -> None:
        """Forget the frame programs and their warm-up, where the reference
        recompiles (changed settings or scene); the state stays as it is."""
        self._program = None
        self._shadow_program = None
        self._warm = None

    def _frame_mode(self) -> str:
        """How the next frame runs: "graph" (a program replay, captured first
        where none is current), or "eager: <why>" (op by op)."""
        if self.device.type != "cuda":
            return f"eager: {program.CPU_REASON}"
        if program.eager_active():
            return "eager: inside program.eager()"
        if self._deferred() and self._graph_dump_pending:
            return "eager: the graph dump records the first deferred frame op by op"
        prog = self._program
        if prog is not None and (prog.scene is not self.device_scene
                                 or prog.settings != self.settings):
            self._drop_programs()  # settings or scene replaced in place
        warm = self._warm is not None and (self._warm[0] == self.settings
                                           and self._warm[1] is self.device_scene)
        if self._program is not None or warm:
            return "graph"
        return "eager: warm-up (the kernels build; the next frame captures the program)"

    def will_capture(self) -> bool:
        """Whether the next frame captures the frame program (on the card,
        the frame after the op-by-op warm-up of a (settings, scene))."""
        return self._frame_mode() == "graph" and self._program is None

    def _eager_frame(self, fields: dict, dump: bool = False, shadow: bool = True) -> dict:
        """One frame op by op (under ``record_graph`` with ``dump``); the
        state is carried through ``frame_state``.  ``shadow`` False takes the
        cached map as it is."""
        params = _params_on_device(fields, self.device)
        shadow_map = (self._shadow_map(params) if shadow or not self.settings.enable_shadows
                      else self._shadow_cache)
        if self._deferred():
            with record_graph(Path("render_graph_dump.txt") if dump else None):
                out, self.frame_state = deferred_frame(self.device_scene, params,
                                                       self.frame_state, self.settings,
                                                       shadow_map)
            if dump:
                log_info("wrote render_graph_dump.txt (the frame's op list)")
        else:
            out = forward_frame(self.device_scene, params, self.settings, shadow_map)
        if self.device.type == "cuda":
            self._warm = (self.settings, self.device_scene)
        return out

    def _program_params(self, fields: dict) -> program.FrameProgram:
        """The current frame program, captured at its first use, with
        ``fields`` loaded into its parameter buffer."""
        host = _host_params(fields, self.device)
        prog = self._program
        if prog is None:
            deferred = self._deferred()
            prog = program.FrameProgram(
                self.device_scene, self.settings, "deferred" if deferred else "forward",
                host.to(self.device), program.params_layout(fields),
                state=self.frame_state if deferred else None,
                shadow_map=self._shadow_cache if self.settings.enable_shadows else None)
            self._program = prog
            if deferred:
                self._frame_state = prog.state
            if self._gpu_timing:
                prog.spans.sink = self._add_frame_timing
            log_info(f"frame program captured: {prog.kind}, {sum(prog.launches.values())} kernel "
                     f"launches, pool {prog.pool_bytes / 2**30:.2f} GiB, {prog.capture_s:.2f} s")
        else:
            prog.load_params(host)
        return prog

    def _add_frame_timing(self, spans: list) -> None:
        """GpuTiming's samples of a replay (or an op-by-op frame) read from
        its events: the frame's whole span as "Frame", and each pass and
        sub-scope (the ms of a name that recurs summed)."""
        by_name: dict = {}
        for sp in spans:
            if sp.name in ("FrameProgram", "EagerFrame"):
                by_name["Frame"] = sp.ms
            elif sp.name != sp.program:
                by_name[sp.name] = by_name.get(sp.name, 0.0) + sp.ms
        for name, ms in by_name.items():
            self._frame_times.add_sample(name, ms)

    def frame_params(self, delta_time: float = 1.0 / 60.0) -> FrameParams:
        return _params_on_device(self._frame_fields(delta_time), self.device)

    def _frame_fields(self, delta_time: float) -> dict:
        """The frame's parameters as host values, FrameParams' fields."""
        view = self.camera.view_matrix()
        proj_base = self.camera.projection_matrix()
        # TAA jitter only once history is valid (DeferredRenderer.cpp:398-411);
        # the forward frame has no TAA
        if self._deferred() and self.settings.enable_taa and self._taa_history_ready:
            jitter = m.taa_jitter(self._frame_counter)
            proj = m.jittered_projection(proj_base, jitter, self.settings.width,
                                         self.settings.height)
        else:
            proj = proj_base
        light_vec = m.light_vector_from_scene_direction(self.light.direction)
        light_vp = m.build_directional_light_view_proj(
            self.scene_data.scene_center, self.scene_data.scene_radius, light_vec)
        cfg = self.config
        return dict(
            view=view,
            proj=proj,
            proj_unjittered=proj_base,
            view_proj=view @ proj,
            camera_pos=self.camera.position,
            light_dir=light_vec,
            light_intensity=self.light.intensity,
            light_color=self.light.color,
            light_view_proj=light_vp,
            shadow_strength=1.0 if self.settings.enable_shadows else 0.0,
            shadow_bias=cfg.shadow_bias if cfg.shadow_bias else 0.002,
            background=self.background,
            model_visible=self.scene_data.visible_mask,
            env_mip_count=self.env_mip_count,
            tonemap_exposure=cfg.tonemap_exposure,
            tonemap_gamma=cfg.tonemap_gamma,
            cas_sharpness=cfg.cas_sharpness,
            taa_history_weight=cfg.taa_history_weight,
            auto_exposure_key=cfg.auto_exposure_key,
            auto_exposure_min=cfg.auto_exposure_min,
            auto_exposure_max=cfg.auto_exposure_max,
            auto_exposure_speed_up=cfg.auto_exposure_speed_up,
            auto_exposure_speed_down=cfg.auto_exposure_speed_down,
            delta_time=delta_time,
        )

    def _shadow_map(self, params: FrameParams | None,
                    prog: program.FrameProgram | None = None) -> torch.Tensor | None:
        """Cached shadow map: geometry and light are static, so the map
        re-renders only when the light or the visibility changes (the D3D12
        renderer re-renders it every frame).  Keyed on the host vectors the
        params were built from; the drop count is read back only when the
        map re-renders.  With ``prog`` (its parameter buffer loaded) the map
        re-renders by the shadow program into ``prog``'s map buffer, else op
        by op from ``params`` (copied into the current program's map buffer
        where there is one)."""
        if not self.settings.enable_shadows:
            return None
        with passes.scope("Renderer.shadow"):
            key = (tuple(m.light_vector_from_scene_direction(self.light.direction).tolist()),
                   tuple(np.asarray(self.scene_data.visible_mask).tolist()))
            if self._shadow_cache is None or key != self._shadow_key:
                if prog is not None:
                    if self._shadow_program is None or self._shadow_program.program is not prog:
                        self._shadow_program = program.ShadowProgram(prog)
                        if self._gpu_timing:
                            self._shadow_program.spans.sink = self._add_frame_timing
                    overflow = self._shadow_program.run()
                    depth = prog.shadow_map
                else:
                    opaque, masked = common.tri_draw_masks(self.device_scene, params.model_visible,
                                                           self.settings)
                    depth, overflow = common.raster_shadow(
                        self.device_scene, params.light_view_proj, opaque | masked, self.settings)
                    current = self._program
                    if current is not None and current.shadow_map is not None:
                        current.shadow_map.copy_(depth)
                        depth = current.shadow_map
                self._shadow_cache = depth
                with passes.scope("Renderer.shadow.drop_read"):
                    self._shadow_overflow = int(overflow)
                if self._shadow_overflow:
                    log_warning(f"shadow compaction dropped {self._shadow_overflow} casters -- "
                                "raise RenderSettings.shadow_compact_cap")
                self._shadow_key = key
            return self._shadow_cache

    def _deferred(self) -> bool:
        """The deferred frame renders unless ``renderer_type`` asks for the
        forward one (any other value renders forward, as in the reference)."""
        return self.settings.renderer_type == "deferred"

    def render_frame(self, delta_time: float = 1.0 / 60.0) -> dict:
        """One deferred or forward frame (``renderer_type``) on the cached
        shadow map; a forward frame leaves the frame state as it is.  On the
        card a replay of the frame program where ``_frame_mode`` says so
        (its outputs are clones, kept as they are by later frames).  No
        fallback: a frame that fails (a kernel that does not build or
        launch, a capture or a replay included) raises; the reference's
        retry with the forward renderer is not carried over.  Under
        ``enable_gpu_timing`` a frame's "Frame" and pass samples come from
        timing events (a replayed frame's program's, or recorded around an
        op-by-op frame on the card), read later with no host sync; on the
        CPU its "Frame" from the host clock; under
        ``enable_graph_dump`` the first deferred frame runs op by op under
        ``record_graph`` and writes ``render_graph_dump.txt``."""
        with passes.scope("Renderer.frame"):
            t0 = time.perf_counter()
            mode = self._frame_mode()
            with passes.scope("Renderer.params"):
                fields = self._frame_fields(delta_time)
                prog = self._program_params(fields) if mode == "graph" else None
            if prog is not None:
                # the map re-rendered into the program's buffer where the
                # light or the visibility changed
                self._shadow_map(None, prog)
                out = prog.run()
            else:
                dump = self._deferred() and self._graph_dump_pending
                self._graph_dump_pending &= not dump
                timed = self._gpu_timing and self.device.type == "cuda"
                with self._eager_spans.running() if timed else contextlib.nullcontext():
                    out = self._eager_frame(fields, dump=dump)
                if self._gpu_timing and not timed:
                    self._frame_times.add_sample("Frame", (time.perf_counter() - t0) * 1e3)
            if self._deferred() and self.settings.enable_taa:
                self._taa_history_ready = True
            self._count(out)
            self.frame_program = mode
            self._frame_counter += 1
            self._last_out = out
            return out

    @staticmethod
    def _count(out: dict) -> None:
        """A frame's device counters into ``passes.COUNTERS`` while a
        profiler records: the resolve's attribute interpolation and material
        tap's (every frame) and the anisotropic tap's (anisotropic frames)."""
        if passes.tracing():
            for key in ("tap_counts", "aniso_counts"):
                if key in out:
                    passes.COUNTERS.add(out[key])

    def render_frames(self, n: int, delta_time: float = 1.0 / 60.0, mutate=None) -> torch.Tensor:
        """Render ``n`` carried frames back to back and return their stacked
        (n, H, W, 3) colour.  ``mutate(renderer, i)`` may move the camera per
        frame; the light and visibility stay fixed, so the shadow map is
        rendered at most once.  The worst frame's value of each drop counter
        stays on the device until ``stats()`` reads it (the reference scans
        the frames in one device program, ``renderer.py:695-763``).  On the
        card each frame is a program replay (after one op-by-op warm-up
        frame where none ran yet), each frame's parameters copied into the
        program's buffer on the stream, with no host synchronisation between
        frames.  Forward frames leave the frame state as it is and, as the
        reference's chain, keep no drop counters."""
        if n < 1:
            raise ValueError(f"render_frames: n must be >= 1, got {n}")
        with passes.scope("Renderer.frames"):
            deferred = self._deferred()
            fields_list = []
            for i in range(n):
                if mutate is not None:
                    mutate(self, i)
                fields_list.append(self._frame_fields(delta_time))
                self._frame_counter += 1
                if deferred and self.settings.enable_taa:
                    self._taa_history_ready = True
            colors, drops = None, ({} if not deferred else None)
            for i, fields in enumerate(fields_list):
                mode = self._frame_mode()
                if mode == "graph":
                    with passes.scope("Renderer.params"):
                        prog = self._program_params(fields)
                    if i == 0:
                        self._shadow_map(None, prog)
                    out = prog.replay()
                else:
                    out = self._eager_frame(fields, shadow=i == 0)
                self._count(out)
                self.frame_program = mode
                with passes.scope("Renderer.frames.gather"):
                    if colors is None:
                        colors = torch.empty((n,) + tuple(out["color"].shape),
                                             dtype=out["color"].dtype, device=out["color"].device)
                    colors[i].copy_(out["color"])
                    if deferred:
                        rs = out["raster_stats"]
                        drops = ({k: v.clone() for k, v in rs.items()} if drops is None else
                                 {k: torch.maximum(drops[k], v) for k, v in rs.items()})
            # stats()/pick() re-render on demand; the chain's drops stay visible
            self._chain_drop_counters = drops
            self._last_out = None
            return colors

    def _latest_out(self) -> dict:
        """The last rendered frame's outputs (one frame is rendered if there
        is none): stats() and pick() read the frame already shown."""
        if self._last_out is None:
            self.render_frame()
        return self._last_out

    def render_to_u8(self, delta_time: float = 1.0 / 60.0) -> np.ndarray:
        """Render and convert to (H, W, 3) uint8 as the UNORM backbuffer
        stores it.  On the card the conversion runs there
        (``ops/present.py present_u8``, into a buffer kept while the frame
        size holds) and only its bytes are read back, into fresh pinned host
        memory; on the CPU the colour is read back and converted on the host.
        The array returned owns its memory: later calls leave it as it is."""
        color = self.render_frame(delta_time)["color"]
        if color.is_cuda:
            with passes.scope("Renderer.present.u8"):
                if self._present_u8 is None or self._present_u8.shape != color.shape:
                    self._present_u8 = torch.empty(color.shape, dtype=torch.uint8,
                                                   device=color.device)
                present_u8(color, out=self._present_u8)
            with passes.scope("Renderer.present.readback"):
                host = torch.empty(color.shape, dtype=torch.uint8, pin_memory=True)
                host.copy_(self._present_u8, non_blocking=True)
                torch.cuda.current_stream(color.device).synchronize()
                return host.numpy()
        with passes.scope("Renderer.present.readback"):
            color = color.cpu().numpy()
        with passes.scope("Renderer.present.u8"):
            return to_u8_host(color)

    # ------------------------------------------------------------------
    # introspection, picking, state

    def update_settings(self, **changes) -> None:
        """Live settings change (the reference's ImGui setters): swaps
        RenderSettings fields and drops what was keyed on the old ones; an
        atlas change rebuilds the device scene, a resolution change resets
        the frame state, otherwise only TAA history is invalidated."""
        new = dataclasses.replace(self.settings, **changes)
        if new == self.settings:
            return
        old = self.settings
        self.settings = new
        self._drop_programs()
        if ("enable_combined_material" in changes or "material_packed_trilinear" in changes
                or "material_atlas_u8" in changes):
            self.texture_substitutions = []
            self.device_scene, self.env_mip_count, combined = _build_device_scene(
                self.scene_data, self.assets_root, new.enable_combined_material,
                packed_trilinear=new.material_packed_trilinear,
                substitutions_out=self.texture_substitutions,
                atlas_u8=new.material_atlas_u8, device=self.device,
            )
            self._sync_atlas_settings(combined)
        self._shadow_cache = None
        self._shadow_overflow = 0
        self._shadow_key = None
        self._taa_history_ready = False
        self._last_out = None
        if (new.width, new.height) != (old.width, old.height):
            self.frame_state = FrameState.initial(new.width, new.height, self.device)
        else:
            self.frame_state = dataclasses.replace(
                self.frame_state, taa_valid=torch.tensor(False, device=self.device))
        log_info(f"settings updated: {changes}")

    def pick(self, x: int, y: int) -> tuple[int, str]:
        """The object id at pixel (x, y) of the last rendered frame and its
        model's name; id 0 is the background.  The uint32 id image is read
        through its int32 view (ids are below 2^24)."""
        out = self._latest_out()
        object_id = int(out["object_id"].view(torch.int32)[y, x])
        name = ""
        if object_id > 0:
            for model in self.scene_data.models:
                if model.object_id == object_id:
                    name = model.name
                    break
        self.selected_object_id = object_id
        self.selected_name = name
        return object_id, name

    def selected_bounds(self):
        """World AABB of the selected model, or None."""
        if self.selected_object_id <= 0:
            return None
        ids = np.asarray(self.scene_data.object_ids)
        idx = np.nonzero(ids == self.selected_object_id)[0]
        if idx.size == 0:
            return None
        i = int(idx[0])
        return (np.asarray(self.scene_data.bounds_min_arr[i]),
                np.asarray(self.scene_data.bounds_max_arr[i]))

    def stats(self) -> dict:
        """Scene and culling counts of the last rendered frame, its drop
        counters (the worst frame of the last ``render_frames`` folded in),
        exposure, TAA state, device memory, how the last frame ran
        (``frame_program``: "graph" or "eager: <why>"), the programs it
        holds (``programs``) and GpuTiming's table, the last frame's samples
        in it (read once its events complete).  Does not advance the
        frames.  A forward frame culls nothing: every model counts as
        visible.  The resolve's counts (``tap_pixels``,
        ``tap_kernel_pixels``, ``attr_pixels``, ``attr_kernel_pixels``:
        ``common.resolve_materials``), and an
        anisotropic frame's (``common.aniso_counters``: ``aniso_pixels``,
        ``aniso_line_pixels``, ``aniso_taps``)."""
        out = self._latest_out()
        passes.collect(wait=True)
        total = self.scene_data.num_models
        n_visible = int(out["model_visible"].sum()) if "model_visible" in out else total
        rs = {k: int(v) for k, v in out["raster_stats"].items()}
        for k, v in (self._chain_drop_counters or {}).items():
            rs[k] = max(rs.get(k, 0), int(v))
        return {
            "models_total": total,
            "models_visible": n_visible,
            "models_culled": total - n_visible,
            "frustum_culled": int(out.get("frustum_culled", 0)),
            "hzb_occluded": int(out.get("hzb_occluded", 0)),
            "triangles_total": self.scene_data.num_triangles,
            "bin_pair_overflow": rs.get("pair_overflow", 0),
            "bin_giant_truncated": rs.get("giant_truncated", 0),
            # valid triangles dropped past the compaction cap
            "compact_overflow": rs.get("compact_overflow", 0),
            # casters dropped past the light-space cap: frames take the
            # cached map, so the cache build's count is the real one
            "shadow_compact_overflow": max(rs.get("shadow_compact_overflow", 0),
                                           int(self._shadow_overflow)),
            "exposure_ev": float(self.frame_state.exposure_ev),
            "taa_history_valid": bool(self.frame_state.taa_valid),
            "frame_program": self.frame_program,
            **{k: int(v) for k, v in out.get("tap_counts", {}).items()},
            **{k: int(v) for k, v in out.get("aniso_counts", {}).items()},
            **self.memory_stats(),
            **self._program_stats(),
            **({"frame_timing": self._frame_times.stats()} if self._gpu_timing else {}),
        }

    def _program_stats(self) -> dict:
        """``{"programs": {name: ...}}`` of the frame and shadow programs
        held: capture seconds, pool bytes, and the traced replays read and
        unread (a replay overwritten before its events were read, as each
        but the last of a ``render_frames`` clip)."""
        progs = {p.spans.program: p for p in (self._program, self._shadow_program)
                 if p is not None}
        if not progs:
            return {}
        return {"programs": {name: {"capture_s": p.capture_s, "pool_bytes": p.pool_bytes,
                                    "replays_read": p.spans.read,
                                    "replays_unread": p.spans.unread}
                             for name, p in progs.items()}}

    def memory_stats(self) -> dict:
        """Device memory in use, total and peak in bytes; empty on the CPU."""
        if self.device.type != "cuda":
            return {}
        _free, total = torch.cuda.mem_get_info(self.device)
        return {
            "hbm_bytes_in_use": int(torch.cuda.memory_allocated(self.device)),
            "hbm_bytes_limit": int(total),
            "hbm_peak_bytes_in_use": int(torch.cuda.max_memory_allocated(self.device)),
        }

    def profile_passes(self, iterations: int = 3) -> PassTimingStats:
        """Per-pass timing table (the GpuTiming toggle analog): the deferred
        stages run and timed one by one (``render/framegraph.py``)."""
        from .framegraph import profile_deferred_passes

        return profile_deferred_passes(self, iterations)

    def profile_trace_passes(self, frames: int = 3, trace_dir=None) -> PassTimingStats:
        """In-frame per-pass device time: one ``profile_trace`` of
        ``frames`` rendered frames, its device rows bucketed by pass
        (``core/traceparse.py``) into a ``PassTimingStats`` table, with
        "(other)" for rows in no pass and "(total)".  Empty on the CPU: the
        trace has no device rows."""
        import tempfile

        from ..core.traceparse import parse_pass_times

        d = trace_dir or tempfile.mkdtemp(prefix="uncle_trace_")
        self.profile_trace(d, frames=frames)
        stats = PassTimingStats(window_seconds=1e9)
        for name, ms in parse_pass_times(d, n_frames=frames).items():
            stats.add_sample(name, ms)
        return stats

    def profile_trace(self, trace_dir, frames: int = 3) -> str:
        """Record ``frames`` rendered frames with ``torch.profiler`` (host
        and, on the card, device activity) and write its Chrome trace into
        ``trace_dir`` (open it in Perfetto); every pass and sub-scope is a
        named range there: the frames run op by op (``program.eager``), as a
        replayed graph replays no range.  Returns ``trace_dir``."""
        trace_dir = Path(trace_dir)
        trace_dir.mkdir(parents=True, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof, program.eager():
            for _ in range(frames):
                self.render_frame()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        path = trace_dir / f"frames_{time.strftime('%Y%m%d_%H%M%S')}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        log_info(f"profiler trace ({frames} frames) written to {path}")
        return str(trace_dir)

    def save_state(self, path) -> None:
        """Checkpoint the camera and the frame-carried state (an .npz the
        reference's ``load_state`` reads too)."""
        st = self.frame_state

        def host(t):
            return t.cpu().numpy()

        np.savez(
            path,
            camera_position=self.camera.position,
            camera_forward=self.camera.forward,
            camera_up=self.camera.up,
            camera_fov_y=self.camera.fov_y,
            taa_history=host(st.taa_history),
            taa_valid=host(st.taa_valid),
            exposure_ev=host(st.exposure_ev),
            exposure_valid=host(st.exposure_valid),
            hzb=host(st.hzb),
            hzb_valid=host(st.hzb_valid),
            frame_index=host(st.frame_index),
            frame_counter=self._frame_counter,
        )

    def load_state(self, path) -> None:
        with np.load(path) as data:
            self.camera.position = data["camera_position"]
            self.camera.forward = data["camera_forward"]
            self.camera.up = data["camera_up"]
            self.camera.fov_y = float(data["camera_fov_y"])

            def dev(name):
                return torch.from_numpy(np.array(data[name])).to(self.device)

            self.frame_state = FrameState(
                taa_history=dev("taa_history"),
                taa_valid=dev("taa_valid"),
                exposure_ev=dev("exposure_ev"),
                exposure_valid=dev("exposure_valid"),
                hzb=dev("hzb"),
                hzb_valid=dev("hzb_valid"),
                frame_index=dev("frame_index"),
            )
            self._frame_counter = int(data["frame_counter"])
            self._taa_history_ready = bool(data["taa_valid"])
        self._last_out = None

    def reload_scene(self, scene_path, background: bool = True):
        """Scene reload (the reference's StartAsyncSceneReload,
        ``Application.cpp:1011-1135``): the new scene and its atlases are
        built on the task pool and swapped in by ``poll_reload`` (call it
        per frame); ``background=False`` builds and swaps now.
        The build takes the current atlas settings (the reference's drops
        ``material_atlas_u8``) and goes through the scene cache as
        construction does, and the scene-dependent settings are synced as at
        construction.  A scene that fails to load raises (no fallback)."""
        scene_path = Path(scene_path)
        settings = self.settings

        def build():
            data, dev, mips, combined, subs, _hit = self._load_or_build(scene_path, settings, {},
                                                                        fallback=False)
            return scene_path, data, dev, mips, combined, subs

        if not background:
            self._apply_reload(build())
            return None
        future = schedule_task(build)
        self._pending_reload = future
        return future

    def _apply_reload(self, built) -> None:
        scene_path, data, dev, mips, combined, subs = built
        self._drop_programs()
        self.texture_substitutions = subs
        self.scene_data = data
        self.device_scene = dev
        self.env_mip_count = mips
        self._sync_scene_settings()
        self._sync_atlas_settings(combined)
        self.frame_state = FrameState.initial(self.settings.width, self.settings.height,
                                              self.device)
        self._taa_history_ready = False
        self._shadow_cache = None
        self._shadow_overflow = 0
        self._shadow_key = None
        self._last_out = None
        _models, light, camera_desc = load_scene_json(scene_path)
        if light is not None:
            self.light = light
        if camera_desc is not None:
            self.camera.position = camera_desc.position
            if camera_desc.look_at is not None:
                self.camera.set_look_at(camera_desc.look_at)
            elif camera_desc.rotation_euler is not None:
                self.camera.set_rotation_euler_degrees(camera_desc.rotation_euler)
        log_info(f"scene reloaded: {scene_path}")

    def poll_reload(self) -> bool:
        """Swap in a finished background reload; True once swapped.  A
        reload that failed raises here."""
        future = self._pending_reload
        if future is None or not future.done():
            return False
        self._pending_reload = None
        self._apply_reload(future.result())
        return True

    def render_overlay_u8(self, delta_time: float = 1.0 / 60.0) -> np.ndarray:
        """Render with the debug overlays (the stats block, the selection
        box, the axis gizmo) as (H, W, 3) uint8.  The stats block is drawn
        in the frame when ``gpu_debug_print`` is on; otherwise, with the
        GpuDebugPrint toggle on, it is composited here."""
        from ..core.debugprint import stats_overlay

        out = self.render_frame(delta_time)
        img = np.array(np.clip(out["color"].cpu().numpy(), 0, 1), copy=True)
        if self.debug_print_enabled and not self.settings.gpu_debug_print:
            # a forward frame draws every model (the reference counts 1 here)
            total = self.scene_data.num_models
            visible = int(out["model_visible"].sum()) if "model_visible" in out else total
            img = stats_overlay(img, {
                "models_total": self.scene_data.num_models,
                "models_visible": visible,
                "models_culled": self.scene_data.num_models - visible,
                "triangles_total": self.scene_data.num_triangles,
                "exposure_ev": float(self.frame_state.exposure_ev),
            })
        self.composite_overlays(img)
        return to_u8_host(img)

    def composite_overlays(self, img: np.ndarray) -> np.ndarray:
        """Selection AABB wireframe and corner axis gizmo onto an (H, W, 3)
        float image, in place (``Application.cpp:754-820``, ``:59-96``)."""
        from ..core.debugprint import axis_gizmo, selection_overlay

        sel = self.selected_bounds()
        if sel is not None:
            vp = np.asarray(self.camera.view_matrix() @ self.camera.projection_matrix())
            selection_overlay(img, sel[0], sel[1], vp, self.selected_name)
        axis_gizmo(img, self.camera.view_matrix())
        return img
