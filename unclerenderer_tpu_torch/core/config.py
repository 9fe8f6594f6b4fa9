"""Renderer configuration (``unclerenderer_tpu/core/config.py``): the INI
loader with the D3D12 renderer's keys, defaults and permissive aliases
(``RendererConfig.h:13-43``, ``RendererConfig.cpp:73-340``), so its
``bin/RendererConfig.ini`` parses unchanged.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from .logging import log_warning

_TRUE = {"1", "true", "yes"}


@dataclasses.dataclass
class RendererConfig:
    renderer_type: str = "deferred"  # "deferred" | "forward"
    scene_file: str = "Assets/Scenes/Scene.json"
    use_depth_prepass: bool = True
    frames_in_flight: int = 3
    enable_frame_overlap: bool = True
    enable_shadows: bool = True
    shadow_bias: float = 0.0
    enable_tonemap: bool = True
    tonemap_exposure: float = 1.0
    tonemap_gamma: float = 2.2
    enable_cas: bool = True
    cas_sharpness: float = 0.5
    enable_auto_exposure: bool = True
    auto_exposure_key: float = 0.3
    auto_exposure_min: float = 0.1
    auto_exposure_max: float = 5.0
    auto_exposure_speed_up: float = 3.0
    auto_exposure_speed_down: float = 1.0
    enable_taa: bool = True
    taa_history_weight: float = 0.9
    use_task_system: bool = True
    log_resource_barriers: bool = False
    enable_graph_dump: bool = False
    enable_gpu_timing: bool = False
    enable_indirect_draw: bool = True
    enable_gpu_debug_print: bool = True
    window_width: int = 1280
    window_height: int = 720


def _parse_bool(value: str) -> bool:
    return value.strip().lower() in _TRUE


def _parse_float(value: str, key: str, default: float) -> float:
    try:
        return float(value)
    except ValueError:
        log_warning(f"Invalid float for renderer config key {key}: {value}")
        return default


def _parse_int(value: str, key: str, default: int) -> int:
    try:
        return int(float(value))
    except ValueError:
        log_warning(f"Invalid int for renderer config key {key}: {value}")
        return default


def apply_key_value(cfg: RendererConfig, key: str, value: str) -> None:
    k = key.strip().lower()
    v = value.strip()
    lv = v.lower()
    if k in ("type", "renderer"):
        cfg.renderer_type = "forward" if lv == "forward" else "deferred"
    elif k in ("scene", "scenefile"):
        cfg.scene_file = v
    elif k in ("usedepthprepass", "depthprepass"):
        cfg.use_depth_prepass = _parse_bool(v)
    elif k in ("frameoverlap", "useframeoverlap"):
        cfg.enable_frame_overlap = _parse_bool(v)
    elif k in ("framesinflight", "inflightframes", "swapchainbuffercount"):
        cfg.frames_in_flight = max(1, min(8, _parse_int(v, k, cfg.frames_in_flight)))
    elif k in ("enableshadows", "shadows"):
        cfg.enable_shadows = _parse_bool(v)
    elif k == "shadowbias":
        cfg.shadow_bias = _parse_float(v, k, cfg.shadow_bias)
    elif k in ("enabletonemap", "tonemap"):
        cfg.enable_tonemap = _parse_bool(v)
    elif k == "tonemapexposure":
        cfg.tonemap_exposure = _parse_float(v, k, cfg.tonemap_exposure)
    elif k == "tonemapgamma":
        cfg.tonemap_gamma = _parse_float(v, k, cfg.tonemap_gamma)
    elif k in ("enablecas", "cas"):
        cfg.enable_cas = _parse_bool(v)
    elif k == "cassharpness":
        cfg.cas_sharpness = _parse_float(v, k, cfg.cas_sharpness)
    elif k in ("enableautoexposure", "autoexposure"):
        cfg.enable_auto_exposure = _parse_bool(v)
    elif k == "autoexposurekey":
        cfg.auto_exposure_key = _parse_float(v, k, cfg.auto_exposure_key)
    elif k == "autoexposuremin":
        cfg.auto_exposure_min = _parse_float(v, k, cfg.auto_exposure_min)
    elif k == "autoexposuremax":
        cfg.auto_exposure_max = _parse_float(v, k, cfg.auto_exposure_max)
    elif k == "autoexposurespeedup":
        cfg.auto_exposure_speed_up = _parse_float(v, k, cfg.auto_exposure_speed_up)
    elif k == "autoexposurespeeddown":
        cfg.auto_exposure_speed_down = _parse_float(v, k, cfg.auto_exposure_speed_down)
    elif k in ("enabletaa", "taa", "temporalaa"):
        cfg.enable_taa = _parse_bool(v)
    elif k in ("taahistoryweight", "taaweight"):
        cfg.taa_history_weight = min(1.0, max(0.0, _parse_float(v, k, cfg.taa_history_weight)))
    elif k in ("usetasksystem", "enabletasksystem", "tasksystem"):
        cfg.use_task_system = _parse_bool(v)
    elif k in ("logresourcebarriers", "logbarriers", "barrierlogging"):
        cfg.log_resource_barriers = _parse_bool(v)
    elif k in ("graphdump", "enablegraphdump", "dumpgraph"):
        cfg.enable_graph_dump = _parse_bool(v)
    elif k in ("gputiming", "enablegputiming", "recordgputiming"):
        cfg.enable_gpu_timing = _parse_bool(v)
    elif k in ("gpudebugprint", "enablegpudebugprint"):
        cfg.enable_gpu_debug_print = _parse_bool(v)
    elif k in ("indirectdraw", "enableindirectdraw"):
        cfg.enable_indirect_draw = _parse_bool(v)
    elif k in ("width", "windowwidth"):
        cfg.window_width = max(1, _parse_int(v, k, cfg.window_width))
    elif k in ("height", "windowheight"):
        cfg.window_height = max(1, _parse_int(v, k, cfg.window_height))
    elif k == "resolution":
        parts = lv.replace("x", " ").split()
        if len(parts) == 2:
            cfg.window_width = max(1, _parse_int(parts[0], k, cfg.window_width))
            cfg.window_height = max(1, _parse_int(parts[1], k, cfg.window_height))


def load_config(path: str | Path | None) -> RendererConfig:
    """Load an INI-style config, falling back to defaults on any error
    (``FRendererConfigLoader::LoadOrDefault``)."""
    cfg = RendererConfig()
    if path is None:
        return cfg
    p = Path(path)
    if not p.is_file():
        return cfg
    for raw_line in p.read_text(encoding="utf-8", errors="replace").splitlines():
        line = raw_line.strip()
        if not line or line.startswith(("#", ";")):
            continue
        if line.startswith("[") and line.endswith("]"):
            continue  # section headers ignored, as in the reference
        if "=" not in line:
            continue
        key, _, value = line.partition("=")
        apply_key_value(cfg, key, value)
    return cfg
