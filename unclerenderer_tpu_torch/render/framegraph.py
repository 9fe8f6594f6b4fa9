"""Frame-graph introspection (``unclerenderer_tpu/render/framegraph.py``):
named per-pass timing.

``PassTimingStats`` keeps rolling avg/min/max windows per pass, as the
D3D12 render graph's GPU timestamp table does (``RenderGraph.cpp:323-390,
698-771``).  ``profile_deferred_passes`` is a debug mode that runs the
deferred pipeline's major stages one at a time and times each: with CUDA
events on the card, with the host clock on the CPU, after one warm-up
call.  The sum of its stages is no frame time: each stage is timed alone.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque

import torch


class PassTimingStats:
    """Rolling-window (1 s) avg/min/max per named pass
    (FRenderGraph::GetGpuTimingStats)."""

    def __init__(self, window_seconds: float = 1.0):
        self.window = window_seconds
        self._samples: dict = defaultdict(deque)

    def add_sample(self, name: str, ms: float) -> None:
        now = time.monotonic()
        q = self._samples[name]
        q.append((now, ms))
        cutoff = now - self.window
        while q and q[0][0] < cutoff:
            q.popleft()

    def stats(self) -> list:
        """Sorted by average, descending (like the reference UI)."""
        out = []
        for name, q in self._samples.items():
            if not q:
                continue
            vals = [v for _, v in q]
            out.append({
                "name": name,
                "avg_ms": sum(vals) / len(vals),
                "min_ms": min(vals),
                "max_ms": max(vals),
                "samples": len(vals),
            })
        out.sort(key=lambda s: -s["avg_ms"])
        return out

    def format_table(self, top_n: int = 16) -> str:
        lines = [f"{'pass':<24}{'avg ms':>9}{'min ms':>9}{'max ms':>9}{'n':>5}"]
        for s in self.stats()[:top_n]:
            lines.append(
                f"{s['name']:<24}{s['avg_ms']:>9.3f}{s['min_ms']:>9.3f}"
                f"{s['max_ms']:>9.3f}{s['samples']:>5}"
            )
        return "\n".join(lines)


def _stage_ms(fn, device: torch.device) -> tuple:
    """(output, ms) of one call of ``fn``: CUDA events around it on the
    card, the host clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def profile_deferred_passes(renderer, iterations: int = 3) -> PassTimingStats:
    """Run the deferred pipeline stage by stage and time each stage
    (``iterations`` samples after one warm-up call), in the reference's
    order and names: GPU Culling, ShadowMap, VertexStage (the AoS stage, as
    the reference's), GBuffer(Visibility), Build HZB, MaterialResolve,
    Lighting, TemporalAA, Tonemap, CAS."""
    from ..ops import pbr
    from ..ops.cull import frustum_cull
    from ..ops.hzb import build_hzb, hzb_layout
    from ..ops.post import cas_sharpen, temporal_aa, tonemap
    from ..ops.raster import VertexAoS
    from . import common
    from .deferred import _matmul4, frustum_planes

    scene = renderer.device_scene
    settings = renderer.settings
    device = renderer.device
    stats = PassTimingStats(window_seconds=1e9)
    params = renderer.frame_params()
    layout, _ = hzb_layout(settings.width // 2, settings.height // 2)

    def timed(name, fn):
        out, _ms = _stage_ms(fn, device)  # warm-up
        for _ in range(iterations):
            out, ms = _stage_ms(fn, device)
            stats.add_sample(name, ms)
        return out

    vp = _matmul4(params.view, params.proj_unjittered)
    visible = timed("GPU Culling", lambda: frustum_cull(scene.bounds_min, scene.bounds_max,
                                                        frustum_planes(vp)))
    model_visible = params.model_visible & visible
    opaque_mask, masked_mask = common.tri_draw_masks(scene, model_visible, settings)
    if settings.enable_shadows:
        timed("ShadowMap", lambda: common.raster_shadow(scene, params.light_view_proj,
                                                        opaque_mask | masked_mask, settings))
    clip, pix_h = timed("VertexStage", lambda: common.vertex_stage(
        scene, params.view_proj, settings.width, settings.height))
    verts = VertexAoS(clip, pix_h)
    raster_out = timed("GBuffer(Visibility)",
                       lambda: common.raster_opaque(scene, opaque_mask, settings, verts))
    depth, tri_id, cids = raster_out[0], raster_out[1], raster_out[4]
    if settings.enable_hzb:
        timed("Build HZB", lambda: build_hzb(depth, layout))
    g = timed("MaterialResolve", lambda: common.resolve_materials(
        scene, verts.pix9(), tri_id, settings, compact_ids=cids))

    def lighting():
        view3 = params.view[:3, :3]
        n = pbr.normalize(g["normal"] @ view3)
        light = pbr.normalize(params.light_dir @ view3)
        v = pbr.normalize(params.camera_pos - g["world_pos"]) @ view3
        f0 = 0.04 + (g["albedo"] - 0.04) * g["metallic"][..., None]
        return pbr.evaluate_pbr(g["albedo"], g["metallic"], g["roughness"], f0, n, v, light)

    hdr = timed("Lighting", lighting)
    if settings.enable_taa:
        valid = torch.tensor(True, device=device)
        hdr = timed("TemporalAA", lambda: temporal_aa(hdr, renderer.frame_state.taa_history,
                                                      params.taa_history_weight, valid))
    zero_ev = torch.tensor(0.0, device=device)
    color = timed("Tonemap", lambda: tonemap(hdr, params.tonemap_exposure, zero_ev,
                                             settings.enable_tonemap, False,
                                             params.tonemap_gamma))
    if settings.enable_cas:
        timed("CAS", lambda: cas_sharpen(color, params.cas_sharpness))
    return stats
