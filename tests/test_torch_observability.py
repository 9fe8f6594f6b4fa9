"""Observability of the port against the reference's: pass markers
(``core/passes.py``), ``PassTimingStats`` and the stage order of
``profile_deferred_passes`` (``render/framegraph.py``), and the per-pass
bucketing of a ``torch.profiler`` trace (``core/traceparse.py``) on
hand-built traces of the torch format: first match, sub-scopes before their
passes, "(other)", "(total)", per-frame division, the launch-correlation
and device-range attributions, gzip, and an empty or missing trace."""

import gzip
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from unclerenderer_tpu.core import traceparse as jtp
from unclerenderer_tpu.render import framegraph as jfg
from unclerenderer_tpu.render.renderer import Renderer as JRenderer
from unclerenderer_tpu_torch.core import passes
from unclerenderer_tpu_torch.core import traceparse as ttp
from unclerenderer_tpu_torch.render import framegraph as tfg
from unclerenderer_tpu_torch.render.params import RenderSettings
from unclerenderer_tpu_torch.render.renderer import Renderer
from unclerenderer_tpu_torch.render.testing import write_scene
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

ROOT = Path(__file__).resolve().parents[1]


def test_pass_names_equal_the_reference():
    assert ttp.PASS_NAMES == jtp.PASS_NAMES
    assert ttp.SUB_SCOPES == jtp.SUB_SCOPES
    assert ttp.PASS_NAMES_FINE == jtp.PASS_NAMES_FINE


def test_pass_names_cover_registrations():
    """Every ``named_pass`` of the port is a pass name and every ``scope``
    a sub-scope, as tests/test_traceparse.py checks the reference's."""
    found, scopes = set(), set()
    for p in (ROOT / "unclerenderer_tpu_torch").rglob("*.py"):
        text = p.read_text()
        found |= set(re.findall(r"named_pass\(\"(\w+)\"\)", text))
        scopes |= set(re.findall(r"\bscope\(\"(\w+)\"\)", text))
    assert found == set(ttp.PASS_NAMES), found ^ set(ttp.PASS_NAMES)
    assert scopes and scopes <= set(ttp.SUB_SCOPES), scopes - set(ttp.SUB_SCOPES)


def test_scopes_nest_as_profiler_ranges():
    @passes.named_pass("ShadowMap")
    def shadow():
        with passes.scope("VertexSetup"):
            return passes.scope_path()

    assert passes.scope_path() == "" and shadow() == "ShadowMap/VertexSetup"
    assert passes.scope_path() == ""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        shadow()
    names = [e.key for e in prof.key_averages()]
    assert "ShadowMap" in names and "VertexSetup" in names


def test_pass_timing_stats_equal_the_reference(monkeypatch):
    clock = iter([0.0, 0.1, 0.2, 0.5, 1.4, 1.45, 2.0, 2.6, 2.7])
    times = list(clock)
    samples = [("Frame", 10.0), ("ShadowMap", 3.0), ("Frame", 12.0), ("CAS", 0.5),
               ("Frame", 9.0), ("ShadowMap", 2.0), ("Frame", 11.0), ("CAS", 0.7), ("Frame", 8.0)]
    got_stats = []
    for mod in (jfg, tfg):
        it = iter(times)
        monkeypatch.setattr(mod.time, "monotonic", lambda: next(it))
        stats = mod.PassTimingStats(window_seconds=1.0)
        for name, ms in samples:
            stats.add_sample(name, ms)
        got_stats.append((stats.stats(), stats.format_table()))
        monkeypatch.undo()
    assert got_stats[0] == got_stats[1]
    assert [s["name"] for s in got_stats[1][0]] == ["Frame", "ShadowMap", "CAS"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_scene(tmp_path_factory.mktemp("obs"), 2, n_materials=2, tex_size=32)


def test_profile_deferred_passes_runs_the_reference_stages_in_order(scene, monkeypatch):
    """The stage names and order of the reference's ``profile_deferred_passes``
    on the same scene files (the reference on its CPU path)."""
    order = {}
    for key, mod, make in (
            ("ref", jfg, lambda: JRenderer(scene, _j_settings())),
            ("port", tfg, lambda: Renderer(scene, RenderSettings(**SMALL), device="cpu"))):
        names = []
        orig = mod.PassTimingStats.add_sample

        def add(self, name, ms, orig=orig, names=names):
            names.append(name)
            return orig(self, name, ms)

        monkeypatch.setattr(mod.PassTimingStats, "add_sample", add)
        stats = mod.profile_deferred_passes(make(), iterations=1)
        monkeypatch.undo()
        order[key] = names
        assert all(row["avg_ms"] > 0 for row in stats.stats())
    assert order["port"] == order["ref"]
    assert order["port"] == ["GPU Culling", "ShadowMap", "VertexStage", "GBuffer(Visibility)",
                             "Build HZB", "MaterialResolve", "Lighting", "TemporalAA",
                             "Tonemap", "CAS"]


SMALL = dict(width=32, height=32, shadow_map_size=32)


def _j_settings():
    from unclerenderer_tpu.render.params import RenderSettings as JSettings

    return JSettings(**SMALL)


# ------------------------------------------------------------ traceparse


def _x(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _write(path: Path, events, gz=False) -> Path:
    path.mkdir(parents=True, exist_ok=True)
    f = path / ("t.pt.trace.json.gz" if gz else "t.pt.trace.json")
    opener = gzip.open if gz else open
    with opener(f, "wt") as fh:
        json.dump({"traceEvents": events}, fh)
    return path


def _trace():
    """One host thread with nested ranges; kernels on stream 7 tied to their
    launches by correlation id; one kernel without a launch event, inside a
    device-side range; a memcpy; cpu ops (no device time)."""
    host = [
        _x("user_annotation", "ShadowMap", 0, 100),
        _x("user_annotation", "VertexSetup", 5, 10),
        _x("user_annotation", "RasterKernel", 20, 30),
        _x("user_annotation", "MaterialResolve", 200, 100),
        _x("user_annotation", "RecGather", 210, 20),
        _x("cpu_op", "aten::add", 6, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 7, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 25, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 1, correlation=3),
        _x("cuda_driver", "cuLaunchKernel", 215, 1, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 250, 1, correlation=5),
        _x("cuda_runtime", "cudaMemcpyAsync", 400, 1, correlation=6),
    ]
    dev = dict(pid=0, tid=7)
    device = [
        _x("kernel", "vertex", 1000, 2.0, correlation=1, **dev),
        _x("kernel", "binned_raster_kernel", 1010, 5.0, correlation=2, **dev),
        _x("kernel", "untile", 1020, 1.0, correlation=3, **dev),
        _x("kernel", "gather", 1030, 4.0, correlation=4, **dev),
        _x("kernel", "interp", 1040, 3.0, correlation=5, **dev),
        _x("gpu_memcpy", "Memcpy DtoH", 1050, 1.0, correlation=6, **dev),
        _x("gpu_user_annotation", "CAS", 1100, 20, **dev),
        _x("kernel", "cas", 1105, 2.0, correlation=99, **dev),
    ]
    return host + device


def test_trace_buckets_first_match(tmp_path):
    out = ttp.parse_pass_times(_write(tmp_path, _trace()))
    assert out == pytest.approx({"ShadowMap": 8e-3, "MaterialResolve": 7e-3, "CAS": 2e-3,
                                 "(other)": 1e-3, "(total)": 18e-3}, abs=1e-12)
    fine = ttp.parse_pass_times(tmp_path, pass_names=ttp.PASS_NAMES_FINE)
    assert fine == pytest.approx({"VertexSetup": 2e-3, "RasterKernel": 5e-3, "ShadowMap": 1e-3,
                                  "RecGather": 4e-3, "MaterialResolve": 3e-3, "CAS": 2e-3,
                                  "(other)": 1e-3, "(total)": 18e-3}, abs=1e-12)
    other = []
    per_frame = ttp.parse_pass_times(tmp_path, n_frames=2, other_top=other)
    assert per_frame["ShadowMap"] == pytest.approx(4e-3) and per_frame["(total)"] == \
        pytest.approx(9e-3)
    assert other == [(1.0, "")]


def test_trace_gzip_newest_and_empty(tmp_path):
    assert ttp.parse_pass_times(tmp_path) == {} and ttp.find_trace_file(tmp_path) is None
    cpu_only = [e for e in _trace() if e["cat"] in ("user_annotation", "cpu_op")]
    assert ttp.parse_pass_times(_write(tmp_path / "cpu", cpu_only)) == {}
    gz = _write(tmp_path / "gz", _trace(), gz=True)
    assert ttp.parse_pass_times(gz)["(total)"] == pytest.approx(18e-3)


def test_trace_parse_of_a_real_cpu_trace_is_empty(scene, tmp_path):
    """A CPU Renderer's trace has ranges and ops but no device rows: ``{}``,
    as the reference's CPU backend."""
    r = Renderer(scene, RenderSettings(**SMALL), device="cpu")
    r.profile_trace(tmp_path, frames=1)
    events = ttp.load_events(ttp.find_trace_file(tmp_path))
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert {"ShadowMap", "VisibilityRaster", "MaterialResolve"} <= names
    assert ttp.parse_pass_times(tmp_path) == {}
    assert np.isfinite(r.stats()["exposure_ev"])
