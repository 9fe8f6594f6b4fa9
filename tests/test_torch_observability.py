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
    """The reference's names, in its order, after the port's own
    sub-scopes (the anisotropic tap's, deeper than any of the reference's)."""
    assert ttp.PASS_NAMES == jtp.PASS_NAMES
    assert ttp.SUB_SCOPES == ttp.PORT_SUB_SCOPES + jtp.SUB_SCOPES
    assert ttp.PASS_NAMES_FINE == ttp.PORT_SUB_SCOPES + jtp.PASS_NAMES_FINE
    assert not set(ttp.PORT_SUB_SCOPES) & set(jtp.PASS_NAMES_FINE)


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


# ------------------------------------------------------------ spans inside the frame


class _Clock:
    """A fake device clock for ``passes.DeviceSpans``: an event records the
    clock's ms; ``done`` says whether recorded work has completed."""

    def __init__(self):
        self.ms, self.done = 0.0, True
        clock = self

        class Event:
            def record(self):
                self.t = clock.ms

            def query(self):
                return clock.done

            def synchronize(self):
                clock.done = True

            def elapsed_time(self, other):
                return other.t - self.t

        self.Event = Event


@pytest.fixture
def store():
    passes.STORE.reset()
    yield passes.STORE
    passes.collect()
    passes.STORE.reset()


def _captured(clock, name="FrameProgram"):
    """A program's spans captured on the fake clock: MaterialResolve
    (3 ms, its RecGather 1 ms at 1 ms) then ShadowPCF (2 ms), whose nested
    ShadowPCF is not timed; 6 ms first to last."""
    spans = passes.DeviceSpans(name, event=clock.Event)

    @passes.named_pass("ShadowPCF")
    def pcf(depth):
        if depth:
            pcf(depth - 1)
        clock.ms += 1.0

    with spans.capturing():
        with passes.scope("MaterialResolve", _pass=True):
            clock.ms += 1.0
            with passes.scope("RecGather"):
                clock.ms += 1.0
            clock.ms += 1.0
        pcf(1)
        clock.ms += 1.0
    return spans


def test_device_spans_pair_nested_scopes_by_the_stack(store):
    clock = _Clock()
    spans = _captured(clock)
    assert spans.events() == 2 + 2 * 3  # first, last; MaterialResolve, RecGather, ShadowPCF
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        spans.launch()
    passes.collect()
    got = {(r.name, r.start_ms, r.ms) for r in store.records}
    assert got == {("FrameProgram", 0.0, 6.0), ("MaterialResolve", 0.0, 3.0),
                   ("RecGather", 1.0, 1.0), ("ShadowPCF", 3.0, 2.0)}
    assert {r.frame for r in store.records} == {0} and (spans.read, spans.unread) == (1, 0)
    assert store.spans("FrameProgram") == {0: {"FrameProgram": 6.0, "MaterialResolve": 3.0,
                                               "RecGather": 1.0, "ShadowPCF": 2.0}}
    assert passes.scope_path() == "" and passes._PASSES == [0] and not passes._CAPTURING


def test_device_spans_fill_the_store_only_while_tracing(store):
    clock = _Clock()
    spans = _captured(clock)
    spans.launch()
    spans.launch()
    passes.collect()
    assert not store.records and spans.read == spans.unread == 0  # tracing off: nothing pending
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        spans.launch()  # replay 2, read at the next launch
        spans.launch()  # replay 3, read at collect
    passes.collect()
    assert sorted({r.frame for r in store.records}) == [2, 3]
    sink = []
    spans.sink = sink.append  # GpuTiming keeps tracing on without a profiler
    spans.launch()
    passes.collect()
    assert [r.frame for r in sink[0]] == [4] * 4 and len(store.records) == 12
    store.reset()
    assert not store.records and spans.read == 3


def test_device_spans_of_a_replay_not_done_are_counted_unread(store):
    """Back-to-back replays (``render_frames``) overwrite the events before
    they complete: each but the last is counted unread, never waited for."""
    clock = _Clock()
    spans = _captured(clock)
    spans.sink = lambda recs: None
    clock.done = False
    for _ in range(3):
        spans.launch()
    assert spans.unread == 2 and not store.records
    clock.done = True
    passes.collect()
    assert spans.read == 1 and {r.frame for r in store.records} == {2}


def test_collect_waits_for_the_last_replay_where_asked(store):
    """``collect(wait=True)`` (``Renderer.stats``) reads a replay that has
    not completed once it has, where ``collect()`` counts it unread."""
    clock = _Clock()
    spans = _captured(clock)
    spans.sink = lambda recs: None
    clock.done = False
    spans.launch()
    passes.collect(wait=True)
    assert (spans.read, spans.unread) == (1, 0) and {r.frame for r in store.records} == {0}
    clock.done = False
    spans.launch()
    passes.collect()
    assert (spans.read, spans.unread) == (1, 1)


def test_device_spans_time_an_op_by_op_run(store):
    """``running``: each op-by-op run records its events afresh, its
    top-level passes timed, and is read at the next run or ``collect()``;
    nothing is timed outside a run."""
    clock = _Clock()
    spans = passes.DeviceSpans("EagerFrame", event=clock.Event)
    got = []
    spans.sink = got.append
    for ms in (2.0, 3.0):
        with spans.running():
            with passes.scope("MaterialResolve", _pass=True):
                clock.ms += ms
            clock.ms += 1.0
        assert spans.events() == 4
    with passes.scope("MaterialResolve", _pass=True):
        clock.ms += 1.0
    passes.collect()
    assert [{r.name: r.ms for r in recs} for recs in got] == [
        {"EagerFrame": 3.0, "MaterialResolve": 2.0}, {"EagerFrame": 4.0, "MaterialResolve": 3.0}]
    assert [recs[0].frame for recs in got] == [0, 1] and spans.read == 2


def test_device_spans_keep_to_the_event_cap(store):
    clock = _Clock()
    spans = passes.DeviceSpans("FrameProgram", event=clock.Event)
    with spans.capturing():
        for _ in range(passes.MAX_EVENTS):
            with passes.scope("Tonemap", _pass=True):
                pass
    assert spans.events() == passes.MAX_EVENTS


@pytest.mark.parametrize("masked", [False, True])
def test_captured_frame_times_its_passes_within_the_cap(tmp_path, masked):
    """The deferred frame run inside a program's capture (fake events on the
    CPU): every top-level pass and the resolve's sub-scopes timed, the
    nested passes not, at most ``MAX_EVENTS`` events."""
    from unclerenderer_tpu_torch.render.deferred import deferred_frame

    path = write_scene(tmp_path, 4 if masked else 2, n_materials=2, tex_size=32, masked=masked)
    r = Renderer(path, RenderSettings(**SMALL), device="cpu")
    spans = passes.DeviceSpans("FrameProgram", event=_Clock().Event)
    with spans.capturing():
        deferred_frame(r.device_scene, r.frame_params(), r.frame_state, r.settings,
                       r._shadow_map(r.frame_params()))
    names = [m[0] for m in spans._marks]
    assert spans.events() <= passes.MAX_EVENTS and all(m[2] is not None for m in spans._marks)
    want = {"VisibilityRaster", "MaterialResolve", "BuildHZB", "ShadowPCF", "IBLAmbient",
            "SkyAtmosphere", "TemporalAA", "AutoExposure", "Tonemap", "CAS"}
    assert want <= set(names) and ("MaskedRaster" in names) == masked
    assert {"InterpAttr", "MaterialTap", "NormalMap"} <= set(names)
    assert len(names) == len(set(names))  # each once: the nested passes untimed


def test_store_records_share_the_profilers_clock(store, tmp_path):
    """A replay's launch time (``time.time_ns()``) and the range around the
    launch in the Chrome trace agree within 1 ms once the trace's
    ``baseTimeNanoseconds`` is taken off."""
    spans = _captured(_Clock())
    # a process's first range sets up the range op (about 1 ms, inside the
    # range): done first, so the measured gap is the clocks' alone
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with passes.scope("FrameProgram.replay"):
            pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with passes.scope("FrameProgram.replay"):
            spans.launch()
    passes.collect()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    doc = json.loads((tmp_path / "t.json").read_text())
    (rng,) = [e for e in doc["traceEvents"] if e.get("name") == "FrameProgram.replay"]
    (t_ns,) = {r.t_ns for r in store.records}
    gap_us = (t_ns - doc["baseTimeNanoseconds"]) / 1e3 - float(rng["ts"])
    assert abs(gap_us) < 1000


def test_render_to_u8_trace_holds_the_present_spans(scene, tmp_path):
    """A CPU profiler trace of ``render_to_u8``: ``Renderer.frame`` (its
    params and shadow spans inside), then ``Renderer.present.readback``,
    then ``Renderer.present.u8``, all under the caller's range."""
    r = Renderer(scene, RenderSettings(**SMALL), device="cpu")
    r.render_frame()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            img = r.render_to_u8()
    assert img.dtype == np.uint8 and img.shape == (32, 32, 3)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    spans = {}
    for e in ttp.load_events(tmp_path / "t.json"):
        if e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], (float(e["ts"]), float(e["ts"]) + float(e["dur"])))

    def inside(inner, outer):
        return spans[outer][0] <= spans[inner][0] and spans[inner][1] <= spans[outer][1]

    for name in ("Renderer.frame", "Renderer.present.readback", "Renderer.present.u8"):
        assert inside(name, "caller"), name
    assert inside("Renderer.params", "Renderer.frame") and inside("Renderer.shadow",
                                                                  "Renderer.frame")
    assert spans["Renderer.frame"][1] <= spans["Renderer.present.readback"][0]
    assert spans["Renderer.present.readback"][1] <= spans["Renderer.present.u8"][0]
    assert set(spans) & set(HOST_SPANS) == {
        "Renderer.frame", "Renderer.params", "Renderer.shadow", "Renderer.present.readback",
        "Renderer.present.u8"}


#: the host spans the Renderer and the programs open (PERF.md's table of spans)
HOST_SPANS = (
    "Renderer.frame", "Renderer.params", "Renderer.shadow", "Renderer.shadow.drop_read",
    "Renderer.present.readback", "Renderer.present.u8", "Renderer.frames",
    "Renderer.frames.gather", "FrameProgram.capture", "FrameProgram.replay",
    "FrameProgram.clone", "ShadowProgram.capture",
)


def test_host_spans_are_listed():
    """Every dotted ``scope`` name of the port is one of the documented
    host spans (``HOST_SPANS``), and every documented span is opened
    somewhere."""
    found = set()
    for p in (ROOT / "unclerenderer_tpu_torch").rglob("*.py"):
        found |= set(re.findall(r"\bscope\(\"([\w.]+\.[\w.]+)\"\)", p.read_text()))
    assert found == set(HOST_SPANS)


def test_scope_enters_a_range_only_while_tracing(monkeypatch):
    """Without a profiler a scope enters no ``record_function`` range (its
    name still goes on the stack of open names); under one it does."""
    entered = []
    real = torch.autograd.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    with passes.scope("Renderer.frame"):
        with passes.scope("MaterialResolve", _pass=True):
            assert passes.scope_path() == "Renderer.frame/MaterialResolve"
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with passes.scope("Renderer.frame"):
            pass
    assert entered == ["Renderer.frame"]


def test_gpu_timing_rows_from_replay_spans(scene):
    """GpuTiming's table fed from a replay's spans: "Frame" from the frame
    program's whole span, a row a pass (a recurring name summed), none for
    the shadow program's whole span."""
    from unclerenderer_tpu_torch.core.config import RendererConfig

    r = Renderer(scene, RenderSettings(**SMALL), device="cpu",
                 config=RendererConfig(enable_gpu_timing=True))
    sp = passes.DeviceSpan
    r._add_frame_timing([sp("FrameProgram", 0, "FrameProgram", 0.0, 10.0, 0),
                         sp("FrameProgram", 0, "MaterialResolve", 1.0, 6.0, 0),
                         sp("FrameProgram", 0, "ShadowPCF", 7.0, 0.5, 0),
                         sp("FrameProgram", 0, "ShadowPCF", 7.5, 0.25, 0)])
    r._add_frame_timing([sp("ShadowProgram", 0, "ShadowProgram", 0.0, 5.0, 0),
                         sp("ShadowProgram", 0, "ShadowMap", 0.0, 4.0, 0)])
    rows = {row["name"]: row["avg_ms"] for row in r._frame_times.stats()}
    assert rows == {"Frame": 10.0, "MaterialResolve": 6.0, "ShadowMap": 4.0, "ShadowPCF": 0.75}
    assert r._frame_times.stats()[0]["name"] == "Frame"
    r._add_frame_timing([sp("EagerFrame", 0, "EagerFrame", 0.0, 20.0, 0)])
    assert {row["name"]: row["samples"] for row in r._frame_times.stats()}["Frame"] == 2


def test_stats_reports_the_programs_held(scene):
    """``stats()["programs"]``: each program the Renderer holds, its capture
    seconds and pool bytes and its replays read and unread; none on a
    Renderer that holds no program."""
    from types import SimpleNamespace

    r = Renderer(scene, RenderSettings(**SMALL), device="cpu")
    r.render_frame()
    assert "programs" not in r.stats()
    spans = passes.DeviceSpans("FrameProgram")
    spans.read, spans.unread = 7, 2
    r._program = SimpleNamespace(spans=spans, capture_s=0.25, pool_bytes=1 << 20)
    assert r.stats()["programs"] == {"FrameProgram": {
        "capture_s": 0.25, "pool_bytes": 1 << 20, "replays_read": 7, "replays_unread": 2}}
