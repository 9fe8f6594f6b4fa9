"""The readers of the spans the port records inside its frame
(``renderbench/spans.py``), each metric file on a synthetic traced window
and span store; and where the port records none (a program without them,
or a CPU run), each reads nothing."""

import pytest

from renderbench import run
from unclerenderer_tpu_torch.core import passes

FRAMES = 4


def _x(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _ctx(rows=True):
    """``FRAMES`` presented frames: each a ``Renderer.present.readback``
    range (2 ms) whose memcpy launch makes a 1.5 ms device row, a
    ``Renderer.present.u8`` range (40 ms), and a 5 ms
    ``Renderer.shadow.drop_read`` inside a ``Renderer.shadow``; a kernel
    launched outside them."""
    ev = []
    for f in range(FRAMES):
        t = f * 100_000.0
        ev += [_x("user_annotation", "Renderer.frame", t, 10_000),
               _x("user_annotation", "Renderer.shadow", t + 100, 6_000),
               _x("user_annotation", "Renderer.shadow.drop_read", t + 200, 5_000),
               _x("cuda_runtime", "cudaGraphLaunch", t + 7_000, 10, correlation=10 * f + 1),
               _x("user_annotation", "Renderer.present.readback", t + 10_000, 2_000),
               _x("cuda_runtime", "cudaMemcpyAsync", t + 10_010, 10, correlation=10 * f + 2),
               _x("user_annotation", "Renderer.present.u8", t + 12_000, 40_000),
               _x("kernel", "frame_kernel", t + 7_050, 3_000, pid=0, tid=7,
                  correlation=10 * f + 1),
               _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", t + 10_050, 1_500, pid=0,
                  tid=7, correlation=10 * f + 2)]
    dev = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev if e["pid"] == 0]
    return {"frames": {"events": ev, "rows": sorted(dev) if rows else [], "busy_us": 1.0,
                       "span_us": 1.0, "frames": FRAMES}}


@pytest.fixture
def store(monkeypatch):
    """A span store of two frame-program replays and one shadow redraw; a
    replay that recurs a name (ShadowPCF) sums it."""
    s = passes.SpanStore()
    sp = passes.DeviceSpan
    for f, (whole, res, vis) in enumerate([(80.0, 52.0, 3.0), (78.0, 50.0, 5.0)]):
        s.records.extend([sp("FrameProgram", f, "FrameProgram", 0.0, whole, 0),
                          sp("FrameProgram", f, "VisibilityRaster", 1.0, vis, 0),
                          sp("FrameProgram", f, "MaterialResolve", 9.0, res, 0),
                          sp("FrameProgram", f, "ShadowPCF", 61.0, 0.5, 0),
                          sp("FrameProgram", f, "ShadowPCF", 62.0, 0.25, 0)])
    s.records.extend([sp("ShadowProgram", 0, "ShadowProgram", 0.0, 5.5, 0),
                      sp("ShadowProgram", 0, "ShadowMap", 0.0, 5.25, 0)])
    monkeypatch.setattr(passes, "STORE", s)
    return s


def _read(name, ctx):
    return run.metric_module(name).read(ctx)


EXPECT = {
    "program.replay_device_ms": 79.0,
    "program.pass_device_ms.MaterialResolve": 51.0,
    "program.pass_device_ms.VisibilityRaster": 4.0,
    "shadow.redraw_device_ms": 5.5,
    "present.readback_device_ms": 1.5,
    "present.u8_host_ms": 40.0,
    "renderer.shadow_wait_host_ms": 5.0,
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_metric_reads_the_spans(store, name):
    assert _read(name, _ctx()) == pytest.approx(EXPECT[name])


def test_a_pass_no_replay_ran_reads_nothing(store):
    assert _read("program.pass_device_ms.MaskedRaster", _ctx()) is None
    assert store.spans("FrameProgram")[0]["ShadowPCF"] == 0.75


@pytest.mark.parametrize("name", sorted(EXPECT) + ["program.pass_device_ms.MaskedRaster"])
def test_a_port_without_spans_reads_nothing(monkeypatch, name):
    """The parent's program: no span store, no program ranges in the trace."""
    monkeypatch.delattr(passes, "STORE")
    ctx = _ctx()
    ctx["frames"]["events"] = [e for e in ctx["frames"]["events"]
                               if not e["name"].startswith("Renderer.")]
    assert _read(name, ctx) is None


@pytest.mark.parametrize("name", ["present.readback_device_ms", "present.u8_host_ms",
                                  "renderer.shadow_wait_host_ms"])
def test_a_window_with_no_device_rows_reads_nothing(store, name):
    assert _read(name, _ctx(rows=False)) is None


def test_the_metrics_are_per_layer_entries():
    bench = run.load_bench()
    names = {m["name"] for m in bench["per_layer"]}
    assert set(EXPECT) | {"program.pass_device_ms.MaskedRaster"} <= names
