"""The anisotropic x4 configuration and its cell: the reference draws it,
the cell resolves to its files and runs correct on the CPU at a size a
test holds, and each of its new metrics reads the port's spans and
counters -- the right number on a hand-built store, nothing where the port
keeps no store or the run had no card."""

import time

import pytest
import torch

from renderbench import run
from renderbench.reference import frames
from unclerenderer_tpu_torch.core import passes

CELL = "sponza263k_aniso4.viewer_orbit"
NEW = ("program.pass_device_ms.AnisoTaps", "program.pass_device_ms.AnisoFootprint",
       "aniso.taps_per_pixel", "aniso.line_pixel_pct")
SMALL = dict(n_objects=8, sphere_res=[8, 6], n_materials=8, tex_size=32, width=96, height=64,
             shadow_map_size=128)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_reference_draws_the_configuration():
    _cell, config, traffic = run.cell_files(run.load_bench(), CELL)
    assert config.get("reference") == "frames"
    assert run.reference_module(config).DRAWS is not None
    assert run.refusal(config, traffic, frames.DRAWS) is None
    assert config["render_settings"]["texture_filter"] == "anisotropic"
    assert config["render_settings"]["max_anisotropy"] == 4


def test_the_cell_resolves():
    bench = run.load_bench()
    cell, config, traffic = run.cell_files(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "sponza263k_aniso4_1080p", "viewer_orbit", 1)
    deferred = run.cell_files(bench, "sponza263k_deferred.viewer_orbit")[1]
    # the deferred configuration but for the sampler and the reference's name
    differ = {k for k in set(config) | set(deferred) if config.get(k) != deferred.get(k)}
    assert differ == {"name", "source", "render_settings", "reference"}
    assert {k: v for k, v in config["render_settings"].items()
            if k not in ("texture_filter", "max_anisotropy")} == deferred["render_settings"]
    layers = {m["name"] for m in run.cell_metrics(bench, "per_layer", CELL)}
    assert set(NEW) <= layers and "pass_ms.MaterialResolve" in layers
    assert {m["name"] for m in run.cell_metrics(bench, "end_to_end", CELL)} == {
        "frame_ms", "frame_ms_p95", "peak_gib", "setup_s"}


def _ctx(rows=True):
    return {"frames": {"events": [], "rows": [(0.0, 1.0, "k")] if rows else [], "busy_us": 1.0,
                       "span_us": 1.0, "frames": 20}}


@pytest.fixture
def stores(monkeypatch):
    """Two replays of the anisotropic frame (one slot tapped, then a frame
    of two slots tapped) and the counters of 20 traced frames."""
    s = passes.SpanStore()
    sp = passes.DeviceSpan
    s.records.extend([sp("FrameProgram", 0, "AnisoFootprint", 10.0, 2.0, 0),
                      sp("FrameProgram", 0, "AnisoTaps", 12.0, 40.0, 0),
                      sp("FrameProgram", 1, "AnisoFootprint", 10.0, 1.0, 0),
                      sp("FrameProgram", 1, "AnisoFootprint", 20.0, 2.0, 0),
                      sp("FrameProgram", 1, "AnisoTaps", 12.0, 20.0, 0),
                      sp("FrameProgram", 1, "AnisoTaps", 22.0, 24.0, 0)])
    c = passes.CounterStore()
    c.add({"aniso_pixels": torch.tensor(1000), "aniso_line_pixels": torch.tensor(600),
           "aniso_taps": torch.tensor(4000)})
    c.add({"aniso_pixels": torch.tensor(1000), "aniso_line_pixels": torch.tensor(700),
           "aniso_taps": torch.tensor(4000)})
    monkeypatch.setattr(passes, "STORE", s)
    monkeypatch.setattr(passes, "COUNTERS", c)


EXPECT = {"program.pass_device_ms.AnisoTaps": 42.0,
          "program.pass_device_ms.AnisoFootprint": 2.5,
          "aniso.taps_per_pixel": 4.0,
          "aniso.line_pixel_pct": 65.0}


@pytest.mark.parametrize("name", NEW)
def test_metric_reads_the_store(stores, name):
    assert run.metric_module(name).read(_ctx()) == pytest.approx(EXPECT[name])


@pytest.mark.parametrize("name", NEW)
def test_a_port_without_stores_reads_nothing(monkeypatch, name):
    """The parent's program: no counter store, no anisotropic spans."""
    monkeypatch.delattr(passes, "COUNTERS")
    monkeypatch.setattr(passes, "STORE", passes.SpanStore())
    assert run.metric_module(name).read(_ctx()) is None


@pytest.mark.parametrize("name", ("aniso.taps_per_pixel", "aniso.line_pixel_pct"))
def test_counters_of_no_card_or_no_frame_read_nothing(stores, name):
    assert run.metric_module(name).read(_ctx(rows=False)) is None
    passes.COUNTERS.reset()
    assert run.metric_module(name).read(_ctx()) is None


def test_the_cell_runs_correct_on_the_cpu():
    """A traced CPU run: correct, nothing failed, and none of the new
    metrics in the line (the CPU has no device rows and no program)."""
    passes.COUNTERS.reset()
    try:
        res = run.run_cell(run.load_bench(), CELL, 2**31 + 2424, 0.6, True, device="cpu",
                           overrides=SMALL, t0=time.perf_counter())
        assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0, res["check"]
        assert not set(NEW) & set(res["metrics"])
        totals = passes.COUNTERS.totals()  # the traced frames' counts, on the CPU too
        assert totals["aniso_taps"] == 4 * totals["aniso_pixels"] > 0
    finally:
        passes.COUNTERS.reset()
