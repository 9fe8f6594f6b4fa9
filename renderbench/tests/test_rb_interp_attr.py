"""``interp_attr.kernel_pixel_pct``: the share of the resolve's valid pixels
whose attributes its kernel interpolated, read from the port's counter
store -- the right percent on a hand-built store, nothing where the port
keeps no store, counts no interpolated pixel or the run had no card -- and
declared for the four viewer cells."""

import pytest
import torch

from renderbench import run
from unclerenderer_tpu_torch.core import passes

NAME = "interp_attr.kernel_pixel_pct"
VIEWERS = ["sponza263k_deferred.viewer_orbit", "sponza263k_masked.viewer_orbit",
           "sponza263k_deferred.moving_sun", "sponza263k_aniso4.viewer_orbit"]


def _ctx(rows=True):
    return {"frames": {"events": [], "rows": [(0.0, 1.0, "k")] if rows else [], "busy_us": 1.0,
                       "span_us": 1.0, "frames": 20}}


@pytest.mark.parametrize("kernel_pixels, want", [((1000, 1000), 100.0), ((1000, 0), 50.0),
                                                 ((0, 0), 0.0)])
def test_reads_the_kernel_share_of_the_interpolated_pixels(monkeypatch, kernel_pixels, want):
    c = passes.CounterStore()
    for k in kernel_pixels:  # two traced frames of 1000 interpolated pixels each
        c.add({"tap_pixels": torch.tensor(1000), "tap_kernel_pixels": torch.tensor(1000),
               "attr_pixels": torch.tensor(1000), "attr_kernel_pixels": torch.tensor(k)})
    monkeypatch.setattr(passes, "COUNTERS", c)
    assert run.metric_module(NAME).read(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no_store", "parent_counters", "no_rows", "empty"])
def test_reads_nothing_without_attr_counts(monkeypatch, case):
    """The parent's program keeps a store with only the material tap's and
    the anisotropic tap's counters; a run with no card has no device rows."""
    c = passes.CounterStore()
    if case == "no_store":
        monkeypatch.delattr(passes, "COUNTERS")
    else:
        if case == "parent_counters":
            c.add({"tap_pixels": torch.tensor(1000), "tap_kernel_pixels": torch.tensor(1000),
                   "aniso_pixels": torch.tensor(1000), "aniso_taps": torch.tensor(4000)})
        elif case == "no_rows":
            c.add({"attr_pixels": torch.tensor(1000), "attr_kernel_pixels": torch.tensor(1000)})
        monkeypatch.setattr(passes, "COUNTERS", c)
    assert run.metric_module(NAME).read(_ctx(rows=case != "no_rows")) is None


def test_declared_for_the_viewer_cells():
    bench = run.load_bench()
    (entry,) = [e for e in bench["per_layer"] if e["name"] == NAME]
    assert entry["workloads"] == VIEWERS and entry["moves"] == "frame_ms"
    assert entry["layer"] == "frame passes" and entry["unit"] == "%"
    assert entry["source"] == "program_counter" and entry["better"] == "higher"
    assert bench["per_layer"][-1] is entry  # appended after every accepted metric
    for cell in VIEWERS:
        assert NAME in [e["name"] for e in run.cell_metrics(bench, "per_layer", cell)]
    for cell in ("sponza263k_deferred.offline_chain", "sponza263k_masked.offline_chain"):
        assert NAME not in [e["name"] for e in run.cell_metrics(bench, "per_layer", cell)]
