"""Every ``BENCHMARK.json`` entry resolves to its files, and the file keeps
to the benchmark's contract where a test can see it."""

import json
import re
from pathlib import Path

import pytest

from renderbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "renderbench/run.py"]
    assert BENCH["paths"] == ["renderbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    w, config, traffic = run.cell_files(BENCH, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    assert config["name"] == w["config"] and len(w["why"]) <= 200
    assert traffic["mode"] in ("present", "clip")
    assert set(config["check"]) <= {"px_off_pct", "mean_abs_level", "history_gap_pct", "ev_gap"}
    assert set(traffic["check"]) == {"start_frames", "carry_within", "samples", "run_frames"}
    e2e = {m["name"] for m in run.cell_metrics(BENCH, "end_to_end", cell)}
    assert "setup_s" in e2e and len(e2e & {"frame_ms", "clip_frame_ms"}) == 1
    layers = run.cell_metrics(BENCH, "per_layer", cell)
    assert layers and all(m["moves"] in e2e for m in layers)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    doc = json.loads((ROOT / config["file"]).read_text())
    assert doc["name"] == config["name"] and doc["source"] == config["source"]
    assert doc["reduced"] == config["reduced"]
    assert config["source"].startswith("https://")
    assert config["name"] in {w["config"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    mod = run.metric_module(metric["name"])
    assert callable(mod.read)
    assert set(metric["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_reader(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "bound", "workloads"}
    assert callable(run.metric_module(metric["name"]).read)


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in BENCH["workloads"]] + \
        [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["name"].endswith("_roofline") == (m["unit"] == "%" and "roofline" in m["name"])
