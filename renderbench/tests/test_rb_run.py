"""Whole runs on the CPU at a size a test can hold: the harness's look for
a card skipped, everything else as on the chip.  A sound run is correct;
a run whose timed path is broken underneath is not, once for each fault a
cell of this benchmark can have.  Without a card, or alone in a
directory, the command prints nothing and fails."""

import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from renderbench import run

ROOT = Path(__file__).resolve().parents[2]
SMALL = dict(n_objects=8, sphere_res=[8, 6], n_materials=8, tex_size=32, width=96, height=64,
             shadow_map_size=128)
SEED = 2**31 + 4242
CELLS = ("sponza263k_deferred.viewer_orbit", "sponza263k_masked.viewer_orbit",
         "sponza263k_deferred.moving_sun", "sponza263k_deferred.offline_chain",
         "sponza263k_masked.offline_chain")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell, trace_on=False, seconds=0.6):
    return run.run_cell(run.load_bench(), cell, SEED, seconds, trace_on, device="cpu",
                        overrides=SMALL, t0=time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "check"
    names = {m["name"] for m in run.cell_metrics(run.load_bench(), "end_to_end", cell)}
    assert set(res["metrics"]) == names


def test_traced_run_reports_per_layer_metrics():
    res = _run(CELLS[0], trace_on=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"renderer.call_host_ms"}  # the CPU has no device rows
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0


def _state_unchanged(frame):
    def broken(scene, params, state, settings, shadow_map=None, **kw):
        out, _new = frame(scene, params, state, settings, shadow_map, **kw)
        return out, state
    return broken


def _half_rows(frame):
    def broken(*args, **kw):
        out, new = frame(*args, **kw)
        out["color"] = out["color"].clone()
        out["color"][out["color"].shape[0] // 2:] = 0.0
        return out, new
    return broken


def _answer_altered(frame):
    """A 16 x 16 tile of the frame brightened where it is produced."""
    def broken(*args, **kw):
        out, new = frame(*args, **kw)
        out["color"] = out["color"].clone()
        out["color"][24:40, 40:56] += 0.5
        return out, new
    return broken


@pytest.mark.parametrize("fault", [_state_unchanged, _half_rows, _answer_altered],
                         ids=["state_unchanged", "half_rows", "answer_altered"])
@pytest.mark.parametrize("cell", [CELLS[0], CELLS[3]])
def test_broken_timed_path_is_not_correct(monkeypatch, fault, cell):
    from unclerenderer_tpu_torch.render import renderer

    monkeypatch.setattr(renderer, "deferred_frame", fault(renderer.deferred_frame))
    res = _run(cell)
    assert not res["correct"], res["check"]


def test_no_card_prints_nothing_and_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "renderbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_alone_in_a_directory_prints_nothing_and_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "renderbench", tmp_path / "renderbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "renderbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_scene_cache_traffic_keeps_a_fixed_scene(tmp_path, monkeypatch):
    """A traffic file with ``scene_cache`` writes the seed's scene once into
    a fixed directory of the checkout and points the Renderer's scene cache
    beside it; without, the scene goes to the run's temporary directory
    and the cache is off."""
    monkeypatch.setattr(run, "CACHE", tmp_path / "cache")
    monkeypatch.delenv("UNCLERENDERER_SCENE_CACHE", raising=False)
    _cell, config, _spec = run.cell_files(run.load_bench(), CELLS[0], SMALL)
    a = run._scene(config, {"scene_cache": True}, SEED, tmp_path / "t1")
    stamp = a.stat().st_mtime_ns
    b = run._scene(config, {"scene_cache": True}, SEED, tmp_path / "t2")
    assert a == b and b.stat().st_mtime_ns == stamp
    assert a.is_relative_to(tmp_path / "cache")
    import os

    assert os.environ["UNCLERENDERER_SCENE_CACHE"] == str(tmp_path / "cache" / "scenecache")
    c = run._scene(config, {}, SEED, tmp_path / "t3")
    assert c.is_relative_to(tmp_path / "t3") and os.environ["UNCLERENDERER_SCENE_CACHE"] == ""
