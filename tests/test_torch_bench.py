"""The port's bench (``python -m unclerenderer_tpu_torch.bench``) on the CPU
at a small size, against the repository's ``bench.py``.

``bench.py`` reads its env overrides when it is loaded, so each test sets
them first and loads it from its file under a fresh name.  The reference's
``"auto"`` takes its XLA path on the CPU, so its chain runs the Pallas path
in interpret mode, which the port's kernel path follows (ROADMAP section 3).

* the synthetic chain: two chains of ``BENCH_FRAMES`` carried frames on the
  orbit, each frame's colour mean within 1e-4 of the reference's and the
  drop counters equal (the faithful tier's chain, on a written Sponza set:
  ``tests/test_torch_sponza_tiers.py``);
* ``main(["--device", "cpu"])`` prints one line whose keys are the
  reference line's, with ``on_gpu`` for ``on_tpu`` and ``kernel_build_s``
  for ``jit_cache_new_entries`` (both mains with one chain rendered in place
  of each timed measurement; ``_measure`` itself on a counted stand-in);
* a failed gate, a row or the pica row that raises, and a missing card
  each exit non-zero, with ``value`` null or the ``*_error`` key;
* both gates hold on the CPU's plain versions; the pica row's keys on a
  written scene."""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import unclerenderer_tpu.core.jaxcache as jaxcache
from unclerenderer_tpu.render import testing as jtesting
from unclerenderer_tpu.render.params import RenderSettings as JSettings
from unclerenderer_tpu_torch import bench
from unclerenderer_tpu_torch.ops import _cuda
from unclerenderer_tpu_torch.render import testing as ttesting
from unclerenderer_tpu_torch.render.params import RenderSettings
from unclerenderer_tpu_torch.render.testing import write_scene
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(BENCH_W="64", BENCH_H="64", BENCH_FRAMES="2", BENCH_OBJECTS="4", BENCH_SHADOW="64",
             BENCH_GEOMETRY="procedural")
ATOL_MEAN = 1e-4
# the reference line's keys that the port renames
RENAMED = {"on_tpu": "on_gpu", "jit_cache_new_entries": "kernel_build_s"}
_loads = [0]


def load_reference_bench():
    """``bench.py`` loaded from its file under a fresh module name (its
    overrides are read at load)."""
    _loads[0] += 1
    spec = importlib.util.spec_from_file_location(f"_reference_bench_{_loads[0]}",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def small(monkeypatch, tmp_path):
    """The small size, and no Sponza assets for either package."""
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    for mod in (jtesting, ttesting):
        monkeypatch.setattr(mod, "_SPONZA_GLTF", str(tmp_path / "absent.gltf"))
        monkeypatch.setattr(mod, "_sponza_chain_cache", {})
        monkeypatch.setattr(mod, "_atlas_memo", {})
    return monkeypatch


def run_main(argv=None):
    """(exit code, stdout lines) of the port's ``main``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(argv)
    return rc, out.getvalue().splitlines()


def hold_chain(ref, geometry: str, frames: int = 2):
    """The port's ``_synthetic_runner`` against the reference's (Pallas in
    interpret mode) at 64^2: two chains, each frame's colour mean within
    ``ATOL_MEAN`` and the drop counters equal after each; returns the
    port's atlas info."""
    common = dict(width=64, height=64, shadow_map_size=64)
    kw = dict(n_objects=4, sphere_res=(32, 24), ground=True, geometry=geometry)
    j_render, j_tris, j_eff, j_drops, j_info = ref._synthetic_runner(
        JSettings(raster_backend="pallas", pallas_interpret=True, **common), **kw)
    t_render, t_tris, t_eff, t_drops, t_info = bench._synthetic_runner(
        RenderSettings(**common), device="cpu", **kw)
    assert t_tris == j_tris and t_info == j_info
    assert (t_eff.has_masked_models, t_eff.combined_material) == (False, True)
    assert t_drops() == {}
    for chain in range(2):  # the state carried across chains
        want, got = np.asarray(j_render()["color"]), t_render()["color"].numpy()
        assert got.shape == want.shape == (frames,)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_MEAN, err_msg=f"chain {chain}")
        assert t_drops() == j_drops(), f"chain {chain}"
    return t_info


def test_synthetic_chain_matches_reference(small):
    info = hold_chain(load_reference_bench(), "procedural")
    assert info == {"material_atlas_dtype": "uint8", "material_atlas_layout": "quad",
                    "texture_source": "procedural", "geometry_source": "procedural_spheres"}


def test_measure_blocks():
    """The first call is the setup; then ``repeats`` blocks of ``frames``
    calls; a non-finite frame raises."""
    calls = []

    def render():
        calls.append(1)
        return {"color": torch.ones(3)}

    stats, setup_s = bench._measure(render, frames=4, repeats=2)
    assert len(calls) == 1 + 2 * 4 and setup_s >= 0
    assert set(stats) == {"n_runs", "median", "min", "max"} and stats["n_runs"] == 2
    assert stats["min"] <= stats["median"] <= stats["max"]
    assert bench._per_frame({"n_runs": 2, "median": 25.0, "min": 20.0, "max": 31.0}, 10) == {
        "n_runs": 2, "median": 2.5, "min": 2.0, "max": 3.1}
    with pytest.raises(RuntimeError, match="colour"):
        bench._measure(lambda: {"color": torch.full((2,), float("nan"))}, frames=1)


def measure_stub(first_only: bool):
    """A ``_measure`` that renders one chain (the first call only, with
    ``first_only``) and returns fixed stats: the line's keys do not depend
    on the times, and the drop counters come from the chain rendered."""
    rendered = []

    def measure(render, frames=1, repeats=3):
        if not (first_only and rendered):
            render()
            rendered.append(1)
        return {"n_runs": repeats, "median": 10.0, "min": 9.0, "max": 11.0}, 0.5

    return measure


def test_main_line_has_the_reference_keys(small):
    """Both mains at the small size, each chain's timing replaced by one
    rendered chain (the reference's headline only: one compile)."""
    small.setenv("BENCH_FRAMES", "1")
    ref = load_reference_bench()
    small.setattr(ref, "_probe_backend", lambda timeout_s=0: "cpu")
    small.setattr(ref, "_measure", measure_stub(first_only=True))
    small.setattr(jaxcache, "enable_persistent_cache", lambda *a, **k: "")
    small.setattr(bench, "_measure", measure_stub(first_only=False))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert ref.main() == 0
    want = json.loads(out.getvalue().splitlines()[-1])

    rc, lines = run_main(["--device", "cpu"])
    assert rc == 0 and len(lines) == 1
    got = json.loads(lines[0])
    assert set(got) == {RENAMED.get(k, k) for k in want}
    assert "sponza_faithful_ms" not in got  # BENCH_GEOMETRY is set
    for k in ("metric", "unit", "triangles", "shadow_map_size", "texture_filter",
              "rich_materials", "combined_material", "pallas_parity", "frame_parity",
              "material_atlas_dtype", "material_atlas_layout", "texture_source",
              "geometry_source", "frames", "drop_counters", "dropped_work"):
        assert got[k] == want[k], k
    assert (got["device"], got["on_gpu"], got["kernel_build_s"]) == ("cpu", False, 0.0)
    assert got["value"] == 10.0 and got["vs_baseline"] == 6.0  # the stand-in's ms, 1 frame a chain
    assert not got["dropped_work"] and not any(got["drop_counters"].values())
    for name in ("shadow2048", "bilinear", "anisotropic"):
        assert got[f"{name}_ms"] == 10.0 and got[f"{name}_runs"]["n_runs"] == 3


def test_failed_gate_exits_nonzero(small, capsys):
    """A gate that fails stops the bench with ``value`` null: nothing is
    benched on another raster."""
    small.setattr(torch.cuda, "is_available", lambda: True)
    small.setattr(_cuda, "build", lambda: (None, 0.0))
    small.setattr(bench, "_pallas_parity_gate", lambda device: False)
    small.setattr(bench, "_frame_parity_gate", lambda device: True)
    small.setattr(bench, "_synthetic_runner", None)  # never reached
    rc, lines = run_main([])
    line = json.loads(lines[-1])
    assert rc == 1 and line["value"] is None and "parity gate failed" in line["error"]
    assert (line["pallas_parity"], line["frame_parity"]) == (False, True)
    assert bench.LAUNCH_TAG in capsys.readouterr().err


@pytest.mark.parametrize("which", ["row", "pica"])
def test_failing_row_exits_nonzero(small, which):
    small.setenv("BENCH_FRAMES", "1")
    small.setattr(bench, "_measure", measure_stub(first_only=True))
    if which == "row":
        runner, calls = bench._synthetic_runner, []

        def failing(*a, **k):
            calls.append(a)
            if len(calls) == 2:  # the first secondary row
                raise RuntimeError("the row failed")
            return runner(*a, **k)

        small.setattr(bench, "_synthetic_runner", failing)
    else:
        small.setattr(bench, "reference_asset", lambda rel: "pica.json")

        def failing(*a, **k):
            raise RuntimeError("the pica row failed")

        small.setattr(bench, "_pica_row", failing)
    rc, lines = run_main(["--device", "cpu"])
    line = json.loads(lines[-1])
    assert rc == 1 and line["value"] > 0
    key = "secondary_rows_error" if which == "row" else "pica_row_error"
    assert "failed" in line[key]


def test_no_card_is_an_error(small):
    small.setattr(torch.cuda, "is_available", lambda: False)
    rc, lines = run_main([])
    line = json.loads(lines[-1])
    assert rc == 1 and line["value"] is None and line["error"] == "no CUDA device"
    assert line["metric"] == bench.METRIC


def test_gates_hold_on_the_cpu(monkeypatch):
    """Both gates on the plain versions: the raster gate at its 256^2, the
    frame gate at 32^2 (its plain X1 frames take ~20 s at 256^2 here)."""
    assert bench._pallas_parity_gate("cpu") is True
    monkeypatch.setattr(bench, "FRAME_GATE_SIZE", 32)
    assert bench._frame_parity_gate("cpu") is True


def test_pica_row_keys(small, tmp_path):
    scene = write_scene(tmp_path, 4, tex_size=16, env_size=8)
    extra = {}
    bench._pica_row(scene, RenderSettings(width=64, height=64, shadow_map_size=64), extra, "cpu")
    assert set(extra) == {"pica_pica_ms", "pica_pica_runs", "pica_pica_setup_s",
                          "pica_scene_cache_hit", "pica_setup_phases"}
    assert extra["pica_pica_runs"]["n_runs"] == 3 and extra["pica_pica_ms"] > 0
    assert "first_render_compile" in extra["pica_setup_phases"]
    bench._pica_row(tmp_path / "absent.json", None, extra, "cpu")  # skipped


def test_overrides_are_read_when_the_bench_runs(monkeypatch):
    monkeypatch.delenv("BENCH_W", raising=False)
    assert bench.env_int("BENCH_W") == 1920
    monkeypatch.setenv("BENCH_W", "96")
    assert bench.env_int("BENCH_W") == 96
