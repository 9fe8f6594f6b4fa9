"""A cell is judged only by a reference that draws what it asks for: a
configuration names its reference, and a setting that reference does not
draw, in the configuration or in a value of the traffic's settings cycle,
is refused before any scene is written, with one line naming the key."""

import json
from pathlib import Path

import pytest

from renderbench import control, run, scenegen

ROOT = Path(__file__).resolve().parents[2]
CELL = "sponza263k_deferred.viewer_orbit"
UNDRAWN = [("renderer_type", "forward"), ("raster_backend", "xla"),
           ("texture_filter", "bilinear"), ("lod_derivatives", "forward"),
           ("shadow_table_u16", False), ("aniso_compact_frac", 0.25)]


def _names(directory: str) -> list:
    return sorted(p.stem for p in (ROOT / "renderbench" / directory).glob("*.json"))


def _cell_with(monkeypatch, place: str, key: str, value):
    """``CELL``'s files with ``key`` set to ``value`` in the configuration's
    ``render_settings`` or in the second value of a settings cycle; no
    scene may be written."""
    cell, config, spec = run.cell_files(run.load_bench(), CELL)
    if place == "render_settings":
        config["render_settings"][key] = value
    else:
        spec["settings_cycle"] = {"every": 2, "values": [{"enable_cas": True}, {key: value}]}

    def no_scene(*_a, **_k):
        raise AssertionError("a scene was written")

    monkeypatch.setattr(run, "cell_files", lambda *_a, **_k: (cell, config, spec))
    monkeypatch.setattr(scenegen, "write_scene", no_scene)


@pytest.mark.parametrize("place", ["render_settings", "settings_cycle"])
@pytest.mark.parametrize("key,value", UNDRAWN, ids=[k for k, _v in UNDRAWN])
def test_undrawn_setting_is_refused_before_the_scene(monkeypatch, capsys, place, key, value):
    _cell_with(monkeypatch, place, key, value)
    rc = run.main(["--workload", CELL, "--seed", "1", "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == ""
    assert err.count("\n") == 1 and f"{place} {key}={json.dumps(value)}" in err, err
    with pytest.raises(run.Refused, match=key):
        run.run_cell(run.load_bench(), CELL, 1, 1.0, False, device="cpu")
    with pytest.raises(run.Refused, match=key):
        control.control_readings(run.load_bench(), CELL, 1, "cpu")


@pytest.mark.parametrize("traffic", _names("traffic"))
@pytest.mark.parametrize("config", _names("configs"))
def test_every_configuration_and_traffic_is_drawn(config, traffic):
    cfg = json.loads((ROOT / "renderbench/configs" / f"{config}.json").read_text())
    spec = json.loads((ROOT / "renderbench/traffic" / f"{traffic}.json").read_text())
    assert run.refusal(cfg, spec, run.reference_module(cfg).DRAWS) is None


def test_settings_at_the_programs_defaults_pass_and_others_do_not():
    cfg = json.loads((ROOT / "renderbench/configs/sponza263k_deferred_1080p.json").read_text())
    draws = run.reference_module(cfg).DRAWS
    at_default = {**cfg, "render_settings": {**cfg["render_settings"], "aniso_compact_frac": 0.0,
                                             "slot_enabled": [True] * 4,
                                             "texture_filter": "anisotropic",
                                             "max_anisotropy": 16}}
    assert run.refusal(at_default, {}, draws) is None
    for place, key, value in [("render_settings", "max_anisotropy", 0),
                              ("render_settings", "slot_enabled", [True, False, True, True]),
                              ("renderer_config", "enable_shadows", False),
                              ("settings_cycle", "width", 960)]:
        if place == "settings_cycle":
            why = run.refusal(cfg, {"settings_cycle": {"every": 1, "values": [{key: value}]}},
                              draws)
        else:
            why = run.refusal({**cfg, place: {**cfg.get(place, {}), key: value}}, {}, draws)
        assert why and f"{place} {key}=" in why


def test_a_configuration_loads_the_reference_it_names(tmp_path):
    (tmp_path / "probe.py").write_text(
        "from .frames import DRAWS, ReferenceScene  # noqa: F401\nPROBE = True\n")
    mod = run.reference_module({"name": "c", "reference": "probe"}, tmp_path)
    assert mod.PROBE and mod.__name__ == "renderbench.reference.probe"
    assert "texture_filter" in run.reference_module({"name": "c"}).DRAWS["render_settings"]
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "absent.py")):
        run.reference_module({"name": "c", "reference": "absent"}, tmp_path)
