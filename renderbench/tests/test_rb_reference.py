"""The independent reference against the program on the CPU, where the
program runs its kernels' plain versions: carried frames of the same
camera, sun, settings and visibility from the generator's one scene, held
to the configuration's limits -- over a moving sun, the masked scene, a
settings cycle and a hide cycle, the traffic features the generator
offers, under both material samplers the reference draws.  The program's
trilinear frames fail against the anisotropic reference: the comparison
tells the two samplers apart."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from renderbench import check, scenegen
from renderbench.reference.frames import ReferenceScene
from renderbench.traffic import Traffic
from unclerenderer_tpu_torch.core.config import RendererConfig
from unclerenderer_tpu_torch.render.params import RenderSettings
from unclerenderer_tpu_torch.render.renderer import Renderer

ROOT = Path(__file__).resolve().parents[2]
LIMITS = json.loads((ROOT / "renderbench/configs/sponza263k_deferred_1080p.json").read_text())[
    "check"]
SETTINGS = dict(width=96, height=64, shadow_map_size=128)
BASE = {"mode": "present", "orbit": {"radius": 4.0, "height": 1.5, "step_rad": 0.05,
                                     "start_rad": [-0.6, -0.3]},
        "sun": None, "warmup_frames": 2,
        "check": {"start_frames": 2, "carry_within": 2, "samples": 1, "run_frames": 2}}
SUN = {"elevation_rad": 1.0, "step_rad": 0.05, "start_azimuth_rad": [0.4, 0.8]}
MIXES = {
    "moving_sun": {"sun": SUN},
    "settings_cycle": {"settings_cycle": {"every": 2, "values": [{"enable_cas": True},
                                                                 {"enable_cas": False}]}},
    "hide_cycle": {"hide_cycle": {"every": 2, "stride": 3}},
}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("UNCLERENDERER_SCENE_CACHE", "")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _readings(tmp_path, masked, traffic_spec, prog_settings, ref_settings):
    """The readings of the program's carried frames at ``prog_settings``
    against the reference's at ``ref_settings``, under ``traffic_spec``."""
    kw = dict(n_objects=8, seed=2**33 + 3, sphere_res=(8, 6), n_materials=8, tex_size=32,
              masked=masked)
    scene_json = scenegen.write_scene(tmp_path, **kw)
    prog = Renderer(scene_json, settings=RenderSettings(**prog_settings),
                    config=RendererConfig(), device="cpu")
    ref = ReferenceScene(scenegen.scene_content(**kw), ref_settings, {}, "cpu")
    traffic = Traffic(traffic_spec, scene_json, 7)
    state, pairs = ref.initial_state(), []
    for n in range(5):
        traffic.apply(prog, n)
        got = prog.render_to_u8()
        img, state = ref.frame(n, traffic.view(n), state, traffic.settings(n),
                               traffic.visible(n, ref.scene.n_models),
                               traffic.settings_changed(n))
        pairs.append((got, img))
    values = check.readings(pairs, ref.scene.n_models)
    prog_state = ref.state_from_program({f: getattr(prog.frame_state, f) for f in
                                         ("taa_history", "taa_valid", "exposure_ev",
                                          "exposure_valid")})
    values.update(check.state_readings(prog_state, state))
    return values


@pytest.mark.parametrize("texture_filter", ["trilinear", "anisotropic"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_reference_is_the_program_on_the_cpu(tmp_path, masked, mix, texture_filter):
    settings = {**SETTINGS, "texture_filter": texture_filter, "max_anisotropy": 4}
    values = _readings(tmp_path, masked, {**BASE, **MIXES[mix]}, settings, settings)
    assert all(values[k] <= lim for k, lim in LIMITS.items()), values
    assert np.isfinite(values["max_level"])


def test_trilinear_frames_fail_the_anisotropic_reference(tmp_path):
    """On the orbit's oblique view of the floor (1.5 m up, 4 m out), where
    the footprints stretch, the program's trilinear frames read past a held
    limit of the deferred configuration against the anisotropic
    reference."""
    aniso = {**SETTINGS, "texture_filter": "anisotropic", "max_anisotropy": 4}
    values = _readings(tmp_path, False, BASE, SETTINGS, aniso)
    assert any(values[k] > lim for k, lim in LIMITS.items()), values
