"""The control fails the comparison: the reference with its vertex inputs
in bfloat16, put in the program's place, reads above the configuration's
limits (here at a size a test run holds; on the card at the cells' own
size, ``renderbench/control.py``)."""

import pytest
import torch

from renderbench import control, run

SMALL = dict(n_objects=100, sphere_res=[8, 6], n_materials=8, tex_size=128, width=192,
             height=128, shadow_map_size=256)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("UNCLERENDERER_SCENE_CACHE", "")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["sponza263k_deferred.viewer_orbit",
                                  "sponza263k_masked.viewer_orbit",
                                  "sponza263k_masked.offline_chain"])
def test_control_is_not_correct(cell):
    res = control.control_readings(run.load_bench(), cell, 2**31 + 77, "cpu", SMALL)
    assert not res["passes"], res["check"]
    assert res["check"]["px_off_pct"]["value"] > res["check"]["px_off_pct"]["limit"]
