"""The port's terminal viewer (``unclerenderer_tpu_torch/viewer.py``): the
reference's scripted sessions (``tests/test_render.py:430-466``,
``tests/test_overlay.py:142``) against the port's ``Renderer(device="cpu")``
at the reference's SMALL size, forward, with no IBL, sky or shadows; the
ANSI frame string equal to the reference's ``frame_to_ansi`` on the same
seeded images; the raw-mode key reader on a pseudo-terminal.  The CLI's
``--interactive`` is driven in ``tests/test_torch_cli.py``."""

import io
import os
import pty

import numpy as np
import pytest

from unclerenderer_tpu import viewer as JV
from unclerenderer_tpu_torch import viewer as V
from unclerenderer_tpu_torch.render.params import RenderSettings
from unclerenderer_tpu_torch.render.renderer import Renderer
from unclerenderer_tpu_torch.scene.camera import Camera
from unclerenderer_tpu_torch.textures.png import load_png
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

SMALL = dict(width=64, height=64, shadow_map_size=64, tile_h=16, tile_w=64, chunk=32,
             shadow_chunk=32)


def _renderer(tmp_path):
    s = RenderSettings(renderer_type="forward", enable_ibl=False, enable_sky=False,
                       enable_shadows=False, **SMALL)
    return Renderer(tmp_path / "missing.json", settings=s, device="cpu")  # procedural fallback


def _script(monkeypatch, keys):
    """The viewer's key reader replaced by ``keys`` (one list per frame,
    then "x"), its terminal output by a buffer, which is returned."""
    keys = list(keys)

    class FakeRaw:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def read_keys(self):
            return keys.pop(0) if keys else ["x"]

    out = io.StringIO()
    monkeypatch.setattr(V, "_RawInput", FakeRaw)
    monkeypatch.setattr(V.sys, "stdout", out)
    return out


def test_interactive_viewer_scripted(tmp_path, monkeypatch):
    """Scripted keys move and turn the camera, nudge a slider ("]" selects
    tonemap_exposure, ".." adds 0.2), save a screenshot and quit; the frames
    really render and reach the terminal."""
    r = _renderer(tmp_path)
    out = _script(monkeypatch, [["w", "arrow_left"], ["arrow_up", "d", "]", ".", "."], ["p"],
                                ["x"]])
    pos0 = np.array(r.camera.position)
    fwd0 = np.array(r.camera.forward)
    shot = tmp_path / "shot.png"
    frames = V.run_viewer(r, save_path=str(shot), target_fps=1000.0)
    assert frames == 3
    png = load_png(shot)
    assert png.shape[:2] == (64, 64) and len(np.unique(png.reshape(-1, png.shape[-1]), axis=0)) > 4
    assert not np.allclose(r.camera.position, pos0)  # the camera moved
    assert not np.allclose(r.camera.forward, fwd0)  # and turned
    assert r.config.tonemap_exposure == pytest.approx(1.2)
    text = out.getvalue()
    assert text.count("\x1b[H") == 3 and text.count("▀") >= 3 * 80
    assert "fps" in text and "tonemap_exposure=1.2" in text


def test_viewer_settings_panel_scripted(tmp_path, monkeypatch):
    """The live settings panel: '5' flips tonemap off, 'c' picks at the
    centre, '9' cycles the filter past trilinear, 'v' clears the pick."""
    r = _renderer(tmp_path)
    _script(monkeypatch, [["5"], ["c"], ["9"], ["v", "x"]])
    assert r.settings.enable_tonemap
    frames = V.run_viewer(r, target_fps=1000.0)
    assert frames == 3
    assert not r.settings.enable_tonemap
    assert r.settings.texture_filter == "anisotropic"
    assert r.selected_object_id == 0


@pytest.mark.parametrize("shape,cols,rows", [((64, 64), 80, 22), ((37, 91), 40, 7),
                                             ((5, 3), 12, 9)])
def test_frame_to_ansi_equals_reference(shape, cols, rows):
    rng = np.random.default_rng(sum(shape) + cols)
    color = rng.uniform(-0.2, 1.2, shape + (3,)).astype(np.float32)
    assert V.frame_to_ansi(color, cols, rows) == JV.frame_to_ansi(color, cols, rows)
    np.testing.assert_array_equal(V._downsample(color, cols, 2 * rows),
                                  JV._downsample(color, cols, 2 * rows))


def test_camera_basis_equals_reference():
    cam = Camera()
    cam.set_rotation_euler_degrees([20.0, -35.0, 0.0])
    got = V._camera_basis(cam)
    want = JV._camera_basis(cam)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_raw_input_reads_keys_from_a_terminal(monkeypatch):
    """``_RawInput`` on a pseudo-terminal: cbreak mode, plain keys, arrow
    escape sequences and a lone ESC; the terminal mode is restored."""
    import termios

    master, slave = pty.openpty()
    with os.fdopen(slave, "r", buffering=1) as tty_in:
        monkeypatch.setattr(V.sys, "stdin", tty_in)
        before = termios.tcgetattr(slave)
        with V._RawInput() as raw:
            os.write(master, b"w\x1b[A\x1b[Dd")
            keys = []
            for _ in range(50):
                keys += raw.read_keys()
                if len(keys) >= 4:
                    break
            os.write(master, b"\x1b")
            keys += raw.read_keys()
        assert termios.tcgetattr(slave) == before
    os.close(master)
    assert keys == ["w", "arrow_up", "arrow_left", "d", "esc"]
