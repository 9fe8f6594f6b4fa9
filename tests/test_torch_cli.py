"""The port's CLI, ``python -m unclerenderer_tpu_torch``: on a scene written
to files, ``--device cpu`` at 64x64 writes a PNG (stdlib encoder) that
decodes, with the port's own ``load_png``, to exactly the port Renderer's
``render_to_u8`` of the same first frame; ``--orbit 2`` writes 2 PNGs,
each the u8 of ``render_frames``' colour; ``--trace DIR`` writes a
profiler trace and ``--profile-passes`` logs the deferred stages;
``--interactive`` runs the terminal viewer on the Renderer, driven here by
scripted keys.

The reference CLI's PNG is not compared here: it has no
``raster_backend`` flag and on the CPU takes its XLA path, whose PCF table
differs from the kernel path the port's CLI renders at its default.  The
port's ``raster_backend="xla"`` renders the reference's XLA image:
``tests/test_torch_xla_backend.py`` holds the port's Renderer at "xla" to
the reference's Renderer at its default "auto" on the CPU, ``render_to_u8``
within 1 level, the u8 frame the reference CLI writes
(``tests/test_torch_renderer.py`` holds the kernel path's Renderer to the
reference's Pallas path)."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from unclerenderer_tpu_torch.app import main
from unclerenderer_tpu_torch.render.params import RenderSettings
from unclerenderer_tpu_torch.render.renderer import Renderer
from unclerenderer_tpu_torch.render.testing import write_scene
from unclerenderer_tpu_torch.textures.png import load_png
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

ROOT = Path(__file__).resolve().parents[1]
SIZE = 64


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_scene(tmp_path_factory.mktemp("cli"), 2, masked=True, n_materials=2,
                       tex_size=32)


def _cli(*args):
    res = subprocess.run([sys.executable, "-m", "unclerenderer_tpu_torch", *map(str, args)],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res


def _renderer(scene):
    return Renderer(scene, settings=RenderSettings(width=SIZE, height=SIZE,
                                                   shadow_map_size=SIZE), device="cpu")


def test_cli_png_equals_render_to_u8(scene, tmp_path):
    out = tmp_path / "out.png"
    res = _cli("--scene", scene, "--width", SIZE, "--height", SIZE, "--shadow-size", SIZE,
               "--device", "cpu", "--frames", 2, "--output", out)
    assert "steady-state" in res.stderr and "on cpu" in res.stderr
    got = load_png(out)
    want = _renderer(scene).render_to_u8()
    assert got.shape == (SIZE, SIZE, 4) and (got[..., 3] == 255).all()
    np.testing.assert_array_equal(got[..., :3], want)
    assert len(np.unique(want.reshape(-1, 3), axis=0)) > 10


def test_cli_orbit_writes_every_frame(scene, tmp_path):
    out = tmp_path / "orbit.png"
    _cli("--scene", scene, "--width", SIZE, "--height", SIZE, "--shadow-size", SIZE,
         "--device", "cpu", "--orbit", 2, "--output", out)
    r = _renderer(scene)
    c = np.asarray(r.scene_data.scene_center)
    rad = 2.5 * float(r.scene_data.scene_radius)

    def orbit(rr, i):  # the CLI's orbit
        a = 2.0 * np.pi * rr._frame_counter / 2
        rr.camera.position = (c[0] + rad * np.sin(a), c[1] + 0.4 * rad, c[2] - rad * np.cos(a))
        rr.camera.set_look_at(c)

    colors = r.render_frames(2, mutate=orbit).numpy()
    for i in range(2):
        got = load_png(tmp_path / f"orbit_{i:03d}.png")
        want = np.clip(np.rint(colors[i] * 255.0), 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(got[..., :3], want)
    assert not (tmp_path / "orbit_002.png").exists()


@pytest.mark.parametrize("flag,title", [(["--interactive"], "viewer and bench"),
                                        (["--trace", "tr"], "observability"),
                                        (["--profile-passes"], "observability")])
def test_cli_unported_flags_raise(scene, flag, title, tmp_path, monkeypatch):
    """The flags that raised until their queue entry was ported now run:
    ``--interactive`` ("viewer and bench") runs the terminal viewer on the
    Renderer the CLI built on ``--device`` -- scripted keys move the camera,
    save the screenshot to ``--output`` and quit after 2 frames --;
    ``--trace`` and ``--profile-passes`` ("observability"): the trace of the
    frame after the first is written into DIR, and the ten deferred stages
    are logged (in a subprocess, whose log the test reads)."""
    args = ["--scene", str(scene), "--width", str(SIZE), "--height", str(SIZE),
            "--shadow-size", str(SIZE), "--device", "cpu", "--output", str(tmp_path / "o.png")]
    if title != "observability":
        import io

        from unclerenderer_tpu_torch import viewer

        keys = [["w", "arrow_left"], ["p"], ["x"]]

        class FakeRaw:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def read_keys(self):
                return keys.pop(0)

        term = io.StringIO()
        monkeypatch.setattr(viewer, "_RawInput", FakeRaw)
        monkeypatch.setattr(viewer.sys, "stdout", term)
        assert main([*args, *flag]) == 0
        assert not keys and term.getvalue().count("\x1b[H") == 2
        shot = load_png(tmp_path / "o.png")
        assert shot.shape == (SIZE, SIZE, 4) and len(np.unique(shot.reshape(-1, 4), axis=0)) > 4
        return
    if flag[0] == "--trace":
        assert main([*args, "--trace", str(tmp_path / "tr"), "--frames", "2"]) == 0
        traces = list((tmp_path / "tr").glob("*.pt.trace.json"))
        assert len(traces) == 1 and traces[0].stat().st_size > 1000
    else:
        res = _cli(*args, *flag)
        logged = re.findall(r"pass (\S+(?: \S+)?)\s+avg", res.stderr + res.stdout)
        assert len(logged) == 10, logged
    assert (tmp_path / "o.png").is_file()


def test_cli_defaults_to_the_card(scene):
    """Without ``--device`` the CLI renders on the card; with no CUDA device
    it fails rather than rendering on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        main(["--scene", str(scene), "--width", "32", "--height", "32", "--shadow-size", "32",
              "--output", str(scene.parent / "never.png")])
    assert not (scene.parent / "never.png").exists()


def test_cli_steady_state_times_replays_only(scene, tmp_path, monkeypatch):
    """``--frames 4`` where the Renderer captures its frame program (the
    card's path, played here on the CPU by a stand-in program whose frames
    are the op-by-op ones): the capturing frame is rendered and logged on
    its own ``capture:`` line before the steady state, whose timed window
    -- between the two clock reads around the loop -- holds the 3 frames
    after it, all replays."""
    import types

    from unclerenderer_tpu_torch import app

    events = []

    def frame_mode(self):
        return "graph" if self._frame_counter > 0 else "eager: warm-up"

    def program_params(self, fields):
        events.append(("frame", "capture" if self._program is None else "replay"))
        if self._program is None:
            self._program = types.SimpleNamespace(state=None)
        return types.SimpleNamespace(run=lambda: self._eager_frame(fields))

    eager_frame = Renderer._eager_frame

    def eager(self, fields, dump=False, shadow=True):
        if not any(e == ("frame", "capture") for e in events):
            events.append(("frame", "eager"))
        return eager_frame(self, fields, dump=dump, shadow=shadow)

    def clock():
        events.append(("clock",))
        return len(events)

    monkeypatch.setattr(Renderer, "_frame_mode", frame_mode)
    monkeypatch.setattr(Renderer, "_program_params", program_params)
    monkeypatch.setattr(Renderer, "_eager_frame", eager)
    monkeypatch.setattr(app, "time", types.SimpleNamespace(monotonic=clock))
    monkeypatch.setattr(app, "log_info", lambda msg: events.append(("log", msg)))
    assert main(["--scene", str(scene), "--width", "32", "--height", "32", "--shadow-size", "32",
                 "--device", "cpu", "--frames", "4", "--output", str(tmp_path / "o.png")]) == 0
    steady = next(i for i, e in enumerate(events) if e[0] == "log" and "steady-state" in e[1])
    stop = max(i for i, e in enumerate(events[:steady]) if e == ("clock",))
    start = max(i for i, e in enumerate(events[:stop]) if e == ("clock",))
    assert events[start + 1:stop] == [("frame", "replay")] * 3, events
    capture = [i for i, e in enumerate(events) if e == ("frame", "capture")]
    logged = [i for i, e in enumerate(events) if e[0] == "log" and e[1].startswith("capture:")]
    assert len(capture) == 1 and len(logged) == 1 and capture[0] < logged[0] < start, events
    assert events.index(("frame", "eager")) < capture[0]
