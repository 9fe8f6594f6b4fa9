"""The port's graft entry (``unclerenderer_tpu_torch/graft_entry.py``)
against the repository's ``__graft_entry__.py`` on the CPU:

* ``entry``: the reference entry's settings (read from its function's
  closure) and its arguments carried over by ``interop.to_port``, bit for
  bit; the port's frame against the reference's Pallas path in interpret
  mode (``tests/test_torch_frame.py``): tri_id and depth bit-equal, colour
  within 1e-4;
* ``dryrun_multichip(2, device="cpu")``: 2 gloo ranks against the
  single-device frame, with its OK line;
* the dry run's sharded frames (``raster_backend="xla"``, 64x32, 2
  frames) against the JAX package's ``render_frame_multichip`` on a
  2-device mesh: tri_id, depth, counters and HZB bit-equal, colour and the
  seam rows within 1e-4, exposure within 1e-5;
* the entry points name the card unless the caller asks for the CPU, and
  ``compile_check`` refuses CPU tensors."""

import dataclasses
import functools
import inspect
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as reference_entry
from unclerenderer_tpu.parallel import multichip as jmulti
from unclerenderer_tpu.render.deferred import deferred_frame as j_frame
from unclerenderer_tpu.render.params import FrameState as JState
from unclerenderer_tpu.render.params import RenderSettings as JSettings
from unclerenderer_tpu.render.testing import synthetic_device_scene as j_scene
from unclerenderer_tpu.render.testing import synthetic_frame_params as j_frame_params
from unclerenderer_tpu_torch import graft_entry, interop
from unclerenderer_tpu_torch.parallel.multichip import run_ranks
from unclerenderer_tpu_torch.render import program
from unclerenderer_tpu_torch.render.deferred import deferred_frame
from unclerenderer_tpu_torch.render.params import (
    DeviceScene,
    FrameParams,
    FrameState,
    RenderSettings,
)
from unclerenderer_tpu_torch.render.testing import sharded_frames
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

RANK_TIMEOUT = 240.0  # seconds: the group's collectives and the join
ATOL_IMAGE = 1e-4  # the transcendentals' ulps, as tests/test_torch_frame.py
ATOL_EV = 1e-5


@pytest.fixture(scope="module")
def entries():
    """(reference fn, its args, its settings), (port fn, its args)."""
    j_fn, j_args = reference_entry.entry()
    return (j_fn, j_args, inspect.getclosurevars(j_fn).nonlocals["settings"]), \
        graft_entry.entry(device="cpu")


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype in (torch.float32, torch.uint32):
        return t.view(torch.int32)
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16)
    return t


def test_entry_settings_and_args_are_the_reference_entrys(entries):
    (_j_fn, j_args, j_settings), (fn, args) = entries
    assert dataclasses.asdict(fn.settings) == {
        f.name: getattr(j_settings, f.name) for f in dataclasses.fields(RenderSettings)}
    assert inspect.getclosurevars(fn).nonlocals["settings"] is fn.settings
    for cls, j_arg, arg in zip((DeviceScene, FrameParams, FrameState), j_args, args):
        want = interop.to_port(j_arg, cls, "cpu")
        for f in dataclasses.fields(cls):
            a, b = getattr(arg, f.name), getattr(want, f.name)
            if b is None:
                assert a is None, f"{cls.__name__}.{f.name}"
                continue
            assert a.device.type == "cpu" and a.dtype == b.dtype and a.shape == b.shape, \
                f"{cls.__name__}.{f.name}: {a.dtype} {tuple(a.shape)} vs {b.dtype} {tuple(b.shape)}"
            assert torch.equal(_bits(a), _bits(b)), f"{cls.__name__}.{f.name}"


def test_entry_frame_matches_reference_pallas_frame(entries):
    (_j_fn, j_args, j_settings), (fn, args) = entries
    settings = dataclasses.replace(j_settings, raster_backend="pallas", pallas_interpret=True)
    j_out, j_state = jax.jit(functools.partial(j_frame, settings=settings))(*j_args)
    color, state = fn(*args)
    out, _ = deferred_frame(*args, fn.settings)  # the same frame: its depth and ids
    assert color.shape == (128, 128, 3) and torch.equal(color, out["color"])
    for k in ("tri_id", "depth"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(j_out[k]), err_msg=k)
    np.testing.assert_allclose(color.numpy(), np.asarray(j_out["color"]), rtol=0,
                               atol=ATOL_IMAGE)
    np.testing.assert_array_equal(state.hzb.numpy(), np.asarray(j_state.hzb))
    assert abs(float(state.exposure_ev) - float(j_state.exposure_ev)) <= ATOL_EV
    assert (out["tri_id"] >= 0).sum() > 1000


def test_dryrun_multichip_two_ranks_on_the_cpu(capsys):
    rep = graft_entry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip OK: 2 ranks, color (32, 64, 3)" in out
    assert "single-device parity held" in out
    assert rep["ranks"] == 2 and rep["frames"] == 4 and rep["shape"] == (32, 64, 3)
    assert rep["color_err"] <= graft_entry.DRYRUN_ATOL and rep["seam_err"] <= rep["color_err"]
    assert rep["ev_err"] < graft_entry.DRYRUN_EV_ATOL
    assert len(rep["per_rank"]) == 2  # the CPU runs the plain versions: nothing launched
    assert all(not any(r["launches"].values()) for r in rep["per_rank"])


@pytest.fixture(scope="module")
def jax_xla_sharded_frames():
    """The JAX package's sharded frames at the dry run's settings for 2
    devices (raster_backend="xla", 64x32), 2 carried frames with camera
    motion."""
    n = 2
    kw = graft_entry.dryrun_settings(n)
    settings = JSettings(**kw)
    scene, data = j_scene(8, with_masked=True)
    mesh = jmulti.make_render_mesh(jax.devices()[:n])
    step = jax.jit(functools.partial(jmulti.render_frame_multichip, settings=settings,
                                     mesh=mesh))
    state = JState.initial(settings.width, settings.height)
    frames = []
    for cam in graft_entry.dryrun_cameras()[:2]:
        out, state = step(scene, j_frame_params(data, settings.width, settings.height,
                                                camera_pos=cam), state)
        frames.append((jax.device_get(out), jax.device_get(state)))
    return n, kw, frames


def test_dryrun_xla_sharded_frames_match_jax_multichip(tmp_path, jax_xla_sharded_frames):
    n, kw, j_frames = jax_xla_sharded_frames
    assert kw["raster_backend"] == "xla" and (kw["width"], kw["height"]) == (64, 32)
    spec = dict(device="cpu", settings=kw, scene=dict(n_objects=8, with_masked=True),
                cameras=graft_entry.dryrun_cameras()[:2])
    frames = run_ranks(sharded_frames, n, f"file://{tmp_path}/rendezvous", args=(spec,),
                       device="cpu", timeout=RANK_TIMEOUT)[0]
    slab_h = kw["height"] // n
    for i, ((j_out, j_state), got) in enumerate(zip(j_frames, frames)):
        for k in ("tri_id", "depth", "object_id"):
            np.testing.assert_array_equal(got[k], np.asarray(j_out[k]), err_msg=f"frame {i} {k}")
        assert set(got["raster_stats"]) == set(j_out["raster_stats"])
        for k, v in j_out["raster_stats"].items():
            assert int(got["raster_stats"][k]) == int(v), f"frame {i} {k}"
        for k in ("frustum_culled", "hzb_occluded"):
            assert int(got[k]) == int(j_out[k]), k
        np.testing.assert_array_equal(got["hzb"], np.asarray(j_state.hzb))
        want = np.asarray(j_out["color"])
        np.testing.assert_allclose(got["color"], want, rtol=0, atol=ATOL_IMAGE,
                                   err_msg=f"frame {i} color")
        for s in range(1, n):
            seam = slice(s * slab_h - 1, s * slab_h + 1)
            np.testing.assert_allclose(got["color"][seam], want[seam], rtol=0, atol=ATOL_IMAGE,
                                       err_msg=f"frame {i} seam {s}")
        assert abs(float(got["exposure_ev"]) - float(j_state.exposure_ev)) <= ATOL_EV
        assert (got["tri_id"] >= 0).sum() > 50


def test_entry_points_default_to_the_card():
    for fn in (graft_entry.entry, graft_entry.dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    if not torch.cuda.is_available():
        for call in (graft_entry.entry, lambda: graft_entry.dryrun_multichip(2)):
            with pytest.raises(RuntimeError, match="no CUDA card is visible"):
                call()
        res = subprocess.run([sys.executable, "-m", "unclerenderer_tpu_torch.graft_entry"],
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0 and "entry OK" not in res.stdout
        assert "--device cpu" in res.stderr


def test_compile_check_refuses_cpu_tensors(entries):
    _reference, (fn, args) = entries
    with pytest.raises(ValueError, match=r"CUDA graphs are the card's"):
        graft_entry.compile_check(fn, args)
    assert program.CPU_REASON.endswith("(CUDA graphs are the card's)")
