"""The frame program's CPU side (``render/program.py``): every op of a frame
traced, at 128x128 on the rich-material u8 scene, one frame a case.

A frame can be captured into a CUDA graph only if it makes no host
synchronisation and every shape is static.  A ``TorchDispatchMode`` sees
each aten op and a ``TorchFunctionMode`` each torch call; a case fails on
any of these outside the kernels' plain versions (``PLAIN``: on the card
the kernel runs in their place) and the constants made once per device
(``ONCE``):

* ``aten::_local_scalar_dense`` (a value read back: ``.item()``,
  ``int(t)``), ``nonzero``, ``bincount``, ``unique*``, ``masked_select``,
  ``equal``, ``is_nonzero``;
* ``repeat_interleave`` without ``output_size``;
* ``index`` / ``index_put_`` with a boolean index;
* ``lift_fresh`` of a tensor with one dim or more, and any
  ``torch.tensor`` / ``as_tensor`` / ``from_numpy`` given a device or
  ``.to(device)`` (a copy from host memory onto the card);
* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``bool()``,
  ``int()``, ``float()`` of a tensor.

Cases: the default deferred frame with its shadow map rendered in the
frame, the forward frame and ``raster_shadow`` are clean; two frames with
different cameras run one op sequence with the same output shapes, the
default and the masked frame, deferred and forward (the plain versions'
ops left out: on the card one kernel launch stands in for them); every
setting ``chip_smoke.py`` runs is either clean and ``supported()``, or
shows a forbidden op in a function that ``supported()``'s reason names
(every setting is clean: only a row-sharded ``dist`` is refused).
Also ``tile_block_ranges`` against a numpy count, and the CPU Renderer's
``frame_program``."""

import dataclasses
import sys

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

import unclerenderer_tpu_torch
from unclerenderer_tpu_torch.ops import consts
from unclerenderer_tpu_torch.ops import raster_kernels as rk
from unclerenderer_tpu_torch.ops.binning import BinnedTriangles
from unclerenderer_tpu_torch.render import common, program
from unclerenderer_tpu_torch.render.deferred import deferred_frame
from unclerenderer_tpu_torch.render.forward import forward_frame
from unclerenderer_tpu_torch.render.params import FrameState, RenderSettings
from unclerenderer_tpu_torch.render.renderer import Renderer
from unclerenderer_tpu_torch.render.testing import (
    synthetic_device_scene,
    synthetic_frame_params,
    write_scene,
)
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

SIZE = 128
PKG = unclerenderer_tpu_torch.__path__[0]
# the kernels' plain versions (file, function): on the card each wrapper
# launches its kernel in their place, so their ops are not the frame's
PLAIN = {("ops/raster_kernels.py", "binned_raster_ref"), ("ops/raster_kernels.py",
                                                          "giant_raster_ref"),
         ("ops/raster_kernels.py", "materialize_rows_ref"), ("ops/raster.py", "rasterize"),
         ("ops/shadow.py", "select9_ref"), ("ops/texture.py", "gather_rows_ref"),
         ("ops/texture.py", "mat_select_ref"), ("ops/texture.py", "env_select_ref"),
         ("ops/hzb.py", "hzb_tail_ref"), ("ops/raster_kernels.py", "masked_raster_ref")}
# made once per device and shared after (a warm-up frame makes them)
ONCE = {("ops/consts.py", "device_constant"), ("ops/overlay.py", "_static_parts")}
BANNED = {"aten::_local_scalar_dense", "aten::nonzero", "aten::nonzero_static", "aten::bincount",
          "aten::masked_select", "aten::equal", "aten::is_nonzero", "aten::unique_dim",
          "aten::unique_consecutive", "aten::_unique", "aten::_unique2"}
INDEX_OPS = {"aten::index", "aten::index_put_", "aten::index_put", "aten::_index_put_impl_"}
HOST_DATA = {"tensor", "as_tensor", "asarray", "from_numpy"}
HOST_READS = {"item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__", "__index__"}
BASE = dict(width=SIZE, height=SIZE, shadow_map_size=SIZE, has_masked_models=False,
            combined_material=True)


class _Trace(TorchDispatchMode):
    """Every aten op (name and output shapes) outside the plain versions,
    and every forbidden op, by the qualified name of the port function that
    made it."""

    def __init__(self):
        super().__init__()
        self.ops, self.bad = [], []

    def flag(self, what):
        """Record ``what`` under the innermost port function on the stack,
        unless a plain version or a once-made constant is on it."""
        where, f = None, sys._getframe(1)
        while f is not None:
            path = f.f_code.co_filename
            if path.startswith(PKG):
                key = (path[len(PKG) + 1:], f.f_code.co_qualname)
                if key in PLAIN or key in ONCE:
                    return
                where = where or f.f_code.co_qualname
            f = f.f_back
        self.bad.append((what, where or "?"))

    @staticmethod
    def in_plain() -> bool:
        """Whether a kernel's plain version is on the stack (on the card one
        launch stands in for its ops)."""
        f = sys._getframe(2)
        while f is not None:
            path = f.f_code.co_filename
            if path.startswith(PKG) and (path[len(PKG) + 1:], f.f_code.co_qualname) in PLAIN:
                return True
            f = f.f_back
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if not self.in_plain():
            self.ops.append((str(func), tuple(tuple(o.shape) for o in outs
                                              if isinstance(o, torch.Tensor))))
        name = func._schema.name
        if name in BANNED or name.startswith("aten::unique"):
            self.flag(name)
        elif name == "aten::repeat_interleave" and kwargs.get("output_size") is None:
            self.flag(name + " without output_size")
        elif name in INDEX_OPS and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                                       for i in args[1] if i is not None):
            self.flag(name + " with a boolean index")
        elif name == "aten::lift_fresh" and args[0].dim() >= 1:
            self.flag("lift_fresh of a tensor with dims")
        return out


class _Host(TorchFunctionMode):
    """Host data made into device tensors, and tensor values read back."""

    def __init__(self, trace):
        super().__init__()
        self.trace = trace

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        to_device = name == "to" and (kwargs.get("device") is not None or any(
            isinstance(a, (torch.device, str)) for a in args[1:]))
        if (name in HOST_DATA and kwargs.get("device") is not None) or to_device:
            self.trace.flag(f"host data onto the device ({name})")
        elif name in HOST_READS:
            self.trace.flag(f"read back ({name})")
        return func(*args, **kwargs)


class _Both:
    def __enter__(self):
        self.t = _Trace()
        self.host = _Host(self.t)
        self.host.__enter__()
        self.t.__enter__()
        return self.t

    def __exit__(self, *exc):
        self.t.__exit__(*exc)
        self.host.__exit__(*exc)


@pytest.fixture
def trace():
    """``with trace() as t:`` records the block's ops and its forbidden
    ones (the plain versions and the once-made constants exempt)."""
    return _Both


@pytest.fixture(scope="module")
def scenes():
    rich = synthetic_device_scene(6, rich_materials=True, atlas_u8=True, device="cpu")
    packed = synthetic_device_scene(6, rich_materials=True, atlas_u8=True, packed_trilinear=True,
                                    device="cpu")
    masked = synthetic_device_scene(6, with_masked=True, device="cpu")
    return {"rich": rich, "packed": packed, "masked": masked}


def _params(data, i=0):
    a = 0.05 * i
    return synthetic_frame_params(data, SIZE, SIZE, camera_pos=(4.0 * np.sin(a), 1.5,
                                                                -4.0 * np.cos(a)), device="cpu")


def test_default_deferred_frame_with_its_shadow_map_is_sync_free(scenes, trace):
    scene, data = scenes["rich"]
    settings = RenderSettings(**BASE)
    assert program.supported(settings) == (True, "")
    p, state = _params(data), FrameState.initial(SIZE, SIZE, "cpu")
    with trace() as t:
        out, _ = deferred_frame(scene, p, state, settings)  # no map given: it rasters its own
    assert t.bad == []
    assert any("giant" in op or "sort" in op for op, _ in t.ops) and out["depth"].shape == (SIZE,
                                                                                          SIZE)


def test_forward_frame_is_sync_free(scenes, trace):
    scene, data = scenes["rich"]
    settings = RenderSettings(renderer_type="forward", **BASE)
    p = _params(data)
    with trace() as t:
        forward_frame(scene, p, settings)
    assert t.bad == []


def test_raster_shadow_is_sync_free(scenes, trace):
    scene, data = scenes["rich"]
    settings = RenderSettings(**BASE)
    p = _params(data)
    opaque, masked = common.tri_draw_masks(scene, p.model_visible, settings)
    with trace() as t:
        depth, overflow = common.raster_shadow(scene, p.light_view_proj, opaque | masked, settings)
    assert t.bad == [] and depth.shape == (SIZE, SIZE) and overflow.shape == ()


# the scenes of the two-camera case: the default frame, and the masked frame
# (M1 on the per-slot masked scene at the Renderer's exact cap)
TWO_CAMERAS = {"rich": {}, "masked": dict(has_masked_models=True, combined_material=False,
                                          masked_tri_cap=64 * 40)}


@pytest.mark.parametrize("which", list(TWO_CAMERAS))
@pytest.mark.parametrize("kind", ["deferred", "forward"])
def test_two_cameras_run_one_op_sequence(scenes, trace, kind, which):
    """What a CUDA graph replays: the same ops with the same output shapes
    whatever the camera (the first frame, untraced, is the warm-up)."""
    scene, data = scenes[which]
    settings = RenderSettings(renderer_type=kind, **{**BASE, **TWO_CAMERAS[which]})
    state = FrameState.initial(SIZE, SIZE, "cpu")
    seqs = []
    for i in range(3):
        p = _params(data, 4 * i)
        if i == 0:
            if kind == "deferred":
                _, state = deferred_frame(scene, p, state, settings)
            else:
                forward_frame(scene, p, settings)
            continue
        with trace() as t:
            if kind == "deferred":
                out, state = deferred_frame(scene, p, state, settings)
            else:
                out = forward_frame(scene, p, settings)
        seqs.append((t.ops, out["tri_id"].clone()))
    assert len(seqs[0][0]) > 1000 and seqs[0][0] == seqs[1][0]
    assert not torch.equal(seqs[0][1], seqs[1][1]), "the cameras must see different pixels"


# every setting chip_smoke.py renders: (scene, overrides)
SETTINGS = {
    "packed atlas, four kernel flags": ("packed", dict(
        material_packed_trilinear=True, hzb_pallas_tail=True, env_select_kernel=True,
        mat_select_kernel=True, bin_mat_idx=True)),
    "fused resolve": ("rich", dict(fused_resolve="on")),
    "sampling": ("rich", dict(lod_derivatives="forward", soa_vertex=False,
                              shadow_table_u16=False)),
    "bilinear": ("rich", dict(texture_filter="bilinear")),
    "anisotropic": ("rich", dict(texture_filter="anisotropic")),
    "anisotropic, compacted taps": ("rich", dict(texture_filter="anisotropic",
                                                 lod_derivatives="forward",
                                                 aniso_compact_frac=0.25)),
    "xla backend": ("rich", dict(raster_backend="xla")),
    "stats block": ("rich", dict(gpu_debug_print=True)),
    "masked": ("masked", dict(has_masked_models=True, combined_material=False,
                              masked_tri_cap=-1)),
    "kernel debug print": ("rich", dict(kernel_debug_print=True)),
}


@pytest.mark.parametrize("label", list(SETTINGS))
def test_setting_is_clean_or_refused_for_its_op(scenes, trace, capsys, label):
    """A clean trace and ``supported()`` True, or a forbidden op in a
    function that ``supported()``'s reason names."""
    which, over = SETTINGS[label]
    scene, data = scenes[which]
    settings = RenderSettings(**{**BASE, **over})
    ok, why = program.supported(settings)
    p, state = _params(data), FrameState.initial(SIZE, SIZE, "cpu")
    shadow_map = common.raster_shadow(scene, p.light_view_proj,
                                      torch.ones(scene.tri_model.shape[0], dtype=torch.bool),
                                      settings)[0]
    with trace() as t:
        deferred_frame(scene, p, state, settings, shadow_map)
    capsys.readouterr()  # the debug print's lines
    if ok:
        assert why == "" and t.bad == [], t.bad
    else:
        assert t.bad, f"{label}: refused ({why}) but its trace is clean"
        for what, where in t.bad:
            assert where.split(".")[0] in why, f"{label}: {what} in {where}, not in {why!r}"


def test_supported_refuses_a_sharded_frame():
    class Shards:
        n_dev = 2

    ok, why = program.supported(RenderSettings(**BASE), dist=Shards())
    assert not ok and "parallel/dist.py" in why
    assert program.supported(RenderSettings(**BASE), dist=type("One", (), {"n_dev": 1})())[0]


def test_device_constant_is_made_once():
    a = consts.device_constant((0.5, 0.25), "cpu")
    assert a is consts.device_constant((0.5, 0.25), torch.device("cpu"))
    assert a.dtype == torch.float32 and a.tolist() == [0.5, 0.25]
    assert consts.device_constant((1, 2), "cpu", torch.int64).dtype == torch.int64


@pytest.mark.parametrize("live", ["some", "none", "all"])
def test_tile_block_ranges_match_a_numpy_count(live):
    """Start and count per tile at a static shape, bit-equal to counting the
    live blocks' tiles on the host; dead blocks and tiles past ``n_tiles``
    count nowhere."""
    rng = np.random.default_rng({"some": 0, "none": 1, "all": 2}[live])
    n_blocks, n_tiles = 300, 40
    tiles = np.sort(rng.integers(0, n_tiles + 5, n_blocks)).astype(np.int32)
    alive = {"some": rng.random(n_blocks) < 0.6, "none": np.zeros(n_blocks, bool),
             "all": np.ones(n_blocks, bool)}[live]
    bins = BinnedTriangles(None, None, None, torch.from_numpy(tiles), None,
                           torch.from_numpy(alive.astype(np.int32)), None, None, None)
    start, count = rk.tile_block_ranges(bins, n_tiles)
    want = np.bincount(tiles[alive & (tiles < n_tiles)], minlength=n_tiles)[:n_tiles]
    assert start.dtype == count.dtype == torch.int32
    np.testing.assert_array_equal(count.numpy(), want)
    np.testing.assert_array_equal(start.numpy(), np.cumsum(want) - want)


def test_program_needs_the_card(scenes):
    scene, data = scenes["rich"]
    fields = dict(view=np.eye(4), model_visible=np.ones(3, bool))
    flat = torch.from_numpy(program.pack_params(fields))
    with pytest.raises(ValueError, match="CUDA graphs run on the card"):
        program.FrameProgram(scene, RenderSettings(**BASE), "deferred", flat,
                             program.params_layout(fields),
                             state=FrameState.initial(SIZE, SIZE, "cpu"))
    # no setting is refused any more: K1's debug print reaches the device check too
    with pytest.raises(ValueError, match="CUDA graphs run on the card"):
        program.FrameProgram(scene, RenderSettings(**{**BASE, "kernel_debug_print": True}),
                             "deferred", flat, program.params_layout(fields),
                             state=FrameState.initial(SIZE, SIZE, "cpu"))


def test_params_pack_round_trip():
    fields = dict(view=np.arange(16, dtype=np.float32).reshape(4, 4), light_intensity=3.0,
                  model_visible=np.array([True, False, True]))
    fields.update({f.name: 0.0 for f in dataclasses.fields(program.FrameParams)
                   if f.name not in fields})
    p = program.unpack_params(torch.from_numpy(program.pack_params(fields)),
                              program.params_layout(fields))
    assert torch.equal(p.view, torch.arange(16, dtype=torch.float32).reshape(4, 4))
    assert p.light_intensity.shape == () and float(p.light_intensity) == 3.0
    assert p.model_visible.tolist() == [True, False, True]


def test_cpu_renderer_runs_frames_eager(tmp_path, monkeypatch):
    monkeypatch.setenv("UNCLERENDERER_SCENE_CACHE", "")
    scene = write_scene(tmp_path, 2, sphere_res=(8, 6))
    r = Renderer(scene, settings=RenderSettings(width=32, height=32, shadow_map_size=32),
                 device="cpu")
    r.render_frame()
    assert r.stats()["frame_program"] == f"eager: {program.CPU_REASON}"
    with program.eager():
        assert program.eager_active()
    assert not program.eager_active()
