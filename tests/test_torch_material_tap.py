"""The material tap's two kernels, T1 ``tap_footprint`` and T2
``material_tap`` (``csrc/material_tap.cu``): the two stages of a slot's tap
in ``render/common.py resolve_materials``, the same on both devices -- T1
every quad-LOD footprint, T2 the packed-atlas taps where
``common.tap_kernels_engage`` holds.

On the CPU: the engagement rule for each kind of input (it ignores the
device); the CPU wrappers return their plain versions, and those compose
the plain footprint (``quad_corner_uvs``, the KHR transform,
``footprint_lod[_aniso]``) and the plain taps (``sample_pyramid_tri``,
``_sample_aniso``) bit for bit; a 32x24 frame's resolve calls
``tex.tap_footprint`` once a slot tapped and ``tex.material_tap`` only
where the rule holds (trilinear and dense anisotropic on the packed
atlas; not bilinear, compacted anisotropic, the quad atlas or the xla
backend); the counters ``tap_pixels`` and ``tap_kernel_pixels`` of a CPU
frame (no kernel pixels there).

Marked ``cuda`` (each skips inside the ``cuda_device`` fixture without a
card): both kernels ``torch.equal`` to the plain path on the card --
trilinear and anisotropic at N = 2, 3, 4 and 16, ``mat_select_kernel`` off
and on, u8, bf16 and f32 atlases, global rows from 0 and 37, empty records
(fused resolve's tri_id -1 pixels), degenerate triangles, LODs past the
chain's end and taps wrapping at rect edges --; and replayed 256x144
frames of the deferred, masked, anisotropic, forward, bilinear and
compacted anisotropic Renderers byte-equal to the same frames with both
wrappers patched to their plain versions, one launch of T1 a replay and
one of T2 where the rule holds.  On a machine with a card (no JAX, hence
no conftest): ``python -m pytest --noconftest tests/test_torch_material_tap.py -q``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from unclerenderer_tpu_torch.core import passes
from unclerenderer_tpu_torch.ops import _cuda
from unclerenderer_tpu_torch.ops import texture as tex
from unclerenderer_tpu_torch.render import common
from unclerenderer_tpu_torch.render import packing as PK
from unclerenderer_tpu_torch.render.params import RenderSettings
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

# the atlas the unit tests tap: ATLAS_H texel rows of ATLAS_W texels, a
# (ATLAS_H * ATLAS_W, 256) packed table
ATLAS_W, ATLAS_H = 256, 96
BASE = 9 + PK.GEO  # the material record's first lane in the resolve record


def _lanes(slot):
    return (BASE + PK.M_UVOS + 4 * slot, BASE + PK.M_UVROT + 2 * slot, BASE + PK.M_RECT + 4 * slot)


def _records(h, w, seed, empty=True):
    """A seeded (h, w, 128) resolve record image and centre uvs (h, w, 2):
    each pixel one of 64 random triangles (homogeneous screen vertices near
    the image), vertex uvs spread 1e-3 to 1e3 so LODs run from
    magnification past every chain's end; a tenth of the triangles
    degenerate (edge sum 0); the four slots' offset-scale (signs mixed),
    rotation and a pyramid rect in the atlas (1x1 to 64x32); with ``empty``
    an eighth of the pixels all zeros, as fused resolve leaves tri_id -1
    pixels (their rect's row index is negative).  Centre uvs in [-2, 3], so
    taps wrap."""
    rng = np.random.default_rng(seed)
    t = 64
    rec = np.zeros((t, 128), np.float32)
    xy = rng.uniform(-0.2, 1.2, (t, 3, 2)) * [w, h]
    wh = rng.uniform(0.5, 2.0, (t, 3, 1))
    pix = np.concatenate([xy * wh, wh], -1)
    degenerate = rng.random(t) < 0.1
    pix[degenerate] = pix[degenerate][:, :1]
    rec[:, 0:9] = pix.reshape(t, 9)
    spread = 10.0 ** rng.uniform(-3, 3, (t, 1, 1))
    uvs = rng.uniform(-1, 2, (t, 3, 2)) * spread
    for k in range(3):
        rec[:, 9 + 16 * k + 10:9 + 16 * k + 12] = uvs[:, k]
    for slot in range(4):
        os_, rot, rect = _lanes(slot)
        rec[:, os_:os_ + 2] = rng.uniform(-1, 1, (t, 2))
        rec[:, os_ + 2:os_ + 4] = rng.uniform(0.5, 2.0, (t, 2)) * rng.choice([-1, 1], (t, 2))
        a = rng.uniform(0, 2 * np.pi, t)
        rec[:, rot], rec[:, rot + 1] = np.cos(a), np.sin(a)
        w0 = 2 ** rng.integers(0, 7, t)
        h0 = np.maximum(w0 >> rng.integers(0, 3, t), 1)
        x0 = rng.integers(0, ATLAS_W - 2 * w0 - 8)
        y0 = rng.integers(0, ATLAS_H - h0)
        rec[:, rect:rect + 4] = np.stack([x0, y0, w0, h0], -1)
    full = rec[rng.integers(0, t, (h, w))]
    if empty:
        full[rng.random((h, w)) < 0.125] = 0.0
    uv = rng.uniform(-2, 3, (h, w, 2)).astype(np.float32)
    return torch.from_numpy(full), torch.from_numpy(uv)


def _atlas(dtype, seed=5):
    rng = np.random.default_rng(seed)
    atlas = torch.from_numpy(rng.integers(0, 256, (ATLAS_H * ATLAS_W, 256), dtype=np.uint8))
    return atlas if dtype == torch.uint8 else (atlas.float() / 255.0).to(dtype)


# ---- the engagement rule (CPU)

def _stand_in(lanes=256, dtype=torch.uint8, cuda=True):
    """A flattened atlas as the rule reads it."""
    return SimpleNamespace(is_cuda=cuda, shape=(64, lanes), dtype=dtype)


ENGAGE = {
    "trilinear": (_stand_in(), {}, True),
    "anisotropic": (_stand_in(), dict(texture_filter="anisotropic"), True),
    "anisotropic_frac_1": (_stand_in(), dict(texture_filter="anisotropic",
                                             aniso_compact_frac=1.0), True),
    "anisotropic_compacted": (_stand_in(), dict(texture_filter="anisotropic",
                                                aniso_compact_frac=0.25), False),
    "bilinear": (_stand_in(), dict(texture_filter="bilinear"), False),
    "forward_lod": (_stand_in(), dict(lod_derivatives="forward"), False),
    "xla": (_stand_in(), dict(raster_backend="xla"), False),
    "pallas": (_stand_in(), dict(raster_backend="pallas"), True),
    "mat_select_kernel": (_stand_in(), dict(mat_select_kernel=True), True),
    "f32": (_stand_in(dtype=torch.float32), {}, True),
    "bf16": (_stand_in(dtype=torch.bfloat16), {}, True),
    "f16": (_stand_in(dtype=torch.float16), {}, False),
    "quad_atlas": (_stand_in(lanes=64), {}, False),
    "other_lanes": (_stand_in(lanes=128), {}, False),
    "ignores_the_device": (_stand_in(cuda=False), {}, True),
}


@pytest.mark.parametrize("case", list(ENGAGE))
def test_engagement_follows_the_inputs(case):
    atlas, over, want = ENGAGE[case]
    assert common.tap_kernels_engage(atlas, RenderSettings(**over)) is want


# ---- the plain versions and the CPU wrappers (CPU)

def _plain_slot(full, uv, slot, row0, n, select, atlas):
    """The resolve's own plain path for one slot (``_sample_slot``, quad LOD)."""
    os_, rot, rect = _lanes(slot)
    t_os, t_rot, rect0 = full[..., os_:os_ + 4], full[..., rot:rot + 2], full[..., rect:rect + 4]
    suv = tex.apply_texture_transform(uv, t_os, t_rot)
    d_dx, d_dy = tex.quad_derivatives(tex.quad_corner_uvs(full[..., 0:57], row0), t_os, t_rot)
    base_w, base_h = rect0[..., 2] * t_os[..., 2].abs(), rect0[..., 3] * t_os[..., 3].abs()
    if not n:
        lod = tex.footprint_lod(d_dx, d_dy, base_w, base_h)
        return lod, tex.sample_trilinear_any(atlas, ATLAS_W, rect0, suv, lod, select_kernel=select)
    fp = tex.footprint_lod_aniso(d_dx, d_dy, base_w, base_h, n)
    settings = RenderSettings(texture_filter="anisotropic", max_anisotropy=n,
                              mat_select_kernel=select)
    valid = torch.ones(full.shape[:2], dtype=torch.bool)
    s, overflow = common._sample_aniso(atlas, ATLAS_W, rect0, suv, fp, valid, settings)
    assert int(overflow) == 0
    return fp[0], s


@pytest.mark.parametrize("n", [0, 3, 4], ids=["trilinear", "aniso3", "aniso4"])
@pytest.mark.parametrize("select", [False, True], ids=["lerp", "k8"])
def test_cpu_wrappers_are_the_plain_path(n, select):
    full, uv = _records(24, 20, 11 + n, empty=not select)
    atlas = _atlas(torch.uint8)
    slot, row0 = (2, 37) if select else (0, 0)
    before = dict(_cuda.LAUNCHES)
    planes = tex.tap_footprint(full, uv, _lanes(slot), row0, n)
    assert torch.equal(planes, tex.tap_footprint_ref(full, uv, _lanes(slot), row0, n))
    assert planes.shape == (6 if n else 3, 24 * 20)
    got = tex.material_tap(atlas, ATLAS_W, full, _lanes(slot)[2], planes, n, select)
    assert torch.equal(got, tex.material_tap_ref(atlas, ATLAS_W, full, _lanes(slot)[2], planes,
                                                 n, select))
    assert _cuda.LAUNCHES == before  # the CPU takes the plain versions
    lod, want = _plain_slot(full, uv, slot, row0, n, select, atlas)
    assert torch.equal(planes[2].reshape(24, 20), lod)
    assert torch.equal(got.reshape(24, 20, 16), want)
    # the seeded images reach what the kernels must hold to: empty records,
    # degenerate triangles, levels past the chains' ends, taps that wrap
    assert (full.abs().sum(-1) == 0).any() != select
    ranged = planes[2][torch.isfinite(planes[2])]
    assert ranged.min() < 0.0 and ranged.max() > 8.0
    assert ((uv < 0) | (uv > 1)).any()


@pytest.mark.parametrize("case", ["records", "uv", "planes", "atlas"])
def test_wrappers_refuse_what_no_kernel_takes(case):
    full, uv = _records(8, 8, 3)
    atlas = _atlas(torch.uint8)
    planes = tex.tap_footprint_ref(full, uv, _lanes(0))
    with pytest.raises(ValueError):
        if case == "records":
            tex.tap_footprint(full[..., :64], uv, _lanes(0))
        elif case == "uv":
            tex.tap_footprint(full, uv.double(), _lanes(0))
        elif case == "planes":
            tex.material_tap(atlas, ATLAS_W, full, _lanes(0)[2], planes, n_taps=4)
        else:
            tex.material_tap(atlas[:, :64], ATLAS_W, full, _lanes(0)[2], planes)


@pytest.mark.parametrize("filt", ["trilinear", "anisotropic"])
def test_tap_counters_of_a_cpu_frame(tmp_path, filt):
    """``tap_pixels`` counts the valid pixels tapped (one combined slot),
    ``tap_kernel_pixels`` none on the CPU; ``stats()`` reads both and
    ``passes.COUNTERS`` sums them while a profiler records."""
    from unclerenderer_tpu_torch.render.renderer import Renderer
    from unclerenderer_tpu_torch.render.testing import write_scene

    path = write_scene(tmp_path, 4, sphere_res=(8, 6), n_materials=4, tex_size=32)
    r = Renderer(path, RenderSettings(width=32, height=24, shadow_map_size=64,
                                      texture_filter=filt, material_packed_trilinear=True),
                 device="cpu")
    assert r.settings.combined_material and r.settings.material_packed_trilinear
    passes.COUNTERS.reset()
    try:
        out = r.render_frame()
        valid = int((out["tri_id"] >= 0).sum())
        assert valid > 0
        assert {k: int(v) for k, v in out["tap_counts"].items()} == {
            "tap_pixels": valid, "tap_kernel_pixels": 0, "attr_pixels": valid,
            "attr_kernel_pixels": 0}
        assert passes.COUNTERS.totals() == {}
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            outs = [r.render_frame() for _ in range(2)]
        totals = passes.COUNTERS.totals()
        assert totals["tap_pixels"] == sum(int(o["tap_counts"]["tap_pixels"]) for o in outs)
        assert totals["tap_kernel_pixels"] == 0
        stats = r.stats()
        assert stats["tap_pixels"] == int((outs[-1]["tri_id"] >= 0).sum())
        assert stats["tap_kernel_pixels"] == 0
    finally:
        passes.COUNTERS.reset()


# the resolve's settings beside the default (trilinear, packed atlas):
# (overrides, packed atlas, whether T2 engages)
RESOLVE_KINDS = {
    "trilinear": (dict(), True, True),
    "bilinear": (dict(texture_filter="bilinear"), True, False),
    "anisotropic_compacted": (dict(texture_filter="anisotropic", aniso_compact_frac=0.25), True,
                              False),
    "quad_atlas": (dict(), False, False),
    "xla": (dict(raster_backend="xla"), True, False),
}


@pytest.mark.parametrize("kind", list(RESOLVE_KINDS))
def test_resolve_calls_the_wrappers_on_every_device(monkeypatch, kind):
    """A 32x24 frame's resolve calls ``tex.tap_footprint`` once a slot
    tapped (every quad-LOD footprint) and ``tex.material_tap`` once a slot
    where ``tap_kernels_engage`` holds, else never."""
    from unclerenderer_tpu_torch.render.deferred import deferred_frame
    from unclerenderer_tpu_torch.render.params import FrameState
    from unclerenderer_tpu_torch.render.testing import synthetic_device_scene, synthetic_frame_params

    over, packed, engaged = RESOLVE_KINDS[kind]
    scene, data = synthetic_device_scene(4, rich_materials=True, atlas_u8=True,
                                         packed_trilinear=packed, device="cpu")
    settings = RenderSettings(width=32, height=24, shadow_map_size=64, combined_material=True,
                              material_packed_trilinear=packed, **over)
    quad_flat = scene.quad_img.reshape(-1, scene.quad_img.shape[-1])
    assert common.tap_kernels_engage(quad_flat, settings) is engaged
    calls = {"tap_footprint": 0, "material_tap": 0}
    for name in calls:
        def counted(*a, name=name, orig=getattr(tex, name), **k):
            calls[name] += 1
            return orig(*a, **k)
        monkeypatch.setattr(tex, name, counted)
    params = synthetic_frame_params(data, 32, 24, device="cpu")
    out, _ = deferred_frame(scene, params, FrameState.initial(32, 24, "cpu"), settings)
    valid = int((out["tri_id"] >= 0).sum())
    assert valid > 0
    slots = int(out["tap_counts"]["tap_pixels"]) // valid
    assert slots == 1 and int(out["tap_counts"]["tap_kernel_pixels"]) == 0
    assert calls == {"tap_footprint": slots, "material_tap": slots if engaged else 0}


def test_tap_counters_sum_the_slots():
    """Per-slot taps (the quad atlas) count each slot's valid pixels."""
    from unclerenderer_tpu_torch.render.deferred import deferred_frame
    from unclerenderer_tpu_torch.render.params import FrameState
    from unclerenderer_tpu_torch.render.testing import synthetic_device_scene, synthetic_frame_params

    scene, data = synthetic_device_scene(4, device="cpu")
    settings = RenderSettings(width=32, height=24, shadow_map_size=64,
                              slot_enabled=(True, True, True, False))
    params = synthetic_frame_params(data, 32, 24, device="cpu")
    out, _ = deferred_frame(scene, params, FrameState.initial(32, 24, "cpu"), settings)
    valid = int((out["tri_id"] >= 0).sum())
    assert valid > 0 and not settings.combined_material
    assert {k: int(v) for k, v in out["tap_counts"].items()} == {
        "tap_pixels": 3 * valid, "tap_kernel_pixels": 0, "attr_pixels": valid,
        "attr_kernel_pixels": 0}


# ---- the kernels on the card

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("row0", [0, 37])
@pytest.mark.parametrize("n", [0, 2, 3, 4, 16], ids=["trilinear", "n2", "n3", "n4", "n16"])
def test_tap_footprint_kernel_bit_equal(cuda_device, n, row0):
    full, uv = (x.to(cuda_device) for x in _records(67, 131, 100 + n + row0))
    for slot in (0, 3):
        before = _cuda.LAUNCHES["tap_footprint"]
        got = tex.tap_footprint(full, uv, _lanes(slot), row0, n)
        assert _cuda.LAUNCHES["tap_footprint"] == before + 1
        want = tex.tap_footprint_ref(full, uv, _lanes(slot), row0, n)
        # bits: NaN planes of degenerate footprints compare too
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("select", [False, True], ids=["lerp", "k8"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16, torch.float32],
                         ids=["u8", "bf16", "f32"])
@pytest.mark.parametrize("n", [0, 2, 3, 4, 16], ids=["trilinear", "n2", "n3", "n4", "n16"])
def test_material_tap_kernel_bit_equal(cuda_device, n, dtype, select):
    """T2 against the plain path on the card (with ``select`` that path
    hands its decode to K8; K8 reads a negative row index past the atlas's
    start, so its records here have no empty pixels)."""
    atlas = _atlas(dtype).to(cuda_device)
    for row0, slot in ((0, 0), (37, 1)):
        full, uv = (x.to(cuda_device)
                    for x in _records(67, 131, 200 + n + row0, empty=not select))
        planes = tex.tap_footprint_ref(full, uv, _lanes(slot), row0, n)
        before = _cuda.LAUNCHES["material_tap"]
        got = tex.material_tap(atlas, ATLAS_W, full, _lanes(slot)[2], planes, n, select)
        assert _cuda.LAUNCHES["material_tap"] == before + 1
        want = tex.material_tap_ref(atlas, ATLAS_W, full, _lanes(slot)[2], planes, n, select)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# kind -> (settings overrides, masked scene, whether T2 engages)
FRAME_KINDS = {
    "deferred": (dict(), False, True),
    "masked": (dict(), True, True),
    "anisotropic": (dict(texture_filter="anisotropic"), False, True),
    "forward": (dict(renderer_type="forward"), False, True),
    "bilinear": (dict(texture_filter="bilinear"), False, False),
    "anisotropic_compacted": (dict(texture_filter="anisotropic", aniso_compact_frac=0.25), False,
                              False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(FRAME_KINDS))
def test_replayed_frames_equal_the_plain_path(cuda_device, tmp_path, monkeypatch, kind):
    """A 256x144 Renderer's frames replayed from its frame program, byte-
    equal to a Renderer's whose wrappers ``tex.tap_footprint`` and
    ``tex.material_tap`` are patched to their plain versions; one launch of
    T1 a replay, and of T2 where ``tap_kernels_engage`` holds (the combined
    material: one slot)."""
    from unclerenderer_tpu_torch.render.renderer import Renderer
    from unclerenderer_tpu_torch.render.testing import write_scene

    over, masked, engaged = FRAME_KINDS[kind]
    monkeypatch.setenv("UNCLERENDERER_SCENE_CACHE", "")
    path = write_scene(tmp_path, 6, sphere_res=(12, 8), n_materials=4, tex_size=32,
                       masked=masked)
    settings = RenderSettings(width=256, height=144, shadow_map_size=256,
                              material_packed_trilinear=True, **over)
    runs = {}
    for kernels in (True, False):
        with monkeypatch.context() as m:
            if not kernels:
                m.setattr(tex, "tap_footprint", tex.tap_footprint_ref)
                m.setattr(tex, "material_tap", tex.material_tap_ref)
            r = Renderer(path, settings=settings, device=cuda_device)
            assert r.settings.combined_material and r.settings.material_packed_trilinear
            center = np.asarray(r.scene_data.scene_center)
            frames, launches = [], []
            for i in range(4):
                r.camera.position = (center[0] + 4 * np.sin(0.2 * i), center[1] + 1.5,
                                     center[2] - 4 * np.cos(0.2 * i))
                r.camera.set_look_at(center)
                _cuda.reset_launches()
                frames.append(r.render_frame())
                launches.append(dict(_cuda.LAUNCHES))
            assert r.frame_program == "graph"
            runs[kernels] = frames, launches
    (got, got_launches), (want, want_launches) = runs[True], runs[False]
    for i in range(4):
        for key in ("color", "depth", "tri_id", "hdr"):
            if key in want[i]:
                assert torch.equal(got[i][key], want[i][key]), (i, key)
        pixels = int(want[i]["tap_counts"]["tap_pixels"])
        assert pixels == int((want[i]["tri_id"] >= 0).sum()) > 0
        # the counter reads the rule, whichever version the wrappers run
        for run in (got, want):
            assert {k: int(v) for k, v in run[i]["tap_counts"].items()} == {
                "tap_pixels": pixels, "tap_kernel_pixels": pixels if engaged else 0,
                "attr_pixels": pixels, "attr_kernel_pixels": pixels}
    # frames 2 and 3 replay the program: one launch of T1, of T2 where the
    # rule holds; none with the plain versions patched in
    for i in (2, 3):
        assert got_launches[i]["tap_footprint"] == 1
        assert got_launches[i]["material_tap"] == int(engaged)
        assert want_launches[i]["tap_footprint"] == want_launches[i]["material_tap"] == 0
