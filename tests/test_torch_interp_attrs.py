"""R1 ``interp_attrs`` (``csrc/material_tap.cu``): the material resolve's
attribute interpolation at the pixel centres, one launch a resolve on the
card, its plain version ``tex.interp_attrs_ref`` on the CPU.

On the CPU: the wrapper on CPU tensors is the plain version; the plain
version's five outputs are the reference's ``InterpAttr`` values
(``unclerenderer_tpu/render/common.py`` resolve_materials, its own lines run
by JAX on the CPU) bit for bit, on a frame and on a row slab; a 32x24
frame's resolve calls ``tex.interp_attrs`` once on the deferred, masked,
anisotropic, xla, fused and forward settings; the counters
``attr_pixels`` (the valid pixels) and ``attr_kernel_pixels`` (none on the
CPU) reach ``stats()`` and ``passes.COUNTERS``; the wrapper refuses what no
kernel takes.

Marked ``cuda`` (each skips inside the ``cuda_device`` fixture without a
card): R1 bit-equal to the plain version on random records with
degenerate triangles (edge sums 0 and -0.0), NaN and inf lanes, empty
pixels, odd widths and row offsets; replayed 128x128 frames of six
settings byte-equal to the same frames with the wrapper patched to its
plain version, one R1 launch a replay; the first six presented 1080p
frames of the benchmark's three configurations SHA-256-equal with the
wrapper patched to its plain version.  On a machine with a card (no JAX,
hence no conftest): ``python -m pytest --noconftest
tests/test_torch_interp_attrs.py -q -m cuda``."""

import hashlib
import inspect

import numpy as np
import pytest
import torch

from unclerenderer_tpu_torch.core import passes
from unclerenderer_tpu_torch.ops import _cuda
from unclerenderer_tpu_torch.ops import texture as tex
from unclerenderer_tpu_torch.render.params import RenderSettings
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

NAMES = ("world_pos", "v_normal", "tangent4", "uv", "v_color")


def _records(h, w, seed, special=False):
    """A seeded (h, w, 128) resolve record image: each pixel one of 64
    random triangles (homogeneous screen vertices near the image, attribute
    lanes spread over six decades), a tenth of them degenerate (edge sum 0),
    an eighth of the pixels all zeros (fused resolve's tri_id -1 pixels).
    With ``special``: triangles whose edge sum is -0.0, zero and mirrored
    vertices, NaN and +-inf in vertex and attribute lanes, attributes near
    f32's largest, huge vertices."""
    rng = np.random.default_rng(seed)
    t = 64
    rec = (rng.standard_normal((t, 128)) * 10.0 ** rng.uniform(-3, 3, (t, 1))).astype(np.float32)
    xy = rng.uniform(-0.2, 1.2, (t, 3, 2)) * [w, h]
    wh = rng.uniform(0.5, 2.0, (t, 3, 1))
    pix = np.concatenate([xy * wh, wh], -1)
    degenerate = rng.random(t) < 0.1
    pix[degenerate] = pix[degenerate][:, :1]
    rec[:, 0:9] = pix.reshape(t, 9)
    if special:
        rec[1, 0:9] = -0.0  # every edge -0.0 + 0.0: the sum replaced by 1
        rec[2, 0:9] = 0.0
        rec[3, 0:9] = -rec[3, 0:9]
        rec[4, 0:9] = np.tile(rec[4, 0:3], 3)  # three equal vertices
        rec[5, 2] = np.nan
        rec[6, 0] = np.inf
        rec[7, 4] = -np.inf
        rec[8, 9 + 3] = np.nan  # v_normal of vertex 0
        rec[9, 9 + 16 + 10] = np.inf  # uv of vertex 1
        rec[10, 9 + 32 + 12] = -np.inf  # v_color of vertex 2
        rec[11, 9:57] = 3.0e38
        rec[12, 9:57] = -3.0e38
        rec[13, 0:9] *= 1e19
        rec[14, 0:9] *= 1e-30
    full = rec[rng.integers(0, t, (h, w))]
    full[rng.random((h, w)) < 0.125] = 0.0
    return torch.from_numpy(full)


def _same_bits(got, want):
    """Bit patterns equal, a NaN matching a NaN (the CPU keeps NaN
    payloads that the card makes canonical)."""
    g, w = got.view(torch.int32), want.view(torch.int32)
    return bool(((g == w) | (torch.isnan(got) & torch.isnan(want))).all())


# ---- the plain version and the CPU wrapper (CPU)

SLABS = {"frame": (24, 20, 0), "slab": (9, 20, 37), "odd": (7, 13, 5)}


@pytest.mark.parametrize("case", list(SLABS))
def test_cpu_wrapper_is_the_plain_path(case):
    h, w, row0 = SLABS[case]
    full = _records(h, w, 3 + row0, special=True)
    before = dict(_cuda.LAUNCHES)
    got = tex.interp_attrs(full, w, row0)
    assert _cuda.LAUNCHES == before  # the CPU takes the plain version
    want = tex.interp_attrs_ref(full, w, row0)
    assert [tuple(g.shape) for g in got] == [(h, w, n) for _o, n in tex.ATTRS]
    for g, x in zip(got, want):
        assert g.dtype == torch.float32 and g.is_contiguous()
        assert _same_bits(g, x)


def _jax_interp_attr():
    """The reference's ``InterpAttr`` values as a jitted JAX function of
    (vertex lanes (H, W, 57), global row of the first row, width, height):
    resolve_materials's own lines, from its screen vertices to ``v_color``."""
    import jax
    import jax.numpy as jnp
    from unclerenderer_tpu.render import common as jcommon

    src = inspect.getsource(jcommon.resolve_materials)
    first, last = "    p0 = av[..., 0:3]\n", "        v_color = interp(12, 4)\n"
    body = src[src.index(first):src.index(last) + len(last)]
    assert 'jax.named_scope("InterpAttr")' in body
    namespace = {"jax": jax, "jnp": jnp}
    exec("def interp_attr(av, row0, width, height):\n" + body  # noqa: S102 -- the reference's lines
         + "    return world_pos, v_normal, tangent4, uv, v_color\n", namespace)
    return jax.jit(namespace["interp_attr"], static_argnums=(2, 3))


@pytest.mark.parametrize("case", ["frame", "slab"])
def test_plain_version_is_the_reference_interp_attr(case):
    """``interp_attrs_ref`` against the reference's jitted ``InterpAttr``
    lines on the CPU, bit for bit: degenerate triangles, empty pixels,
    attributes over six decades; a slab's pixel centres on global rows."""
    h, w, row0 = SLABS[case]
    full = _records(h, w, 11 + row0)
    j_vals = _jax_interp_attr()(full[..., 0:57].numpy(), row0, w, h)
    t_vals = tex.interp_attrs_ref(full, w, row0)
    for name, t, j in zip(NAMES, t_vals, j_vals):
        assert _same_bits(t, torch.from_numpy(np.array(j))), name
    # the seeded image reaches what the kernel must hold to: degenerate
    # triangles (a sum of 0 replaced by 1) and empty records
    assert (full.abs().sum(-1) == 0).any()
    p = full[..., 0:9].reshape(h, w, 3, 3)
    assert ((p[..., 0, :] == p[..., 1, :]).all(-1) & (full.abs().sum(-1) > 0)).any()


@pytest.mark.parametrize("case", ["records", "width", "dtype"])
def test_wrapper_refuses_what_no_kernel_takes(case):
    full = _records(8, 8, 3)
    with pytest.raises(ValueError):
        if case == "records":
            tex.interp_attrs(full[..., :64], 8)
        elif case == "width":
            tex.interp_attrs(full, 9)
        else:
            tex.interp_attrs(full.double(), 8)


# the settings a resolve runs under: (settings, scene) beside the packed
# atlas's combined material; the masked scene on its per-map quad atlas
PACKED = dict(rich_materials=True, atlas_u8=True, packed_trilinear=True)
RESOLVE_KINDS = {
    "deferred": (dict(), PACKED),
    "masked": (dict(combined_material=False, material_packed_trilinear=False),
               dict(with_masked=True)),
    "anisotropic": (dict(texture_filter="anisotropic"), PACKED),
    "xla": (dict(raster_backend="xla"), PACKED),
    "fused": (dict(fused_resolve="on"), PACKED),
    "forward": (dict(renderer_type="forward"), PACKED),
}


@pytest.mark.parametrize("kind", list(RESOLVE_KINDS))
def test_resolve_calls_interp_attrs_once(monkeypatch, kind):
    """A 32x24 frame's resolve calls ``tex.interp_attrs`` once, whatever the
    settings; its counters count the valid pixels, none by R1 on the CPU."""
    from unclerenderer_tpu_torch.render.deferred import deferred_frame
    from unclerenderer_tpu_torch.render.forward import forward_frame
    from unclerenderer_tpu_torch.render.params import FrameState
    from unclerenderer_tpu_torch.render.testing import synthetic_device_scene, synthetic_frame_params

    over, scene_kw = RESOLVE_KINDS[kind]
    scene, data = synthetic_device_scene(4, device="cpu", **scene_kw)
    settings = RenderSettings(**{**dict(width=32, height=24, shadow_map_size=64,
                                        combined_material=True, material_packed_trilinear=True),
                                 **over})
    calls = [0]

    def counted(*a, orig=tex.interp_attrs, **k):
        calls[0] += 1
        return orig(*a, **k)

    monkeypatch.setattr(tex, "interp_attrs", counted)
    params = synthetic_frame_params(data, 32, 24, device="cpu")
    if kind == "forward":
        out = forward_frame(scene, params, settings)
    else:
        out, _ = deferred_frame(scene, params, FrameState.initial(32, 24, "cpu"), settings)
    valid = int((out["tri_id"] >= 0).sum())
    assert valid > 0 and calls[0] == 1
    counts = {k: int(v) for k, v in out["tap_counts"].items()}
    assert counts["attr_pixels"] == valid and counts["attr_kernel_pixels"] == 0


def test_attr_counters_of_a_cpu_frame(tmp_path):
    """``attr_pixels`` counts the valid pixels, ``attr_kernel_pixels`` none
    on the CPU; ``stats()`` reads both and ``passes.COUNTERS`` sums them
    while a profiler records."""
    from unclerenderer_tpu_torch.render.renderer import Renderer
    from unclerenderer_tpu_torch.render.testing import write_scene

    path = write_scene(tmp_path, 4, sphere_res=(8, 6), n_materials=4, tex_size=32)
    r = Renderer(path, RenderSettings(width=32, height=24, shadow_map_size=64), device="cpu")
    passes.COUNTERS.reset()
    try:
        out = r.render_frame()
        valid = int((out["tri_id"] >= 0).sum())
        assert valid > 0
        assert int(out["tap_counts"]["attr_pixels"]) == valid
        assert int(out["tap_counts"]["attr_kernel_pixels"]) == 0
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            outs = [r.render_frame() for _ in range(2)]
        totals = passes.COUNTERS.totals()
        assert totals["attr_pixels"] == sum(int((o["tri_id"] >= 0).sum()) for o in outs)
        assert totals["attr_kernel_pixels"] == 0
        stats = r.stats()
        assert stats["attr_pixels"] == int((outs[-1]["tri_id"] >= 0).sum())
        assert stats["attr_kernel_pixels"] == 0
    finally:
        passes.COUNTERS.reset()


# ---- the kernel on the card

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(67, 131, 0), (67, 131, 37), (1, 1, 0), (5, 3, 1079),
                                   (33, 64, 1), (135, 240, 0)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("special", [False, True], ids=["random", "special"])
def test_interp_attrs_kernel_bit_equal(cuda_device, shape, special):
    h, w, row0 = shape
    full = _records(h, w, 300 + h + w + row0, special=special).to(cuda_device)
    before = _cuda.LAUNCHES["interp_attrs"]
    got = tex.interp_attrs(full, w, row0)
    assert _cuda.LAUNCHES["interp_attrs"] == before + 1
    want = tex.interp_attrs_ref(full, w, row0)
    for name, g, x in zip(NAMES, got, want):
        assert g.shape == x.shape and g.is_contiguous(), name
        # bits: the card's NaNs are canonical on both paths, signed zeros count
        assert torch.equal(g.view(torch.int32), x.view(torch.int32)), name


# kind -> (settings overrides, masked scene)
FRAME_KINDS = {
    "deferred": (dict(), False),
    "masked": (dict(), True),
    "anisotropic": (dict(texture_filter="anisotropic"), False),
    "forward": (dict(renderer_type="forward"), False),
    "fused": (dict(fused_resolve="on"), False),
    "xla": (dict(raster_backend="xla"), False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(FRAME_KINDS))
def test_replayed_frames_equal_the_plain_path(cuda_device, tmp_path, monkeypatch, kind):
    """A 128x128 Renderer's frames replayed from its frame program, byte-
    equal to a Renderer's whose ``tex.interp_attrs`` is patched to its plain
    version; one R1 launch a replay, none with the plain version."""
    from unclerenderer_tpu_torch.render.renderer import Renderer
    from unclerenderer_tpu_torch.render.testing import write_scene

    over, masked = FRAME_KINDS[kind]
    monkeypatch.setenv("UNCLERENDERER_SCENE_CACHE", "")
    path = write_scene(tmp_path, 6, sphere_res=(12, 8), n_materials=4, tex_size=32,
                       masked=masked)
    settings = RenderSettings(width=128, height=128, shadow_map_size=256,
                              material_packed_trilinear=True, **over)
    runs = {}
    for kernel in (True, False):
        with monkeypatch.context() as m:
            if not kernel:
                m.setattr(tex, "interp_attrs", tex.interp_attrs_ref)
            r = Renderer(path, settings=settings, device=cuda_device)
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
            runs[kernel] = frames, launches
    (got, got_launches), (want, want_launches) = runs[True], runs[False]
    for i in range(4):
        for key in ("color", "depth", "tri_id", "hdr"):
            if key in want[i]:
                assert torch.equal(got[i][key], want[i][key]), (i, key)
        valid = int((want[i]["tri_id"] >= 0).sum())
        assert valid > 0
        assert int(got[i]["tap_counts"]["attr_pixels"]) == valid
        # the counter reads the device, whichever version the wrapper runs
        for run in (got, want):
            assert int(run[i]["tap_counts"]["attr_kernel_pixels"]) == valid
    for i in (2, 3):  # replays of the program
        assert got_launches[i]["interp_attrs"] == 1
        assert want_launches[i]["interp_attrs"] == 0


VIEWER_CELLS = ["sponza263k_deferred.viewer_orbit", "sponza263k_masked.viewer_orbit",
                "sponza263k_aniso4.viewer_orbit"]


def presented_hashes(cell: str, seed: int, root, frames: int = 6) -> list:
    """SHA-256 of the first ``frames`` frames the viewer traffic of benchmark
    cell ``cell`` presents (``render_to_u8``), on its configuration's scene
    written from ``seed`` under ``root`` (the scene cache there)."""
    import os

    from renderbench import run, scenegen
    from renderbench.traffic import Traffic
    from unclerenderer_tpu_torch.core.config import RendererConfig
    from unclerenderer_tpu_torch.render.renderer import Renderer

    _cell, config, spec = run.cell_files(run.load_bench(), cell)
    scene_dir = root / f"scene-{hashlib.sha256(repr(config['scene']).encode()).hexdigest()[:8]}"
    scene_json = scene_dir / "Scenes" / "scene.json"
    if not scene_json.exists():
        scenegen.write_scene(scene_dir, seed=seed, **config["scene"])
    os.environ["UNCLERENDERER_SCENE_CACHE"] = str(root / "scenecache")
    r = Renderer(scene_json, settings=RenderSettings(**config["render_settings"]),
                 config=RendererConfig(**config.get("renderer_config", {})), device="cuda")
    traffic = Traffic(spec, scene_json, seed)
    out = [hashlib.sha256(np.ascontiguousarray(traffic.step(r, n)[0]).tobytes()).hexdigest()
           for n in range(frames)]
    del r
    torch.cuda.empty_cache()
    return out


@pytest.mark.cuda
def test_presented_1080p_frames_equal_the_plain_path(cuda_device, tmp_path, monkeypatch):
    """The first six presented 1080p frames of each of the benchmark's three
    configurations (its viewer traffic, one seed) hash alike with R1 and
    with the wrapper patched to its plain version."""
    monkeypatch.setenv("UNCLERENDERER_SCENE_CACHE", "")
    for cell in VIEWER_CELLS:
        kernel = presented_hashes(cell, 2700000027, tmp_path)
        with monkeypatch.context() as m:
            m.setattr(tex, "interp_attrs", tex.interp_attrs_ref)
            plain = presented_hashes(cell, 2700000027, tmp_path)
        assert kernel == plain, cell
        assert len(set(kernel)) == len(kernel), cell  # the orbit moves every frame
