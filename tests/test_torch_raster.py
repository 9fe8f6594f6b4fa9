"""Port vs reference: vertex stage, triangle setup, compaction and binning.
Setups feed depth and triangle ids, so everything here is bit-equal; the
reference runs jitted (its frame always is, and XLA:CPU's FMA contractions
are part of its numbers -- unclerenderer_tpu_torch/ops/fma.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_kernels import _setup as _random_setup  # the reference tests' random triangles

from unclerenderer_tpu.ops import binning as jbin
from unclerenderer_tpu.ops import raster as jr
from unclerenderer_tpu.render import common as jc
from unclerenderer_tpu.render.testing import synthetic_device_scene as j_scene
from unclerenderer_tpu.render.testing import synthetic_frame_params as j_frame_params
from unclerenderer_tpu_torch.ops import binning as tbin
from unclerenderer_tpu_torch.ops import raster as tr
from unclerenderer_tpu_torch.render import common as tc
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module


def T(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got,
                                  np.asarray(want), err_msg=msg)


def _setup_eq(got, want):
    _eq(got.coef, want.coef, "coef")
    _eq(got.valid, want.valid, "valid")
    _eq(got.bbox, want.bbox, "bbox")


def _port_setup(s):
    return tr.RasterSetup(coef=T(s.coef), valid=T(s.valid), bbox=T(s.bbox))


@pytest.fixture(scope="module")
def scene():
    j, data = j_scene(24, rich_materials=True, atlas_u8=True, ground=True)
    return j, data


@pytest.mark.parametrize("cull,light", [(jr.CULL_BACK, False), (jr.CULL_FRONT, True),
                                        (jr.CULL_BACK, True), (jr.CULL_FRONT, False)])
def test_vertex_stage_and_setup_bit_equal(scene, cull, light):
    j, data = scene
    p = j_frame_params(data, 160, 96)
    vp = p.light_view_proj if light else p.view_proj
    w, h = (128, 128) if light else (160, 96)
    rng = np.random.default_rng(1)
    mask = rng.random(j.tri_model.shape[0]) < 0.9

    def ref(pos, m, mask):
        v = jc.vertex_stage_soa(pos, m, w, h)
        return v, jr.triangle_setup_from_soa(v, mask, cull, w, h)

    jv, js = jax.jit(ref)(j.pos_soa, vp, mask)
    tv = tc.vertex_stage_soa(T(j.pos_soa), T(vp), w, h)
    _eq(tv.pix9(), jv.pix9(), "pix9")
    ts = tr.triangle_setup_from_soa(tv, T(mask), cull, w, h)
    _setup_eq(ts, js)
    assert ts.valid.sum() > 100


def test_normalize_ortho_and_flip_depth_key(scene):
    j, data = scene
    p = j_frame_params(data, 128, 128)
    mask = np.ones(j.tri_model.shape[0], bool)

    def ref(pos, m, mask):
        v = jc.vertex_stage_soa(pos, m, 128, 128)
        s = jr.triangle_setup_from_soa(v, mask, jr.CULL_FRONT, 128, 128)
        return s, jr.normalize_ortho_setup(s), jr.flip_depth_key(s)

    js, jo, jf = jax.jit(ref)(j.pos_soa, p.light_view_proj, mask)
    ts = _port_setup(js)
    _setup_eq(tr.normalize_ortho_setup(ts), jo)
    _setup_eq(tr.flip_depth_key(ts), jf)


@pytest.mark.parametrize("cap", [64, 500, 5000])
def test_compact_setup_bit_equal_with_overflow(cap):
    s = _random_setup(3000, seed=4, size=0.02)
    js, jids, jov = jax.jit(lambda s: jr.compact_setup(s, cap))(s)
    ts, tids, tov = tr.compact_setup(_port_setup(s), cap)
    _setup_eq(ts, js)
    _eq(tids, jids, "ids")
    assert int(tov) == int(jov)
    assert (int(tov) > 0) == (cap < int(np.asarray(s.valid).sum()))


@pytest.mark.parametrize("mode", ["sort", "scatter", "shift"])
def test_compact_mask_any_mode_matches(mode):
    rng = np.random.default_rng(2)
    mask = rng.random(4000) < 0.3
    jids, jok = jr.compact_mask(jnp.asarray(mask), 1000, mode)
    tids, tok = tr.compact_mask(T(mask), 1000, mode)
    ok = np.asarray(jok)
    _eq(tok, ok)
    _eq(tids.numpy()[ok], np.asarray(jids)[ok])


@pytest.mark.parametrize("n,size,budget,tiles", [
    (150, 0.04, 2.0, (16, 64)), (60, 0.3, 2.0, (32, 128)),
    (2000, 0.04, 0.001, (16, 64)),  # starved budget: pair_overflow
])
def test_bin_triangles_tables_bit_equal(n, size, budget, tiles):
    s = _random_setup(n, seed=5, size=size)
    th, tw = tiles
    jb = jbin.bin_triangles(s, 256, 256, th, tw, 32, budget_factor=budget)
    tb = tbin.bin_triangles(_port_setup(s), 256, 256, th, tw, 32, budget_factor=budget)
    for name in ("coef", "tri_id", "valid", "blk_tile", "blk_first", "blk_live",
                 "tile_used", "big_mask", "overflow"):
        _eq(getattr(tb, name), getattr(jb, name), name)
    if budget < 1:
        assert int(tb.overflow) > 0


def test_sort_pairs_matches_reference():
    rng = np.random.default_rng(11)
    for n_tiles, n_pairs in [(64, 4096), (2048, 100_000), (4095, 1 << 18)]:
        keys = rng.integers(0, n_tiles + 1, n_pairs).astype(np.int32)
        jk, jt = jbin._sort_pairs(jnp.asarray(keys), n_tiles, 4)
        tk, tt = tbin._sort_pairs(T(keys), n_tiles, 4)
        _eq(tk, jk)
        _eq(tt, jt)


def test_compaction_caps_match_reference():
    from unclerenderer_tpu.render.params import RenderSettings as JS
    from unclerenderer_tpu_torch.render.params import RenderSettings as TS

    for kw in ({}, {"has_masked_models": False}, {"has_masked_models": False, "compact_cap": 256},
               {"shadow_compact_cap": 1000}):
        for t in (1000, 94208, 94209, 263184, 400000):
            assert tc.compaction_cap(TS(**kw), t) == jc.compaction_cap(JS(**kw), t)
            assert tc.shadow_compaction_cap(TS(**kw), t) == jc.shadow_compaction_cap(JS(**kw), t)
    assert tc.compaction_cap(TS(has_masked_models=False), 263184) == 163840
    assert tc.shadow_compaction_cap(TS(), 263184) == 163840


def _indexed_meshes(seed):
    """Two UV spheres and a cube (shared vertices, ``indices``) placed at
    random before a perspective camera, the first sphere around the camera
    (vertices behind it, w < 0): (clip (V, 4) f32, tris (T, 3) i32)."""
    from unclerenderer_tpu_torch import mathlib as m
    from unclerenderer_tpu_torch.scene.mesh import create_cube, create_sphere

    rng = np.random.default_rng(seed)
    eye = rng.uniform(-0.5, 0.5, 3).astype(np.float32) + np.float32([0.0, 0.5, -3.0])
    centers = [eye + np.float32([0.0, 0.0, 0.4])] + list(rng.uniform(-2.0, 2.0, (2, 3)))
    pos, tris = [], []
    for mesh, c in zip((create_sphere(1.0, 12, 8), create_cube(1.5), create_sphere(0.7, 9, 6)),
                       centers):
        tris.append(mesh.indices.reshape(-1, 3).astype(np.int32) + sum(len(p) for p in pos))
        pos.append(mesh.position + np.asarray(c, np.float32))
    pos = np.concatenate(pos)
    vp = m.look_at_lh(eye, np.zeros(3, np.float32), [0, 1, 0]) @ m.perspective_reverse_z_infinite(
        np.radians(60.0), 1.25, 0.1)
    clip = (np.concatenate([pos, np.ones((len(pos), 1), np.float32)], 1) @ vp).astype(np.float32)
    return clip, np.concatenate(tris)


def _bits_eq(got, want, msg):
    got, want = got.numpy(), np.asarray(want)
    if got.dtype == np.float32:  # signed zeros too
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=msg)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cull", [jr.CULL_NONE, jr.CULL_BACK, jr.CULL_FRONT])
def test_triangle_setup_indexed_bit_equal(seed, cull):
    """``triangle_setup`` (the indexed-mesh setup, exported from ``ops``)
    and the de-indexed ``triangle_setup_expanded`` against the reference's,
    jitted as its frames run: coef, valid and bbox bit for bit, the
    near-degenerate pole triangles' orientation under CULL_NONE and the
    bbox's signed zeros included."""
    from unclerenderer_tpu_torch import ops as tops

    w, h = 160, 128
    clip, tris = _indexed_meshes(seed)
    mask = np.random.default_rng(seed + 7).random(len(tris)) < 0.9
    j_pix = jr.viewport_homogeneous(jnp.asarray(clip), w, h)
    want = jax.jit(jr.triangle_setup, static_argnums=(4, 5, 6))(
        j_pix, jnp.asarray(clip[:, 2]), jnp.asarray(tris), jnp.asarray(mask), cull, w, h)
    t_clip = T(clip)
    t_pix = tops.viewport_homogeneous(t_clip, w, h)
    got = tops.triangle_setup(t_pix, t_clip[:, 2], T(tris), T(mask), cull, w, h)
    flat = T(tris.reshape(-1)).long()
    expanded = tops.triangle_setup_expanded(t_pix[flat], t_clip[flat, 2], T(mask), cull, w, h)
    assert (clip[:, 3] < 0).any() and 0 < int(got.valid.sum()) < len(tris)
    for name, setup in (("indexed", got), ("expanded", expanded)):
        for f in ("coef", "valid", "bbox"):
            _bits_eq(getattr(setup, f), getattr(want, f), f"{name} {f}")
