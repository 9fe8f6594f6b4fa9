"""The non-default sampling and storage branches' building blocks against
the reference's, on the same seeded inputs:

* the f32 superblock table (``pack_shadow_blocks``), K4's plain version on
  f32 rows against the reference's ``_select9_fetch`` (Pallas, interpret
  mode), and the PCF factor on the f32 table (unquantized compares), all
  bit-equal;
* the forward-difference LOD (``_edge_gated_uv_derivs``, ``uv_screen_lod``,
  ``uv_screen_lod_aniso``) on uv and triangle-id images with triangle
  edges: derivatives, ``dmaj`` and ``extent`` bit-equal, LOD within 2 ulps
  of its magnitude floored at 1 (``_lod_close``: PyTorch's log2 is not
  XLA's, and near LOD 0 an ulp of the squared footprint is many ulps of the
  LOD);
* the AoS vertex stage and triangle setup (``vertex_stage``,
  ``triangle_setup_expanded``) for CULL_BACK and CULL_FRONT: clip, pix_h,
  coefficients and bbox bit-equal, valid flags too except on the degenerate
  pole triangles (ROADMAP section 3, as ``tests/test_torch_probes.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unclerenderer_tpu.ops import raster as jr
from unclerenderer_tpu.ops import shadow as js
from unclerenderer_tpu.ops import texture as jt
from unclerenderer_tpu.render import common as jc
from unclerenderer_tpu.render.testing import synthetic_device_scene as j_scene
from unclerenderer_tpu.render.testing import synthetic_frame_params as j_frame_params
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.ops import raster as tr
from unclerenderer_tpu_torch.ops import shadow as ts
from unclerenderer_tpu_torch.ops import texture as tt
from unclerenderer_tpu_torch.render import common as tc
from unclerenderer_tpu_torch.render.params import DeviceScene, FrameParams
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

LVP = np.array([[0.15, 0.0, 0.0, 0.0],
                [0.0, -0.15, 0.02, 0.0],
                [0.01, 0.02, 0.08, 0.0],
                [0.0, 0.0, 0.55, 1.0]], np.float32)


def T(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got,
                                  np.asarray(want), err_msg=msg)


def _map(size, seed):
    return np.random.default_rng(seed).uniform(0.3, 1.0, (size, size)).astype(np.float32)


# ---------------------------------------------------------------- f32 table


@pytest.mark.parametrize("size", [256, 512, 1024])
def test_pack_shadow_blocks_f32_bit_equal(size):
    sm = _map(size, size)
    sm[::7, ::5] = 1.5
    sm[::11, ::3] = -0.2
    want = np.asarray(jax.jit(js.pack_shadow_blocks)(sm))
    got = ts.pack_shadow_blocks(T(sm))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _eq(got, want)
    assert np.isinf(want).any()  # the +inf border


def test_select9_plain_on_f32_rows_matches_pallas_kernel():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((2048, 128)).astype(np.float32)
    table.reshape(-1)[::17] = -0.0
    table.reshape(-1)[5::31] = np.inf
    n = 5000  # not a multiple of the reference's 1024-pixel blocks
    for bw in (4, 6, 8):
        deltas = ts.pcf_deltas(bw)
        row = rng.integers(0, 2048, n).astype(np.int32)
        base = rng.integers(0, 128 - deltas[-1], n).astype(np.int32)
        want = np.asarray(js._select9_fetch(jnp.asarray(table), jnp.asarray(row),
                                            jnp.asarray(base), deltas, interpret=True))
        args = (T(table), T(row), T(base), deltas)
        got = ts.select9_ref(*args)
        # bit patterns: -0 comes out as +0, as the reference's lane sum gives
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
        _eq(ts.select9(*args), want)


@pytest.mark.parametrize("pcf", ["deferred", "forward"])
@pytest.mark.parametrize("size", [256, 4096])
def test_shadow_factor_on_f32_table_bit_equal(size, pcf):
    rng = np.random.default_rng(3)
    sm = _map(size, 3)
    world = rng.uniform(-8.0, 8.0, (64, 96, 3)).astype(np.float32)
    table = jax.jit(js.pack_shadow_blocks)(sm)
    want = np.asarray(jax.jit(
        lambda t, w, l: js.shadow_factor_blocks(t, size, w, l, jnp.float32(0.9),
                                                jnp.float32(2e-3), pcf=pcf,
                                                interpret=True))(table, world, LVP))
    got = ts.shadow_factor_blocks(T(table), size, T(world), T(LVP), torch.tensor(0.9),
                                  torch.tensor(2e-3), pcf=pcf)
    _eq(got, want)
    assert 0.0 < float(got.mean()) < 1.0


# -------------------------------------------------------- forward-difference LOD


def _lod_inputs(seed, h=48, w=64):
    """A uv image and a triangle-id image with triangle edges: vertical and
    diagonal runs of ids, empty pixels (-1), and uvs that jump across ids."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    tri = ((xx // 7) + 3 * ((xx + yy) // 11)).astype(np.int32)
    tri[rng.random((h, w)) < 0.05] = -1
    uv = (np.stack([xx * 0.013, yy * 0.021], -1)
          + 0.3 * np.sin(tri[..., None] * [1.3, 0.7])
          + rng.normal(0, 1e-3, (h, w, 2))).astype(np.float32)
    base_w = rng.choice([64.0, 256.0, 1024.0], (h, w)).astype(np.float32)
    base_h = rng.choice([64.0, 512.0], (h, w)).astype(np.float32)
    same = {k: np.asarray(v) for k, v in zip(
        ("x", "y", "bx", "by"),
        (jnp.diff(tri, axis=1, append=tri[:, -1:]) == 0,
         jnp.diff(tri, axis=0, append=tri[-1:]) == 0,
         jnp.diff(tri, axis=1, prepend=tri[:, :1]) == 0,
         jnp.diff(tri, axis=0, prepend=tri[:1]) == 0))}
    return tri, uv, base_w, base_h, same


def _lod_close(got, want):
    """LODs within 2 ulps at max(|LOD|, 1); returns the share that differs."""
    got, want = np.asarray(got), np.asarray(want)
    tol = 2 * np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
    assert (np.abs(got - want) <= tol).all(), float(np.abs(got - want).max())
    return float((got != want).mean())


def test_same_triangle_masks_match_the_reference_diffs():
    tri, _uv, _bw, _bh, same = _lod_inputs(0)
    t = T(tri)
    _eq(tc._same_next(t, 1), same["x"], "same_x")
    _eq(tc._same_next(t, 0), same["y"], "same_y")
    _eq(tc._same_next(t.flip(1), 1).flip(1), same["bx"], "same_bx")
    _eq(tc._same_next(t.flip(0), 0).flip(0), same["by"], "same_by")


@pytest.mark.parametrize("backward", [True, False], ids=["gated", "ungated"])
def test_forward_difference_lod_matches_reference(backward):
    _tri, uv, bw, bh, same = _lod_inputs(1)
    bx, by = (same["bx"], same["by"]) if backward else (None, None)
    tbx, tby = (T(bx), T(by)) if backward else (None, None)
    j_kw = dict(same_tri_bx=bx, same_tri_by=by)
    t_kw = dict(same_tri_bx=tbx, same_tri_by=tby)

    jd = jax.jit(lambda u, sx, sy: jt._edge_gated_uv_derivs(u, sx, sy, bx, by, None, None))(
        uv, same["x"], same["y"])
    td = tt._edge_gated_uv_derivs(T(uv), T(same["x"]), T(same["y"]), tbx, tby, None, None)
    for g, w, name in zip(td, jd, ("dx", "dy")):
        _eq(g, w, name)
        assert (np.asarray(w) == 0).any() and (np.asarray(w) != 0).mean() > 0.5

    jl = jax.jit(lambda u, a, b, sx, sy: jt.uv_screen_lod(u, a, b, sx, sy, **j_kw))(
        uv, bw, bh, same["x"], same["y"])
    tl = tt.uv_screen_lod(T(uv), T(bw), T(bh), T(same["x"]), T(same["y"]), **t_kw)
    assert _lod_close(tl, jl) < 0.5

    ja = jax.jit(lambda u, a, b, sx, sy: jt.uv_screen_lod_aniso(u, a, b, sx, sy, 4, **j_kw))(
        uv, bw, bh, same["x"], same["y"])
    ta = tt.uv_screen_lod_aniso(T(uv), T(bw), T(bh), T(same["x"]), T(same["y"]), 4, **t_kw)
    assert _lod_close(ta[0], ja[0]) < 0.5
    _eq(ta[1], ja[1], "dmaj")
    _eq(ta[2], ja[2], "extent")
    assert (np.asarray(ja[2]) > 0).mean() > 0.1


def test_forward_difference_lod_uses_the_neighbour_rows():
    """A row slab with its true neighbour rows (the sharded reference's
    halo) takes its edge-row differences from them."""
    _tri, uv, bw, bh, same = _lod_inputs(2)
    above, below = uv[:1] + 0.01, uv[-1:] - 0.02
    want = jax.jit(lambda u: jt.uv_screen_lod(u, bw, bh, same["x"], same["y"], above, below,
                                              same["bx"], same["by"]))(uv)
    got = tt.uv_screen_lod(T(uv), T(bw), T(bh), T(same["x"]), T(same["y"]), T(above), T(below),
                           T(same["bx"]), T(same["by"]))
    _lod_close(got, want)


# ------------------------------------------------------------ AoS vertex stage


@pytest.fixture(scope="module")
def aos_scene():
    j, data = j_scene(24, rich_materials=True, atlas_u8=True, ground=True)
    return j, data, interop.to_port(j, DeviceScene, "cpu")


@pytest.mark.parametrize("cull,light", [(jr.CULL_BACK, False), (jr.CULL_FRONT, True),
                                        (jr.CULL_BACK, True), (jr.CULL_FRONT, False)])
def test_aos_vertex_stage_and_setup_bit_equal(aos_scene, cull, light):
    j, data, t = aos_scene
    p = j_frame_params(data, 160, 96)
    tp = interop.to_port(p, FrameParams, "cpu")
    w, h = (128, 128) if light else (160, 96)
    vp, tvp = (p.light_view_proj, tp.light_view_proj) if light else (p.view_proj, tp.view_proj)
    mask = np.random.default_rng(1).random(j.tri_model.shape[0]) < 0.9

    def ref(scene, m, mask):
        clip, pix_h = jc.vertex_stage(scene, m, w, h)
        return clip, pix_h, jr.triangle_setup_expanded(pix_h, clip[:, 2], mask, cull, w, h)

    jclip, jpix, jsetup = jax.jit(ref)(j, vp, mask)
    clip, pix_h = tc.vertex_stage(t, tvp, w, h)
    _eq(clip, jclip, "clip")
    _eq(pix_h, jpix, "pix_h")
    setup = tr.triangle_setup_expanded(pix_h, clip[:, 2], T(mask), cull, w, h)
    _eq(setup.coef, jsetup.coef, "coef")
    _eq(setup.bbox, jsetup.bbox, "bbox")
    pos = np.asarray(j.position).reshape(-1, 3, 3)
    degenerate = ((pos[:, 0] == pos[:, 1]).all(-1) | (pos[:, 1] == pos[:, 2]).all(-1)
                  | (pos[:, 0] == pos[:, 2]).all(-1))
    valid = setup.valid.numpy()
    np.testing.assert_array_equal(valid[~degenerate], np.asarray(jsetup.valid)[~degenerate])
    assert valid.sum() > 300
    # the frame's dispatch takes the same setup from VertexAoS
    via = tr.triangle_setup_any(tr.VertexAoS(clip, pix_h), T(mask), cull, w, h)
    assert torch.equal(via.coef, setup.coef) and torch.equal(via.valid, setup.valid)
