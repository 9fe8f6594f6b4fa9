"""Port vs reference for the probe path (``unclerenderer_tpu_torch/ops/probes.py``):
the three kernels inside the reference's TPU measurement probes and the
rows around them, on the same inputs.

* K10 ``merge_select``, K11 ``copy_rows`` and K12 ``materialize``: their
  plain versions against the probes' Pallas kernels in interpret mode,
  bit-equal (a select and two copies: there is no rounding to differ in).
* The rows: merged ids, copied rows and index arrays and the gathered
  coefficient blocks bit-equal; channel and record sums within
  ``SUM_ATOL`` (see there).

The probes are scripts: they are loaded from their files with the JAX
compile cache pointed at a temporary directory, and ``pallas_call`` is
patched to interpret mode for the calls (their kernels take no
``interpret`` flag).  Nothing in ``tools/`` changes.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from unclerenderer_tpu.ops import binning as jbin
from unclerenderer_tpu.ops import raster as jr
from unclerenderer_tpu.ops.texture import _rows_to_f32 as j_rows_to_f32
from unclerenderer_tpu.render import common as jc
from unclerenderer_tpu.render.params import RenderSettings as JSettings
from unclerenderer_tpu.render.testing import synthetic_device_scene as j_scene
from unclerenderer_tpu.render.testing import synthetic_frame_params as j_frame_params
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.ops import probes
from unclerenderer_tpu_torch.ops.raster import RasterSetup
from unclerenderer_tpu_torch.render.params import DeviceScene, FrameParams, RenderSettings
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

ROOT = Path(__file__).resolve().parents[1]

# Sums of 16 blended channels (v10/v11, |sum| <= 16) and of 128
# standard-normal record lanes (|sum| ~40 here): XLA:CPU and PyTorch add in
# other orders and XLA contracts the blend's multiply-adds, each worth a
# few ulp of the sum (1 ulp is 3.8e-6 at 40).  Measured on these inputs:
# 7.6e-6 (records), 2.9e-6 (v10, v11).
SUM_ATOL = 2e-5


def T(x):
    return interop.array_to_tensor(x, "cpu")


def _eq(got, want, msg=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, msg
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=msg)


@pytest.fixture(scope="module")
def tools(tmp_path_factory):
    """The probe scripts ``prof_fuse`` and ``prof_tap_bisect``, loaded from
    their files (their import pins the JAX platform and enables the
    persistent compile cache: pointed at a temporary directory here)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UNCLERENDERER_JAX_CACHE", str(tmp_path_factory.mktemp("jax_cache")))
    mods = {}
    try:
        for name in ("prof_fuse", "prof_tap_bisect"):
            spec = importlib.util.spec_from_file_location(f"_probe_{name}",
                                                          ROOT / "tools" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mods[name] = mod
    finally:
        mp.undo()
    return mods


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def merge_pallas(a_, b_, ka, kb):
    """``tools/prof_r5.py:219-230`` verbatim (local to the probe's
    ``main()``, so it cannot be imported), at the (H, W) of the inputs."""
    H, W = a_.shape

    def _merge_k(a_ref, b_ref, ka_ref, kb_ref, o_ref):
        o_ref[...] = jnp.where(
            ka_ref[...] > kb_ref[...], a_ref[...], b_ref[...])

    return pl.pallas_call(
        _merge_k,
        grid=(H // 8,),
        in_specs=[pl.BlockSpec((8, W), lambda i: (i, 0))] * 4,
        out_specs=pl.BlockSpec((8, W), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((H, W), jnp.int32),
    )(a_, b_, ka, kb)


def _merge_inputs(case, h=24, w=40, tc=500, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, tc, (h, w)).astype(np.int32)
    b = rng.integers(0, tc, (h, w)).astype(np.int32)
    ka = rng.standard_normal((h, w)).astype(np.float32)
    kb = rng.standard_normal((h, w)).astype(np.float32)
    if case == "special":
        special = np.array([np.nan, 0.0, -0.0, 1.0, -1.0, np.inf, -np.inf], np.float32)
        ka = rng.choice(special, (h, w)).astype(np.float32)
        kb = rng.choice(special, (h, w)).astype(np.float32)
    elif case == "equal":
        kb = np.where(rng.random((h, w)) < 0.5, ka, kb).astype(np.float32)
    return a, b, ka, kb


# --------------------------------------------------------------------- K10


@pytest.mark.parametrize("case", ["random", "special", "equal"])
def test_merge_select_matches_pallas_merge(interpret, case):
    a, b, ka, kb = _merge_inputs(case)
    want = merge_pallas(*map(jnp.asarray, (a, b, ka, kb)))
    got = probes.merge_select(T(a), T(b), T(ka), T(kb))
    _eq(got, want)
    if case == "special":  # NaN, equal keys and -0.0 vs +0.0 all chose b
        nan_or_tie = np.isnan(ka) | np.isnan(kb) | (ka == kb)
        assert nan_or_tie.sum() > 100
        np.testing.assert_array_equal(got.numpy()[nan_or_tie], b[nan_or_tie])


# --------------------------------------------------------------------- K11


@pytest.mark.parametrize("dtype,n,lanes", [(np.int32, 3000, 16), (np.float32, 2500, 64),
                                           (np.int32, 1024, 16), (np.float32, 7, 64)])
def test_copy_rows_matches_pallas_copy(tools, interpret, dtype, n, lanes):
    rng = np.random.default_rng(n)
    if dtype == np.int32:
        rows = rng.integers(-2**31, 2**31 - 1, (n, lanes), dtype=np.int64).astype(np.int32)
    else:
        rows = rng.standard_normal((n, lanes)).astype(np.float32)
    want = jax.jit(tools["prof_tap_bisect"]._pl_copy)(jnp.asarray(rows))
    got = probes.copy_rows(T(rows))
    _eq(got, want)
    assert got.data_ptr() != T(rows).data_ptr()


# --------------------------------------------------------------------- K12


@pytest.mark.parametrize("shape,dtype", [((95, 64), np.int32), ((24, 40), np.int32),
                                         ((37, 5), np.float32), ((7,), np.int32)])
def test_materialize_matches_pallas_materialize(tools, interpret, shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = (rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int64).astype(np.int32)
         if dtype == np.int32 else rng.standard_normal(shape).astype(np.float32))
    want = jax.jit(tools["prof_fuse"].materialize)(jnp.asarray(x))
    _eq(probes.materialize(T(x)), want)


# ------------------------------------------------------- record gather rows


def test_rec_pmerge_and_rec_mat_match_probe_rows(tools, interpret):
    """``rec_pmerge`` (prof_r5.py:232-234) and ``rec_mat``
    (prof_fuse.py:219-222) against the probes' expressions, jitted."""
    tc = 700
    a, b, ka, kb = _merge_inputs("special", tc=tc, seed=3)
    rec = np.random.default_rng(4).standard_normal((tc, 128)).astype(np.float32)
    materialize = tools["prof_fuse"].materialize

    def j_pmerge(r, a_, b_, ka_, kb_):
        tri = merge_pallas(a_, b_, ka_, kb_)
        return r[jnp.maximum(tri, 0)].sum(-1)

    def j_mat(r, a_, b_, ka_, kb_):
        tri = jnp.where(ka_ > kb_, a_, b_)
        tri = materialize(tri)
        return r[jnp.maximum(tri, 0)].sum(-1)

    j_args = [jnp.asarray(x) for x in (rec, a, b, ka, kb)]
    t_args = [T(x) for x in (rec, a, b, ka, kb)]
    for j_fn, t_fn in ((j_pmerge, probes.rec_pmerge), (j_mat, probes.rec_mat)):
        want = np.asarray(jax.jit(j_fn)(*j_args))
        got = t_fn(*t_args).numpy()
        assert got.shape == want.shape == (24, 40)
        np.testing.assert_allclose(got, want, rtol=0, atol=SUM_ATOL)
    # the id image feeding the gather is bit-equal, and so is the param-fed row
    tri = np.asarray(merge_pallas(*j_args[1:]))
    _eq(probes.merge_select(*t_args[1:]), tri)
    np.testing.assert_allclose(probes.rec_param(T(rec), T(tri)).numpy(),
                               np.asarray(jax.jit(lambda r, t: r[jnp.maximum(t, 0)].sum(-1))(
                                   j_args[0], jnp.asarray(tri))), rtol=0, atol=SUM_ATOL)


# ------------------------------------------------------ tap copy rows (v10, v11)


def _tap_inputs(rows=4096, n=3000, seed=5):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 255, (rows, 256), dtype=np.int64).astype(np.uint8)
    idx = rng.integers(0, rows, n, dtype=np.int64).astype(np.int32)
    fx = rng.random((n, 1), np.float32)
    fy = rng.random((n, 1), np.float32)
    return table, idx, fx, fy


def test_tap_copy_blends_match_probe_rows(tools, interpret):
    """v10 and v11 (prof_tap_bisect.py:315-333, restated: they are local to
    ``variants5``) on a packed u8 table with n not a multiple of 1024."""
    pl_copy = tools["prof_tap_bisect"]._pl_copy
    c = 16
    table, idx, fx, fy = _tap_inputs()
    n = idx.shape[0]

    def blend(q, fx, fy):
        top = q[..., 0:c] * (1.0 - fx) + q[..., c : 2 * c] * fx
        bot = q[..., 2 * c : 3 * c] * (1.0 - fx) + q[..., 3 * c :] * fx
        return (top * (1.0 - fy) + bot * fy).sum(axis=-1)

    def v10(t, i, fx, fy):
        raw = t[i][..., 0 : 4 * c]
        pairs = jax.lax.bitcast_convert_type(raw.reshape(n, 4 * c // 4, 4), jnp.int32)
        pairs = pl_copy(pairs)
        q = j_rows_to_f32(
            jax.lax.bitcast_convert_type(pairs[..., None], jnp.uint8).reshape(n, 4 * c), c)
        return blend(q, fx, fy), pairs

    def v11(t, i, fx, fy):
        q = pl_copy(j_rows_to_f32(t[i][..., 0 : 4 * c], c))
        return blend(q, fx, fy), q

    j_args = [jnp.asarray(x) for x in (table, idx, fx, fy)]
    t_args = [T(x) for x in (table, idx, fx, fy)]
    want10, pairs = jax.jit(v10)(*j_args)
    want11, q = jax.jit(v11)(*j_args)
    # the rows K11 copies: little-endian int32 words, and decoded f32 lanes
    _eq(T(table)[T(idx).long(), :64].contiguous().view(torch.int32), pairs)
    _eq(probes.copy_rows(probes._rows_to_f32(T(table)[T(idx).long(), :64], c)), q)
    for t_fn, want in ((probes.tap_copy_blend_i32, want10), (probes.tap_copy_blend_f32, want11)):
        got = t_fn(*t_args).numpy()
        assert got.shape == (n,)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=SUM_ATOL)


# -------------------------------------------------- binning index array rows


W, H, SHADOW = 160, 96, 128


@pytest.fixture(scope="module")
def probe_scene():
    """A small synthetic scene (24 objects with a floor and wall of giant
    triangles), the reference's and the port's."""
    j, data = j_scene(24, rich_materials=True, atlas_u8=True, ground=True)
    p = j_frame_params(data, W, H)
    return j, p, interop.to_port(j, DeviceScene, "cpu"), interop.to_port(p, FrameParams, "cpu")


def _j_setups(j, p, settings):
    """The reference's frame route to the two setups (the port's raster
    tests hold the port's vertex stage and setup bit-equal to it)."""
    opaque = np.ones(j.tri_model.shape[0], bool)  # every model visible and opaque

    def cam(pos, vp, opaque):
        v = jc.vertex_stage_soa(pos, vp, W, H)
        return jr.triangle_setup_from_soa(v, opaque, jr.CULL_BACK, W, H)

    def shadow(pos, lvp, opaque):
        vs = jc.vertex_stage_soa(pos, lvp, SHADOW, SHADOW)
        sh = jr.triangle_setup_from_soa(vs, opaque, jr.CULL_FRONT, SHADOW, SHADOW)
        return jr.flip_depth_key(jr.normalize_ortho_setup(sh))

    t_count = int(j.tri_model.shape[0])
    assert jc.compaction_cap(settings, t_count) == 0  # small scene: no compaction
    assert jc.shadow_compaction_cap(settings, t_count) == 0
    return (jax.jit(cam)(j.pos_soa, p.view_proj, opaque),
            jax.jit(shadow)(j.pos_soa, p.light_view_proj, opaque))


def test_probe_setups_match_reference(probe_scene):
    j, p, tj, tp = probe_scene
    kw = dict(width=W, height=H, shadow_map_size=SHADOW, has_masked_models=False,
              combined_material=True)
    jcam, jsh = _j_setups(j, p, JSettings(**kw))
    cam, sh = probes.probe_setups(tj, tp, RenderSettings(**kw))
    # Triangles with two coincident vertices (the sphere poles) have an
    # exactly-zero determinant whose rounded sign is set by the operand order
    # XLA:CPU picks for its multiply-adds, which differs between compiles of
    # the same setup (ROADMAP section 3): only their valid flag may differ.
    pos = np.asarray(j.pos_soa)  # (3 vertices, xyz, T)
    degenerate = ((pos[0] == pos[1]).all(0) | (pos[1] == pos[2]).all(0)
                  | (pos[0] == pos[2]).all(0))
    for which, got, want in (("cam", cam, jcam), ("shadow", sh, jsh)):
        _eq(got.coef, want.coef, f"{which} coef")
        _eq(got.bbox, want.bbox, f"{which} bbox")
        valid, want_valid = got.valid.numpy(), np.asarray(want.valid)
        np.testing.assert_array_equal(valid[~degenerate], want_valid[~degenerate],
                                      err_msg=f"{which} valid")
    assert 0 < degenerate.sum() < 0.15 * degenerate.size  # pole rows of the 12x8 spheres
    assert int(cam.valid.sum()) > 300 and int(sh.valid.sum()) > 300


@pytest.mark.parametrize("which", ["cam", "shadow"])
def test_align_gathers_match_probe_rows(tools, interpret, probe_scene, which):
    """``align_gather`` and ``align_materialize_gather`` against the
    probe's ``fused`` and ``mat`` (prof_fuse.py:144-160) at the settings'
    camera and shadow tilings: index blocks and gathered coefficients
    bit-equal."""
    j, p, _tj, _tp = probe_scene
    s = JSettings(width=W, height=H, shadow_map_size=SHADOW, has_masked_models=False,
                  combined_material=True)
    jcam, jsh = _j_setups(j, p, s)
    if which == "cam":
        st0, (w_, h_, th, tw, ck, budget) = jcam, (W, H, s.tile_h, s.tile_w, s.chunk,
                                                   s.bin_budget_factor)
    else:
        st0, (w_, h_, th, tw, ck, budget) = jsh, (SHADOW, SHADOW, s.shadow_tile_h,
                                                  s.shadow_tile_w, s.shadow_chunk,
                                                  s.shadow_bin_budget_factor)
    span = s.bin_max_span
    n_tiles = (-(-w_ // tw)) * (-(-h_ // th))
    n_blocks = max(int(budget * st0.coef.shape[0]) // ck + n_tiles, 2)
    materialize = tools["prof_fuse"].materialize

    def align(st):
        keys, _big = jbin._pair_keys(st, w_, h_, th, tw, span)
        sk, stri = jbin._sort_pairs(keys, n_tiles, span * span)
        btid, sv, *_rest = jbin._align_pairs(sk, stri, n_tiles, ck, n_blocks)
        return jnp.where(sv, btid, 0), sv

    def fused(st):
        bt, sv = align(st)
        return st.coef[bt].transpose(0, 2, 1), sv

    def mat(st):
        bt, sv = align(st)
        bt = materialize(bt)
        return st.coef[bt].transpose(0, 2, 1), sv

    setup = RasterSetup(coef=T(st0.coef), valid=T(st0.valid), bbox=T(st0.bbox))
    args = (setup, w_, h_, th, tw, ck, budget, span)
    for j_fn, t_fn in ((fused, probes.align_gather), (mat, probes.align_materialize_gather)):
        jcoef, jsv = jax.jit(j_fn)(st0)
        tcoef, tsv = t_fn(*args)
        _eq(tcoef, jcoef, "coef blocks")
        _eq(tsv, jsv, "slot valid")
        assert int(tsv.sum()) > 100
    bt, _sv = probes._align(*args)
    _eq(probes.materialize(bt), jax.jit(lambda st: materialize(align(st)[0]))(st0), "index array")

