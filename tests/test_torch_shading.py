"""Port vs reference: lighting, sky, post-processing, culling and HZB.
Culling masks and the HZB pyramid (min-reductions) are bit-equal.  Shading
and post use transcendentals (pow, exp, log2, rsqrt, sqrt) whose XLA:CPU and
PyTorch implementations differ by a few ulps, so they are held to 1e-5
relative + 1e-6 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unclerenderer_tpu.ops import cull as jcull
from unclerenderer_tpu.ops import hzb as jhzb
from unclerenderer_tpu.ops import pbr as jpbr
from unclerenderer_tpu.ops import post as jpost
from unclerenderer_tpu.ops import sky as jsky
from unclerenderer_tpu.render import deferred as jdef
from unclerenderer_tpu.render.testing import synthetic_frame_params as j_frame_params
from unclerenderer_tpu.render.testing import synthetic_scene_data
from unclerenderer_tpu_torch.ops import cull as tcull
from unclerenderer_tpu_torch.ops import hzb as thzb
from unclerenderer_tpu_torch.ops import pbr as tpbr
from unclerenderer_tpu_torch.ops import post as tpost
from unclerenderer_tpu_torch.ops import sky as tsky
from unclerenderer_tpu_torch.render import deferred as tdef

TOL = dict(rtol=1e-5, atol=1e-6)


def T(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(kw or TOL))


def _unit(rng, shape):
    v = rng.standard_normal(shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_evaluate_pbr_and_normal_map():
    rng = np.random.default_rng(0)
    shp = (40, 50)
    albedo = rng.uniform(0, 1, shp + (3,)).astype(np.float32)
    metal = rng.uniform(0, 1, shp).astype(np.float32)
    rough = rng.uniform(0.05, 1, shp).astype(np.float32)
    f0 = (0.04 + (albedo - 0.04) * metal[..., None]).astype(np.float32)
    n, v, l = _unit(rng, shp + (3,)), _unit(rng, shp + (3,)), _unit(rng, (3,))
    want = jax.jit(jpbr.evaluate_pbr)(albedo, metal, rough, f0, n, v, l)
    _close(tpbr.evaluate_pbr(T(albedo), T(metal), T(rough), T(f0), T(n), T(v), T(l)), want,
           rtol=2e-5, atol=2e-6)
    tan = rng.standard_normal(shp + (4,)).astype(np.float32)
    tn = rng.uniform(-1, 1, shp + (3,)).astype(np.float32)
    tn[0, :5] = 0.0  # degenerate tangent-space normal -> (0, 0, 1)
    want = jax.jit(jpbr.apply_normal_map)(n, tan, tn)
    _close(tpbr.apply_normal_map(T(n), T(tan), T(tn)), want, rtol=2e-5, atol=2e-6)


def test_ibl_ambient():
    rng = np.random.default_rng(1)
    shp = (30, 40)
    albedo = rng.uniform(0, 1, shp + (3,)).astype(np.float32)
    metal = rng.uniform(0, 1, shp).astype(np.float32)
    rough = rng.uniform(0, 1, shp).astype(np.float32)
    f0 = rng.uniform(0, 1, shp + (3,)).astype(np.float32)
    n, v = _unit(rng, shp + (3,)), _unit(rng, shp + (3,))

    def run(m, xp, a, mt, f, nn, vv, r, mips):
        env = lambda d, lod: d * 0.5 + lod[..., None] * 0.1
        lut = lambda uv: uv * 0.7
        lvl = lambda d, lev: d * 0.25 + 0.1
        return m.ibl_ambient(a, mt, f, nn, vv, env, lut, mips, r, env_sample_level_fn=lvl)

    want = jax.jit(lambda *a: run(jpbr, jnp, *a))(albedo, metal, f0, n, v, rough, np.float32(5.0))
    got = run(tpbr, torch, T(albedo), T(metal), T(f0), T(n), T(v), T(rough), torch.tensor(5.0))
    _close(got, want)


def test_sky():
    data = synthetic_scene_data(4)
    p = j_frame_params(data, 96, 64)
    want_dir = jax.jit(lambda cp, v, pr: jsky.sky_view_directions(96, 64, cp, v, pr))(
        p.camera_pos, p.view, p.proj_unjittered)
    got_dir = tsky.sky_view_directions(96, 64, T(p.camera_pos), T(p.view), T(p.proj_unjittered))
    _close(got_dir, want_dir)
    want = jax.jit(jsky.apply_atmosphere)(want_dir, p.camera_pos, p.light_dir, p.light_color)
    got = tsky.apply_atmosphere(T(want_dir), T(p.camera_pos), T(p.light_dir), T(p.light_color))
    _close(got, want)


@pytest.mark.parametrize("use_history", [False, True])
def test_post_chain(use_history):
    rng = np.random.default_rng(2)
    hdr = rng.uniform(0, 4, (48, 64, 3)).astype(np.float32)
    hist = rng.uniform(0, 4, (48, 64, 3)).astype(np.float32)
    uh = np.bool_(use_history)
    want = jax.jit(jpost.temporal_aa)(hdr, hist, np.float32(0.9), uh)
    _close(tpost.temporal_aa(T(hdr), T(hist), torch.tensor(0.9), torch.tensor(uh)), want)
    args = [np.float32(x) for x in (0.3, 0.3, 0.1, 5.0, 3.0, 1.0, 1 / 60)]
    args.insert(1, uh)
    want_ev = jax.jit(jpost.auto_exposure_ev)(hdr, *args)
    got_ev = tpost.auto_exposure_ev(T(hdr), *[torch.tensor(a) for a in args])
    np.testing.assert_allclose(float(got_ev), float(want_ev), rtol=0, atol=1e-5)
    want_c = jax.jit(lambda h, e: jpost.tonemap(h, np.float32(1.0), e, True, True,
                                                np.float32(2.2)))(hdr, want_ev)
    got_c = tpost.tonemap(T(hdr), torch.tensor(1.0), T(want_ev), True, True, torch.tensor(2.2))
    _close(got_c, want_c)
    want_s = jax.jit(lambda c: jpost.cas_sharpen(c, np.float32(0.5)))(want_c)
    _close(tpost.cas_sharpen(T(want_c), torch.tensor(0.5)), want_s)


@pytest.fixture(scope="module")
def culling_inputs():
    data = synthetic_scene_data(40, ground=True)
    rng = np.random.default_rng(3)
    w, h = 96, 64
    layout, total = jhzb.hzb_layout(w // 2, h // 2)
    depth = rng.uniform(0, 0.02, (h, w)).astype(np.float32)
    depth[10:40, 20:70] = 0.5  # a near occluder
    return data, layout, depth, w, h


def test_build_hzb_and_load_bit_equal(culling_inputs):
    _data, layout, depth, _w, _h = culling_inputs
    want = jax.jit(lambda d: jhzb.build_hzb(d, layout))(depth)
    got = thzb.build_hzb(T(depth), layout)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(4)
    mip, x, y = (rng.integers(-2, 12, 500).astype(np.int32) for _ in range(3))
    wl = jhzb.hzb_load(want, layout, jnp.asarray(mip), jnp.asarray(x), jnp.asarray(y))
    tl = thzb.hzb_load(got, layout, T(mip), T(x), T(y))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(wl))


def test_frustum_and_occlusion_cull_bit_equal(culling_inputs):
    data, layout, depth, w, h = culling_inputs
    hzb = jax.jit(lambda d: jhzb.build_hzb(d, layout))(depth)
    bmin, bmax = data.bounds_min_arr, data.bounds_max_arr
    for pos in [(0.0, 1.5, -4.0), (3.0, 2.0, -1.0), (-2.0, 0.5, 6.0)]:
        p = j_frame_params(data, w, h, camera_pos=pos)

        def ref(view, proj, bmin, bmax, hzb):
            vp = view @ proj
            planes = jdef.frustum_planes(vp)
            return (planes, jcull.frustum_cull(bmin, bmax, planes),
                    jcull.occlusion_cull(bmin, bmax, vp, hzb, layout, w // 2, h // 2))

        jp, jf, jo = jax.jit(ref)(p.view, p.proj_unjittered, bmin, bmax, hzb)
        vp = tdef._matmul4(T(p.view), T(p.proj_unjittered))
        tp = tdef.frustum_planes(vp)
        # XLA fuses the plane normalization into the 4x4 product with its
        # own contractions; planes agree to 1 ulp, the masks exactly
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=2.4e-7, atol=0)
        tf = tcull.frustum_cull(T(bmin), T(bmax), tp)
        to = tcull.occlusion_cull(T(bmin), T(bmax), vp, T(hzb), layout, w // 2, h // 2)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        assert 0 < int(tf.sum()) < len(bmin) or int(to.sum()) > 0
