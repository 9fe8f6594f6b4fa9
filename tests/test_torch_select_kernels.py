"""Port vs reference for the four kernels of the packed-trilinear slice,
their plain versions against the reference's Pallas kernels in interpret
mode, on the same inputs:

* K6 ``hzb_tail`` vs ``build_hzb(pallas_tail=True)``: bit-equal (min is
  exact);
* K7 ``env_select`` vs ``_env_select_call`` and K8 ``mat_select`` vs
  ``_mat_select_call``: bit-equal -- the port spells out the multiply-adds
  that XLA:CPU contracts in the interpret-mode kernels (``ops/fma.py``);
* K9 ``materialize_rows`` vs ``materialize_rows``: bit-equal;

and the samplers around them: the packed sampler ``sample_pyramid_tri``
and the cube sampler on their kernel paths (bit-equal), and the packed
sampler's plain select-then-decode path, the level tap and the anisotropic
footprint within rtol 1e-6 / atol 1e-7 (the reference's own bound for the
two venues' contraction noise: the port's plain blends are uncontracted)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unclerenderer_tpu.ops import hzb as jhzb
from unclerenderer_tpu.ops import texture as jt
from unclerenderer_tpu.ops.pallas_raster import materialize_rows as j_materialize_rows
from unclerenderer_tpu.textures.atlas import build_pyramid_tri_atlas
from unclerenderer_tpu.textures.image import encode_combined_u8, generate_mips
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.ops import hzb as thzb
from unclerenderer_tpu_torch.ops import raster_kernels as rk
from unclerenderer_tpu_torch.ops import texture as tt

RTOL, ATOL = 1e-6, 1e-7


def T(x):
    return interop.array_to_tensor(x, "cpu")


def _capture(monkeypatch, name):
    """Record the arguments of the port's kernel wrapper ``tt.<name>``."""
    calls = []
    orig = getattr(tt, name)

    def rec(*args):
        calls.append(args)
        return orig(*args)

    monkeypatch.setattr(tt, name, rec)
    return calls


# --------------------------------------------------------------------- K6


@pytest.mark.parametrize("shape", [(64, 64), (60, 34), (128, 72), (1080, 1920)])
def test_hzb_tail_matches_pallas_tail(shape):
    h, w = shape
    rng = np.random.default_rng(h + w)
    depth = rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)
    depth[rng.random((h, w)) < 0.3] = 0.0  # empty pixels carry far depth 0
    layout, _ = jhzb.hzb_layout(w // 2, h // 2)
    want = np.asarray(jhzb.build_hzb(jnp.asarray(depth), layout, pallas_tail=True,
                                     interpret=True))
    got = thzb.build_hzb(torch.from_numpy(depth), layout, pallas_tail=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(thzb.build_hzb(torch.from_numpy(depth), layout).numpy(), want)
    assert len(layout) > 2


@pytest.mark.parametrize("size", [(1920, 1080), (1280, 720), (961, 541), (7, 1), (1, 1)])
def test_hzb_tail_dims_are_the_layout_levels(size):
    """K6 derives its levels by the halving rule: they are hzb_layout's tail
    after any of its levels."""
    layout, _ = jhzb.hzb_layout(*size)
    for k in range(len(layout)):
        _off, w, h = layout[k]
        rest = [(lw, lh) for _o, lw, lh in layout[k + 1:]]
        assert list(thzb.tail_dims(h, w, len(rest))) == rest


@pytest.mark.parametrize("dims", [[(240, 134)], [(240, 135), (121, 67)], [(480, 270)], []])
def test_hzb_tail_refuses_other_levels_on_the_cpu(dims):
    with pytest.raises(ValueError, match="halving"):
        thzb.hzb_tail(torch.zeros((270, 480)), dims)


# --------------------------------------------------------------------- K7


@pytest.fixture(scope="module")
def seamless_env():
    """The seamless cube of the reference's env-kernel test
    (tests/test_texture_sampling.py): 6 random 16^2 faces, cube=True."""
    rng = np.random.default_rng(7)
    chains = [generate_mips(rng.random((16, 16, 4)).astype(np.float32)) for _ in range(6)]
    tri, rect = build_pyramid_tri_atlas(chains, cube=True)
    m = 3000
    dirs = rng.normal(size=(m, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    lods = rng.uniform(0.0, 4.0, m).astype(np.float32)
    return tri, rect.astype(np.float32), dirs, lods


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_env_select_plain_matches_pallas_kernel(seamless_env, dtype, monkeypatch):
    tri, rect, dirs, lods = seamless_env
    flat = jnp.asarray(tri).reshape(-1, 128).astype(dtype)
    calls = _capture(monkeypatch, "env_select")
    got = tt.sample_cube_pyramid_tri(T(flat), tri.shape[1], T(rect), T(dirs), T(lods),
                                     select_kernel=True)
    (table, rows, params9), = calls
    want = np.asarray(jt._env_select_call(flat, jnp.asarray(rows.numpy()),
                                          jnp.asarray(params9.numpy()), interpret=True))
    np.testing.assert_array_equal(tt.env_select_ref(table, rows, params9).numpy(), want)
    # the whole sampler on its K7 path against the reference's
    want = np.asarray(jt.sample_cube_pyramid_tri(flat, tri.shape[1], jnp.asarray(rect),
                                                 jnp.asarray(dirs), jnp.asarray(lods),
                                                 select_kernel=True, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.std() > 0.05


def test_env_select_kernel_semantics_on_random_params(seamless_env):
    """Unclipped window column/row (-1 and 2 test as < 0.5 and not) and
    every border-mask combination, straight into both kernels."""
    tri, _, _, _ = seamless_env
    flat = jnp.asarray(tri).reshape(-1, 128).astype(jnp.bfloat16)
    rng = np.random.default_rng(8)
    n = 5000
    rows = rng.integers(0, flat.shape[0], n).astype(np.int32)
    params9 = np.concatenate([
        rng.random((5, n)), rng.integers(0, 2, (2, n)), rng.integers(-1, 3, (2, n))
    ]).astype(np.float32)
    want = np.asarray(jt._env_select_call(flat, jnp.asarray(rows), jnp.asarray(params9),
                                          interpret=True))
    got = tt.env_select(T(flat), torch.from_numpy(rows), torch.from_numpy(params9))
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------- K8


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "u8"])
def packed_material(request):
    """The packed-trilinear chains of the reference's material-kernel test
    (tests/test_texture_sampling.py): 3 random 16-channel 32^2 chains."""
    rng = np.random.default_rng(11)
    chains = []
    for _ in range(3):
        chain = [rng.random((32, 32, 16)).astype(np.float32)]
        while chain[-1].shape[0] > 1:
            chain.append(chain[-1][::2, ::2])
        chains.append(chain)
    u8 = request.param
    if u8:
        chains = [[encode_combined_u8(lv) for lv in c] for c in chains]
    tri, r0 = build_pyramid_tri_atlas(chains, wrap=True, dtype=np.uint8 if u8 else np.float32)
    m = 2500
    uv = rng.uniform(-0.4, 1.6, (m, 2)).astype(np.float32)
    lods = rng.uniform(0.0, 4.5, m).astype(np.float32)
    rect = r0[rng.integers(0, 3, m)].astype(np.float32)
    return jnp.asarray(tri).reshape(-1, tri.shape[-1]), tri.shape[1], rect, uv, lods


def test_mat_select_plain_matches_pallas_kernel(packed_material, monkeypatch):
    flat, aw, rect, uv, lods = packed_material
    calls = _capture(monkeypatch, "mat_select")
    got = tt.sample_pyramid_tri(T(flat), aw, T(rect), T(uv), T(lods), select_kernel=True)
    (table, rows, params7), = calls
    want = np.asarray(jt._mat_select_call(flat, jnp.asarray(rows.numpy()),
                                          jnp.asarray(params7.numpy()), 16, interpret=True))
    np.testing.assert_array_equal(tt.mat_select_ref(table, rows, params7).numpy(), want)
    want = np.asarray(jt.sample_pyramid_tri(flat, aw, jnp.asarray(rect), jnp.asarray(uv),
                                            jnp.asarray(lods), select_kernel=True,
                                            interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.std() > 0.05


def test_packed_sampler_flag_off_matches_reference(packed_material):
    flat, aw, rect, uv, lods = packed_material
    want = np.asarray(jt.sample_pyramid_tri(flat, aw, jnp.asarray(rect), jnp.asarray(uv),
                                            jnp.asarray(lods)))
    got = tt.sample_pyramid_tri(T(flat), aw, T(rect), T(uv), T(lods))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # both decode paths of the port agree
    np.testing.assert_allclose(
        tt.sample_pyramid_tri(T(flat), aw, T(rect), T(uv), T(lods), select_kernel=True).numpy(),
        got.numpy(), rtol=RTOL, atol=ATOL)


def test_packed_level_tap_matches_reference(packed_material):
    flat, aw, rect, uv, lods = packed_material
    level = np.round(lods).astype(np.int32)
    want = np.asarray(jt.sample_pyramid_tri_level(flat, aw, jnp.asarray(rect), jnp.asarray(uv),
                                                  jnp.asarray(level)))
    got = tt.sample_pyramid_tri_level(T(flat), aw, T(rect), T(uv), T(level))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_aniso_footprint_matches_reference():
    rng = np.random.default_rng(5)
    dx, dy = (rng.standard_normal((4000, 2)).astype(np.float32) * 0.01 for _ in range(2))
    dy[:500] = dx[:500]  # isotropic footprints: extent exactly 0
    bw, bh = (rng.choice([64, 128, 256], 4000).astype(np.float32) for _ in range(2))
    want = [np.asarray(x) for x in jt.footprint_lod_aniso(dx, dy, bw, bh, 4)]
    got = tt.footprint_lod_aniso(T(dx), T(dy), T(bw), T(bh), 4)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy() > 0, want[2] > 0)


# --------------------------------------------------------------------- K9


@pytest.mark.parametrize("shape", [(7936, 64), (1150, 32), (37, 5), (4,)])
def test_materialize_rows_matches_pallas_kernel(shape):
    x = np.random.default_rng(len(shape) + shape[0]).integers(
        -2**31, 2**31 - 1, shape, dtype=np.int64).astype(np.int32)
    want = np.asarray(j_materialize_rows(jnp.asarray(x), interpret=True))
    got = rk.materialize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(rk.materialize_rows_ref(torch.from_numpy(x)).numpy(), want)
