"""Port vs reference: the plain version of K5 (row gather) and the draw
masks (bit-equal), and the texture samplers of the default frame.  The
samplers' bilinear/trilinear blends are multiply-add chains that XLA:CPU
contracts in its own order, so they are held to 2e-6 absolute (a few f32
ulps of the [0, 1] texel range); everything exact (texel addressing, row
selection) shows up as a gross difference if it is wrong."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unclerenderer_tpu.ops import texture as jt
from unclerenderer_tpu.render import common as jc
from unclerenderer_tpu.render.testing import synthetic_device_scene as j_scene
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.ops import texture as tt
from unclerenderer_tpu_torch.render import common as tc
from unclerenderer_tpu_torch.render import packing as PK
from unclerenderer_tpu_torch.render.params import DeviceScene

ATOL = 2e-6


def T(x):
    return interop.array_to_tensor(x, "cpu")


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_gather_rows_plain_matches_onehot_kernel(dtype):
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.standard_normal((342, 2)).astype(np.float32)).astype(dtype)
    idx = rng.integers(0, 342, 3000).astype(np.int32)
    want = np.asarray(jt.gather_rows_onehot_matmul(table, jnp.asarray(idx), interpret=True))
    got = tt.gather_rows_ref(T(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tt.gather_rows(T(table), torch.from_numpy(idx)).numpy(), want)


@pytest.fixture(scope="module", params=[True, False], ids=["u8_atlas", "bf16_atlas"])
def scene(request):
    j, _data = j_scene(12, rich_materials=True, atlas_u8=request.param)
    return j, interop.to_port(j, DeviceScene, "cpu")


def test_tri_draw_masks_match_reference(scene):
    j, t = scene
    vis = np.random.default_rng(1).random(j.object_ids.shape[0]) < 0.6
    jo, jm = jc.tri_draw_masks(j, jnp.asarray(vis), matmul=True, interpret=True)
    to, tm = tc.tri_draw_masks(t, torch.from_numpy(vis))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(to.numpy(), vis[np.asarray(j.tri_model)])


def test_trilinear_quad_atlas_taps(scene):
    j, t = scene
    rng = np.random.default_rng(2)
    n = 4096
    model = rng.integers(0, j.object_ids.shape[0], n)
    rect0 = np.asarray(j.tri_mrec)[np.searchsorted(np.asarray(j.tri_model), model),
                                   PK.M_RECT:PK.M_RECT + 4]
    uv = rng.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    lod = rng.uniform(-1.0, 10.0, n).astype(np.float32)
    quad = j.quad_img.reshape(-1, j.quad_img.shape[-1])
    aw = j.quad_img.shape[1]
    want = np.asarray(jax.jit(lambda q, r, u, l: jt.sample_pyramid_trilinear(q, aw, r, u, l))(
        quad, rect0, uv, lod))
    got = tt.sample_pyramid_trilinear(t.quad_img.reshape(-1, 64), aw, T(rect0), T(uv), T(lod))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert want.std() > 0.05


def test_env_cube_tri_tap():
    rng = np.random.default_rng(3)
    env = jnp.asarray(rng.uniform(0, 2, (64, 128, 128)).astype(np.float32)).astype(jnp.bfloat16)
    rect = np.array([[f % 3 * 40, f // 3 * 20, 16, 16] for f in range(6)], np.float32)
    d = rng.standard_normal((3000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lod = rng.uniform(-0.5, 5.0, 3000).astype(np.float32)
    flat = env.reshape(-1, 128)
    want = np.asarray(jax.jit(lambda e, r, d, l: jt.sample_cube_pyramid_tri(e, 128, r, d, l))(
        flat, rect, d, lod))
    got = tt.sample_cube_pyramid_tri(T(flat), 128, T(rect), T(d), T(lod))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4 * ATOL)


def test_lut_and_tail_matmuls():
    rng = np.random.default_rng(4)
    lut = rng.uniform(0, 1, (32, 128, 2)).astype(np.float32)
    uv = rng.uniform(-0.1, 1.1, (50, 60, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jt.sample_table_bilinear_matmul)(lut, uv))
    got = tt.sample_table_bilinear_matmul(T(lut), T(uv))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    tail = rng.uniform(0, 1, (6, 4, 4, 4)).astype(np.float32)
    d = rng.standard_normal((50, 60, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jt.sample_cube_tail_matmul)(tail, d))
    got = tt.sample_cube_tail_matmul(T(tail), T(d))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_texture_transform_lod_and_face_uv():
    rng = np.random.default_rng(5)
    uv = rng.uniform(-2, 2, (300, 2)).astype(np.float32)
    os_ = rng.uniform(-1, 2, (300, 4)).astype(np.float32)
    rot = rng.uniform(-1, 1, (300, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jt.apply_texture_transform)(uv, os_, rot))
    np.testing.assert_allclose(tt.apply_texture_transform(T(uv), T(os_), T(rot)).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    dx, dy = (rng.standard_normal((300, 2)).astype(np.float32) * 0.01 for _ in range(2))
    bw, bh = (rng.choice([64, 128, 256], 300).astype(np.float32) for _ in range(2))
    want = np.asarray(jax.jit(jt.footprint_lod)(dx, dy, bw, bh))
    np.testing.assert_allclose(tt.footprint_lod(T(dx), T(dy), T(bw), T(bh)).numpy(), want,
                               rtol=0, atol=1e-5)
    d = rng.standard_normal((300, 3)).astype(np.float32)
    jf, juv = jax.jit(jt.cube_direction_to_face_uv)(d)
    tf, tuv = tt.cube_direction_to_face_uv(T(d))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tuv.numpy(), np.asarray(juv))
