"""Port vs reference: u16 superblock packing, the plain version of K4
(PCF neighbourhood fetch) and the deferred PCF factor -- all bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unclerenderer_tpu.ops import shadow as js
from unclerenderer_tpu_torch.ops import shadow as ts

LVP = np.array([[0.15, 0.0, 0.0, 0.0],
                [0.0, -0.15, 0.02, 0.0],
                [0.01, 0.02, 0.08, 0.0],
                [0.0, 0.0, 0.55, 1.0]], np.float32)


def _map(size, seed):
    return np.random.default_rng(seed).uniform(0.3, 1.0, (size, size)).astype(np.float32)


def _port_table(jtable):
    return torch.from_numpy(np.asarray(jtable).view(np.int16).copy())


@pytest.mark.parametrize("size", [64, 256, 2048])
def test_pack_shadow_blocks_u16_bit_equal(size):
    sm = _map(size, size)
    sm[::7, ::5] = 1.5   # clipped to 65535 like the border
    sm[::11, ::3] = -0.2  # clipped to 0
    want = np.asarray(jax.jit(js.pack_shadow_blocks_u16)(sm))
    got = ts.pack_shadow_blocks_u16(torch.from_numpy(sm)).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


def test_select9_plain_matches_pallas_kernel():
    rng = np.random.default_rng(0)
    table = rng.integers(0, 65536, (4096, 128)).astype(np.uint16)
    n = 5000  # not a multiple of the reference's 1024-pixel blocks
    row = rng.integers(0, 4096, n).astype(np.int32)
    base = rng.integers(0, 78, n).astype(np.int32)
    deltas = tuple(dy * 10 + dx for dy in range(3) for dx in range(3))
    want = np.asarray(js._select9_fetch(jnp.asarray(table), jnp.asarray(row), jnp.asarray(base),
                                        deltas, interpret=True))
    got = ts.select9_ref(torch.from_numpy(table.view(np.int16)), torch.from_numpy(row),
                         torch.from_numpy(base), deltas)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ts.select9(torch.from_numpy(table.view(np.int16)),
                                             torch.from_numpy(row), torch.from_numpy(base),
                                             deltas).numpy(), want)


@pytest.mark.parametrize("size", [256, 4096])
def test_shadow_factor_blocks_bit_equal(size):
    """Receivers over and beyond the map (border behaviour included), in the
    pattern of tests/test_pallas_kernels.py::test_shadow_blocks_matches_reference,
    on the u16 table the frame uses."""
    rng = np.random.default_rng(3)
    sm = _map(size, 3)
    world = rng.uniform(-8.0, 8.0, (64, 96, 3)).astype(np.float32)
    table = jax.jit(js.pack_shadow_blocks_u16)(sm)
    want = np.asarray(jax.jit(
        lambda t, w, l: js.shadow_factor_blocks(t, size, w, l, jnp.float32(0.9), jnp.float32(2e-3),
                                                interpret=True))(table, world, LVP))
    got = ts.shadow_factor_blocks(_port_table(table), size, torch.from_numpy(world),
                                  torch.from_numpy(LVP), torch.tensor(0.9), torch.tensor(2e-3))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.0 < float(got.mean()) < 1.0


def test_shadow_project_bit_equal():
    world = np.random.default_rng(5).uniform(-8.0, 8.0, (40, 50, 3)).astype(np.float32)
    want = jax.jit(lambda w, l: js._shadow_project(w, l, 512, jnp.float32(2e-3)))(world, LVP)
    got = ts._shadow_project(torch.from_numpy(world), torch.from_numpy(LVP), 512, torch.tensor(2e-3))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
