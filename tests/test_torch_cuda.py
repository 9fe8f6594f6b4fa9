"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips (inside the ``cuda_device`` fixture, never
at import) when no CUDA device is present.  On a machine with an NVIDIA
GPU (which has no JAX, hence no conftest):
``python -m pytest --noconftest tests/test_torch_cuda.py -q``."""

import numpy as np
import pytest
import torch

from unclerenderer_tpu_torch.ops import _cuda
from unclerenderer_tpu_torch.ops import hzb as hzb_mod
from unclerenderer_tpu_torch.ops import probes
from unclerenderer_tpu_torch.ops import raster_kernels as rk
from unclerenderer_tpu_torch.ops import texture as tex_mod
from unclerenderer_tpu_torch.ops.binning import bin_triangles
from unclerenderer_tpu_torch.ops.raster import CULL_NONE, triangle_setup_from_components
from unclerenderer_tpu_torch.ops.shadow import select9, select9_ref
from unclerenderer_tpu_torch.ops.texture import gather_rows, gather_rows_ref

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _setup(n, seed, size, dev, w=256, h=256):
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    ctr[:, 2] = rng.uniform(0.1, 0.9, n)
    d1 = rng.normal(0, size, (n, 3)).astype(np.float32)
    d2 = rng.normal(0, size, (n, 3)).astype(np.float32)
    v = torch.from_numpy(np.stack([ctr - d1, ctr + d2, ctr + d1], 1)).to(dev)
    px = [(v[:, k, 0] * 0.5 + 0.5) * w for k in range(3)]
    py = [(0.5 - v[:, k, 1] * 0.5) * h for k in range(3)]
    pw = [torch.ones(n, device=dev) for _ in range(3)]
    return triangle_setup_from_components(
        px[0], py[0], pw[0], px[1], py[1], pw[1], px[2], py[2], pw[2],
        v[:, 0, 2], v[:, 1, 2], v[:, 2, 2], torch.ones(n, dtype=torch.bool, device=dev),
        CULL_NONE, w, h)


def _same(a, b):
    for x, y in zip(a, b):
        if x is None:
            assert y is None
        else:
            assert torch.equal(x, y)


@pytest.mark.parametrize("seed,n,size", [(0, 150, 0.04), (3, 40, 0.6), (5, 2000, 0.04)])
@pytest.mark.parametrize("want_ids,ortho", [(True, False), (False, True)])
def test_binned_raster_kernel_bit_equal(cuda_device, seed, n, size, want_ids, ortho):
    s = _setup(n, seed, size, cuda_device)
    bins = bin_triangles(s, 256, 256, 16, 64, 32)
    start, count = rk.tile_block_ranges(bins, 64)
    args = (bins.coef, bins.tri_id, bins.valid, start, count, 16, 64, 4, 0.0, want_ids, ortho)
    before = _cuda.LAUNCHES["binned_raster"]
    _same(rk.binned_raster(*args), rk.binned_raster_ref(*args))
    assert _cuda.LAUNCHES["binned_raster"] == before + 1


@pytest.mark.parametrize("tile", [(16, 64), (32, 256)])
@pytest.mark.parametrize("want_ids", [True, False])
def test_giant_raster_kernel_bit_equal(cuda_device, tile, want_ids):
    s = _setup(80, 2, 0.3, cuda_device)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rk, "giant_raster", rk.giant_raster_ref)
        want = rk.rasterize_giant(s, 256, 256, tile_h=tile[0], tile_w=tile[1], chunk=8,
                                  want_ids=want_ids)
    got = rk.rasterize_giant(s, 256, 256, tile_h=tile[0], tile_w=tile[1], chunk=8,
                             want_ids=want_ids)
    _same(got, want)


def test_rasterize_binned_kernels_match_plain(cuda_device):
    s = _setup(300, 7, 0.15, cuda_device)
    kw = dict(tile_h=16, tile_w=64, chunk=32, mid_divisor=2, giant_divisor=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rk, "giant_raster", rk.giant_raster_ref)
        mp.setattr(rk, "binned_raster", rk.binned_raster_ref)
        want = rk.rasterize_binned(s, 256, 256, **kw)
    got = rk.rasterize_binned(s, 256, 256, **kw)
    _same(got[:2], want[:2])


def test_select9_kernel_bit_equal(cuda_device):
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.integers(0, 65536, (4096, 128)).astype(np.uint16).view(np.int16))
    row = torch.from_numpy(rng.integers(0, 4096, 50000).astype(np.int32))
    base = torch.from_numpy(rng.integers(0, 78, 50000).astype(np.int32))
    deltas = tuple(dy * 10 + dx for dy in range(3) for dx in range(3))
    args = [t.to(cuda_device) for t in (table, row, base)]
    assert torch.equal(select9(*args, deltas), select9_ref(*args, deltas))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_rows_kernel_bit_equal(cuda_device, dtype):
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.standard_normal((342, 2)).astype(np.float32)).to(cuda_device, dtype)
    idx = torch.from_numpy(rng.integers(0, 342, 263184).astype(np.int32)).to(cuda_device)
    assert torch.equal(gather_rows(table, idx), gather_rows_ref(table, idx))


@pytest.mark.parametrize("shape", [(270, 480), (60, 34), (67, 31), (1, 1)])
def test_hzb_tail_kernel_bit_equal(cuda_device, shape):
    h, w = shape
    rng = np.random.default_rng(h * w)
    depth = rng.uniform(0.0, 1.0, (2 * h, 2 * w)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.3] = 0.0
    depth = torch.from_numpy(depth).to(cuda_device)
    layout, _ = hzb_mod.hzb_layout(w, h)
    before = _cuda.LAUNCHES["hzb_tail"]
    got = hzb_mod.build_hzb(depth, layout, pallas_tail=True)
    assert torch.equal(got, hzb_mod.build_hzb(depth, layout))
    assert _cuda.LAUNCHES["hzb_tail"] == before + (len(layout) > 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_env_select_kernel_bit_equal(cuda_device, dtype):
    rng = np.random.default_rng(2)
    n = 200_000
    env = torch.from_numpy(rng.uniform(0, 4, (2048, 128)).astype(np.float32)).to(cuda_device, dtype)
    rows = torch.from_numpy(rng.integers(0, 2048, n).astype(np.int32)).to(cuda_device)
    params9 = torch.from_numpy(np.concatenate([
        rng.random((5, n)), rng.integers(0, 2, (2, n)), rng.integers(-1, 3, (2, n)),
    ]).astype(np.float32)).to(cuda_device)
    got = tex_mod.env_select(env, rows, params9)
    assert torch.equal(got, tex_mod.env_select_ref(env, rows, params9))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32, torch.bfloat16])
def test_mat_select_kernel_bit_equal(cuda_device, dtype):
    rng = np.random.default_rng(3)
    n = 200_000
    atlas = torch.from_numpy(rng.integers(0, 256, (4096, 256), dtype=np.uint8)).to(cuda_device)
    if dtype != torch.uint8:
        atlas = (atlas.float() / 255.0).to(dtype)
    rows = torch.from_numpy(rng.integers(0, 4096, n).astype(np.int32)).to(cuda_device)
    params7 = torch.from_numpy(np.concatenate([
        rng.random((5, n)), rng.integers(0, 2, (2, n))]).astype(np.float32)).to(cuda_device)
    got = tex_mod.mat_select(atlas, rows, params7)
    assert torch.equal(got, tex_mod.mat_select_ref(atlas, rows, params7))


def test_packed_samplers_kernel_paths_match_plain_paths(cuda_device):
    """The packed material and env samplers with select_kernel on (K8, K7)
    against the same samplers with the plain kernel versions."""
    rng = np.random.default_rng(4)
    n = 50_000
    atlas = torch.from_numpy(rng.integers(0, 256, (64 * 128, 256), dtype=np.uint8)).to(cuda_device)
    rect = torch.tensor([[0.0, 0.0, 32.0, 32.0]], device=cuda_device).expand(n, 4)
    uv = torch.from_numpy(rng.uniform(-0.4, 1.6, (n, 2)).astype(np.float32)).to(cuda_device)
    lod = torch.from_numpy(rng.uniform(0.0, 4.5, n).astype(np.float32)).to(cuda_device)
    got = tex_mod.sample_pyramid_tri(atlas, 128, rect, uv, lod, select_kernel=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tex_mod, "mat_select", tex_mod.mat_select_ref)
        want = tex_mod.sample_pyramid_tri(atlas, 128, rect, uv, lod, select_kernel=True)
    assert torch.equal(got, want)
    env = torch.from_numpy(rng.uniform(0, 2, (64, 128, 128)).astype(np.float32)).to(
        cuda_device, torch.bfloat16).reshape(-1, 128)
    face_rect = torch.tensor([[f % 3 * 40, f // 3 * 20, 16, 16] for f in range(6)],
                             dtype=torch.float32, device=cuda_device)
    d = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).to(cuda_device)
    got = tex_mod.sample_cube_pyramid_tri(env, 128, face_rect, d, lod, select_kernel=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tex_mod, "env_select", tex_mod.env_select_ref)
        want = tex_mod.sample_cube_pyramid_tri(env, 128, face_rect, d, lod, select_kernel=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["aligned", "misaligned", "odd"])
def test_materialize_rows_kernel_bit_equal(cuda_device, case):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, 7936 * 64 + 1,
                                      dtype=np.int64).astype(np.int32)).to(cuda_device)
    x = {"aligned": x[:-1].reshape(7936, 64), "misaligned": x[1:1002],
         "odd": x[:37 * 5].reshape(37, 5)}[case]
    before = _cuda.LAUNCHES["materialize_rows"]
    got = rk.materialize_rows(x)
    assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()
    assert _cuda.LAUNCHES["materialize_rows"] == before + 1


def test_rasterize_binned_mat_idx_matches_plain(cuda_device):
    s = _setup(300, 7, 0.15, cuda_device)
    kw = dict(tile_h=16, tile_w=64, chunk=32, mid_divisor=2, giant_divisor=4)
    before = _cuda.LAUNCHES["materialize_rows"]
    got = rk.rasterize_binned(s, 256, 256, mat_idx=True, **kw)
    assert _cuda.LAUNCHES["materialize_rows"] == before + 2
    want = rk.rasterize_binned(s, 256, 256, **kw)
    _same(got[:2], want[:2])


def test_wrapper_rejects_bad_input(cuda_device):
    table = torch.zeros((4, 2), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError):
        gather_rows(table, torch.zeros(3, dtype=torch.int32, device=cuda_device))
    idx = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # u8 decode needs C = 16
        tex_mod.mat_select(torch.zeros((4, 64), dtype=torch.uint8, device=cuda_device), idx,
                           torch.zeros((7, 3), device=cuda_device))
    with pytest.raises(ValueError):  # params9 shape
        tex_mod.env_select(torch.zeros((4, 128), device=cuda_device), idx,
                           torch.zeros((7, 3), device=cuda_device))
    with pytest.raises(ValueError):
        rk.materialize_rows(torch.zeros(8, dtype=torch.int64, device=cuda_device))


def _merge_inputs(n, seed, case):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 20, n).astype(np.int32)
    b = rng.integers(0, 1 << 20, n).astype(np.int32)
    if case == "special":
        special = np.array([np.nan, 0.0, -0.0, 1.0, -1.0, np.inf, -np.inf], np.float32)
        ka, kb = rng.choice(special, n), rng.choice(special, n)
    else:
        ka, kb = rng.standard_normal(n), rng.standard_normal(n)
        if case == "equal":
            kb = np.where(rng.random(n) < 0.5, ka, kb)
    return [torch.from_numpy(x) for x in (a, b, ka.astype(np.float32), kb.astype(np.float32))]


@pytest.mark.parametrize("case", ["random", "special", "equal"])
@pytest.mark.parametrize("layout", ["image", "odd", "misaligned"])
def test_merge_select_kernel_bit_equal(cuda_device, case, layout):
    n = {"image": 1080 * 1920, "odd": 1001, "misaligned": 4097}[layout]
    a, b, ka, kb = (t.to(cuda_device) for t in _merge_inputs(n, 6, case))
    if layout == "image":
        a, b, ka, kb = (t.reshape(1080, 1920) for t in (a, b, ka, kb))
    elif layout == "misaligned":  # views 4 bytes past a 16-byte boundary
        a, b, ka, kb = (t[1:] for t in (a, b, ka, kb))
    before = _cuda.LAUNCHES["merge_select"]
    got = probes.merge_select(a, b, ka, kb)
    assert torch.equal(got, probes.merge_select_ref(a, b, ka, kb))
    assert _cuda.LAUNCHES["merge_select"] == before + 1


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32, torch.float32,
                                   torch.int64])
@pytest.mark.parametrize("case", ["aligned", "misaligned", "odd"])
def test_copy_kernels_bit_equal(cuda_device, dtype, case):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(0, 256, 8 * 4100 * 16, dtype=np.uint8)).to(cuda_device)
    x = x.view(dtype)
    x = {"aligned": x[: 4096 * 16].reshape(4096, 16), "misaligned": x[1:1 + 999 * 8].reshape(999, 8),
         "odd": x[: 37 * 5].reshape(37, 5)}[case]
    for name, fn, ref in (("copy_rows", probes.copy_rows, probes.copy_rows_ref),
                          ("materialize", probes.materialize, probes.materialize_ref)):
        before = _cuda.LAUNCHES[name]
        got = fn(x)
        # bytes, not values: random float bits hold NaNs
        assert torch.equal(got.reshape(-1).view(torch.uint8), ref(x).reshape(-1).view(torch.uint8))
        assert got.shape == x.shape and got.dtype == x.dtype and got.data_ptr() != x.data_ptr()
        assert _cuda.LAUNCHES[name] == before + 1


def test_probe_rows_kernel_paths_match_plain(cuda_device):
    """The probe rows with K10-K12 on the card against the same rows with
    the plain versions, at small shapes: every output bit-equal."""
    rng = np.random.default_rng(8)
    tc = 5000
    rec = torch.from_numpy(rng.standard_normal((tc, 128)).astype(np.float32)).to(cuda_device)
    a, b, ka, kb = (t.reshape(96, 160).to(cuda_device) for t in _merge_inputs(96 * 160, 9, "random"))
    a, b = a % tc, b % tc
    table = torch.from_numpy(rng.integers(0, 255, (8192, 256)).astype(np.uint8)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(0, 8192, 30001).astype(np.int32)).to(cuda_device)
    fx, fy = (torch.from_numpy(rng.random((30001, 1), np.float32)).to(cuda_device) for _ in "xy")
    setup = _setup(2000, 10, 0.04, cuda_device)
    rows = [
        lambda: probes.rec_pmerge(rec, a, b, ka, kb),
        lambda: probes.rec_mat(rec, a, b, ka, kb),
        lambda: probes.tap_copy_blend_i32(table, idx, fx, fy),
        lambda: probes.tap_copy_blend_f32(table, idx, fx, fy),
        lambda: probes.align_materialize_gather(setup, 256, 256, 16, 64, 32, 3.0),
    ]
    got = [row() for row in rows]
    with pytest.MonkeyPatch.context() as mp:
        for name in ("merge_select", "copy_rows", "materialize"):
            mp.setattr(probes, name, getattr(probes, f"{name}_ref"))
        want = [row() for row in rows]
    for g, w in zip(got, want):
        _same(g if isinstance(g, tuple) else (g,), w if isinstance(w, tuple) else (w,))
