"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips (inside the ``cuda_device`` fixture, never
at import) when no CUDA device is present.  On a machine with an NVIDIA
GPU (which has no JAX, hence no conftest):
``python -m pytest --noconftest tests/test_torch_cuda.py -q``."""

import contextlib
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from unclerenderer_tpu_torch.ops import _cuda
from unclerenderer_tpu_torch.ops import hzb as hzb_mod
from unclerenderer_tpu_torch.ops import probes
from unclerenderer_tpu_torch.ops import raster_kernels as rk
from unclerenderer_tpu_torch.ops import texture as tex_mod
from unclerenderer_tpu_torch.ops.binning import bin_triangles
from unclerenderer_tpu_torch.ops.raster import (
    CULL_NONE,
    normalize_ortho_setup,
    rasterize,
    triangle_setup_from_components,
)
from unclerenderer_tpu_torch.ops.shadow import pcf_deltas, select9, select9_ref
from unclerenderer_tpu_torch.ops.texture import gather_rows, gather_rows_ref

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    _renew_cupti(dev)
    return dev


def _renew_cupti(dev):
    """One profiler trace that tears CUPTI down at its end, and CUPTI kept
    alive after it (``TEARDOWN_CUPTI=0``, as the profiler itself sets it
    for CUDA graphs).  On the card's machine a trace that follows another
    one's teardown may record none of its device rows, and a trace of
    rows it did not launch (a fill kernel of earlier work); after this,
    each trace of ``_kernels_launched`` holds its own launches' rows."""
    from torch.profiler import ProfilerActivity, profile

    os.environ["TEARDOWN_CUPTI"] = "1"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
    os.environ["TEARDOWN_CUPTI"] = "0"


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


@pytest.mark.parametrize("chunk", [66, 256, 512])
@pytest.mark.parametrize("want_ids,ortho", [(True, False), (False, True)])
def test_binned_raster_fitted_chunks_bit_equal(cuda_device, chunk, want_ids, ortho):
    """K1 at chunks it takes after ``fit_binned_blocks``: bit-equal to the
    plain version on the raw inputs, one launch."""
    s = _setup(2000, 5, 0.04, cuda_device)
    if ortho:
        s = normalize_ortho_setup(s)
    bins = bin_triangles(s, 256, 256, 16, 64, chunk)
    start, count = rk.tile_block_ranges(bins, 64)
    args = (bins.coef, bins.tri_id, bins.valid, start, count, 16, 64, 4, 0.0, want_ids, ortho)
    before = _cuda.LAUNCHES["binned_raster"]
    _same(rk.binned_raster(*args), rk.binned_raster_ref(*args))
    assert _cuda.LAUNCHES["binned_raster"] == before + 1


@pytest.mark.parametrize("chunk", [66, 256, 512])
@pytest.mark.parametrize("want_ids,ids", [(True, True), (True, False), (False, False)])
def test_giant_raster_fitted_chunks_bit_equal(cuda_device, chunk, want_ids, ids):
    """K2 at chunks up to one window and past it (``fit_giant_chunks``):
    bit-equal to the plain version on the raw inputs, one launch."""
    s = _setup(1100, 2, 0.3, cuda_device)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rk, "giant_raster", lambda *a: calls.append(a) or rk.giant_raster_ref(*a))
        rk.rasterize_giant(s, 256, 256, tile_h=32, tile_w=256, chunk=chunk, want_ids=want_ids,
                           ids=torch.arange(1100, device=cuda_device) * 2 + 5 if ids else None)
    (args,) = calls
    before = _cuda.LAUNCHES["giant_raster"]
    _same(rk.giant_raster(*args), rk.giant_raster_ref(*args))
    assert _cuda.LAUNCHES["giant_raster"] == before + 1


def _x1_setup(case, n, seed, size, dev):
    """X1's test tables: (setup, width, height).  ``random``: the random
    triangles on a 256 x 200 image; ``ground``: with a ground plane (two
    rows whose boxes span every band and column) in the middle of the
    table; ``empty_band``: every triangle above row 96 and below row 160,
    so the bands between hold no row; ``map``: a 4096-row-tall map's tile
    grid at small T."""
    if case == "map":
        return _setup(n, seed, size, dev, w=4096, h=4096), 4096, 4096
    s = _setup(n, seed, size, dev, w=256, h=200)
    if case == "ground":  # two triangles past every edge of the image
        px = torch.tensor([[-1e3, 3e3, -1e3], [3e3, 3e3, -1e3]], device=dev)
        py = torch.tensor([[-1e3, -1e3, 3e3], [-1e3, 3e3, 3e3]], device=dev)
        one, z = torch.ones(2, device=dev), torch.full((2,), 0.95, device=dev)
        g = triangle_setup_from_components(
            px[:, 0], py[:, 0], one, px[:, 1], py[:, 1], one, px[:, 2], py[:, 2], one, z, z, z,
            torch.ones(2, dtype=torch.bool, device=dev), CULL_NONE, 256, 200)
        half = n // 2
        s = type(s)(coef=torch.cat([s.coef[:half], g.coef, s.coef[half:]]),
                    valid=torch.cat([s.valid[:half], g.valid, s.valid[half:]]),
                    bbox=torch.cat([s.bbox[:, :half], g.bbox, s.bbox[:, half:]], 1))
        assert bool(((s.bbox[1] <= 0) & (s.bbox[3] >= 199) & (s.bbox[0] <= 0)
                     & (s.bbox[2] >= 255)).any())
    if case == "empty_band":
        keep = (s.bbox[3] < 96) | (s.bbox[1] > 160)
        s = type(s)(coef=s.coef[keep].contiguous(), valid=s.valid[keep],
                    bbox=s.bbox[:, keep].contiguous())
    return s, 256, 200


X1_CASES = [("random", 0, 150, 0.04), ("random", 3, 40, 0.6), ("random", 5, 2000, 0.04),
            ("ground", 1, 600, 0.04), ("empty_band", 4, 700, 0.04), ("map", 6, 300, 0.02)]


@pytest.mark.parametrize("case,seed,n,size", X1_CASES)
@pytest.mark.parametrize("depth_mode", [0, 1])
@pytest.mark.parametrize("want_ids,ortho", [(True, False), (False, False), (False, True)])
@pytest.mark.parametrize("tile,y_offset", [((16, 64), 0.0), ((32, 128), 48.0), ((24, 36), 0.0),
                                           ((6, 10), 48.0)])
def test_exhaustive_raster_kernel_bit_equal(cuda_device, case, seed, n, size, depth_mode,
                                            want_ids, ortho, tile, y_offset):
    """X1 against its plain version (``ops/raster.py rasterize``) on the
    random setups, a ground plane spanning every band, an empty band and a
    4096-row-tall map grid, both depth modes, ids on and off,
    ortho-normalized, the frame's tiles and partial warp rectangles, and a
    row offset; one wrapper call (the mask and tile launches) a call."""
    s, w, h = _x1_setup(case, n, seed, size, cuda_device)
    if ortho:
        s = normalize_ortho_setup(s)
    kw = dict(tile_h=tile[0], tile_w=tile[1], depth_mode=depth_mode, y_offset=y_offset,
              want_ids=want_ids, ortho=ortho)
    before = _cuda.LAUNCHES["exhaustive_raster"]
    got = rk.rasterize_exhaustive(s, w, h, **kw)
    assert _cuda.LAUNCHES["exhaustive_raster"] == before + 1
    _same(got, rasterize(s, w, h, chunk=64, **kw))


@pytest.mark.parametrize("case,seed,n,size", X1_CASES + [("random", 7, 77, 0.1),
                                                          ("random", 8, 0, 0.1)])
@pytest.mark.parametrize("tile,y_offset", [((16, 64), 0.0), ((32, 128), 37.25), ((6, 10), 48.0)])
def test_exhaustive_raster_masks_equal_plain(cuda_device, case, seed, n, size, tile, y_offset):
    """The kernel's band and column masks (its scratch) equal
    ``band_masks_plain`` and ``column_masks_plain`` word for word (T of no
    multiple of 32 and T = 0 included), and the kernel launches exactly
    its mask and tile kernels."""
    s, w, h = _x1_setup(case, n, seed, size, cuda_device)
    got = []
    names = _kernels_launched(lambda: got.append(rk.rasterize_exhaustive(
        s, w, h, tile_h=tile[0], tile_w=tile[1], y_offset=y_offset, want_masks=True)))
    want = torch.cat([rk.band_masks_plain(s, h, tile[0], y_offset),
                      rk.column_masks_plain(s, w, tile[1])])
    assert torch.equal(got[0][2], want)
    want_names = ["exhaustive_masks", "exhaustive_raster_kernel"][0 if n else 1:]
    assert len(names) == len(want_names) and all(
        k in x for k, x in zip(want_names, names)), names


def test_rasterize_binned_kernels_match_plain(cuda_device):
    s = _setup(300, 7, 0.15, cuda_device)
    kw = dict(tile_h=16, tile_w=64, chunk=32, mid_divisor=2, giant_divisor=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rk, "giant_raster", rk.giant_raster_ref)
        mp.setattr(rk, "binned_raster", rk.binned_raster_ref)
        want = rk.rasterize_binned(s, 256, 256, **kw)
    got = rk.rasterize_binned(s, 256, 256, **kw)
    _same(got[:2], want[:2])


# receiver counts: one, under and over a warp, the frame's kind of count
# (no multiple of a block or of 4), and one past a power of two
@pytest.mark.parametrize("n", [1, 31, 33, 50000, 2**20 + 3])
@pytest.mark.parametrize("bw", [4, 5, 6, 7, 8])  # ops/shadow.py shadow_block_shape's range
def test_select9_kernel_bit_equal(cuda_device, bw, n):
    rng = np.random.default_rng(bw * n)
    deltas = pcf_deltas(bw)
    table = torch.from_numpy(rng.integers(0, 65536, (4096, 128)).astype(np.uint16).view(np.int16))
    row = torch.from_numpy(rng.integers(0, 4096, n).astype(np.int32))
    base = torch.from_numpy(rng.integers(0, 128 - deltas[-1], n).astype(np.int32))
    row[-1], base[-1] = 4095, 127 - deltas[-1]  # the 3x3 ends on the table's last lane
    args = [t.to(cuda_device) for t in (table, row, base)]
    before = _cuda.LAUNCHES["shadow_select9"]
    assert torch.equal(select9(*args, deltas), select9_ref(*args, deltas))
    assert _cuda.LAUNCHES["shadow_select9"] == before + 1


@pytest.mark.parametrize("n", [1, 31, 33, 50000, 2**20 + 3])
@pytest.mark.parametrize("bw", [4, 5, 6, 7, 8])
def test_select9_f32_kernel_bit_equal(cuda_device, bw, n):
    """K4 on f32 rows (shadow_table_u16=False): bit patterns equal to the
    plain version's, -0 read as +0, inf kept, runs at every lane offset
    mod 4 and the table's last lane."""
    rng = np.random.default_rng(bw * n + 1)
    deltas = pcf_deltas(bw)
    table = rng.standard_normal((4096, 128)).astype(np.float32)
    table.reshape(-1)[::13] = -0.0
    table.reshape(-1)[3::29] = np.inf
    row = torch.from_numpy(rng.integers(0, 4096, n).astype(np.int32))
    base = torch.from_numpy(rng.integers(0, 128 - deltas[-1], n).astype(np.int32))
    row[-1], base[-1] = 4095, 127 - deltas[-1]
    args = [t.to(cuda_device) for t in (torch.from_numpy(table), row, base)]
    before = dict(_cuda.LAUNCHES)
    got = select9(*args, deltas)
    assert torch.equal(got.view(torch.int32), select9_ref(*args, deltas).view(torch.int32))
    assert _cuda.LAUNCHES["shadow_select9_f32"] == before["shadow_select9_f32"] + 1
    assert _cuda.LAUNCHES["shadow_select9"] == before["shadow_select9"]


def test_binned_raster_debug_prints_each_live_block(cuda_device):
    """K1 with debug: keys and ids those of the launch without, and (in a
    subprocess: device printf writes to the process's fd 1) one line per
    live block, the plain version's lines, also at a chunk the wrapper
    recuts (the pre-recut block numbers)."""
    import subprocess
    import sys
    from pathlib import Path

    s = _setup(2000, 5, 0.04, cuda_device)
    for chunk in (32, 256):
        bins = bin_triangles(s, 256, 256, 16, 64, chunk)
        start, count = rk.tile_block_ranges(bins, 64)
        a = (bins.coef, bins.tri_id, bins.valid, start, count, 16, 64, 4)
        _same(rk.binned_raster(*a, debug=True), rk.binned_raster(*a))
    torch.cuda.synchronize()
    code = (
        "import collections, torch, numpy as np\n"
        "from unclerenderer_tpu_torch.ops import raster_kernels as rk\n"
        "from unclerenderer_tpu_torch.ops.binning import bin_triangles\n"
        "import test_torch_cuda as t\n"
        "s = t._setup(2000, 5, 0.04, torch.device('cuda', 0))\n"
        "for chunk in (32, 256):\n"
        "    bins = bin_triangles(s, 256, 256, 16, 64, chunk)\n"
        "    start, count = rk.tile_block_ranges(bins, 64)\n"
        "    rk.binned_raster(bins.coef, bins.tri_id, bins.valid, start, count, 16, 64, 4,\n"
        "                     debug=True)\n"
        "    torch.cuda.synchronize()\n"
        "    print('want', chunk, len(rk.debug_lines(start, count)), flush=True)\n"
        "    for line in rk.debug_lines(start.cpu(), count.cpu()):\n"
        "        print('ref', line, flush=True)\n"
    )
    here = Path(__file__).resolve().parent
    res = subprocess.run([sys.executable, "-c", code], cwd=here.parent, capture_output=True,
                         text=True, timeout=300,
                         env={**__import__("os").environ,
                              "PYTHONPATH": f"{here}:{here.parent}"})
    assert res.returncode == 0, res.stderr[-2000:]
    out = res.stdout.splitlines()
    dev = sorted(ln for ln in out if ln.startswith("binned raster"))
    ref = sorted(ln[4:] for ln in out if ln.startswith("ref binned raster"))
    assert dev == ref and len(dev) > 100


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


# tops with a side of 1, odd sides, one tile and less, the 1080p top, tops
# past a tile row or column, and one whose levels outgrow the finishing
# block's shared buffers
HZB_TOPS = [(1, 1), (1, 7), (3, 1), (1, 300), (300, 1), (5, 9), (31, 63), (135, 240),
            (270, 480), (541, 961), (1080, 1920), (4100, 4100)]


def _hzb_top(shape, levels=None):
    h, w = shape
    top = np.random.default_rng(h * 7 + w).uniform(0.0, 1.0, (h, w)).astype(np.float32)
    top[np.random.default_rng(w).random((h, w)) < 0.2] = 0.0
    n = len(hzb_mod.hzb_layout(max(1, w // 2), max(1, h // 2))[0]) if levels is None else levels
    return torch.from_numpy(top), list(hzb_mod.tail_dims(h, w, n))


@pytest.mark.parametrize("shape", HZB_TOPS)
def test_hzb_tail_tops_bit_equal_one_launch(cuda_device, shape):
    """K6 at every level count of a top: bit-equal to the plain version, one
    kernel launch a call."""
    top, dims = _hzb_top(shape)
    top = top.to(cuda_device)
    for n in sorted({1, 2, len(dims) // 2 + 1, len(dims)}):
        before = _cuda.LAUNCHES["hzb_tail"]
        got = []
        names = _kernels_launched(lambda: got.append(hzb_mod.hzb_tail(top, dims[:n])))
        assert torch.equal(got[0], hzb_mod.hzb_tail_ref(top, dims[:n])), n
        assert _cuda.LAUNCHES["hzb_tail"] == before + len(got)
        assert len(names) == 1 and "hzb_tail" in names[0], names


@pytest.mark.parametrize("shape", [(270, 480), (541, 961), (7, 5)])
def test_hzb_tail_back_to_back_and_graph_replays(cuda_device, shape):
    """The ticket counter is back at 0 after every launch: three launches in
    a row and 10 replays of one CUDA graph (on new inputs) stay bit-equal."""
    top, dims = _hzb_top(shape)
    top = top.to(cuda_device)
    want = hzb_mod.hzb_tail_ref(top, dims)
    outs = [hzb_mod.hzb_tail(top, dims) for _ in range(3)]
    assert all(torch.equal(o, want) for o in outs)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = hzb_mod.hzb_tail(top, dims)
    for k in range(10):
        top.copy_(torch.roll(top, k + 1, dims=1))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, hzb_mod.hzb_tail_ref(top, dims)), k


@pytest.mark.parametrize("dims", [[(240, 134)], [(240, 135), (121, 67)], [(480, 270)],
                                  [(240, 135)] * 2, []])
def test_hzb_tail_refuses_other_levels(cuda_device, dims):
    top = torch.zeros((270, 480), device=cuda_device)
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="halving"):
        hzb_mod.hzb_tail(top, dims)
    assert _cuda.LAUNCHES == before


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


@pytest.mark.parametrize("n", [1, 31, 33, 200_000, 2**20 + 3])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32, torch.bfloat16])
def test_mat_select_kernel_bit_equal(cuda_device, dtype, n):
    rng = np.random.default_rng(3 + n)
    atlas = torch.from_numpy(rng.integers(0, 256, (4096, 256), dtype=np.uint8)).to(cuda_device)
    if dtype != torch.uint8:
        atlas = (atlas.float() / 255.0).to(dtype)
    rows = torch.from_numpy(rng.integers(0, 4096, n).astype(np.int32)).to(cuda_device)
    rows[-1] = 4095  # the atlas's last row
    params7 = torch.from_numpy(np.concatenate([
        rng.random((5, n)), rng.integers(0, 2, (2, n))]).astype(np.float32)).to(cuda_device)
    before = _cuda.LAUNCHES["mat_select"]
    got = tex_mod.mat_select(atlas, rows, params7)
    assert _cuda.LAUNCHES["mat_select"] == before + 1
    assert torch.equal(got, tex_mod.mat_select_ref(atlas, rows, params7))


@pytest.mark.parametrize("case", ["atlas_u8", "atlas_f32", "table", "params_view"])
def test_select_kernels_take_aligned_views_only(cuda_device, case):
    """K8's atlas and K4's table are read with vector loads: a view off a
    16-byte boundary is refused (ValueError, no launch); K8's params7 and
    rows_idx take scalar loads, so a params7 view 4 bytes off is fine."""
    rng = np.random.default_rng(9)
    n = 1001
    rows = torch.from_numpy(rng.integers(0, 64, n).astype(np.int32)).to(cuda_device)
    flat = torch.from_numpy(np.concatenate([
        rng.random(1), rng.random((5, n)).ravel(), rng.integers(0, 2, 2 * n)]).astype(np.float32))
    params7 = flat.to(cuda_device)[1:].view(7, n)
    atlas = torch.from_numpy(rng.integers(0, 256, 64 * 256 + 16, dtype=np.uint8)).to(cuda_device)
    before = dict(_cuda.LAUNCHES)
    if case == "params_view":
        atlas = atlas[:64 * 256].view(64, 256)
        assert params7.data_ptr() % 16 == 4
        got = tex_mod.mat_select(atlas, rows, params7)
        assert torch.equal(got, tex_mod.mat_select_ref(atlas, rows, params7))
        return
    with pytest.raises(ValueError, match="aligned"):
        if case == "table":
            table = torch.zeros(16 * 128 + 1, dtype=torch.int16, device=cuda_device)[1:]
            select9(table.view(16, 128), rows % 16, rows % 10, pcf_deltas(8))
        else:
            a = atlas[1:1 + 64 * 256].view(64, 256)
            if case == "atlas_f32":
                a = torch.zeros(64 * 256 + 1, device=cuda_device)[1:].view(64, 256)
            tex_mod.mat_select(a, rows, params7.contiguous())
    assert _cuda.LAUNCHES == before


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


_WINDOW = "kernels_launched_window"


def _kernels_launched(fn, attempts=5):
    """Names of the device rows (kernels, copies, fills) that one call of
    ``fn`` launches, in the order they ran, from a ``torch.profiler``
    trace: the rows whose launch -- the CUDA API call of the same
    correlation id -- lies on this thread inside a range around ``fn``.
    Rows of other work that the trace also holds are not the call's.  A
    trace that misses the row of a launch inside the range (the profiler
    drops rows now and then) is taken again, so ``fn`` may run more than
    once, CUPTI renewed before each retry (``_renew_cupti``); no complete
    trace in ``attempts`` fails the test."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, record_function

    from unclerenderer_tpu_torch.core.traceparse import load_events

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(_WINDOW):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            names = _window_rows(load_events(path))
        if names:
            return names
        _renew_cupti(torch.device("cuda", torch.cuda.current_device()))
    pytest.fail(f"no complete profiler trace of the call in {attempts} attempts")


def _window_rows(events):
    """Names of a Chrome trace's device rows whose launch lies inside the
    ``_WINDOW`` range on the range's thread, in the order they ran; [] if
    a launch there (a kernel launch, copy or fill call) has no row."""
    from unclerenderer_tpu_torch.core.traceparse import DEVICE_CATS, LAUNCH_CATS

    spans = [e for e in events if e.get("ph") == "X"]
    window = [e for e in spans if e.get("cat") == "user_annotation" and e.get("name") == _WINDOW]
    if len(window) != 1:
        return []
    w = window[0]
    t0, t1 = float(w["ts"]), float(w["ts"]) + float(w.get("dur", 0))
    inside = {(e.get("args") or {}).get("correlation"): e for e in spans
              if e.get("cat") in LAUNCH_CATS and (e.get("pid"), e.get("tid")) == (
                  w.get("pid"), w.get("tid")) and t0 <= float(e["ts"]) <= t1}
    rows = sorted((float(e["ts"]), (e.get("args") or {}).get("correlation"), str(e.get("name", "")))
                  for e in spans if e.get("cat") in DEVICE_CATS
                  and (e.get("args") or {}).get("correlation") in inside)
    launched = {c for c, e in inside.items()
                if any(k in str(e.get("name", "")) for k in ("Launch", "Memcpy", "Memset"))}
    if not launched <= {c for _, c, _ in rows}:
        return []
    return [name for _, _, name in rows]


# (rows, C): the frame's draw-mask table, the other widths of the vector
# kernel, a width for the one-row-per-thread kernel, and tables past 48 KB
# (f32 at C = 2, both types at C = 5), all read from device memory
@pytest.mark.parametrize("rows,c", [(342, 2), (342, 1), (342, 3), (342, 4), (342, 5),
                                    (8192, 2), (8192, 5)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["ragged", "misaligned", "odd", "table_view"])
def test_gather_rows_variants_bit_equal_one_launch(cuda_device, rows, c, dtype, case):
    rng = np.random.default_rng(rows * c)
    flat = torch.from_numpy(rng.standard_normal(rows * c + 1).astype(np.float32))
    flat = flat.to(cuda_device, dtype)
    # a table view one element past a 16-byte boundary
    table = (flat[1:] if case == "table_view" else flat[:-1]).view(rows, c)
    idx = torch.from_numpy(rng.integers(0, rows, 263_187).astype(np.int32)).to(cuda_device)
    idx = {"misaligned": idx[1:], "odd": idx[:1001]}.get(case, idx)  # n mod 4 = 2, 1; else 3
    before = _cuda.LAUNCHES["gather_rows"]
    got = []
    names = _kernels_launched(lambda: got.append(gather_rows(table, idx)))
    assert torch.equal(got[0], gather_rows_ref(table, idx))
    assert _cuda.LAUNCHES["gather_rows"] == before + len(got)
    assert len(names) == 1 and ("gather_vec" if c <= 4 else "gather_row") in names[0], names


@pytest.mark.parametrize("offset", [0, 1, 2, 4, 8])  # 16-, 1-, 2-, 4-, 8-byte words
@pytest.mark.parametrize("tail", [0, 7, 13])
def test_copy_kernel_large_one_launch(cuda_device, offset, tail):
    """24 MB at every word width (a grid of up to 6,144 blocks, more than
    the card holds at once) with a byte tail: bit-equal, one launch."""
    rng = np.random.default_rng(offset * 16 + tail)
    raw = torch.from_numpy(rng.integers(0, 256, 24 * 2**20 + 16 + tail, dtype=np.uint8))
    x = raw.to(cuda_device)[offset:offset + 24 * 2**20 + tail]
    for name, fn in (("copy_rows", lambda: probes.copy_rows(x.reshape(1, -1))),
                     ("materialize", lambda: probes.materialize(x))):
        before = _cuda.LAUNCHES[name]
        got = []
        names = _kernels_launched(lambda: got.append(fn()))
        assert torch.equal(got[0].reshape(-1), x)
        assert _cuda.LAUNCHES[name] == before + len(got)
        assert len(names) == 1 and "copy_words" in names[0], names


@pytest.mark.parametrize("case", ["aligned", "misaligned", "odd"])
def test_copy_kernels_launch_once(cuda_device, case):
    x = torch.arange(8 * 4100 * 4, dtype=torch.int32, device=cuda_device)
    x = {"aligned": x[: 4096 * 16].reshape(4096, 16),
         "misaligned": x[1:1 + 999 * 8].reshape(999, 8),
         "odd": x[: 37 * 5].reshape(37, 5)}[case]
    for fn in (rk.materialize_rows, probes.copy_rows, probes.materialize):
        names = _kernels_launched(lambda: fn(x))
        assert len(names) == 1 and "copy_words" in names[0], names


def test_launch_follows_the_current_stream_and_graph_capture(cuda_device):
    """The raw stream of each launch is PyTorch's current stream: a side
    stream, and a CUDA graph's capture stream (replayed equal)."""
    x = torch.arange(1 << 16, dtype=torch.int32, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = probes.materialize(x)
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(y, x)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        z = probes.materialize(x)
    x.add_(1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(z, x)


def _tris_setup(v, dev, w=256, h=256):
    """Setup of triangles given as (n, 3, 3) pixel x, y and depth z."""
    v = torch.from_numpy(np.asarray(v, np.float32)).to(dev)
    n = v.shape[0]
    one = torch.ones(n, device=dev)
    return triangle_setup_from_components(
        v[:, 0, 0], v[:, 0, 1], one, v[:, 1, 0], v[:, 1, 1], one, v[:, 2, 0], v[:, 2, 1], one,
        v[:, 0, 2], v[:, 1, 2], v[:, 2, 2], torch.ones(n, dtype=torch.bool, device=dev),
        CULL_NONE, w, h)


def _raster_case(case, dev, big=False):
    """(setup, y_offset) of a K1/K2 card case.

    random     -- the reference tests' random triangles;
    coplanar   -- 70 copies of a small and 20 of a giant triangle among
                  others: equal keys with different ids within one bin
                  block, across the blocks of a tile and across giant chunks;
    busy_tile  -- 900 tiny triangles in one tile, a few elsewhere: most
                  tiles have no block, one has many times the mean;
    windows    -- (K2) 2,100 large triangles: more live rows than one
                  staged window and more chunks than one scan pass;
    y_offset   -- random triangles rastered as a slab starting at row 40."""
    rng = np.random.default_rng(21)
    if case == "random":
        return _setup(1500 if not big else 80, 5, 0.04 if not big else 0.3, dev), 0.0
    if case == "y_offset":
        return _setup(600 if not big else 80, 6, 0.06 if not big else 0.3, dev), 40.0
    if case == "coplanar":
        small = [[70.0, 66.0, 0.5], [82.0, 66.0, 0.5], [70.0, 78.0, 0.5]]  # in one fine tile
        giant = [[0.0, 0.0, 0.7], [250.0, 0.0, 0.7], [0.0, 250.0, 0.7]]
        other = rng.uniform(10.0, 240.0, (40, 1, 3)) + rng.normal(0.0, 8.0, (40, 3, 3))
        other[..., 2] = rng.uniform(0.2, 0.9, (40, 3))
        v = np.concatenate([other[:20], np.tile(small, (70, 1, 1)), np.tile(giant, (20, 1, 1)),
                            other[20:]])
        return _tris_setup(v, dev), 0.0
    if case == "busy_tile":
        ctr = np.concatenate([rng.uniform([70.0, 70.0], [120.0, 78.0], (900, 2)),
                              rng.uniform(0.0, 256.0, (30, 2))])[:, None, :]
        xy = ctr + rng.normal(0.0, 2.5, (930, 3, 2))
        v = np.concatenate([xy, rng.uniform(0.1, 0.9, (930, 3, 1))], -1)
        return _tris_setup(v, dev), 0.0
    assert case == "windows"
    ctr = rng.uniform(0.0, 256.0, (2100, 1, 2))
    xy = ctr + rng.normal(0.0, 120.0, (2100, 3, 2))
    v = np.concatenate([xy, rng.uniform(0.1, 0.9, (2100, 3, 1))], -1)
    return _tris_setup(v, dev), 0.0


MODES = [(True, False), (True, True), (False, False), (False, True)]


# the frame's two levels, then tiles that end in partial warp rectangles
# (16 x 8), are smaller than one, or are no whole number of 16-byte stores wide
BINNED_TILES = [((16, 64), 64), ((32, 128), 32), ((8, 20), 16), ((24, 36), 32), ((12, 40), 128),
                ((6, 10), 4), ((20, 30), 8)]
# the frame's giant tiles, then the same kinds of tiles for 8 x 32 rectangles
GIANT_TILES = [(32, 256), (64, 512), (16, 64), (8, 20), (24, 36), (12, 40), (6, 10)]


@pytest.mark.parametrize("tile,chunk", BINNED_TILES)
@pytest.mark.parametrize("want_ids,ortho", MODES)
@pytest.mark.parametrize("case", ["random", "coplanar", "busy_tile", "y_offset"])
def test_binned_raster_cases_bit_equal_one_launch(cuda_device, tile, chunk, want_ids, ortho, case):
    s, y_off = _raster_case(case, cuda_device)
    if ortho:
        s = normalize_ortho_setup(s)
    height = 256 - int(y_off)
    bins = bin_triangles(s, 256, height, tile[0], tile[1], chunk, y_offset=y_off)
    n_tiles = -(-256 // tile[1]) * -(-height // tile[0])
    start, count = rk.tile_block_ranges(bins, n_tiles)
    if case == "busy_tile":
        live = count[count > 0].float()
        assert int((count == 0).sum()) > 0 and float(live.max()) >= 4 * float(live.mean())
    args = (bins.coef, bins.tri_id, bins.valid, start, count, tile[0], tile[1],
            -(-256 // tile[1]), y_off, want_ids, ortho)
    before = _cuda.LAUNCHES["binned_raster"]
    got = rk.binned_raster(*args)
    assert _cuda.LAUNCHES["binned_raster"] == before + 1
    _same(got, rk.binned_raster_ref(*args))
    if case == "coplanar" and want_ids:
        won = set(torch.unique(got[1]).tolist()) & set(range(20, 90))
        # of the 70 equal-key copies only the first wins; at tiles too small
        # for the copy's span this level does not bin it
        binned = set(bins.tri_id[bins.valid > 0].tolist()) & set(range(20, 90))
        assert won == ({20} if binned else set()), won
        assert binned or tile[0] * tile[1] < 512


@pytest.mark.parametrize("tile", GIANT_TILES)
@pytest.mark.parametrize("want_ids,ortho", MODES)
@pytest.mark.parametrize("case", ["random", "coplanar", "windows", "y_offset"])
def test_giant_raster_cases_bit_equal_one_launch(cuda_device, tile, want_ids, ortho, case):
    s, y_off = _raster_case(case, cuda_device, big=True)
    if ortho:
        s = normalize_ortho_setup(s)
    with pytest.MonkeyPatch.context() as mp:
        calls = []
        mp.setattr(rk, "giant_raster", lambda *a: calls.append(a) or rk.giant_raster_ref(*a))
        rk.rasterize_giant(s, 256, 256 - int(y_off), tile_h=tile[0], tile_w=tile[1], chunk=8,
                           y_offset=y_off, want_ids=want_ids, ortho=ortho,
                           ids=torch.arange(s.coef.shape[0], device=cuda_device) + 1000)
    (args,) = calls
    if case == "windows":
        overlap = args[2]
        assert overlap.shape[1] > 128 and int((overlap != 0).sum(1).max()) * 8 > 256
    before = _cuda.LAUNCHES["giant_raster"]
    got = rk.giant_raster(*args)
    assert _cuda.LAUNCHES["giant_raster"] == before + 1
    _same(got, rk.giant_raster_ref(*args))
    if case == "coplanar" and want_ids:
        won = set(torch.unique(got[1]).tolist()) & set(range(1090, 1110))
        assert won == {1090}, won  # of the 20 equal-key giant copies only the first wins


# ------------------------------------------- fused resolve: K1 and K2 with records


def _records(rows, r_cols, dev, misaligned=False):
    """A (rows, r_cols) f32 table; ``misaligned``: a contiguous view 4 bytes
    past a 16-byte boundary (the kernels' float path)."""
    g = torch.Generator().manual_seed(rows * 1000 + r_cols)
    flat = torch.randn(rows * r_cols + 1, generator=g).to(dev)
    return flat[1:].view(rows, r_cols) if misaligned else flat[:-1].view(rows, r_cols)


@pytest.mark.parametrize("r_cols,misaligned", [(1, False), (7, False), (128, False),
                                               (128, True), (12, True)])
@pytest.mark.parametrize("chunk", [32, 66, 256, 512])
@pytest.mark.parametrize("case", ["random", "coplanar"])
def test_binned_raster_attrs_bit_equal_one_launch(cuda_device, r_cols, misaligned, chunk, case):
    """K1 with records: keys and ids those of the launch without, the
    records ``records_ref`` of the ids (zeros where none won), one launch of
    ``binned_raster_attrs``."""
    s, _ = _raster_case(case, cuda_device)
    bins = bin_triangles(s, 256, 256, 16, 64, chunk)
    start, count = rk.tile_block_ranges(bins, 64)
    args = (bins.coef, bins.tri_id, bins.valid, start, count, 16, 64, 4)
    records = _records(s.coef.shape[0], r_cols, cuda_device, misaligned)
    key, ids = rk.binned_raster(*args)
    before = _cuda.LAUNCHES["binned_raster_attrs"]
    got = rk.binned_raster(*args, records=records)
    assert _cuda.LAUNCHES["binned_raster_attrs"] == before + 1
    assert torch.equal(got[0], key) and torch.equal(got[1], ids)
    assert torch.equal(got[2], rk.records_ref(records, ids))
    _same(got, rk.binned_raster_ref(*args, records=records))
    assert int((ids >= 0).sum()) > 1000 and int((ids < 0).sum()) > 0


@pytest.mark.parametrize("r_cols,misaligned", [(1, False), (7, False), (128, False),
                                               (128, True)])
@pytest.mark.parametrize("chunk,tile", [(8, (32, 256)), (8, (16, 64)), (8, (24, 36)),
                                        (512, (32, 256))])
@pytest.mark.parametrize("case", ["random", "windows"])
def test_giant_raster_attrs_bit_equal_one_launch(cuda_device, r_cols, misaligned, chunk, tile,
                                                 case):
    """K2/K3 with records read through the global ids: keys and ids those of
    the launch without, records ``records_ref`` of the global ids; tables
    past one staged window (the K3 case) included."""
    s, _ = _raster_case(case, cuda_device, big=True)
    n = s.coef.shape[0]
    gids = torch.randperm(n, generator=torch.Generator().manual_seed(n)).to(cuda_device)
    with pytest.MonkeyPatch.context() as mp:
        calls = []
        mp.setattr(rk, "giant_raster", lambda *a: calls.append(a) or rk.giant_raster_ref(*a))
        rk.rasterize_giant(s, 256, 256, tile_h=tile[0], tile_w=tile[1], chunk=chunk, ids=gids)
    (args,) = calls
    records = _records(n, r_cols, cuda_device, misaligned)
    key, ids = rk.giant_raster(*args)
    before = _cuda.LAUNCHES["giant_raster_attrs"]
    got = rk.giant_raster(*args, records=records)
    assert _cuda.LAUNCHES["giant_raster_attrs"] == before + 1
    assert torch.equal(got[0], key) and torch.equal(got[1], ids)
    assert torch.equal(got[2], rk.records_ref(records, ids))
    _same(got, rk.giant_raster_ref(*args, records=records))
    assert int((ids >= 0).sum()) > 1000


@pytest.mark.parametrize("chunk,big_chunk", [(32, 32), (64, 32), (66, 66), (256, 32)])
def test_rasterize_binned_records_match_plain(cuda_device, chunk, big_chunk):
    """The three levels with records on the card: depth, ids, counters and
    the merged record image equal the plain versions', and the image is
    ``where(ids >= 0, records[ids], 0)``."""
    s = _setup(512, 5, 0.4, cuda_device)
    records = _records(512, 128, cuda_device)
    kw = dict(tile_h=16, tile_w=64, chunk=chunk, big_chunk=big_chunk, records=records)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rk, "giant_raster", rk.giant_raster_ref)
        mp.setattr(rk, "binned_raster", rk.binned_raster_ref)
        want = rk.rasterize_binned(s, 256, 256, **kw)
    _cuda.reset_launches()
    got = rk.rasterize_binned(s, 256, 256, **kw)
    assert _cuda.LAUNCHES["binned_raster_attrs"] == 2 and _cuda.LAUNCHES["giant_raster_attrs"] == 1
    assert _cuda.LAUNCHES["binned_raster"] == _cuda.LAUNCHES["giant_raster"] == 0
    _same(got[:2], want[:2])
    assert {k: int(v) for k, v in got[2].items()} == {k: int(v) for k, v in want[2].items()}
    assert torch.equal(got[3], want[3]) and torch.equal(got[3], rk.records_ref(records, got[1]))


# ------------------------------------------------------- the Renderer on the card


@pytest.fixture(scope="module")
def card_renderers(cuda_device, tmp_path_factory):
    """A Renderer of a small scene written to files on the card and one on
    the CPU (64x64, 64^2 shadow map)."""
    from unclerenderer_tpu_torch.render.params import RenderSettings
    from unclerenderer_tpu_torch.render.renderer import Renderer
    from unclerenderer_tpu_torch.render.testing import write_scene

    scene = write_scene(tmp_path_factory.mktemp("card_scene"), 2, masked=True, n_materials=2,
                        tex_size=32)
    settings = RenderSettings(width=64, height=64, shadow_map_size=64)
    return (Renderer(scene, settings=settings, device=cuda_device),
            Renderer(scene, settings=settings, device="cpu"))


def test_renderer_cached_shadow_map_equals_the_frames_own(card_renderers):
    """The Renderer's cached map is the frame's own shadow raster, and the
    frame given it equals the frame that renders it, bit for bit."""
    import dataclasses

    from unclerenderer_tpu_torch.render.deferred import deferred_frame

    r, _ = card_renderers
    r.render_frame()
    params = r.frame_params()
    cached = r._shadow_map(params)
    state = dataclasses.replace(r.frame_state)
    _cuda.reset_launches()
    own, _ = deferred_frame(r.device_scene, params, state, r.settings)
    assert _cuda.LAUNCHES["binned_raster"] == 4 and _cuda.LAUNCHES["giant_raster"] == 2
    _cuda.reset_launches()
    given, _ = deferred_frame(r.device_scene, params, state, r.settings, shadow_map=cached)
    assert _cuda.LAUNCHES["binned_raster"] == 2 and _cuda.LAUNCHES["giant_raster"] == 1
    for k, v in own.items():
        if isinstance(v, dict):  # raster_stats, tap_counts
            assert {n: int(x) for n, x in v.items()} == {n: int(x) for n, x in given[k].items()}
        else:
            assert torch.equal(v, given[k]), k


def test_renderer_pick_reads_uint32_ids_on_the_card(card_renderers):
    r, c = card_renderers
    out = r.render_frame()
    ids = out["object_id"]
    assert ids.dtype == torch.uint32 and ids.device.type == "cuda"
    host = ids.view(torch.int32).cpu().numpy()
    y, x = np.argwhere(host > 0)[0]
    got = r.pick(int(x), int(y))
    names = {m.object_id: m.name for m in r.scene_data.models}
    assert got == (int(host[y, x]), names[int(host[y, x])])
    y0, x0 = np.argwhere(host == 0)[0]
    assert r.pick(int(x0), int(y0)) == (0, "")
    assert r.stats()["hbm_bytes_in_use"] > 0


def test_renderer_card_frames_equal_cpu_frames(card_renderers):
    """3 carried frames of the scene: depth, ids and counters bit-equal
    between the card (kernels) and the CPU (plain versions), colour within
    1e-3 (the cross-device bar)."""
    from unclerenderer_tpu_torch.render.params import FrameState

    r, c = card_renderers
    for rr in (r, c):
        rr.frame_state = FrameState.initial(64, 64, rr.device)
        rr._frame_counter, rr._taa_history_ready = 0, False
    for _ in range(3):
        g, h = r.render_frame(), c.render_frame()
        for k in ("depth", "tri_id", "model_visible"):
            assert torch.equal(g[k].cpu(), h[k]), k
        assert torch.equal(g["object_id"].view(torch.int32).cpu(), h["object_id"].view(torch.int32))
        assert {k: int(v) for k, v in g["raster_stats"].items()} == \
            {k: int(v) for k, v in h["raster_stats"].items()}
        assert float((g["color"].cpu() - h["color"]).abs().max()) <= 1e-3


@pytest.mark.parametrize("renderer_type,fused", [("forward", "auto"), ("forward", "on"),
                                                 ("deferred", "on")])
def test_renderer_forward_and_fused_card_frames_equal_cpu_frames(cuda_device, tmp_path,
                                                                 renderer_type, fused):
    """The forward Renderer, and fused resolve on either frame, at 64x64:
    card (kernels, the record-emitting entries under fused resolve) and CPU
    (plain versions) frames with depth, ids and counters bit-equal, colour
    within 1e-3."""
    from unclerenderer_tpu_torch.render.params import RenderSettings
    from unclerenderer_tpu_torch.render.renderer import Renderer
    from unclerenderer_tpu_torch.render.testing import write_scene

    scene = write_scene(tmp_path, 2, masked=True, n_materials=2, tex_size=32)
    settings = RenderSettings(width=64, height=64, shadow_map_size=64,
                              renderer_type=renderer_type, fused_resolve=fused)
    r, c = (Renderer(scene, settings=settings, device=d) for d in (cuda_device, "cpu"))
    for i in range(2):
        _cuda.reset_launches()
        g, h = r.render_frame(), c.render_frame()
        attrs = _cuda.LAUNCHES["binned_raster_attrs"], _cuda.LAUNCHES["giant_raster_attrs"]
        assert attrs == ((2, 1) if fused == "on" else (0, 0))
        assert ("hdr" in g) == (renderer_type == "deferred")
        for k in ("depth", "tri_id"):
            assert torch.equal(g[k].cpu(), h[k]), k
        assert torch.equal(g["object_id"].view(torch.int32).cpu(), h["object_id"].view(torch.int32))
        assert {k: int(v) for k, v in g["raster_stats"].items()} == \
            {k: int(v) for k, v in h["raster_stats"].items()}
        assert float((g["color"].cpu() - h["color"]).abs().max()) <= 1e-3
        assert int((h["tri_id"] >= 0).sum()) > 100


# --------------------------------------------- the frame program (render/program.py)

PROGRAM_SIZE = 128


@pytest.fixture(scope="module")
def program_scene(cuda_device, tmp_path_factory):
    """An unmasked scene written to files, for Renderers at 128x128 with a
    128^2 map."""
    from unclerenderer_tpu_torch.render.testing import write_scene

    return write_scene(tmp_path_factory.mktemp("program_scene"), 6, n_materials=3, tex_size=32)


def _program_renderer(scene, dev, monkeypatch, **over):
    from unclerenderer_tpu_torch.render.params import RenderSettings
    from unclerenderer_tpu_torch.render.renderer import Renderer

    monkeypatch.setenv("UNCLERENDERER_SCENE_CACHE", "")
    s = PROGRAM_SIZE
    r = Renderer(scene, settings=RenderSettings(width=s, height=s, shadow_map_size=s, **over),
                 device=dev)
    center = np.asarray(r.scene_data.scene_center)

    def orbit():
        a = 0.2 * r._frame_counter
        r.camera.position = (center[0] + 4 * np.sin(a), center[1] + 1.5,
                             center[2] - 4 * np.cos(a))
        r.camera.set_look_at(center)

    return r, orbit


def _snapshot(r):
    import dataclasses

    from unclerenderer_tpu_torch.render.params import FrameState

    st = FrameState(**{f.name: getattr(r.frame_state, f.name).clone()
                       for f in dataclasses.fields(FrameState)})
    return st, r._frame_counter, r._taa_history_ready


def _restore(r, snap):
    r.frame_state = snap[0]
    r._frame_counter, r._taa_history_ready = snap[1], snap[2]


def _assert_frames_equal(a, b):
    assert set(a) == set(b)
    for k, v in a.items():
        if isinstance(v, dict):
            assert {n: int(x) for n, x in v.items()} == {n: int(x) for n, x in b[k].items()}, k
        elif v.dtype == torch.uint32:
            assert torch.equal(v.view(torch.int32), b[k].view(torch.int32)), k
        else:
            assert torch.equal(v, b[k]), k


def _assert_states_equal(a, b):
    import dataclasses

    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def _hold_program_frames(scene, dev, monkeypatch, renderer_type, kernel):
    """3 carried frames replayed from the captured program and the same 3
    op by op from one start state: every output and every state field
    bit-equal, the same launches a frame (``kernel`` among them); the
    Renderer reports "graph"."""
    from unclerenderer_tpu_torch.render import program

    r, orbit = _program_renderer(scene, dev, monkeypatch, renderer_type=renderer_type)
    for _ in range(2):  # the warm-up frame, then the capture
        orbit()
        r.render_frame()
    assert r.stats()["frame_program"] == "graph" and r._program is not None
    start = _snapshot(r)
    runs = {}
    for eager in (False, True):
        _restore(r, start)
        outs, states, launches = [], [], []
        with program.eager() if eager else contextlib.nullcontext():
            for _ in range(3):
                orbit()
                _cuda.reset_launches()
                outs.append(r.render_frame())
                launches.append(dict(_cuda.LAUNCHES))
                states.append(_snapshot(r)[0])
        runs[eager] = outs, states, launches
    assert r.frame_program == "eager: inside program.eager()"
    for i in range(3):
        _assert_frames_equal(runs[False][0][i], runs[True][0][i])
        _assert_states_equal(runs[False][1][i], runs[True][1][i])
        assert runs[False][2][i] == runs[True][2][i] and runs[False][2][i][kernel] > 0
    return runs


@pytest.mark.parametrize("renderer_type", ["deferred", "forward"])
def test_program_frames_equal_eager_frames(program_scene, cuda_device, monkeypatch,
                                           renderer_type):
    """3 carried frames replayed and op by op: bit-equal, the same launches."""
    _hold_program_frames(program_scene, cuda_device, monkeypatch, renderer_type, "binned_raster")


@pytest.fixture(scope="module")
def masked_program_scene(cuda_device, tmp_path_factory):
    """A scene with alpha-masked models written to files (every 4th object
    from 1 an alpha-checker MASK material): the Renderer turns the masked
    raster on."""
    from unclerenderer_tpu_torch.render.testing import write_scene

    return write_scene(tmp_path_factory.mktemp("masked_program_scene"), 6, n_materials=3,
                       tex_size=32, masked=True)


@pytest.mark.parametrize("renderer_type", ["deferred", "forward"])
def test_masked_program_frames_equal_eager_frames(masked_program_scene, cuda_device, monkeypatch,
                                                  renderer_type):
    """The masked frame captured: replays bit-equal to op-by-op frames, M1
    launched twice a frame (levels 1 and 2) in both."""
    runs = _hold_program_frames(masked_program_scene, cuda_device, monkeypatch, renderer_type,
                                "masked_raster")
    assert all(n["masked_raster"] == 2 for n in runs[False][2])


def test_program_render_frames_equal_render_frame_calls(program_scene, cuda_device, monkeypatch):
    r, orbit = _program_renderer(program_scene, cuda_device, monkeypatch)
    for _ in range(2):
        orbit()
        r.render_frame()
    start = _snapshot(r)
    colors = r.render_frames(3, mutate=lambda rr, i: orbit())
    assert r.frame_program == "graph"
    chain_state, drops = _snapshot(r)[0], dict(r._chain_drop_counters)
    _restore(r, start)
    singles = []
    for _ in range(3):
        orbit()
        singles.append(r.render_frame())
    assert torch.equal(colors, torch.stack([o["color"] for o in singles]))
    _assert_states_equal(chain_state, r.frame_state)
    assert {k: int(v) for k, v in drops.items()} == \
        {k: max(int(o["raster_stats"][k]) for o in singles) for k in drops}


def test_program_outputs_kept_unchanged_by_the_next_replay(program_scene, cuda_device,
                                                           monkeypatch):
    r, orbit = _program_renderer(program_scene, cuda_device, monkeypatch)
    for _ in range(3):
        orbit()
        kept = r.render_frame()
    assert r.frame_program == "graph"
    copy = {k: v.clone() for k, v in kept.items() if not isinstance(v, dict)}
    orbit()
    nxt = r.render_frame()
    assert not torch.equal(nxt["color"], kept["color"])
    for k, v in copy.items():
        assert torch.equal(v.view(torch.int32) if v.dtype == torch.uint32 else v,
                           kept[k].view(torch.int32) if v.dtype == torch.uint32 else kept[k]), k


def test_program_rebuilt_after_update_settings(program_scene, cuda_device, monkeypatch):
    r, orbit = _program_renderer(program_scene, cuda_device, monkeypatch)
    for _ in range(2):
        orbit()
        r.render_frame()
    first = r._program
    assert first is not None and r.frame_program == "graph"
    r.update_settings(enable_cas=False)
    assert r._program is None
    orbit()
    r.render_frame()
    assert r.frame_program.startswith("eager: warm-up")
    orbit()
    r.render_frame()
    assert r.frame_program == "graph" and r._program is not first
    assert r._program.settings == r.settings and not r._program.settings.enable_cas


def test_program_capture_that_syncs_raises(program_scene, cuda_device, tmp_path):
    """A supported path made to read a value back inside the frame: the
    capture raises from render_frame, nothing falls back to the op-by-op
    frame.  In a child process, so a failed capture leaves this one as it
    was."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent(f"""
        import os, sys
        os.environ["UNCLERENDERER_SCENE_CACHE"] = ""
        sys.path.insert(0, {str(Path(__file__).resolve().parents[1])!r})
        from unclerenderer_tpu_torch.render import deferred
        from unclerenderer_tpu_torch.render.params import RenderSettings
        from unclerenderer_tpu_torch.render.renderer import Renderer
        real = deferred.tonemap
        def syncing(hdr, *a, **k):
            float(hdr.max())  # a read-back: a host sync
            return real(hdr, *a, **k)
        deferred.tonemap = syncing
        r = Renderer({str(program_scene)!r}, settings=RenderSettings(width=64, height=64,
                     shadow_map_size=64), device="cuda")
        r.render_frame()
        assert r.frame_program.startswith("eager: warm-up"), r.frame_program
        try:
            r.render_frame()
        except RuntimeError as e:
            print("RAISED", type(e).__name__, str(e)[:200])
        else:
            print("RAN AS", r.frame_program)
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    # a RuntimeError (torch.AcceleratorError is one): the capture was invalidated
    assert res.stdout.startswith("RAISED") and "capture" in res.stdout, (res.stdout,
                                                                         res.stderr[-2000:])


# ------------------------------------------------ spans inside the replayed frame

SPAN_SIZE = 512  # big enough that a pass's kernels, not the gaps between them, fill it


@pytest.fixture(scope="module")
def span_renderer(program_scene, cuda_device):
    """A GpuTiming Renderer at 512^2 replaying its frame program (the light
    fixed: the map is drawn once), the span store emptied."""
    from unclerenderer_tpu_torch.core import passes
    from unclerenderer_tpu_torch.core.config import RendererConfig
    from unclerenderer_tpu_torch.render.params import RenderSettings
    from unclerenderer_tpu_torch.render.renderer import Renderer

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UNCLERENDERER_SCENE_CACHE", "")
        s = SPAN_SIZE
        r = Renderer(program_scene, settings=RenderSettings(width=s, height=s, shadow_map_size=s),
                     config=RendererConfig(enable_gpu_timing=True), device=cuda_device)
    for _ in range(3):
        r.render_frame()
    assert r.frame_program == "graph" and r._program.spans.sink is not None
    torch.cuda.synchronize()
    passes.collect()
    passes.STORE.reset()
    return r


def test_program_spans_add_no_host_sync(span_renderer):
    """Replayed frames with tracing on (GpuTiming, and a profiler) under
    sync debug mode "error": reading the previous replay's events waits
    for nothing; every replay but the last is read at the next one."""
    from unclerenderer_tpu_torch.core import passes

    r = span_renderer
    torch.cuda.synchronize()
    passes.collect()
    passes.STORE.reset()
    spans = r._program.spans
    seen = spans.read + spans.unread
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            r.render_frame()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            for _ in range(2):
                r.render_frame()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    assert spans.read + spans.unread - seen == 4
    passes.collect()
    assert spans.read + spans.unread - seen == 5
    st = r.stats()
    timing = st["frame_timing"]
    assert timing[0]["name"] == "Frame" and {"MaterialResolve", "VisibilityRaster"} <= {
        row["name"] for row in timing}
    assert st["programs"]["FrameProgram"]["replays_read"] == spans.read
    assert st["programs"]["FrameProgram"]["capture_s"] > 0


def test_stats_holds_the_last_frames_timing(span_renderer):
    """``render_frame()`` then ``stats()`` with no sync between: the last
    replay is read, not counted unread, and its "Frame" and pass samples
    are in the table."""
    import time

    r = span_renderer
    spans = r._program.spans
    r.stats()
    read, unread = spans.read, spans.unread
    t = time.monotonic()
    r.render_frame()
    r.stats()
    assert (spans.read, spans.unread) == (read + 1, unread)
    for name in ("Frame", "MaterialResolve", "VisibilityRaster"):
        assert r._frame_times._samples[name][-1][0] >= t, name


def test_program_pass_spans_match_op_by_op_passes(span_renderer, tmp_path):
    """The replayed MaterialResolve and VisibilityRaster device ms within
    10% of the same Renderer's op-by-op frames, bucketed from a profiler
    trace (``core/traceparse.py``)."""
    from unclerenderer_tpu_torch.core import passes

    r = span_renderer
    torch.cuda.synchronize()
    passes.collect()
    passes.STORE.reset()
    for _ in range(6):
        r.render_frame()
        torch.cuda.synchronize()  # as a present: each replay read at the next
    passes.collect()
    replays = passes.STORE.spans("FrameProgram")
    eager = r.profile_trace_passes(frames=3, trace_dir=tmp_path)
    eager = {row["name"]: row["avg_ms"] for row in eager.stats()}
    assert len(replays) == 6
    for name in ("MaterialResolve", "VisibilityRaster"):
        replayed = sum(f[name] for f in replays.values()) / len(replays)
        assert abs(replayed - eager[name]) <= 0.10 * eager[name], (name, replayed, eager[name])


def test_program_spans_lie_inside_the_frame(span_renderer):
    """Each replay's pass spans lie inside its first-to-last span, which
    lies inside CUDA events placed before and after the ``render_frame``
    call (``program.frame_device_ms``'s)."""
    from unclerenderer_tpu_torch.core import passes

    r = span_renderer
    torch.cuda.synchronize()
    passes.collect()
    passes.STORE.reset()
    outside = []
    for _ in range(4):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        r.render_frame()
        b.record()
        b.synchronize()
        outside.append(a.elapsed_time(b))
    passes.collect()
    recs = [x for x in passes.STORE.records if x.program == "FrameProgram"]
    frames = sorted({x.frame for x in recs})
    assert len(frames) == 4
    for frame, around in zip(frames, outside):
        mine = [x for x in recs if x.frame == frame]
        (whole,) = [x.ms for x in mine if x.name == "FrameProgram"]
        inner = [x for x in mine if x.name != "FrameProgram"]
        assert len(inner) >= 10
        assert all(0.0 <= x.start_ms and x.start_ms + x.ms <= whole + 1e-3 for x in inner)
        top = [x for x in inner if x.name not in passes.TIMED_SUB_SCOPES]
        assert sum(x.ms for x in top) <= whole <= around, (frame, whole, around)


def test_gpu_timing_times_an_op_by_op_frame_on_the_device(span_renderer):
    """GpuTiming of an op-by-op frame on the card: "Frame" and its passes
    from events recorded around it (no host sync in ``render_frame``), the
    frame's whole span at least the sum of its timed passes."""
    import time

    from unclerenderer_tpu_torch.core import passes
    from unclerenderer_tpu_torch.render import program

    r = span_renderer
    r.stats()
    passes.STORE.reset()
    t = time.monotonic()
    with program.eager():
        r.render_frame()
    assert r.frame_program.startswith("eager")
    r.stats()
    assert r._eager_spans.read >= 1
    recs = [x for x in passes.STORE.records if x.program == "EagerFrame"]
    (whole,) = [x.ms for x in recs if x.name == "EagerFrame"]
    top = [x.ms for x in recs if x.name not in ("EagerFrame",) + passes.TIMED_SUB_SCOPES]
    assert len(top) >= 8 and 0 < sum(top) <= whole
    assert r._frame_times._samples["Frame"][-1][0] >= t
    assert r._frame_times._samples["Frame"][-1][1] == whole


# ------------------------------------------------------------- M1: the masked raster

MASKED_LAYOUTS = [("quad4", torch.float32), ("quad4", torch.bfloat16), ("quad16", torch.uint8),
                  ("quad16", torch.float32), ("packed", torch.uint8), ("packed", torch.bfloat16),
                  ("packed", torch.float32)]
# (chunk, y_offset, bilinear, misaligned tables): the frame's chunk, a slab's
# rows with the nearest-mip filter, and the exhaustive scan's wider chunks
MASKED_CALLS = [(64, 0, False, False), (32, 48, True, True), (256, 0, False, True),
                (128, 48, False, False)]


@pytest.mark.parametrize("form", ["binned", "exhaustive"])
@pytest.mark.parametrize("layout,dtype", MASKED_LAYOUTS)
@pytest.mark.parametrize("case", ["random", "ties", "zero", "slivers", "cutoff"])
def test_masked_raster_kernel_bit_equal_one_launch(cuda_device, case, layout, dtype, form):
    """M1 against its plain version on the special setups, every atlas
    layout, binned and exhaustive: key bits, ids and the live-block and
    covered counts equal, tapped pairs at most the covered ones; one launch
    a call."""
    from unclerenderer_tpu_torch.render.testing import (
        masked_raster_args,
        masked_raster_atlas,
        masked_raster_setup,
    )

    setup, arec = masked_raster_setup(case, 1, cuda_device)
    atlas, aw = masked_raster_atlas(layout, dtype, cuda_device, seed=2)
    for chunk, y_offset, bilinear, misaligned in MASKED_CALLS:
        args = masked_raster_args(setup, arec, atlas, aw, 256, 256 - y_offset, form, chunk,
                                  y_offset=y_offset, full_height=256, bilinear=bilinear,
                                  misaligned=misaligned)
        before = _cuda.LAUNCHES["masked_raster"]
        key, ids, counts = rk.masked_raster(*args, stats=True)
        assert _cuda.LAUNCHES["masked_raster"] == before + 1
        want_key, want_ids, want = rk.masked_raster_ref(*args, stats=True)
        assert torch.equal(key.view(torch.int32), want_key.view(torch.int32))
        assert torch.equal(ids, want_ids)
        assert int((ids >= 0).sum()) > 0
        assert int(counts["blocks"]) == int(want["blocks"])
        assert int(counts["covered"]) == int(want["covered"]) > 0
        assert 0 < int(counts["tapped"]) <= int(counts["covered"])
        # the frame's call counts nothing and gives the same images
        plain = rk.masked_raster(*args)
        assert plain[2] is None and torch.equal(plain[0], key) and torch.equal(plain[1], ids)


@pytest.mark.parametrize("form", ["binned", "exhaustive"])
@pytest.mark.parametrize("layout,dtype", [("quad4", torch.float32), ("packed", torch.uint8)])
@pytest.mark.parametrize("case", ["random", "ties"])
@pytest.mark.parametrize("chunk", [32, 64])
def test_masked_raster_split_tiles_and_full_lists(cuda_device, case, layout, dtype, form, chunk):
    """M1 on a dense setup -- 9,000 triangles over 64 x 64 pixels: every
    tile holds more blocks than M1 splits at (``MASKED_SPLIT``), and the
    covered pairs a won pixel outnumber a pixel's candidate list
    (``MASKED_LIST``), so some list fills within a stage -- bit-equal to the
    plain version, with its live-block and covered counts, and tapped pairs
    at most the covered ones."""
    from unclerenderer_tpu_torch.render.testing import (
        masked_raster_args,
        masked_raster_atlas,
        masked_raster_setup,
    )

    setup, arec = masked_raster_setup(case, 5, cuda_device, 64, 64, n=9000)
    atlas, aw = masked_raster_atlas(layout, dtype, cuda_device, seed=3)
    args = masked_raster_args(setup, arec, atlas, aw, 64, 64, form, chunk)
    if form == "binned":
        start, count = args[4], args[5]
        assert int(count.min()) > rk.MASKED_SPLIT
        tile, _, nb = rk.masked_split(start, count, args[0].shape[0])
        assert tile.shape[0] > count.shape[0] and int(nb.max()) <= rk.MASKED_SPLIT
    key, ids, counts = rk.masked_raster(*args, stats=True)
    want_key, want_ids, want = rk.masked_raster_ref(*args, stats=True)
    assert torch.equal(key.view(torch.int32), want_key.view(torch.int32))
    assert torch.equal(ids, want_ids)
    won = int((ids >= 0).sum())
    assert won > 0 and int(want["covered"]) > rk.MASKED_LIST * won
    assert int(counts["blocks"]) == int(want["blocks"])
    assert int(counts["covered"]) == int(want["covered"])
    assert 0 < int(counts["tapped"]) <= int(counts["covered"])
    # again with no counts, and once more: the split tiles' words and
    # tickets are laid out anew by every call
    for _ in range(2):
        again = rk.masked_raster(*args)
        assert torch.equal(again[0], key) and torch.equal(again[1], ids)


# --------------------------------------------- the graft entry (graft_entry.py)


def test_graft_entry_compile_check_replay_equals_op_by_op(cuda_device):
    """``compile_check(*entry())``: the 128^2 frame captured as one CUDA
    graph with no host sync, replayed, colour and every new state field
    bit-equal to an op-by-op call (it raises otherwise), with K1, K2, K4
    and K5 among the graph's launches."""
    from unclerenderer_tpu_torch import graft_entry

    fn, args = graft_entry.entry()
    assert all(t.device.type == "cuda" for t in (args[0].tri_model, args[1].view, args[2].hzb))
    rep = graft_entry.compile_check(fn, args)
    assert rep["shape"] == (128, 128, 3) and rep["capture_s"] > 0 and rep["pool_bytes"] >= 0
    for name in ("binned_raster", "giant_raster", "shadow_select9", "gather_rows"):
        assert rep["launches"].get(name, 0) > 0, name


# ------------------------------------------------ the bench entry (bench.py)


def test_bench_parity_gates_hold(cuda_device):
    """The bench's two gates on the card: X1 against K1/K2 on the 256^2
    frame, and the kernel path's 256^2 frame against the xla frame."""
    from unclerenderer_tpu_torch import bench

    _cuda.reset_launches()
    assert bench._pallas_parity_gate(cuda_device) is True
    assert bench._frame_parity_gate(cuda_device) is True
    assert _cuda.LAUNCHES["exhaustive_raster"] == 3  # the raster gate, the xla camera and map
    assert _cuda.LAUNCHES["binned_raster"] > 0 and _cuda.LAUNCHES["giant_raster"] > 0


def test_bench_chain_replays_match_the_cpu(cuda_device, monkeypatch):
    """Two chains of 3 frames at 64^2: on the card frame 0 op by op, then
    replays of the captured program (the map rasterized in each: K2 twice
    a replay), against the same chains op by op on the CPU: each frame's
    colour mean within 1e-3 (the card/CPU tolerance), drop counters equal;
    each chain's last frame (a replay) pixel by pixel: depth and ids
    bit-equal, colour within 1e-3."""
    from unclerenderer_tpu_torch import bench
    from unclerenderer_tpu_torch.render.params import RenderSettings

    monkeypatch.setenv("BENCH_FRAMES", "3")
    settings = RenderSettings(width=64, height=64, shadow_map_size=64)
    runs = {d: bench._synthetic_runner(settings, 4, (32, 24), True, geometry="procedural",
                                       device=d) for d in (cuda_device, "cpu")}
    for chain in range(2):
        _cuda.reset_launches()
        got = runs[cuda_device][0]()
        launched = dict(_cuda.LAUNCHES)
        want = runs["cpu"][0]()
        np.testing.assert_allclose(got["color"].cpu().numpy(), want["color"].numpy(), rtol=0,
                                   atol=1e-3, err_msg=f"chain {chain}")
        g, h = got["last"], want["last"]
        for k in ("depth", "tri_id"):
            assert torch.equal(g[k].cpu(), h[k]), (chain, k)
        assert int((h["tri_id"] >= 0).sum()) > 100
        assert float((g["color"].cpu() - h["color"]).abs().max()) <= 1e-3, chain
        assert runs[cuda_device][3]() == runs["cpu"][3](), f"chain {chain}"
        assert launched["giant_raster"] == 2 * 3, launched  # camera and map, every frame


# ------------------------------------- the present (ops/present.py, render_to_u8)


def _numpy_u8(x: np.ndarray) -> np.ndarray:
    """The reference's conversion (``unclerenderer_tpu/render/renderer.py:779``)."""
    with np.errstate(invalid="ignore", over="ignore"):  # NaN's cast, the largest floats
        return np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)


def _present_case(case, dev):
    """(colour, out or None, the kernel expected).  ``frame1080``: a random
    1080p colour in [-0.5, 1.5] with every level's half (k + 0.5) / 255
    and its two float32 neighbours each side, +-0, +-inf, the largest
    floats and NaN scattered over it; ``odd``, ``tiny``: lengths of no
    whole quad (tails 3 and 3); ``misaligned``: a colour view one float
    past a 16-byte boundary; ``out_misaligned``: an output view one byte
    past a 4-byte boundary."""
    rng = np.random.default_rng(2200)
    if case == "frame1080":
        x = rng.uniform(-0.5, 1.5, (1080, 1920, 3)).astype(np.float32)
        half = ((np.arange(255) + 0.5) / 255).astype(np.float32)
        near = [half]
        for toward in (np.float32(np.inf), np.float32(-np.inf)):
            y = half
            for _ in range(2):
                y = np.nextafter(y, toward)
                near.append(y)
        big = np.finfo(np.float32).max
        special = np.concatenate(near + [np.array([0.0, -0.0, np.inf, -np.inf, big, -big,
                                                   np.nan, -np.nan], np.float32)])
        flat = x.reshape(-1)
        flat[rng.choice(flat.size, special.size, replace=False)] = special
        return torch.from_numpy(x).to(dev), None, "present_quads"
    n = {"odd": 1001 * 3, "tiny": 3}.get(case, 4001)
    flat = torch.from_numpy(rng.uniform(-0.5, 1.5, n + 1).astype(np.float32)).to(dev)
    if case == "misaligned":
        return flat[1:], None, "present_scalars"
    if case == "out_misaligned":
        out = torch.empty(n + 1, dtype=torch.uint8, device=dev)[1:]
        return flat[:n], out, "present_scalars"
    return flat[:n].reshape(-1, 3), None, "present_quads"


@pytest.mark.parametrize("case", ["frame1080", "odd", "tiny", "misaligned", "out_misaligned"])
def test_present_u8_kernel_bit_equal_one_launch(cuda_device, case):
    """The u8 conversion kernel byte-equal to its plain version and to
    numpy's formula (NaN to 0), one launch of the vector kernel on aligned
    buffers, of the scalar kernel on a misaligned view."""
    from unclerenderer_tpu_torch.ops.present import present_u8, present_u8_ref

    x, out, kernel = _present_case(case, cuda_device)
    before = _cuda.LAUNCHES["present_u8"]
    got = []
    names = _kernels_launched(lambda: got.append(present_u8(x, out=out)))
    assert _cuda.LAUNCHES["present_u8"] == before + len(got)
    assert len(names) == 1 and kernel in names[0], names
    assert got[0].dtype == torch.uint8 and got[0].shape == x.shape
    assert out is None or got[0] is out
    assert torch.equal(got[0], present_u8_ref(x))
    np.testing.assert_array_equal(got[0].cpu().numpy(), _numpy_u8(x.cpu().numpy()))


def test_present_u8_kernel_refuses_what_it_does_not_take(cuda_device):
    from unclerenderer_tpu_torch.ops.present import present_u8

    x = torch.zeros((8, 8, 3), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        present_u8(x.half())
    with pytest.raises(ValueError, match="uint8"):
        present_u8(x, out=torch.empty((8, 8, 3), dtype=torch.int8, device=cuda_device))
    with pytest.raises(ValueError, match="shape"):
        present_u8(x, out=torch.empty((8, 8, 4), dtype=torch.uint8, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        present_u8(x.transpose(0, 1))
    with pytest.raises(ValueError, match="one CUDA device"):
        present_u8(x, out=torch.empty((8, 8, 3), dtype=torch.uint8))


def test_render_to_u8_on_the_card_equals_numpys_conversion(program_scene, cuda_device,
                                                           monkeypatch):
    """``render_to_u8`` on a 128^2 card Renderer, op by op, capturing and
    replaying: numpy's conversion of the same frame's colour, one launch of
    the conversion a present."""
    r, orbit = _program_renderer(program_scene, cuda_device, monkeypatch)
    modes = []
    for _ in range(4):
        orbit()
        before = _cuda.LAUNCHES["present_u8"]
        img = r.render_to_u8()
        assert _cuda.LAUNCHES["present_u8"] == before + 1
        modes.append(r.frame_program)
        assert img.dtype == np.uint8 and img.shape == (PROGRAM_SIZE, PROGRAM_SIZE, 3)
        np.testing.assert_array_equal(img, _numpy_u8(r._last_out["color"].cpu().numpy()))
    assert modes[0].startswith("eager") and modes[-1] == "graph", modes


def test_render_to_u8_arrays_outlive_later_presents(program_scene, cuda_device, monkeypatch):
    """An array ``render_to_u8`` returned is unchanged by two later calls
    that present other frames, and shares no memory with theirs."""
    r, orbit = _program_renderer(program_scene, cuda_device, monkeypatch)
    for _ in range(3):  # op by op, capture, replay
        orbit()
        r.render_to_u8()
    first = r.render_to_u8()
    kept = first.copy()
    later = []
    for _ in range(2):
        orbit()
        later.append(r.render_to_u8())
    np.testing.assert_array_equal(first, kept)
    assert not np.array_equal(later[-1], kept)
    assert not any(np.shares_memory(first, img) for img in later)
    assert not np.shares_memory(later[0], later[1])


def test_render_to_u8_card_trace_holds_the_present_spans(program_scene, cuda_device,
                                                        monkeypatch, tmp_path):
    """A profiler trace of a replayed ``render_to_u8`` on the card:
    ``Renderer.frame``, then ``Renderer.present.u8`` (the conversion's
    kernel launched in it), then ``Renderer.present.readback`` (the u8
    frame's copy launched in it), all under the caller's range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from unclerenderer_tpu_torch.core.traceparse import LAUNCH_CATS, load_events

    r, orbit = _program_renderer(program_scene, cuda_device, monkeypatch)
    for _ in range(3):
        orbit()
        r.render_to_u8()
    assert r.frame_program == "graph"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("caller"):
            r.render_to_u8()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = [e for e in load_events(tmp_path / "t.json") if e.get("ph") == "X"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], (float(e["ts"]), float(e["ts"]) + float(e["dur"])))

    def inside(t, name):
        return spans[name][0] <= t[0] and t[1] <= spans[name][1]

    for name in ("Renderer.frame", "Renderer.present.u8", "Renderer.present.readback"):
        assert inside(spans[name], "caller"), name
    assert spans["Renderer.frame"][1] <= spans["Renderer.present.u8"][0]
    assert spans["Renderer.present.u8"][1] <= spans["Renderer.present.readback"][0]
    calls = [(float(e["ts"]), str(e.get("name", ""))) for e in events
             if e.get("cat") in LAUNCH_CATS]
    assert any("LaunchKernel" in n and inside((t, t), "Renderer.present.u8") for t, n in calls)
    assert any("Memcpy" in n and inside((t, t), "Renderer.present.readback") for t, n in calls)
