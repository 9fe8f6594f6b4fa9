"""The port's row-sharded frame (``unclerenderer_tpu_torch/parallel``) on the
CPU, gloo ranks spawned by ``parallel/multichip.py run_ranks`` (every
rendezvous a ``file://`` path under ``tmp_path``, every group and join under
a time limit):

* the port against itself: 4 ranks at 64x64 over 2 carried frames with
  camera motion at the reference test's settings
  (``tests/test_render.py:186-235``: IBL, masked geometry, HZB, TAA, CAS,
  auto-exposure), and 2 ranks whose slabs split the raster tiles, against
  the port's single-device frame: tri_id, depth, counters and the carried
  HZB bit-equal, colour within 1e-5 with the seam rows checked on their
  own (only the exposure grid's sum order differs); the region binning
  that keeps a slab's tiles the whole image's;
* the port against the JAX package: 2 ranks against JAX
  ``render_frame_multichip`` on a 2-device mesh, Pallas path in interpret
  mode (``tests/test_pallas_kernels.py:415``; the port's PCF is the Pallas
  path's table): tri_id, depth, counters and the HZB bit-equal, hdr/colour
  within 1e-4 (the bar of ``tests/test_torch_frame.py``), exposure 1e-5;
* the new functions against the JAX functions on seeded inputs:
  ``pooled_log_luminance_slab``, ``halo2d``/``row_below``/``row_above``
  (the port's ``RowShards`` with its all-gather replaced by the slabs'
  rows, against the JAX hooks under ``shard_map``), ``sky_view_directions``
  on a slab, and TAA/CAS with a ``pad_fn``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unclerenderer_tpu.ops import post as jpost
from unclerenderer_tpu.ops import sky as jsky
from unclerenderer_tpu.parallel import dist as jdist
from unclerenderer_tpu.parallel import multichip as jmulti
from unclerenderer_tpu.render.params import FrameState as JState
from unclerenderer_tpu.render.params import RenderSettings as JSettings
from unclerenderer_tpu.render.testing import synthetic_device_scene as j_scene
from unclerenderer_tpu.render.testing import synthetic_frame_params as j_frame_params
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.ops import post as tpost
from unclerenderer_tpu_torch.ops import sky as tsky
from unclerenderer_tpu_torch.parallel.dist import RowShards, SingleChip
from unclerenderer_tpu_torch.parallel.multichip import run_ranks
from unclerenderer_tpu_torch.render.deferred import deferred_frame
from unclerenderer_tpu_torch.render.params import FrameState, RenderSettings
from unclerenderer_tpu_torch.render.testing import (
    sharded_frames,
    synthetic_device_scene,
    synthetic_frame_params,
)
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

RANK_TIMEOUT = 240.0  # seconds: the group's collectives and the join
EXACT = ("tri_id", "depth", "object_id")
TOL = dict(rtol=1e-5, atol=1e-6)


def cameras(n):
    return [(4.0 * np.sin(0.12 * i), 1.5, -4.0 * np.cos(0.12 * i)) for i in range(n)]


def sharded(tmp_path, n, spec):
    return run_ranks(sharded_frames, n, f"file://{tmp_path}/rendezvous", args=(spec,),
                     device="cpu", timeout=RANK_TIMEOUT)[0]


def assert_seams(got, want, n, atol, label):
    slab_h = want.shape[0] // n
    for s in range(1, n):
        seam = slice(s * slab_h - 1, s * slab_h + 1)
        np.testing.assert_allclose(got[seam], want[seam], rtol=0, atol=atol,
                                   err_msg=f"{label} seam {s}")


# ---------------------------------------------------------------- frames


REFERENCE_TEST = dict(enable_ibl=True, enable_hzb=True, enable_cas=True, has_masked_models=True,
                      width=64, height=64, shadow_map_size=64, tile_h=8, tile_w=64, chunk=32,
                      shadow_chunk=32)


@pytest.mark.parametrize("n,st", [
    (4, REFERENCE_TEST),
    # slabs of 40 rows across 32-row tiles (giant tiles 16): each rank
    # rasterizes the tile-aligned region around its slab and crops it
    (2, {**REFERENCE_TEST, "height": 80, "giant_tile_h": 16, "shadow_map_size": 128}),
], ids=["reference_test", "unaligned_slabs"])
def test_sharded_frames_match_single_device(tmp_path, n, st):
    spec = dict(device="cpu", settings=st, scene=dict(n_objects=8, with_masked=True),
                cameras=cameras(2))
    frames = sharded(tmp_path, n, spec)
    settings = RenderSettings(**st)
    scene, data = synthetic_device_scene(8, with_masked=True, device="cpu")
    state = FrameState.initial(settings.width, settings.height, "cpu")
    masked = data.alpha_mode[data.tri_model] == 1
    for i, cam in enumerate(spec["cameras"]):
        params = synthetic_frame_params(data, settings.width, settings.height, camera_pos=cam,
                                        device="cpu")
        out, state = deferred_frame(scene, params, state, settings)
        want, got = interop.to_numpy(out), frames[i]
        for k in EXACT:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"frame {i} {k}")
        assert {k: int(v) for k, v in got["raster_stats"].items()} == {
            k: int(v) for k, v in want["raster_stats"].items()}
        for k in ("frustum_culled", "hzb_occluded"):
            assert int(got[k]) == int(want[k]), k
        np.testing.assert_array_equal(got["hzb"], state.hzb.numpy())
        np.testing.assert_allclose(got["color"], want["color"], rtol=0, atol=1e-5)
        assert_seams(got["color"], want["color"], n, 1e-5, f"frame {i} color")
        np.testing.assert_allclose(got["taa_history"], state.taa_history.numpy(), rtol=0,
                                   atol=1e-5)
        assert abs(float(got["exposure_ev"]) - float(state.exposure_ev)) <= 1e-5
        tri = want["tri_id"]
        assert (tri >= 0).sum() > 300 and masked[tri[tri >= 0]].sum() > 20, "masked pixels"


@pytest.fixture(scope="module")
def jax_sharded_frames():
    """The JAX package's sharded frames on a 2-device mesh (Pallas path,
    interpret mode): 2 carried frames with camera motion at 64x64."""
    n = 2
    st = dict(enable_ibl=True, enable_hzb=True, enable_cas=True, has_masked_models=True,
              width=64, height=64, shadow_map_size=64, tile_h=8, tile_w=64, chunk=32,
              shadow_chunk=32)
    settings = JSettings(raster_backend="pallas", pallas_interpret=True, **st)
    scene, data = j_scene(8, with_masked=True)
    mesh = jmulti.make_render_mesh(jax.devices()[:n])
    step = jax.jit(functools.partial(jmulti.render_frame_multichip, settings=settings,
                                     mesh=mesh))
    state = JState.initial(settings.width, settings.height)
    frames = []
    for cam in cameras(2):
        out, state = step(scene, j_frame_params(data, 64, 64, camera_pos=cam), state)
        frames.append((jax.device_get(out), jax.device_get(state)))
    return n, st, frames


def test_sharded_frames_match_jax_multichip(tmp_path, jax_sharded_frames):
    n, st, j_frames = jax_sharded_frames
    spec = dict(device="cpu", settings=st, scene=dict(n_objects=8, with_masked=True),
                cameras=cameras(2))
    frames = sharded(tmp_path, n, spec)
    for i, ((j_out, j_state), got) in enumerate(zip(j_frames, frames)):
        for k in EXACT:
            np.testing.assert_array_equal(got[k], np.asarray(j_out[k]), err_msg=f"frame {i} {k}")
        assert set(got["raster_stats"]) == set(j_out["raster_stats"])
        for k, v in j_out["raster_stats"].items():
            assert int(got["raster_stats"][k]) == int(v), f"frame {i} {k}"
        for k in ("frustum_culled", "hzb_occluded"):
            assert int(got[k]) == int(j_out[k]), k
        np.testing.assert_array_equal(got["hzb"], np.asarray(j_state.hzb))
        for k in ("hdr", "color"):
            np.testing.assert_allclose(got[k], np.asarray(j_out[k]), rtol=0, atol=1e-4,
                                       err_msg=f"frame {i} {k}")
        assert_seams(got["color"], np.asarray(j_out["color"]), n, 1e-4, f"frame {i}")
        np.testing.assert_allclose(got["taa_history"], np.asarray(j_state.taa_history),
                                   rtol=0, atol=1e-4)
        assert abs(float(got["exposure_ev"]) - float(j_state.exposure_ev)) <= 1e-5
        assert (got["tri_id"] >= 0).sum() > 300


def test_run_ranks_reports_a_failing_rank(tmp_path):
    """Ranks that raise fail the call with a rank's traceback (here a
    height that does not divide over the ranks), and no rank outlives it."""
    spec = dict(device="cpu", settings=dict(width=64, height=30, shadow_map_size=32),
                scene=dict(n_objects=2), cameras=cameras(1))
    with pytest.raises(RuntimeError, match="must divide over 4 ranks"):
        run_ranks(sharded_frames, 4, f"file://{tmp_path}/rendezvous", args=(spec,),
                  device="cpu", timeout=RANK_TIMEOUT)


def test_entry_points_default_to_the_card(tmp_path):
    """``init_render_group`` and ``run_ranks`` name the card unless the
    caller asks for the CPU; on a host without a card for every rank the
    card's group is gloo (here: no card, one rank)."""
    import inspect

    import torch.distributed as dist

    from unclerenderer_tpu_torch.parallel.multichip import init_render_group

    for fn in (init_render_group, run_ranks):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    group = init_render_group(0, 1, f"file://{tmp_path}/rendezvous")
    try:
        want = "nccl" if torch.cuda.device_count() >= 1 else "gloo"
        assert dist.get_backend(group) == want
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- functions


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_pooled_log_luminance_slab_matches_jax(n):
    """Each slab's partial 16x16 grid, summed over the slabs (the psum),
    then the mean log2: equal to the JAX function on every slab, and to the
    one-slab pooling up to the sum order."""
    h, w = 60, 40
    hdr = np.random.default_rng(n).uniform(0, 4, (h, w, 3)).astype(np.float32)
    hs = h // n

    def run(fn, wrap):
        parts = []
        for r in range(n):
            fn(wrap(hdr[r * hs:(r + 1) * hs]), r * hs, h, lambda c: parts.append(c) or c)
        total = functools.reduce(lambda a, b: a + b, parts)
        return [float(fn(wrap(hdr[r * hs:(r + 1) * hs]), r * hs, h, lambda c: total))
                for r in range(n)]

    got = run(tpost.pooled_log_luminance_slab, torch.from_numpy)
    want = run(jpost.pooled_log_luminance_slab, jnp.asarray)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert len(set(got)) == 1
    one = float(tpost.pooled_log_luminance_slab(torch.from_numpy(hdr), 0, h, lambda c: c))
    assert abs(got[0] - one) <= 1e-5


def _port_shards(slabs, rank):
    """The port's RowShards of ``rank`` with its all-gather replaced by the
    slabs' first and last rows (what the group would gather)."""
    d = RowShards.__new__(RowShards)
    d.n_dev, d.rank, d.slab_h = len(slabs), rank, slabs[0].shape[0]
    d.row0 = rank * d.slab_h

    def gather(x):
        assert torch.equal(x, torch.cat([slabs[rank][:1], slabs[rank][-1:]]))
        return torch.stack([torch.cat([s[:1], s[-1:]]) for s in slabs])

    d._all_gather = gather
    return d


@pytest.mark.parametrize("n", [2, 4])
def test_halo_hooks_match_jax(n):
    h, w = 8 * n, 12
    img = np.random.default_rng(n).standard_normal((h, w, 3)).astype(np.float32)
    mesh = jmulti.make_render_mesh(jax.devices()[:n])
    jd = jdist.RowShards(jmulti.AXIS, n, h)
    spec = jax.sharding.PartitionSpec(jmulti.AXIS)

    def on_mesh(fn):
        return np.asarray(jmulti.shard_map(fn, mesh=mesh, in_specs=(spec,), out_specs=spec,
                                           **jmulti._SHMAP_KW)(jnp.asarray(img)))

    want = {"halo2d": on_mesh(jd.halo2d), "row_below": on_mesh(jd.row_below),
            "row_above": on_mesh(jd.row_above)}
    slabs = list(torch.from_numpy(img).split(h // n))
    for name, stacked in want.items():
        got = np.concatenate([getattr(_port_shards(slabs, r), name)(slabs[r]).numpy()
                              for r in range(n)])
        np.testing.assert_array_equal(got, stacked, err_msg=name)
    # one slab: the single-device hooks, equal to the edge padding
    one = SingleChip(h)
    full = torch.from_numpy(img)
    np.testing.assert_array_equal(one.halo2d(full).numpy(),
                                  np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge"))
    assert torch.equal(one.row_below(full), full[-1:]) and torch.equal(one.row_above(full),
                                                                      full[:1])


def test_sky_view_directions_on_a_slab_match_jax():
    p = j_frame_params(j_scene(4)[1], 96, 64)
    T = functools.partial(interop.array_to_tensor, device="cpu")
    full = tsky.sky_view_directions(96, 64, T(p.camera_pos), T(p.view), T(p.proj_unjittered))
    for row0, out_h in ((16, 24), (48, 16)):
        want = jax.jit(lambda cp, v, pr: jsky.sky_view_directions(
            96, 64, cp, v, pr, row0=row0, out_h=out_h))(p.camera_pos, p.view, p.proj_unjittered)
        got = tsky.sky_view_directions(96, 64, T(p.camera_pos), T(p.view), T(p.proj_unjittered),
                                       row0=row0, out_h=out_h)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert torch.equal(got, full[row0:row0 + out_h])


@pytest.mark.parametrize("use_history", [False, True])
def test_taa_and_cas_take_a_pad_fn(use_history):
    """A ``pad_fn`` border (here a constant one) is the one TAA and CAS
    use, as in the JAX functions; the edge padding is the default."""
    rng = np.random.default_rng(7)
    hdr = rng.uniform(0, 4, (24, 32, 3)).astype(np.float32)
    hist = rng.uniform(0, 4, (24, 32, 3)).astype(np.float32)
    color = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    uh = np.bool_(use_history)

    def t_pad(x):
        return torch.nn.functional.pad(x.permute(2, 0, 1), (1, 1, 1, 1), value=0.5).permute(
            1, 2, 0)

    def j_pad(x):
        return jnp.pad(x, ((1, 1), (1, 1), (0, 0)), constant_values=0.5)

    want = jax.jit(lambda a, b: jpost.temporal_aa(a, b, np.float32(0.9), uh, pad_fn=j_pad))(
        hdr, hist)
    got = tpost.temporal_aa(torch.from_numpy(hdr), torch.from_numpy(hist), torch.tensor(0.9),
                            torch.tensor(uh), pad_fn=t_pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jax.jit(lambda c: jpost.cas_sharpen(c, np.float32(0.5), pad_fn=j_pad))(color)
    got = tpost.cas_sharpen(torch.from_numpy(color), torch.tensor(0.5), pad_fn=t_pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    c = torch.from_numpy(color)
    assert torch.equal(tpost.cas_sharpen(c, torch.tensor(0.5), pad_fn=tpost.edge_pad),
                       tpost.cas_sharpen(c, torch.tensor(0.5)))
    if use_history:
        assert not torch.equal(got, tpost.cas_sharpen(c, torch.tensor(0.5)))


@pytest.mark.parametrize("y0,rows", [(0, 48), (32, 48), (64, 64), (96, 32)])
def test_region_binning_keeps_the_whole_images_tiles(y0, rows):
    """A region of a 128-row image whose first row is a multiple of the
    tile height keys each triangle to the whole image's tiles inside it
    (shifted by the region's tile rows), at the whole image's level."""
    from unclerenderer_tpu_torch.ops import binning
    from unclerenderer_tpu_torch.ops.raster import RasterSetup

    rng = np.random.default_rng(y0 + rows)
    t, w, h, th, tw, span = 300, 128, 128, 16, 32, 2
    x = np.sort(rng.integers(0, w, (2, t)), axis=0)
    y = np.sort(rng.integers(0, h, (2, t)), axis=0)
    bbox = torch.tensor(np.stack([x[0], y[0], x[1], y[1]]).astype(np.float32))
    setup = RasterSetup(coef=torch.zeros((t, 16)), valid=torch.tensor(rng.random(t) < 0.9),
                        bbox=bbox)
    full_keys, full_big = binning._pair_keys(setup, w, h, th, tw, span)
    keys, big = binning._pair_keys(setup, w, rows, th, tw, span, float(y0), full_height=h)
    n_tx, skip = -(-w // tw), (y0 // th) * (-(-w // tw))
    full_keys, keys = full_keys.reshape(t, -1), keys.reshape(t, -1)
    in_rows = (bbox[3] >= y0) & (bbox[1] <= y0 + rows - 1)
    assert torch.equal(big, full_big & in_rows)
    n_region = n_tx * (-(-rows // th))
    for i in range(t):
        want = {int(k) - skip for k in full_keys[i] if skip <= int(k) < skip + n_region
                and int(k) < n_tx * (h // th)}
        got = {int(k) for k in keys[i] if int(k) < n_region}
        assert got == want, i
    # without full_height the region is an image of its own, as before
    own, _ = binning._pair_keys(setup, w, rows, th, tw, span, float(y0))
    clamp = RasterSetup(coef=setup.coef, valid=setup.valid,
                        bbox=torch.stack([bbox[0], bbox[1].clamp(y0, y0 + rows - 1) - y0,
                                          bbox[2], bbox[3].clamp(y0, y0 + rows - 1) - y0]))
    keep = (bbox[3] >= y0) & (bbox[1] <= y0 + rows - 1)
    ref, _ = binning._pair_keys(RasterSetup(coef=clamp.coef, valid=clamp.valid & keep,
                                            bbox=clamp.bbox), w, rows, th, tw, span)
    assert torch.equal(own, ref)
