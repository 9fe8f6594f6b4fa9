"""Fused resolve (``fused_resolve="on"``): the raster kernels emit each
pixel's winning resolve record, against the reference's want_attrs branch
(``unclerenderer_tpu/ops/pallas_raster.py _emit_records``, Pallas in
interpret mode) on the CPU, where K1 and K2 run their plain versions:

* the three-level ``rasterize_binned(..., records=)`` at the two setups of
  the reference's ``test_fused_attr_emission_matches_gather`` (512 random
  triangles, 256x256, tile 16x64, chunk 32, big_chunk 32, seeds 2 and 5,
  sizes 0.08 and 0.4): depth, ids, counters and the record image
  bit-equal, and the image equal to ``where(ids >= 0, records[ids], 0)``;
* K1's and K2's plain versions alone at R = 1, 7 and 128: keys and ids
  those of the call without records, records ``records_ref``;
* ``raster_masked_combine(..., attr=)`` at ``masked_tri_cap`` 0, -1 and
  the exact masked count: depth, ids and records bit-equal;
* a 128x128 deferred frame with fused resolve against the reference's
  fused Pallas frame (depth, ids, object ids, counters, HZB
  bit-equal; hdr and colour within 1e-4, exposure 1e-5, as
  ``tests/test_torch_frame.py``), and bit-identical to the port's own
  unfused frame, on the rich scene with compaction (the compact rows'
  records) and on the masked scene at the Renderer's masked cap."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_kernels import _setup as _random_setup  # the reference tests' random triangles

from unclerenderer_tpu.ops.pallas_raster import rasterize_binned as j_binned
from unclerenderer_tpu.render import common as jcommon
from unclerenderer_tpu.render.deferred import deferred_frame as j_frame
from unclerenderer_tpu.render.params import FrameState as JState
from unclerenderer_tpu.render.params import RenderSettings as JSettings
from unclerenderer_tpu.render.testing import synthetic_device_scene as j_scene
from unclerenderer_tpu.render.testing import synthetic_frame_params as j_frame_params
from unclerenderer_tpu_torch import interop
from unclerenderer_tpu_torch.ops import raster as tr
from unclerenderer_tpu_torch.ops import raster_kernels as rk
from unclerenderer_tpu_torch.ops.binning import bin_triangles
from unclerenderer_tpu_torch.render import common as tcommon
from unclerenderer_tpu_torch.render.deferred import deferred_frame
from unclerenderer_tpu_torch.render.params import DeviceScene, FrameParams, FrameState, RenderSettings
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

SIZE = 128
EXACT = ("depth", "tri_id", "object_id", "model_visible", "frustum_culled", "hzb_occluded")
ATOL_IMAGE = 1e-4
ATOL_EV = 1e-5
KW = dict(tile_h=16, tile_w=64, chunk=32, big_chunk=32)


def T(x):
    return torch.from_numpy(np.array(x))


def _port(s):
    return tr.RasterSetup(coef=T(s.coef), valid=T(s.valid), bbox=T(s.bbox))


def _bits(x):
    """Float bits, so -0.0 and 0.0 differ."""
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("seed,size", [(2, 0.08), (5, 0.4)])
def test_fused_attr_matches_reference(seed, size):
    s = _random_setup(512, seed=seed, size=size)
    records = np.random.default_rng(9 + seed).standard_normal((512, 128)).astype(np.float32)
    jd, ji, js, ja = j_binned(s, 256, 256, **KW, interpret=True, records=jnp.asarray(records))
    td, ti, ts, ta = rk.rasterize_binned(_port(s), 256, 256, **KW, records=T(records))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for k in ("pair_overflow", "giant_truncated"):
        assert int(ts[k]) == int(js[k]), k
    np.testing.assert_array_equal(_bits(ta.numpy()), _bits(ja))
    ids = ti.numpy()
    want = np.where((ids >= 0)[..., None], records[ids.clip(0)], 0.0)
    np.testing.assert_array_equal(ta.numpy(), want)
    assert (ids >= 0).sum() > 500
    # without records: the same depth and ids
    td2, ti2, _ = rk.rasterize_binned(_port(s), 256, 256, **KW)
    assert torch.equal(td, td2) and torch.equal(ti, ti2)


@pytest.mark.parametrize("r_cols", [1, 7, 128])
def test_kernel_plain_records(r_cols):
    """K1's and K2's plain versions with records: keys and ids unchanged,
    records ``records_ref`` of the winners (zeros where none won)."""
    s = _port(_random_setup(150, seed=5, size=0.3, w=128, h=128))
    rng = np.random.default_rng(r_cols)
    records = T(rng.standard_normal((150, r_cols)).astype(np.float32))
    bins = bin_triangles(s, 128, 128, 16, 64, 32)
    start, count = rk.tile_block_ranges(bins, 2 * 8)
    a = (bins.coef, bins.tri_id, bins.valid, start, count, 16, 64, 2)
    key, ids = rk.binned_raster(*a)
    key_r, ids_r, attr = rk.binned_raster(*a, records=records)
    assert torch.equal(key, key_r) and torch.equal(ids, ids_r)
    assert tuple(attr.shape) == (16, 16 * 64, r_cols)
    assert torch.equal(attr, rk.records_ref(records, ids))
    assert int((ids >= 0).sum()) > 1000 and int((ids < 0).sum()) > 0

    ids_map = T(rng.permutation(150).astype(np.int32))  # local row -> "global" id
    kw = dict(tile_h=32, tile_w=64, chunk=8, ids=ids_map)
    d, tri = rk.rasterize_giant(s, 128, 128, **kw)
    d_r, tri_r, attr_g = rk.rasterize_giant(s, 128, 128, **kw, records=records)
    assert torch.equal(d, d_r) and torch.equal(tri, tri_r)
    assert tuple(attr_g.shape) == (128, 128, r_cols)
    assert torch.equal(attr_g, rk.records_ref(records, tri))
    assert int((tri >= 0).sum()) > 1000
    with pytest.raises(ValueError, match="want_ids"):
        rk.binned_raster(*a, 0.0, False, records=records)


@pytest.fixture(scope="module")
def masked():
    scene, data = j_scene(8, with_masked=True)
    cam = tuple(np.asarray(data.models[1].center) + [0.0, 0.3, -1.1])
    params = j_frame_params(data, SIZE, SIZE, camera_pos=cam)
    n_masked = int((np.asarray(data.alpha_mode)[data.tri_model] == 1).sum())
    return scene, data, interop.to_port(scene, DeviceScene, "cpu"), params, n_masked


@pytest.mark.parametrize("cap", [0, -1, "exact"])
def test_masked_combine_records_match_reference(masked, cap):
    """Pixels won by the masked raster take their triangle's record (from the
    compacted masked list at 0 < cap < T), the others keep the opaque
    raster's."""
    scene, _, t_scene, params, n_masked = masked
    cap = -(-n_masked // 64) * 64 if cap == "exact" else cap
    settings = RenderSettings(width=SIZE, height=SIZE, masked_tri_cap=cap)
    p = interop.to_port(params, FrameParams, "cpu")
    vsoa = tcommon.vertex_stage_soa(t_scene.pos_soa, p.view_proj, SIZE, SIZE)
    opaque, masked_mask = tcommon.tri_draw_masks(t_scene, p.model_visible)
    depth, tri_id, _, attr, _ = tcommon.raster_opaque(t_scene, opaque, settings, vsoa,
                                                      fused=True)
    assert torch.equal(attr, rk.records_ref(tcommon.build_resolve_records(t_scene, vsoa.pix9()),
                                            tri_id))
    j_vsoa = jcommon.VertexSoA(*[tuple(x.numpy() for x in getattr(vsoa, f))
                                 for f in ("px", "py", "pw", "z")])
    j_settings = JSettings(raster_backend="pallas", pallas_interpret=True, width=SIZE,
                           height=SIZE, masked_tri_cap=cap)
    want = jax.jit(lambda sc, vs, mm, d, t, a: jcommon.raster_masked_combine(
        sc, None, None, mm, d, t, j_settings, attr=a,
        records=jcommon.build_resolve_records(sc, vs.pix9()), vsoa=vs))(
            scene, j_vsoa, masked_mask.numpy(), depth.numpy(), tri_id.numpy(), attr.numpy())
    got = tcommon.raster_masked_combine(t_scene, masked_mask, depth, tri_id, settings, vsoa,
                                        attr=attr)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(_bits(got[3].numpy()), _bits(want[2]))
    am = t_scene.alpha_mode[t_scene.tri_model.long()]
    assert int(((got[1] >= 0) & (am[got[1].clamp(min=0).long()] == 1)).sum()) > 500


def _frames(scene, data, t_scene, common, cams):
    """The reference's fused Pallas frames and the port's fused and unfused
    frames, carried over ``cams``; yields (reference, fused, unfused) outs
    and states per frame (one camera: the state after one frame)."""
    j_settings = JSettings(raster_backend="pallas", pallas_interpret=True, fused_resolve="on",
                           **common)
    step = jax.jit(functools.partial(j_frame, settings=j_settings))
    j_state = JState.initial(SIZE, SIZE)
    states = [interop.to_port(j_state, FrameState, "cpu")] * 2
    settings = [RenderSettings(fused_resolve=f, **common) for f in ("on", "auto")]
    for cam in cams:
        params = j_frame_params(data, SIZE, SIZE, camera_pos=cam)
        j_out, j_state = step(scene, params, j_state)
        t_params = interop.to_port(params, FrameParams, "cpu")
        outs = []
        for i in range(2):
            out, states[i] = deferred_frame(t_scene, t_params, states[i], settings[i])
            outs.append(out)
        yield (j_out, j_state), (outs[0], states[0]), (outs[1], states[1])


FRAME_CASES = {
    # the rich u8 scene with a cap that compacts: records of the compact rows
    "compacted": dict(has_masked_models=False, combined_material=True, compact_cap=256),
    # the masked scene at the reference's defaults and the Renderer's masked cap
    "masked": dict(masked_tri_cap="exact"),
}


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_fused_frame_matches_reference_and_unfused(case, masked):
    common = dict(width=SIZE, height=SIZE, shadow_map_size=SIZE, **FRAME_CASES[case])
    if case == "masked":
        scene, data, t_scene, _, n_masked = masked
        common["masked_tri_cap"] = -(-n_masked // 64) * 64
        cams = [tuple(np.asarray(data.models[1].center) + [0.0, 0.3, -1.1])]
    else:
        scene, data = j_scene(6, rich_materials=True, atlas_u8=True)
        t_scene = interop.to_port(scene, DeviceScene, "cpu")
        cams = [(0.0, 1.5, -4.0)]
    for i, ((j_out, j_state), (f_out, f_state), (u_out, u_state)) in enumerate(
            _frames(scene, data, t_scene, common, cams)):
        got = interop.to_numpy(f_out)
        for k in EXACT:
            np.testing.assert_array_equal(got[k], np.asarray(j_out[k]), err_msg=f"frame {i} {k}")
        assert set(got["raster_stats"]) == set(j_out["raster_stats"])
        for k, v in j_out["raster_stats"].items():
            assert int(got["raster_stats"][k]) == int(v), f"frame {i} {k}"
        for k in ("hdr", "color"):
            np.testing.assert_allclose(got[k], np.asarray(j_out[k]), rtol=0, atol=ATOL_IMAGE,
                                       err_msg=f"frame {i} {k}")
        got_state = interop.to_numpy(f_state)
        for f in dataclasses.fields(JState):
            want = np.asarray(getattr(j_state, f.name))
            if f.name in ("taa_history", "exposure_ev"):
                tol = ATOL_IMAGE if f.name == "taa_history" else ATOL_EV
                np.testing.assert_allclose(got_state[f.name], want, rtol=0, atol=tol)
            else:
                np.testing.assert_array_equal(got_state[f.name], want, err_msg=f.name)
        # the port's fused frame is its unfused frame, bit for bit
        for k, v in u_out.items():
            if isinstance(v, dict):  # raster_stats, tap_counts
                assert {a: int(b) for a, b in v.items()} == {
                    a: int(b) for a, b in f_out[k].items()}
            else:
                assert torch.equal(f_out[k], v), f"frame {i} {k}"
        for f in dataclasses.fields(FrameState):
            assert torch.equal(getattr(f_state, f.name), getattr(u_state, f.name)), f.name
        assert (got["tri_id"] >= 0).sum() > 1000
