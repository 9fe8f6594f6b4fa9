"""The kernel-bearing rows of the reference's three TPU measurement probes,
on the card: each probe kernel with the computation its probe wraps around
it, at the probes' own shapes.  The probes' timing harness
(``tools/timing.py``) and their other rows stay unported (ROADMAP.md).

Kernels, each a wrapper with its plain version (``*_ref``) beside it:

* ``merge_select`` -- K10 (``csrc/merge_select.cu``), the probe's
  ``jnp.where(ka > kb, a, b)`` kernel (``tools/prof_r5.py merge_pallas``);
* ``copy_rows`` -- K11 (``csrc/copy_bytes.cu``), the identity copy of
  gathered texture rows (``tools/prof_tap_bisect.py _pl_copy``);
* ``materialize`` -- K12 (``csrc/copy_bytes.cu``), the identity copy of
  any array (``tools/prof_fuse.py materialize``).

Rows:

* ``rec_param`` / ``rec_pmerge`` / ``rec_mat`` (``prof_r5.py:180``,
  ``:232``; ``prof_fuse.py:219``): a (tc, 128) record gather fed by a
  merged (H, W) id image -- the id image given, merged by K10, or merged by
  a plain select and copied by K12;
* ``tap_copy_blend_i32`` / ``tap_copy_blend_f32`` (``prof_tap_bisect.py``
  v10, v11): a packed-atlas row gather whose rows K11 copies (as int32
  words of the u8 lanes, or decoded to f32) before a bilinear blend;
* ``align_gather`` / ``align_materialize_gather`` (``prof_fuse.py:144``):
  the binning's pair sort and block alignment feeding the coefficient
  gather, with the block index array copied by K12 in between;
* ``probe_setups``: the camera and shadow-map setups those rows bin.
"""

from __future__ import annotations

import torch

from ..render.common import compaction_cap, shadow_compaction_cap, tri_draw_masks, vertex_stage_soa
from ..textures.image import COMBINED_C
from . import _cuda
from .binning import _align_pairs, _pair_keys, _sort_pairs
from .raster import (
    CULL_BACK,
    CULL_FRONT,
    RasterSetup,
    compact_setup,
    flip_depth_key,
    normalize_ortho_setup,
    triangle_setup_from_soa,
)
from .texture import _rows_to_f32


# ---------------------------------------------------------------------------
# K10: merge select
# ---------------------------------------------------------------------------


def merge_select_ref(a, b, ka, kb):
    """Plain version of K10: ``where(ka > kb, a, b)``."""
    return torch.where(ka > kb, a, b)


def merge_select(a, b, ka, kb):
    """K10 wrapper: int32 ids ``a``, ``b`` and f32 keys ``ka``, ``kb`` of one
    shape -> int32 ``where(ka > kb, a, b)`` (a NaN key or equal keys choose
    ``b``)."""
    if _cuda.on_cpu("merge_select", a):
        return merge_select_ref(a, b, ka, kb)
    if not (a.shape == b.shape == ka.shape == kb.shape):
        raise ValueError("merge_select: ids and keys must share one shape")
    if a.dtype != torch.int32 or b.dtype != torch.int32 or ka.dtype != torch.float32 \
            or kb.dtype != torch.float32:
        raise ValueError("merge_select: expects int32 ids and f32 keys")
    _cuda.check_cuda("merge_select", a, b, ka, kb)
    out = torch.empty_like(a)
    if a.numel():
        _cuda.launch("merge_select", _cuda.ptr(a), _cuda.ptr(b), _cuda.ptr(ka), _cuda.ptr(kb),
                     _cuda.ptr(out), a.numel())
    return out


# ---------------------------------------------------------------------------
# K11 and K12: identity copies
# ---------------------------------------------------------------------------


def copy_rows_ref(rows):
    """Plain version of K11: a copy of ``rows``."""
    return rows.clone()


def copy_rows(rows):
    """K11 wrapper: a bit-exact copy of a contiguous (n, lanes) tensor of any
    element type into a fresh one (the probe's pad to whole 1024-row blocks
    and slice back is the identity)."""
    if _cuda.on_cpu("copy_rows", rows):
        return copy_rows_ref(rows)
    if rows.dim() != 2:
        raise ValueError(f"copy_rows: expects (n, lanes) rows, got shape {tuple(rows.shape)}")
    return _cuda.copy("copy_rows", rows)


def materialize_ref(x):
    """Plain version of K12: a copy of ``x``."""
    return x.clone()


def materialize(x):
    """K12 wrapper: a bit-exact copy of a contiguous tensor of any shape and
    element type into a fresh one."""
    if _cuda.on_cpu("materialize", x):
        return materialize_ref(x)
    return _cuda.copy("materialize", x)


# ---------------------------------------------------------------------------
# Record gather fed by a merged id image (prof_r5 rec, prof_fuse rec128)
# ---------------------------------------------------------------------------


def rec_param(rec, tri):
    """``rec[max(tri, 0)].sum(-1)``: the (tc, 128) record gather fed by the
    id image ``tri`` as given (the probe's floor row)."""
    return rec[torch.clamp(tri, min=0).long()].sum(-1)


def rec_pmerge(rec, a, b, ka, kb):
    """The record gather fed by K10's merge of (a, ka) and (b, kb)."""
    return rec_param(rec, merge_select(a, b, ka, kb))


def rec_mat(rec, a, b, ka, kb):
    """The record gather fed by a plain merge whose id image K12 copies."""
    return rec_param(rec, materialize(torch.where(ka > kb, a, b)))


# ---------------------------------------------------------------------------
# Packed material rows copied before the blend (prof_tap_bisect v10, v11)
# ---------------------------------------------------------------------------


def _quad_blend(q, fx, fy):
    c = COMBINED_C
    top = q[..., 0:c] * (1.0 - fx) + q[..., c:2 * c] * fx
    bot = q[..., 2 * c:3 * c] * (1.0 - fx) + q[..., 3 * c:] * fx
    return (top * (1.0 - fy) + bot * fy).sum(-1)


def tap_copy_blend_i32(table, idx, fx, fy):
    """v10: the quad lanes (0:64) of the u8 packed rows ``table[idx]`` as 16
    little-endian int32 words per row, copied by K11, back to u8, decoded
    and blended by (fx, fy) (n, 1) and summed over channels."""
    n = idx.shape[0]
    raw = table[idx.long(), :4 * COMBINED_C].contiguous()  # (n, 64) u8
    pairs = copy_rows(raw.view(torch.int32))                # (n, 16) i32
    q = _rows_to_f32(pairs.view(torch.uint8).reshape(n, 4 * COMBINED_C), COMBINED_C)
    return _quad_blend(q, fx, fy)


def tap_copy_blend_f32(table, idx, fx, fy):
    """v11: the quad lanes of ``table[idx]`` decoded to f32, copied by K11,
    blended and summed."""
    q = copy_rows(_rows_to_f32(table[idx.long(), :4 * COMBINED_C], COMBINED_C))
    return _quad_blend(q, fx, fy)


# ---------------------------------------------------------------------------
# Binning index array feeding the coefficient gather (prof_fuse fuse[...])
# ---------------------------------------------------------------------------


def _align(setup: RasterSetup, width, height, tile_h, tile_w, chunk, budget_factor, max_span):
    """The probe's ``align``: pair keys, the packed sort and block alignment
    -> (block index array (n_blocks, chunk) int32, 0 at invalid slots as
    the probe's ``where(sv, btid, 0)`` makes it; slot valid)."""
    n_tiles = (-(-width // tile_w)) * (-(-height // tile_h))
    n_blocks = max(int(budget_factor * setup.coef.shape[0]) // chunk + n_tiles, 2)
    keys, _big = _pair_keys(setup, width, height, tile_h, tile_w, max_span)
    sk, stri = _sort_pairs(keys, n_tiles, max_span * max_span)
    btid, sv, *_rest = _align_pairs(sk, stri, n_tiles, chunk, n_blocks)
    return btid, sv


def align_gather(setup: RasterSetup, width, height, tile_h, tile_w, chunk, budget_factor,
                 max_span=2):
    """Binning alignment and the (n_blocks, 16, chunk) coefficient gather it
    feeds.  Returns (coef blocks, slot valid)."""
    bt, sv = _align(setup, width, height, tile_h, tile_w, chunk, budget_factor, max_span)
    return setup.coef[bt.long()].transpose(1, 2).contiguous(), sv


def align_materialize_gather(setup: RasterSetup, width, height, tile_h, tile_w, chunk,
                             budget_factor, max_span=2):
    """``align_gather`` with the block index array copied by K12 before the
    gather."""
    bt, sv = _align(setup, width, height, tile_h, tile_w, chunk, budget_factor, max_span)
    bt = materialize(bt)
    return setup.coef[bt.long()].transpose(1, 2).contiguous(), sv


def probe_setups(scene, params, settings):
    """The setups the probes bin: the camera's (CULL_BACK, compacted under
    ``compaction_cap``) and the shadow map's (CULL_FRONT, compacted under
    ``shadow_compaction_cap``, ortho-normalised, depth key flipped), both
    from the frame's vertex stage over the opaque draw mask."""
    opaque, _masked = tri_draw_masks(scene, params.model_visible)
    t_count = scene.tri_model.shape[0]
    w, h, size = settings.width, settings.height, settings.shadow_map_size
    cam = triangle_setup_from_soa(vertex_stage_soa(scene.pos_soa, params.view_proj, w, h),
                                  opaque, CULL_BACK, w, h)
    cap = compaction_cap(settings, t_count)
    if cap:
        cam, _ids, _ovf = compact_setup(cam, cap)
    sh = triangle_setup_from_soa(
        vertex_stage_soa(scene.pos_soa, params.light_view_proj, size, size),
        opaque, CULL_FRONT, size, size)
    scap = shadow_compaction_cap(settings, t_count)
    if scap:
        sh, _ids, _ovf = compact_setup(sh, scap)
    return cam, flip_depth_key(normalize_ortho_setup(sh))
