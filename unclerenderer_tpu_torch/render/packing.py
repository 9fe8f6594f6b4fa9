"""Record packing for the material resolve (numpy; re-homed from
``unclerenderer_tpu/render/packing.py`` with bit-equal output, since that
module sits under the reference's JAX-importing ``render`` package).

TPU gathers cost tens of ns per row for widths up to ~64 channels (with a
catastrophic lowering cliff at 128 -- measured), so the material resolve
packs everything it needs per pixel into TWO static per-triangle records:

tri_geo (T, 48) -- per-vertex attribute blocks (prepended per frame with the
9 screen-space homogeneous coords -> a (T, 57) record):
  [k*16 + 0..2]   vertex k position (world)
  [k*16 + 3..5]   vertex k normal (world, unnormalized)
  [k*16 + 6..9]   vertex k tangent (xyz normalized + handedness)
  [k*16 + 10..11] vertex k uv
  [k*16 + 12..15] vertex k color        (k = 0, 1, 2)

tri_mrec (T, 64) -- the owning model's material constants (model record
broadcast per triangle at load):
  0..2 base_color_factor | 3 base_color_alpha | 4 metallic | 5 roughness
  6..8 emissive | 9 alpha_cutoff | 10 object_id | 11 alpha_mode
  12..15 has_map | 16..31 uv offset-scale (4 slots x 4)
  32..39 uv rotation (4 slots x 2)
  40..55 per-slot atlas rect0 (x0, y0, w0, h0) for the pyramid sampler
  56 model_id | 57..63 pad

Texture ids never reach the device: the pyramid atlas rect0 IS the texture
identity (ops/texture.py sample_pyramid_*).
"""

from __future__ import annotations

import numpy as np

from .params import bf16_bits

MREC = 64
GEO = 48

M_BCF, M_ALPHA, M_METAL, M_ROUGH = 0, 3, 4, 5
M_EMISSIVE, M_CUTOFF, M_OBJID, M_AMODE = 6, 9, 10, 11
M_HAS, M_UVOS, M_UVROT, M_RECT, M_ID = 12, 16, 32, 40, 56


def pack_model_record(
    data, has_map: np.ndarray, slot_rect0: np.ndarray
) -> np.ndarray:
    """SceneData + per-(model, slot) atlas rect0 (M, 4, 4) -> (M, 64) f32."""
    m = data.num_models
    rec = np.zeros((m, MREC), np.float32)
    rec[:, M_BCF : M_BCF + 3] = data.base_color_factor
    rec[:, M_ALPHA] = data.base_color_alpha
    rec[:, M_METAL] = data.metallic_factor
    rec[:, M_ROUGH] = data.roughness_factor
    rec[:, M_EMISSIVE : M_EMISSIVE + 3] = data.emissive_factor
    rec[:, M_CUTOFF] = data.alpha_cutoff
    rec[:, M_OBJID] = data.object_ids.astype(np.float32)
    rec[:, M_AMODE] = data.alpha_mode.astype(np.float32)
    rec[:, M_HAS : M_HAS + 4] = has_map.astype(np.float32)
    rec[:, M_UVOS : M_UVOS + 16] = data.uv_transform.reshape(m, 16)
    rec[:, M_UVROT : M_UVROT + 8] = data.uv_rotation.reshape(m, 8)
    rec[:, M_RECT : M_RECT + 16] = slot_rect0.reshape(m, 16).astype(np.float32)
    rec[:, M_ID] = np.arange(m, dtype=np.float32)
    return rec


def pack_tri_geo(data) -> np.ndarray:
    """De-indexed SceneData -> (T, 48) f32 static vertex-attribute record."""
    t = data.num_triangles
    rec = np.zeros((t, GEO), np.float32)
    for k in range(3):
        base = k * 16
        rows = slice(k, 3 * t, 3)
        rec[:, base + 0 : base + 3] = data.position[rows]
        rec[:, base + 3 : base + 6] = data.normal[rows]
        rec[:, base + 6 : base + 10] = data.tangent[rows]
        rec[:, base + 10 : base + 12] = data.uv[rows]
        rec[:, base + 12 : base + 16] = data.color[rows]
    return rec


def pack_tri_mrec(data, model_rec: np.ndarray) -> np.ndarray:
    """(M, 64) model records broadcast per triangle -> (T, 64)."""
    return model_rec[data.tri_model]


def scene_host_arrays(data, tex_ids, has_map, quad_img, tri_geo, tri_mrec, brdf_lut, env_quad,
                      env_rect0, env_tail) -> dict:
    """Every ``DeviceScene`` field of a scene as numpy, byte-equal to the
    reference Renderer's host arrays (``render/renderer.py:252-286``), with
    bfloat16 as its uint16 bit patterns (``params.bf16_bits``; the caller
    passes bf16 fields as such or as float32).  ``params.upload_scene``
    puts them on a device."""
    return dict(
        position=data.position,
        # lane-dense [vertex slot][x/y/z][tri] for the SoA vertex stage
        pos_soa=np.ascontiguousarray(data.position.reshape(-1, 3, 3).transpose(1, 2, 0)),
        normal=data.normal,
        tangent=data.tangent,
        uv=data.uv,
        color=data.color,
        tris=data.tri_indices.astype(np.int32),
        tri_model=data.tri_model.astype(np.int32),
        base_color_factor=data.base_color_factor,
        base_color_alpha=data.base_color_alpha,
        metallic_factor=data.metallic_factor,
        roughness_factor=data.roughness_factor,
        emissive_factor=data.emissive_factor,
        alpha_mode=data.alpha_mode.astype(np.int32),
        alpha_cutoff=data.alpha_cutoff,
        uv_transform=data.uv_transform,
        uv_rotation=data.uv_rotation,
        tex_ids=tex_ids,
        has_map=has_map,
        object_ids=data.object_ids,
        bounds_min=data.bounds_min_arr,
        bounds_max=data.bounds_max_arr,
        quad_img=quad_img if quad_img.dtype in (np.uint8, np.uint16) else bf16_bits(quad_img),
        brdf_lut=np.asarray(brdf_lut)[..., :2],
        env_quad=env_quad if env_quad.dtype == np.uint16 else bf16_bits(env_quad),
        env_rect0=np.asarray(env_rect0).astype(np.float32),
        env_tail=np.asarray(env_tail),
        tri_geo=tri_geo,
        tri_mrec=tri_mrec,
    )
