"""Texture sampling over the pyramid atlases (``unclerenderer_tpu/ops/texture.py``).

The port runs the reference's default material path (u8 or bf16 combined
quad atlas, trilinear with quad-derivative LOD) and its IBL path (seamless
packed-trilinear env cube, hat-function matmuls for the BRDF LUT and the
irradiance tail), plus ``gather_rows`` -- the K5 kernel
(``csrc/gather_rows.cu``).
"""

from __future__ import annotations

import torch

from . import _cuda

ADDRESS_WRAP = 0
ADDRESS_CLAMP = 1


def _decode_combined_u8(rows: torch.Tensor, c: int) -> torch.Tensor:
    """u8 combined-material lanes -> linear f32 before filtering: colour
    channels (``lane % c`` in 0..2 and 8..10) are stored on a gamma-2 curve,
    the rest linearly."""
    x = rows.to(torch.float32) * torch.tensor(1.0 / 255.0, dtype=torch.float32)
    ch = torch.arange(rows.shape[-1], device=rows.device) % c
    g2 = (ch < 3) | ((ch >= 8) & (ch < 11))
    return torch.where(g2, x * x, x)


def _rows_to_f32(rows: torch.Tensor, c: int) -> torch.Tensor:
    if rows.dtype == torch.uint8:
        if c != 16 or rows.shape[-1] % c:
            raise ValueError(
                "u8 atlas decode is defined only for COMBINED_C=16-interleaved "
                f"material rows, got lanes={rows.shape[-1]} c={c}")
        return _decode_combined_u8(rows, c)
    return rows.to(torch.float32)


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: ``table[idx]`` widened to f32, shape
    idx.shape + (C,)."""
    return table[idx.long()].to(torch.float32)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Exact row gather from a (rows, C) f32/bf16 table (K5 wrapper; the
    reference's ``gather_rows_onehot_matmul``).  idx: any shape, int32."""
    if _cuda.on_cpu("gather_rows", table):
        return gather_rows_ref(table, idx)
    if table.dtype not in (torch.float32, torch.bfloat16) or table.dim() != 2:
        raise ValueError("gather_rows: table must be a 2-D f32 or bf16 tensor")
    flat = idx.reshape(-1).to(torch.int32).contiguous()
    table = table.contiguous()
    _cuda.check_cuda("gather_rows", table, flat)
    n, c = flat.shape[0], table.shape[1]
    out = torch.empty((n, c), dtype=torch.float32, device=table.device)
    _cuda.launch("gather_rows", _cuda.ptr(table), _cuda.ptr(flat), _cuda.ptr(out),
                 n, c, int(table.dtype == torch.bfloat16))
    return out.reshape(*idx.shape, c)


def _wrap_index(i, size, mode: int):
    if mode == ADDRESS_WRAP:
        return torch.remainder(i, size)
    return torch.minimum(torch.clamp(i, min=0), size - 1)


def footprint_lod(dx, dy, base_w, base_h):
    """Isotropic LOD from explicit uv derivatives: max screen-axis footprint
    in texels, squared-log2."""
    sz = torch.stack([base_w.to(torch.float32), base_h.to(torch.float32)], dim=-1)
    lx = ((dx * sz) ** 2).sum(dim=-1)
    ly = ((dy * sz) ** 2).sum(dim=-1)
    rho2 = torch.maximum(lx, ly)
    return 0.5 * torch.log2(torch.clamp(rho2, min=1e-12))


def apply_texture_transform(uv, offset_scale, rotation):
    """KHR_texture_transform: scale, rotate, offset.
    offset_scale (..., 4) = (off.x, off.y, scale.x, scale.y); rotation
    (..., 2) = (cos, sin)."""
    scaled = uv * offset_scale[..., 2:4]
    cos_r, sin_r = rotation[..., 0], rotation[..., 1]
    rot = torch.stack(
        [scaled[..., 0] * cos_r - scaled[..., 1] * sin_r,
         scaled[..., 0] * sin_r + scaled[..., 1] * cos_r],
        dim=-1,
    )
    return rot + offset_scale[..., 0:2]


def cube_direction_to_face_uv(direction):
    """D3D cubemap addressing: direction (..., 3) -> (face (...,) i64, uv
    (..., 2) in [0, 1]).  Face order +X, -X, +Y, -Y, +Z, -Z."""
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(
        is_x, torch.where(x >= 0, 0, 1),
        torch.where(is_y, torch.where(y >= 0, 2, 3), torch.where(z >= 0, 4, 5)),
    )
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    ma = torch.clamp(ma, min=1e-20)
    u = torch.where(is_x, torch.where(x >= 0, -z, z),
                    torch.where(is_y, x, torch.where(z >= 0, x, -x)))
    v = torch.where(is_x, -y, torch.where(is_y, torch.where(y >= 0, z, -z), -y))
    uv = torch.stack([(u / ma + 1.0) * 0.5, (v / ma + 1.0) * 0.5], dim=-1)
    return face, uv


def _pyramid_rect(rect0, level):
    """rect0 (..., 4) float (x0, y0, w0, h0); level (...,) int -> (x, y, w,
    h) of that mip, level clamped to the chain length (mip L of a pow2
    texture sits at x-offset 2*(w0 - (w0 >> L)))."""
    x0 = rect0[..., 0].to(torch.int32)
    y0 = rect0[..., 1].to(torch.int32)
    w0 = rect0[..., 2].to(torch.int32)
    h0 = rect0[..., 3].to(torch.int32)
    mx = torch.maximum(w0, h0).to(torch.float32)
    lmax = torch.round(torch.log2(torch.clamp(mx, min=1.0))).to(torch.int32)
    lv = torch.minimum(torch.clamp(level, min=0), lmax)
    w = torch.clamp(w0 >> lv, min=1)
    h = torch.clamp(h0 >> lv, min=1)
    lw = torch.round(torch.log2(torch.clamp(w0.to(torch.float32), min=1.0))).to(torch.int32)
    x = x0 + 2 * (w0 - w) + torch.clamp(lv - lw, min=0)
    return x, y0, w, h


def _to_int(x: torch.Tensor) -> torch.Tensor:
    """f32 -> i32 like XLA's convert: saturating, NaN -> 0 (a plain cast of
    an out-of-range value is undefined)."""
    x = torch.nan_to_num(x, nan=0.0)
    return torch.clamp(x, -2147483648.0, 2147483520.0).to(torch.int32)


def sample_pyramid_bilinear(quad_flat, atlas_width: int, rect0, uv, level):
    """One bilinear tap (WRAP addressing, the material sampler) = one
    quad-record gather with mip-rect arithmetic.  quad_flat (H*W, 4*C):
    corners TL, TR, BL, BR of a C-channel texel."""
    c = quad_flat.shape[-1] // 4
    x, y, w, h = _pyramid_rect(rect0, level)
    tx = uv[..., 0] * w.to(torch.float32) - 0.5
    ty = uv[..., 1] * h.to(torch.float32) - 0.5
    fx0 = torch.floor(tx)
    fy0 = torch.floor(ty)
    fx = (tx - fx0)[..., None]
    fy = (ty - fy0)[..., None]
    ix = _wrap_index(_to_int(fx0), w, ADDRESS_WRAP)
    iy = _wrap_index(_to_int(fy0), h, ADDRESS_WRAP)
    flat = (y + iy) * atlas_width + (x + ix)
    quad = _rows_to_f32(quad_flat[flat.long()], c)
    top = quad[..., 0:c] * (1.0 - fx) + quad[..., c:2 * c] * fx
    bot = quad[..., 2 * c:3 * c] * (1.0 - fx) + quad[..., 3 * c:] * fx
    return top * (1.0 - fy) + bot * fy


def sample_pyramid_trilinear(quad_flat, atlas_width: int, rect0, uv, lod):
    """Trilinear tap: two bilinear taps on the quad atlas, mip lerp."""
    lod = torch.clamp(lod, min=0.0)
    l0 = _to_int(torch.floor(lod))
    frac = torch.clamp(lod - l0.to(torch.float32), 0.0, 1.0)[..., None]
    a = sample_pyramid_bilinear(quad_flat, atlas_width, rect0, uv, l0)
    b = sample_pyramid_bilinear(quad_flat, atlas_width, rect0, uv, l0 + 1)
    return a * (1.0 - frac) + b * frac


def sample_table_bilinear_matmul(table, uv):
    """Bilinear sample of a SMALL (TH, TW, C) table via hat-function
    matmuls (CLAMP, half-texel centers).  Exact 2-tap filtering needs full
    f32 matmuls: TF32 must be off on the card (``chip_smoke.py`` checks
    it)."""
    th, tw, c = table.shape
    shape = uv.shape[:-1]
    tx = torch.clamp(uv[..., 0] * tw - 0.5, 0.0, tw - 1.0).reshape(-1)
    ty = torch.clamp(uv[..., 1] * th - 0.5, 0.0, th - 1.0).reshape(-1)
    ix = torch.arange(tw, dtype=torch.float32, device=uv.device)
    iy = torch.arange(th, dtype=torch.float32, device=uv.device)
    wx = torch.clamp(1.0 - (tx[:, None] - ix[None, :]).abs(), min=0.0)
    wy = torch.clamp(1.0 - (ty[:, None] - iy[None, :]).abs(), min=0.0)
    z = wx @ table.permute(1, 0, 2).reshape(tw, th * c)
    out = (z.reshape(-1, th, c) * wy[..., None]).sum(dim=1)
    return out.reshape(shape + (c,))


def sample_cube_tail_matmul(tail, direction):
    """Cubemap bilinear sample of the small per-face tail (6, TH, TW, C):
    per-face hat matmuls + face select."""
    face, uv = cube_direction_to_face_uv(direction)
    out = sample_table_bilinear_matmul(tail[0], uv)
    for f in range(1, 6):
        out = torch.where((face == f)[..., None], sample_table_bilinear_matmul(tail[f], uv), out)
    return out


def _cube_face_rect(face_rect0, direction):
    face, uv = cube_direction_to_face_uv(direction)
    rect = torch.zeros(face.shape + (4,), dtype=torch.float32, device=direction.device)
    for f in range(6):
        rect = torch.where((face == f)[..., None], face_rect0[f].to(torch.float32), rect)
    return rect, uv


def sample_cube_pyramid_tri(env_tri_flat, atlas_width: int, face_rect0, direction, lod):
    """Trilinear cubemap sample with ONE row gather over the packed
    atlas: lanes 0:16 are the mip-L quad, 16:52 the parent 3x3 at mip L+1,
    and (seamless rows, >= 128 lanes) 52:72 the baked cross-face border
    lanes.  Returns (..., 4) f32."""
    rect, uv = _cube_face_rect(face_rect0, direction)
    lod = torch.clamp(lod, min=0.0)
    l0 = _to_int(torch.floor(lod))
    frac = torch.clamp(lod - l0.to(torch.float32), 0.0, 1.0)[..., None]
    seamless = env_tri_flat.shape[-1] >= 128

    x, y, w, h = _pyramid_rect(rect, l0)
    wf, hf = w.to(torch.float32), h.to(torch.float32)
    if seamless:
        tx = uv[..., 0] * wf - 0.5
        ty = uv[..., 1] * hf - 0.5
    else:
        tx = torch.minimum(torch.clamp(uv[..., 0] * wf - 0.5, min=0.0), wf - 1.0)
        ty = torch.minimum(torch.clamp(uv[..., 1] * hf - 0.5, min=0.0), hf - 1.0)
    fx0 = torch.floor(tx)
    fy0 = torch.floor(ty)
    fx = (tx - fx0)[..., None]
    fy = (ty - fy0)[..., None]
    ix_raw = _to_int(fx0)
    iy_raw = _to_int(fy0)
    ix = _wrap_index(ix_raw, w, ADDRESS_CLAMP)
    iy = _wrap_index(iy_raw, h, ADDRESS_CLAMP)
    env_rows = (y + iy) * atlas_width + (x + ix)
    row = env_tri_flat[env_rows.long()]
    q00, q10 = row[..., 0:4], row[..., 4:8]
    q01, q11 = row[..., 8:12], row[..., 12:16]
    if seamless:
        m_ix = (ix_raw < 0)[..., None]
        m_iy = (iy_raw < 0)[..., None]
        bl_, bt_, bc_ = row[..., 52:56], row[..., 56:60], row[..., 60:64]
        bl2, bt2 = row[..., 64:68], row[..., 68:72]
        both = m_ix & m_iy
        tl = torch.where(both, bc_, torch.where(m_ix, bl_, torch.where(m_iy, bt_, q00)))
        tr = torch.where(both, bt_, torch.where(m_ix, q00, torch.where(m_iy, bt2, q10)))
        bl = torch.where(both, bl_, torch.where(m_ix, bl2, torch.where(m_iy, q00, q01)))
        br = torch.where(both, q00, torch.where(m_ix, q01, torch.where(m_iy, q10, q11)))
    else:
        tl, tr, bl, br = q00, q10, q01, q11
    tl, tr, bl, br = (v.to(torch.float32) for v in (tl, tr, bl, br))
    a = (tl * (1.0 - fx) + tr * fx) * (1.0 - fy) + (bl * (1.0 - fx) + br * fx) * fy

    _, _, w2, h2 = _pyramid_rect(rect, l0 + 1)
    w2f, h2f = w2.to(torch.float32), h2.to(torch.float32)
    if seamless:
        tx2 = uv[..., 0] * w2f - 0.5
        ty2 = uv[..., 1] * h2f - 0.5
    else:
        tx2 = torch.minimum(torch.clamp(uv[..., 0] * w2f - 0.5, min=0.0), w2f - 1.0)
        ty2 = torch.minimum(torch.clamp(uv[..., 1] * h2f - 0.5, min=0.0), h2f - 1.0)
    fx20 = torch.floor(tx2)
    fy20 = torch.floor(ty2)
    fx2 = (tx2 - fx20)[..., None]
    fy2 = (ty2 - fy20)[..., None]
    ix2 = _to_int(fx20) if seamless else _wrap_index(_to_int(fx20), w2, ADDRESS_CLAMP)
    iy2 = _to_int(fy20) if seamless else _wrap_index(_to_int(fy20), h2, ADDRESS_CLAMP)
    # 3x3 window column/row of the base corner: parent p = i >> 1, base in
    # {p-1, p} -> col = i2 - (p - 1) in {0, 1}
    cox = (ix2 - (ix >> 1) + 1)[..., None, None]
    roy = (iy2 - (iy >> 1) + 1)[..., None, None]
    r3 = row[..., 16:52].reshape(row.shape[:-1] + (3, 3, 4))
    win_t = torch.where(cox == 0, r3[..., 0, 0:2, :], r3[..., 0, 1:3, :])
    win_m = torch.where(cox == 0, r3[..., 1, 0:2, :], r3[..., 1, 1:3, :])
    win_b = torch.where(cox == 0, r3[..., 2, 0:2, :], r3[..., 2, 1:3, :])
    row_top = torch.where(roy == 0, win_t, win_m).to(torch.float32)
    row_bot = torch.where(roy == 0, win_m, win_b).to(torch.float32)
    top2 = row_top[..., 0, :] * (1.0 - fx2) + row_top[..., 1, :] * fx2
    bot2 = row_bot[..., 0, :] * (1.0 - fx2) + row_bot[..., 1, :] * fx2
    b = top2 * (1.0 - fy2) + bot2 * fy2
    return a * (1.0 - frac) + b * frac
