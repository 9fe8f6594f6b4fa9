"""Texture sampling over the pyramid atlases (``unclerenderer_tpu/ops/texture.py``).

The port runs the reference's material samplers on the combined atlas in
both layouts -- the quad atlas (two row gathers per trilinear tap) and the
packed-trilinear atlas (one 16C-lane row gather, ``sample_pyramid_tri``) --
with the trilinear, bilinear and anisotropic footprints, and its IBL path
(seamless packed-trilinear env cube, hat-function matmuls for the BRDF LUT
and the irradiance tail), and the quad-atlas env samplers
(``sample_cube_pyramid``, ``sample_cube_pyramid_level``).  Six kernels
live here, each with its plain version (``*_ref``) beside it:

* ``gather_rows`` -- K5 (``csrc/gather_rows.cu``), the draw-mask row gather;
* ``mat_select`` -- K8 (``csrc/mat_select.cu``), the packed material decode
  under ``RenderSettings.mat_select_kernel`` (on the plain tap only);
* ``env_select`` -- K7 (``csrc/env_select.cu``), the seamless env decode
  under ``RenderSettings.env_select_kernel``;
* ``interp_attrs``, ``tap_footprint`` and ``material_tap`` -- R1, T1 and
  T2 (``csrc/material_tap.cu``), the material resolve's stages on both
  devices, from the resolve record image (``render/common.py
  resolve_materials``): R1 the attributes at the pixel centres, in every
  resolve; T1 every quad-LOD footprint, whatever the filter, atlas or
  raster backend; T2 the trilinear or dense anisotropic taps on the
  packed atlas (``tap_kernels_engage``), where the other taps read T1's
  planes with the plain samplers.
"""

from __future__ import annotations

import torch

from . import _cuda
from .fma import fdiff, fdot, fma

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
    is_bf16 = table.dtype == torch.bfloat16
    if not (is_bf16 or table.dtype == torch.float32) or table.dim() != 2:
        raise ValueError("gather_rows: table must be a 2-D f32 or bf16 tensor")
    # no tensor op for the frame's call: idx contiguous int32, table contiguous
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        idx = idx.to(torch.int32).contiguous()
    if not table.is_contiguous():
        table = table.contiguous()
    dev = _cuda.check_cuda("gather_rows", table, idx)
    c = table.shape[1]
    out = torch.empty((*idx.shape, c), dtype=torch.float32, device=table.device)
    if out.numel():
        _cuda.launch("gather_rows", dev, table.data_ptr(), idx.data_ptr(),
                     out.data_ptr(), idx.numel(), c, int(is_bf16))
    return out


def _wrap_index(i, size, mode: int):
    if mode == ADDRESS_WRAP:
        return torch.remainder(i, size)
    return torch.minimum(torch.clamp(i, min=0), size - 1)


def _footprint_axes(dx, dy, base_w, base_h, contract: bool = False):
    """Squared screen-axis footprints (lx, ly) in texels.  ``contract``: the
    sum of the two squares as the reference's ``uv_screen_lod`` contracts
    it, ``fma(v, v, u * u)`` (0 differing sums against it, where the
    uncontracted sum differs in 2-15% of them; its anisotropic twin, which
    reads lx and ly twice, does not contract)."""
    sz = torch.stack([base_w.to(torch.float32), base_h.to(torch.float32)], dim=-1)
    if not contract:
        return ((dx * sz) ** 2).sum(dim=-1), ((dy * sz) ** 2).sum(dim=-1)

    def sq(d):
        p = d * sz
        return fma(p[..., 1], p[..., 1], p[..., 0] * p[..., 0])

    return sq(dx), sq(dy)


def _iso_lod(lx, ly):
    return 0.5 * torch.log2(torch.clamp(torch.maximum(lx, ly), min=1e-12))


def _diff(x, dim: int, append=None, prepend=None):
    """``jnp.diff(x, axis=dim, append=..., prepend=...)`` for one step."""
    parts = [p for p in (prepend, x, append) if p is not None]
    x = torch.cat(parts, dim=dim) if len(parts) > 1 else x
    n = x.shape[dim]
    return x.narrow(dim, 1, n - 1) - x.narrow(dim, 0, n - 1)


def _edge_gated_uv_derivs(uv, same_tri_x, same_tri_y, same_tri_bx, same_tri_by,
                          uv_above, uv_below):
    """Screen-space uv derivatives that never cross a triangle edge: the
    forward difference where the +x / +y neighbour is the same triangle,
    else the backward difference where the -x / -y neighbour is, else 0
    (the quad helper-lane analog; a None backward mask takes the backward
    difference ungated).  uv (H, W, 2); the masks (H, W) bool; uv_above /
    uv_below (1, W, 2) the true rows around a row slab, None at the frame's
    edges (the edge row repeats: a 0 difference)."""
    dx = _diff(uv, 1, append=uv[:, -1:])
    dy = _diff(uv, 0, append=uv[-1:] if uv_below is None else uv_below)
    bx = _diff(uv, 1, prepend=uv[:, :1])
    by = _diff(uv, 0, prepend=uv[:1] if uv_above is None else uv_above)
    zero = torch.zeros_like(uv)
    dx = torch.where(same_tri_x[..., None], dx,
                     torch.where(same_tri_bx[..., None], bx, zero) if same_tri_bx is not None
                     else bx)
    dy = torch.where(same_tri_y[..., None], dy,
                     torch.where(same_tri_by[..., None], by, zero) if same_tri_by is not None
                     else by)
    return dx, dy


def uv_screen_lod(uv, base_w, base_h, same_tri_x, same_tri_y, uv_above=None, uv_below=None,
                  same_tri_bx=None, same_tri_by=None):
    """Per-pixel LOD from screen-space uv differences
    (``_edge_gated_uv_derivs``) with ``footprint_lod``'s rule: uv (H, W,
    2), base_w / base_h (H, W) mip-0 size, same_tri_* (H, W) whether the
    neighbour in that direction is the pixel's triangle."""
    dx, dy = _edge_gated_uv_derivs(uv, same_tri_x, same_tri_y, same_tri_bx, same_tri_by,
                                   uv_above, uv_below)
    return _iso_lod(*_footprint_axes(dx, dy, base_w, base_h, contract=True))


def uv_screen_lod_aniso(uv, base_w, base_h, same_tri_x, same_tri_y, max_aniso: int,
                        uv_above=None, uv_below=None, same_tri_bx=None, same_tri_by=None):
    """``(lod, dmaj, extent)`` of ``footprint_lod_aniso`` from the
    screen-space uv differences of ``uv_screen_lod``."""
    dx, dy = _edge_gated_uv_derivs(uv, same_tri_x, same_tri_y, same_tri_bx, same_tri_by,
                                   uv_above, uv_below)
    return footprint_lod_aniso(dx, dy, base_w, base_h, max_aniso)


def footprint_lod(dx, dy, base_w, base_h):
    """Isotropic LOD from explicit uv derivatives: max screen-axis footprint
    in texels, squared-log2."""
    return _iso_lod(*_footprint_axes(dx, dy, base_w, base_h))


def footprint_lod_aniso(dx, dy, base_w, base_h, max_aniso: int):
    """Anisotropic ``(lod, dmaj, extent)`` from explicit uv derivatives:
    the minor-axis LOD (floored so ``max_aniso`` taps still cover the major
    axis), the uv derivative along the major axis, and the tap-offset scale
    ``extent`` in [0, 1) (0 for an isotropic footprint)."""
    lx, ly = _footprint_axes(dx, dy, base_w, base_h)
    return _aniso_lod(lx, ly, dx, dy, max_aniso)


def _aniso_lod(lx, ly, dx, dy, max_aniso: int):
    rho_maj = torch.clamp(torch.maximum(lx, ly), min=1e-12)
    rho_min = torch.clamp(torch.minimum(lx, ly), min=1e-12)
    # the square root correctly rounded, as XLA's (PyTorch's vectorised f32
    # sqrt on the CPU is not: 0.2% of extents 1 ulp off)
    ratio = torch.sqrt((rho_maj / rho_min).double()).float()
    n_eff = torch.clamp(ratio, 1.0, float(max_aniso))
    rho_eff = torch.maximum(rho_min, rho_maj / (n_eff * n_eff))
    lod = 0.5 * torch.log2(rho_eff)
    dmaj = torch.where((lx >= ly)[..., None], dx, dy)
    extent = 1.0 - 1.0 / n_eff
    return lod, dmaj, extent


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


def edge_fn(pa, pb, X, Y):
    """Screen-space edge function of the pixel's triangle, contracted like
    the reference (near-degenerate triangles amplify any rounding
    difference through the barycentric divide)."""
    cx = fdiff(pa[..., 1], pb[..., 2], pa[..., 2], pb[..., 1])
    cy = fdiff(pa[..., 2], pb[..., 0], pa[..., 0], pb[..., 2])
    cz = fdiff(pa[..., 0], pb[..., 1], pa[..., 1], pb[..., 0])
    return fdot([(cx, X), (cy, Y)], cz)


def interp3(w, av, offset, n):
    """sum_k w_k * attr_k over the three vertex blocks of the resolve record."""
    a = [av[..., 9 + k * 16 + offset:9 + k * 16 + offset + n] for k in range(3)]
    return fdot([(w[0][..., None], a[0]), (w[1][..., None], a[1]), (w[2][..., None], a[2])])


def quad_corner_uvs(av, row0: int = 0):
    """D3D 2x2-quad derivatives with helper-lane semantics, evaluated
    analytically from the pixel's own triangle: the uv at the pixel's
    quad's TL, TR and BL centres (bases ``x & ~1``, ``y & ~1``, rows global
    from ``row0``).  av (H, W, >= 57): the record's vertex lanes."""
    height, width = av.shape[:2]
    dev = av.device
    xi = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    yi = torch.arange(row0, row0 + height, dtype=torch.int32, device=dev)[:, None]
    bx = (xi & ~1).to(torch.float32)
    by = (yi & ~1).to(torch.float32)
    p0, p1, p2 = av[..., 0:3], av[..., 3:6], av[..., 6:9]

    def uv_at(X, Y):
        f0 = edge_fn(p1, p2, X, Y)
        f1 = edge_fn(p2, p0, X, Y)
        f2 = edge_fn(p0, p1, X, Y)
        fs = f0 + f1 + f2
        fs = torch.where(fs != 0.0, fs, torch.ones_like(fs))
        return interp3((f0 / fs, f1 / fs, f2 / fs), av, 10, 2)

    return uv_at(bx + 0.5, by + 0.5), uv_at(bx + 1.5, by + 0.5), uv_at(bx + 0.5, by + 1.5)


def quad_derivatives(corners, offset_scale, rotation):
    """(d/dx, d/dy) of the transformed uv, as the shader's quad sees them,
    from ``quad_corner_uvs``'s corners."""
    uv_tl, uv_tr, uv_bl = corners
    s_tl = apply_texture_transform(uv_tl, offset_scale, rotation)
    return (apply_texture_transform(uv_tr, offset_scale, rotation) - s_tl,
            apply_texture_transform(uv_bl, offset_scale, rotation) - s_tl)


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


def _lerp(a, b, f):
    """``a * (1 - f) + b * f``, uncontracted."""
    return a * (1.0 - f) + b * f


def _tap_coords(rect0, uv, level):
    """Texel coordinates of a WRAP bilinear tap at ``level``: (x, y, w, h)
    of the mip rect, the floors (fx0, fy0) and their int conversions."""
    x, y, w, h = _pyramid_rect(rect0, level)
    tx = uv[..., 0] * w.to(torch.float32) - 0.5
    ty = uv[..., 1] * h.to(torch.float32) - 0.5
    fx0, fy0 = torch.floor(tx), torch.floor(ty)
    return x, y, w, h, tx, ty, fx0, fy0, _to_int(fx0), _to_int(fy0)


def sample_pyramid_tri_level(tri_flat, atlas_width: int, rect0, uv, level):
    """One bilinear tap at an integer mip over the PACKED atlas: lanes 0:4C
    of a packed row are exactly the quad atlas's row.  Returns (..., C)."""
    c = tri_flat.shape[-1] // 16
    x, y, w, h, tx, ty, fx0, fy0, ix_raw, iy_raw = _tap_coords(rect0, uv, level)
    fx = (tx - fx0)[..., None]
    fy = (ty - fy0)[..., None]
    ix = _wrap_index(ix_raw, w, ADDRESS_WRAP)
    iy = _wrap_index(iy_raw, h, ADDRESS_WRAP)
    quad = _rows_to_f32(tri_flat[((y + iy) * atlas_width + (x + ix)).long()][..., :4 * c], c)
    return _lerp(_lerp(quad[..., 0:c], quad[..., c:2 * c], fx),
                 _lerp(quad[..., 2 * c:3 * c], quad[..., 3 * c:], fx), fy)


def atlas_is_packed_tri(quad_flat) -> bool:
    """The combined packed-trilinear atlas has 16 * 16 = 256 lanes, the
    combined quad atlas 64."""
    return quad_flat.shape[-1] == 256


def sample_level_any(quad_flat, atlas_width: int, rect0, uv, level):
    """Bilinear tap at an integer mip on either atlas layout."""
    if atlas_is_packed_tri(quad_flat):
        return sample_pyramid_tri_level(quad_flat, atlas_width, rect0, uv, level)
    return sample_pyramid_bilinear(quad_flat, atlas_width, rect0, uv, level)


def sample_trilinear_any(quad_flat, atlas_width: int, rect0, uv, lod, select_kernel=False):
    """Trilinear tap on either layout: one row gather on the packed atlas
    (``select_kernel``: decoded by K8), two on the quad atlas."""
    if atlas_is_packed_tri(quad_flat):
        return sample_pyramid_tri(quad_flat, atlas_width, rect0, uv, lod,
                                  select_kernel=select_kernel)
    return sample_pyramid_trilinear(quad_flat, atlas_width, rect0, uv, lod)


def sample_pyramid_tri(tri_flat, atlas_width: int, rect0, uv, lod, select_kernel: bool = False):
    """Trilinear tap with ONE row gather over the packed atlas
    (``build_pyramid_tri_atlas``): lanes 0:4C of the row are the mip-L
    quad, lanes 4C:13C the parent texel's 3x3 at mip L+1, from which the
    second tap's 2x2 is a lane select.  tri_flat (H*W, 16C); returns
    (..., C).

    ``select_kernel`` (C = 16) computes the select parameters before the
    gather and hands row index + parameters to K8 (``mat_select``); off,
    the 3x3 select runs on the raw rows and only the 8 winning lane groups
    decode (select-then-decode; selects commute with the per-element
    decode).  The window column/row are clipped to [0, 1] on both paths
    (the saturated w == 1 tail, where the window is uniform)."""
    c = tri_flat.shape[-1] // 16
    lod = torch.clamp(lod, min=0.0)
    l0 = _to_int(torch.floor(lod))
    frac = torch.clamp(lod - l0.to(torch.float32), 0.0, 1.0)
    x, y, w, h, tx, ty, fx0, fy0, ix_raw, iy_raw = _tap_coords(rect0, uv, l0)
    ix = _wrap_index(ix_raw, w, ADDRESS_WRAP)
    iy = _wrap_index(iy_raw, h, ADDRESS_WRAP)
    rows_idx = (y + iy) * atlas_width + (x + ix)
    _, _, _, _, tx2, ty2, fx20, fy20, ix2_raw, iy2_raw = _tap_coords(rect0, uv, l0 + 1)
    cox = torch.clamp(ix2_raw - (ix_raw >> 1) + 1, 0, 1)
    roy = torch.clamp(iy2_raw - (iy_raw >> 1) + 1, 0, 1)
    if select_kernel and c == 16:
        params7 = torch.stack([tx - fx0, ty - fy0, tx2 - fx20, ty2 - fy20, frac,
                               cox.to(torch.float32), roy.to(torch.float32)]).reshape(7, -1)
        out = mat_select(tri_flat, rows_idx.reshape(-1), params7)
        return out.reshape(uv.shape[:-1] + (c,))
    fx, fy = (tx - fx0)[..., None], (ty - fy0)[..., None]
    fx2, fy2 = (tx2 - fx20)[..., None], (ty2 - fy20)[..., None]
    row = tri_flat[rows_idx.long()]
    quad = _rows_to_f32(row[..., 0:4 * c], c)
    a = _lerp(_lerp(quad[..., 0:c], quad[..., c:2 * c], fx),
              _lerp(quad[..., 2 * c:3 * c], quad[..., 3 * c:], fx), fy)
    cox0 = (cox == 0)[..., None, None]
    roy0 = (roy == 0)[..., None, None]
    r3 = row[..., 4 * c:13 * c].reshape(row.shape[:-1] + (3, 3, c))
    win_t = torch.where(cox0, r3[..., 0, 0:2, :], r3[..., 0, 1:3, :])
    win_m = torch.where(cox0, r3[..., 1, 0:2, :], r3[..., 1, 1:3, :])
    win_b = torch.where(cox0, r3[..., 2, 0:2, :], r3[..., 2, 1:3, :])
    rt = _rows_to_f32(torch.where(roy0, win_t, win_m).flatten(-2), c)
    rb = _rows_to_f32(torch.where(roy0, win_m, win_b).flatten(-2), c)
    b = _lerp(_lerp(rt[..., 0:c], rt[..., c:], fx2), _lerp(rb[..., 0:c], rb[..., c:], fx2), fy2)
    return _lerp(a, b, frac[..., None])


def sample_aniso_line(quad_flat, atlas_width: int, rect0, uv, lod, dmaj, extent, n: int,
                      select_kernel: bool = False):
    """The dense anisotropic taps: ``n`` trilinear taps at ``lod`` along
    ``dmaj`` (t = ((k + 0.5) / n - 0.5) * extent), averaged."""
    acc = 0.0
    for k in range(n):
        t = ((k + 0.5) / n - 0.5) * extent
        # the reference's uv + dmaj * t contracts to one FMA on XLA:CPU
        acc = acc + sample_trilinear_any(quad_flat, atlas_width, rect0,
                                         fma(dmaj, t[..., None], uv), lod,
                                         select_kernel=select_kernel)
    return acc / n


# The K7/K8 blends contract like the reference's kernels do under XLA:CPU
# (measured bit-equal on 20k random rows each); the CUDA kernels use the
# same __fmaf_rn sequence.
def _lerp_fa(a, b, f):
    """``a * (1 - f) + b * f`` as ``fma(a, 1 - f, b * f)``."""
    return fma(a, 1.0 - f, b * f)


def _lerp_fb(a, b, f):
    """``a * (1 - f) + b * f`` as ``fma(b, f, a * (1 - f))``."""
    return fma(b, f, a * (1.0 - f))


def mat_select_ref(tri_flat: torch.Tensor, rows_idx: torch.Tensor, params7: torch.Tensor):
    """Plain version of K8 (the reference's ``_mat_select_kernel``): per
    pixel, row ``rows_idx[n]`` of the packed (rows, 16C) atlas decoded to
    f32 (u8: gamma 2 on channels {0,1,2,8,9,10}), tap-a quad blend, tap-b
    2x2 of the 3x3 chosen by (cox < 0.5, roy < 0.5), mip lerp, contracted
    as the reference's kernel is.  params7 (7, N) f32 = [fx, fy, fx2, fy2,
    frac, cox, roy]; returns (N, C) f32."""
    c = tri_flat.shape[-1] // 16
    n = rows_idx.shape[0]
    rows = tri_flat[rows_idx.long()].reshape(n, 16, c)
    fx, fy, fx2, fy2, frac = (params7[k][:, None] for k in range(5))
    i0 = torch.where(params7[5] < 0.5, 0, 1)
    j0 = torch.where(params7[6] < 0.5, 0, 1)
    base = 4 + j0 * 3 + i0
    q = torch.arange(4, device=rows.device).expand(n, 4)
    cells = torch.stack([base, base + 1, base + 3, base + 4], dim=1)
    lane_groups = torch.cat([q, cells], dim=1)[:, :, None].expand(n, 8, c)
    v = _rows_to_f32(torch.gather(rows, 1, lane_groups), c)
    a = _lerp_fa(_lerp_fa(v[:, 0], v[:, 1], fx), _lerp_fa(v[:, 2], v[:, 3], fx), fy)
    b = _lerp_fa(_lerp_fa(v[:, 4], v[:, 5], fx2), _lerp_fa(v[:, 6], v[:, 7], fx2), fy2)
    return _lerp_fb(a, b, frac)


# the atlas element types the kernels read (K8, M1), as their C entries code them
ATLAS_DTYPE_CODE = {torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2}


def mat_select(tri_flat: torch.Tensor, rows_idx: torch.Tensor, params7: torch.Tensor):
    """K8 wrapper (same contract as ``mat_select_ref``) for the C = 16
    material rows at which the reference reaches its kernel
    (``sample_pyramid_tri``); the same on both devices."""
    if tri_flat.dim() != 2 or tri_flat.shape[-1] != 256 or tri_flat.dtype not in ATLAS_DTYPE_CODE:
        raise ValueError("mat_select: atlas must be (rows, 256) u8, f32 or bf16 (C = 16)")
    n = rows_idx.shape[0]
    if params7.shape != (7, n) or params7.dtype != torch.float32:
        raise ValueError("mat_select: params7 must be (7, N) f32")
    if _cuda.on_cpu("mat_select", tri_flat):
        return mat_select_ref(tri_flat, rows_idx, params7)
    # .contiguous() costs a dispatcher call even when it returns its tensor
    if rows_idx.dtype != torch.int32 or not rows_idx.is_contiguous():
        rows_idx = rows_idx.to(torch.int32).contiguous()
    if not params7.is_contiguous():
        params7 = params7.contiguous()
    if not tri_flat.is_contiguous():
        tri_flat = tri_flat.contiguous()
    dev = _cuda.check_cuda("mat_select", tri_flat, rows_idx, params7)
    if tri_flat.data_ptr() % 16:  # vector loads of its lane groups
        raise ValueError("mat_select: the atlas must be 16-byte aligned")
    out = torch.empty((n, 16), dtype=torch.float32, device=tri_flat.device)
    _cuda.launch("mat_select", dev, tri_flat.data_ptr(), rows_idx.data_ptr(), params7.data_ptr(),
                 out.data_ptr(), n, ATLAS_DTYPE_CODE[tri_flat.dtype])
    return out


def tap_footprint_ref(full, uv, lanes, row0: int = 0, max_aniso: int = 0):
    """Plain version of T1: a material slot's tap coordinates and footprint
    as SoA planes (K, H*W) f32 -- su, sv, lod (``footprint_lod``), and with
    ``max_aniso`` > 0 dmaj.u, dmaj.v, extent (``footprint_lod_aniso``) --
    from the (H, W, 128) resolve record image ``full`` (vertices, their uvs,
    and the slot's offset-scale, rotation and rect at ``lanes``), the
    pixels' centre uv (H, W, 2) and the quad corners' (``quad_corner_uvs``
    from global row ``row0``)."""
    lane_os, lane_rot, lane_rect = lanes
    t_os = full[..., lane_os:lane_os + 4]
    t_rot = full[..., lane_rot:lane_rot + 2]
    rect0 = full[..., lane_rect:lane_rect + 4]
    suv = apply_texture_transform(uv, t_os, t_rot)
    d_dx, d_dy = quad_derivatives(quad_corner_uvs(full[..., 0:57], row0), t_os, t_rot)
    base_w = rect0[..., 2] * t_os[..., 2].abs()
    base_h = rect0[..., 3] * t_os[..., 3].abs()
    if max_aniso:
        lod, dmaj, extent = footprint_lod_aniso(d_dx, d_dy, base_w, base_h, max_aniso)
        planes = (suv[..., 0], suv[..., 1], lod, dmaj[..., 0], dmaj[..., 1], extent)
    else:
        planes = (suv[..., 0], suv[..., 1], footprint_lod(d_dx, d_dy, base_w, base_h))
    return torch.stack(planes).reshape(len(planes), -1)


def _check_records(name, full):
    if full.dim() != 3 or full.shape[-1] != 128 or full.dtype != torch.float32:
        raise ValueError(f"{name}: the record image must be (H, W, 128) f32")


# the interpolated attributes (lane offset in a vertex's 16, width): world_pos,
# v_normal, tangent4, uv, v_color
ATTRS = ((0, 3), (3, 3), (6, 4), (10, 2), (12, 4))


def interp_attrs_ref(full, width: int, row0: int = 0):
    """Plain version of R1: the resolve's attributes at the pixel centres of
    the (H, W, 128) resolve record image ``full`` -- the barycentric weights
    of the pixel's triangle (``edge_fn`` of its homogeneous screen vertices,
    lanes 0:9) at (x + 0.5, y + 0.5), rows global from ``row0``, then
    ``interp3`` of each attribute -- as the five (H, W, n) f32 images
    world_pos, v_normal, tangent4, uv, v_color."""
    av = full[..., 0:57]
    p0, p1, p2 = av[..., 0:3], av[..., 3:6], av[..., 6:9]
    dev = full.device
    yy = torch.arange(row0, row0 + full.shape[0], dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    qx, qy = xx + 0.5, yy + 0.5
    e0 = edge_fn(p1, p2, qx, qy)
    e1 = edge_fn(p2, p0, qx, qy)
    e2 = edge_fn(p0, p1, qx, qy)
    ssum = e0 + e1 + e2
    ssum = torch.where(ssum != 0.0, ssum, torch.ones_like(ssum))
    bary = (e0 / ssum, e1 / ssum, e2 / ssum)
    return tuple(interp3(bary, av, offset, n) for offset, n in ATTRS)


def interp_attrs(full, width: int, row0: int = 0):
    """R1 wrapper (same contract as ``interp_attrs_ref``): the resolve's
    attribute interpolation on both devices (the plain version on the
    CPU)."""
    _check_records("interp_attrs", full)
    if full.shape[1] != width:
        raise ValueError(f"interp_attrs: the record image is {full.shape[1]} wide, not {width}")
    if _cuda.on_cpu("interp_attrs", full):
        return interp_attrs_ref(full, width, row0)
    if not full.is_contiguous():
        full = full.contiguous()
    dev = _cuda.check_cuda("interp_attrs", full)
    if full.data_ptr() % 16:  # 16-byte loads of the vertex lanes
        raise ValueError("interp_attrs: the record image must be 16-byte aligned")
    height = full.shape[0]
    outs = tuple(torch.empty((height, width, n), dtype=torch.float32, device=full.device)
                 for _offset, n in ATTRS)
    _cuda.launch("interp_attrs", dev, full.data_ptr(), *(o.data_ptr() for o in outs),
                 height * width, width, row0)
    return outs


def tap_footprint(full, uv, lanes, row0: int = 0, max_aniso: int = 0):
    """T1 wrapper (same contract as ``tap_footprint_ref``): the resolve's
    quad-LOD footprint on both devices (the plain version on the CPU)."""
    _check_records("tap_footprint", full)
    if uv.shape != full.shape[:2] + (2,) or uv.dtype != torch.float32:
        raise ValueError("tap_footprint: uv must be (H, W, 2) f32")
    if _cuda.on_cpu("tap_footprint", full):
        return tap_footprint_ref(full, uv, lanes, row0, max_aniso)
    # the frame's record image and centre uv are contiguous: no copy, no dispatch
    if not full.is_contiguous():
        full = full.contiguous()
    if not uv.is_contiguous():
        uv = uv.contiguous()
    dev = _cuda.check_cuda("tap_footprint", full, uv)
    n = full.shape[0] * full.shape[1]
    out = torch.empty((6 if max_aniso else 3, n), dtype=torch.float32, device=full.device)
    _cuda.launch("tap_footprint", dev, full.data_ptr(), uv.data_ptr(), out.data_ptr(), n,
                 full.shape[1], row0, *lanes, max_aniso)
    return out


def material_tap_ref(tri_flat, atlas_width: int, full, rect_lane: int, planes, n_taps: int = 0,
                     select: bool = False):
    """Plain version of T2: per pixel of the (H, W, 128) record image, the
    slot's trilinear tap (``sample_pyramid_tri``) at ``tap_footprint``'s
    planes -- one at su, sv (``n_taps`` 0), or ``sample_aniso_line``'s
    ``n_taps`` along dmaj --, the slot's rect at ``rect_lane``; ``select``:
    the packed decode by K8 (``mat_select_kernel``).  Returns (H*W, 16)
    f32."""
    rect0 = full[..., rect_lane:rect_lane + 4].reshape(-1, 4)
    suv, lod = planes[0:2].t(), planes[2]
    if n_taps == 0:
        return sample_pyramid_tri(tri_flat, atlas_width, rect0, suv, lod, select_kernel=select)
    return sample_aniso_line(tri_flat, atlas_width, rect0, suv, lod, planes[3:5].t(), planes[5],
                             n_taps, select_kernel=select)


def material_tap(tri_flat, atlas_width: int, full, rect_lane: int, planes, n_taps: int = 0,
                 select: bool = False):
    """T2 wrapper (same contract as ``material_tap_ref``) for the packed
    (rows, 256) u8, f32 or bf16 atlas (C = 16)."""
    if tri_flat.dim() != 2 or tri_flat.shape[-1] != 256 or tri_flat.dtype not in ATLAS_DTYPE_CODE:
        raise ValueError("material_tap: atlas must be (rows, 256) u8, f32 or bf16 (C = 16)")
    _check_records("material_tap", full)
    n = full.shape[0] * full.shape[1]
    if planes.shape != (6 if n_taps else 3, n) or planes.dtype != torch.float32:
        raise ValueError("material_tap: planes must be tap_footprint's (3 or 6, H*W) f32")
    if _cuda.on_cpu("material_tap", tri_flat):
        return material_tap_ref(tri_flat, atlas_width, full, rect_lane, planes, n_taps, select)
    if not full.is_contiguous():
        full = full.contiguous()
    if not planes.is_contiguous():
        planes = planes.contiguous()
    dev = _cuda.check_cuda("material_tap", tri_flat, full, planes)
    if tri_flat.data_ptr() % 16:  # vector loads of its lane groups
        raise ValueError("material_tap: the atlas must be 16-byte aligned")
    out = torch.empty((n, 16), dtype=torch.float32, device=tri_flat.device)
    _cuda.launch("material_tap", dev, tri_flat.data_ptr(), full.data_ptr(), planes.data_ptr(),
                 out.data_ptr(), n, atlas_width, tri_flat.shape[0], rect_lane, n_taps,
                 ATLAS_DTYPE_CODE[tri_flat.dtype], int(select))
    return out


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


def _sample_cube_bilinear(env_quad_flat, atlas_width: int, rect, uv, level):
    """One bilinear tap of the quad-atlas env samplers: CLAMP addressing in
    the face's mip rect, the three blends contracted as the reference's
    jitted samplers (``_lerp_fa``)."""
    c = env_quad_flat.shape[-1] // 4
    x, y, w, h = _pyramid_rect(rect, level)
    wf, hf = w.to(torch.float32), h.to(torch.float32)
    # D3D clamps each tap: below half a texel both taps land on texel 0, so
    # the blend fraction dies out there too
    tx = torch.minimum(torch.clamp(uv[..., 0] * wf - 0.5, min=0.0), wf - 1.0)
    ty = torch.minimum(torch.clamp(uv[..., 1] * hf - 0.5, min=0.0), hf - 1.0)
    fx0 = torch.floor(tx)
    fy0 = torch.floor(ty)
    fx = (tx - fx0)[..., None]
    fy = (ty - fy0)[..., None]
    ix = _wrap_index(_to_int(fx0), w, ADDRESS_CLAMP)
    iy = _wrap_index(_to_int(fy0), h, ADDRESS_CLAMP)
    quad = _rows_to_f32(env_quad_flat[((y + iy) * atlas_width + (x + ix)).long()], c)
    top = _lerp_fa(quad[..., 0:c], quad[..., c:2 * c], fx)
    bot = _lerp_fa(quad[..., 2 * c:3 * c], quad[..., 3 * c:], fx)
    return _lerp_fa(top, bot, fy)


def sample_cube_pyramid(env_quad_flat, atlas_width: int, face_rect0, direction, lod):
    """Cubemap trilinear sample over the quad-record pyramid atlas (CLAMP
    addressing a face): two bilinear taps at floor(lod) and the next mip,
    blended by the fraction.  face_rect0 (6, 4): each face's mip-0 rect."""
    rect, uv = _cube_face_rect(face_rect0, direction)
    lod = torch.clamp(lod, min=0.0)
    l0 = _to_int(torch.floor(lod))
    frac = torch.clamp(lod - l0.to(torch.float32), 0.0, 1.0)[..., None]
    a = _sample_cube_bilinear(env_quad_flat, atlas_width, rect, uv, l0)
    b = _sample_cube_bilinear(env_quad_flat, atlas_width, rect, uv, l0 + 1)
    return _lerp_fa(a, b, frac)


def sample_cube_pyramid_level(env_quad_flat, atlas_width: int, face_rect0, direction, level):
    """Single-tap cube sample at an integer mip over the quad-record
    pyramid atlas (the reference's SampleLevel(maxMip) irradiance fetch)."""
    rect, uv = _cube_face_rect(face_rect0, direction)
    return _sample_cube_bilinear(env_quad_flat, atlas_width, rect, uv, level)


def env_select_ref(env_tri_flat: torch.Tensor, env_rows: torch.Tensor, params9: torch.Tensor):
    """Plain version of K7 (the reference's ``_env_select_kernel``): per
    pixel, row ``env_rows[n]`` of the seamless packed env atlas (>= 72
    lanes of 4-channel groups).  Tap a picks its 2x2 from the quad and the
    baked border groups by (m_ix > 0.5, m_iy > 0.5); tap b its 2x2 of the
    3x3 by (cox < 0.5, roy < 0.5) -- cox/roy unclipped, as the kernel
    receives them; mip lerp, contracted as the reference's kernel is.
    params9 (9, N) f32 = [fx, fy, fx2, fy2, frac, m_ix, m_iy, cox, roy];
    returns (N, 4) f32."""
    n = env_rows.shape[0]
    groups = env_tri_flat[env_rows.long()].reshape(n, -1, 4)
    fx, fy, fx2, fy2, frac = (params9[k][:, None] for k in range(5))
    m_ix, m_iy = params9[5] > 0.5, params9[6] > 0.5
    both = m_ix & m_iy

    def pick(g_both, g_ix, g_iy, g_none):
        return torch.where(both, g_both, torch.where(m_ix, g_ix, torch.where(m_iy, g_iy, g_none)))

    # groups: quad 0-3, 3x3 cell (j, i) at 4 + 3j + i, borders L 13, T 14,
    # corner 15, L2 16, T2 17
    tl, tr = pick(15, 13, 14, 0), pick(14, 0, 17, 1)
    bl, br = pick(13, 16, 0, 2), pick(0, 2, 1, 3)
    base = 4 + torch.where(params9[8] < 0.5, 0, 1) * 3 + torch.where(params9[7] < 0.5, 0, 1)
    sel = torch.stack([tl, tr, bl, br, base, base + 1, base + 3, base + 4], dim=1)
    v = torch.gather(groups, 1, sel[:, :, None].expand(n, 8, 4)).to(torch.float32)
    a = _lerp_fa(_lerp_fb(v[:, 0], v[:, 1], fx), _lerp_fb(v[:, 2], v[:, 3], fx), fy)
    b = _lerp_fa(_lerp_fa(v[:, 4], v[:, 5], fx2), _lerp_fa(v[:, 6], v[:, 7], fx2), fy2)
    return _lerp_fb(a, b, frac)


def env_select(env_tri_flat: torch.Tensor, env_rows: torch.Tensor, params9: torch.Tensor):
    """K7 wrapper (same contract as ``env_select_ref``)."""
    if _cuda.on_cpu("env_select", env_tri_flat):
        return env_select_ref(env_tri_flat, env_rows, params9)
    if (env_tri_flat.dim() != 2 or env_tri_flat.shape[-1] < 72
            or env_tri_flat.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError("env_select: env atlas must be (rows, >= 72 lanes) f32 or bf16")
    n = env_rows.shape[0]
    if params9.shape != (9, n) or params9.dtype != torch.float32:
        raise ValueError("env_select: params9 must be (9, N) f32")
    env_rows = env_rows.to(torch.int32).contiguous()
    env_tri_flat, params9 = env_tri_flat.contiguous(), params9.contiguous()
    dev = _cuda.check_cuda("env_select", env_tri_flat, env_rows, params9)
    out = torch.empty((n, 4), dtype=torch.float32, device=env_tri_flat.device)
    _cuda.launch("env_select", dev, env_tri_flat.data_ptr(), env_rows.data_ptr(),
                 params9.data_ptr(), out.data_ptr(), n, env_tri_flat.shape[-1],
                 int(env_tri_flat.dtype == torch.bfloat16))
    return out


def sample_cube_pyramid_tri(env_tri_flat, atlas_width: int, face_rect0, direction, lod,
                            select_kernel: bool = False):
    """Trilinear cubemap sample with ONE row gather over the packed
    atlas: lanes 0:16 are the mip-L quad, 16:52 the parent 3x3 at mip L+1,
    and (seamless rows, >= 128 lanes) 52:72 the baked cross-face border
    lanes.  Returns (..., 4) f32.

    ``select_kernel`` (seamless rows only) computes the select parameters
    before the gather and hands them to K7 (``env_select``), with the
    kernel's own semantics: cox/roy unclipped and tested ``< 0.5``, where
    the path below tests ``== 0``."""
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
    if select_kernel and seamless:
        _, _, _, _, tx2k, ty2k, fx20k, fy20k, ix2k, iy2k = _tap_coords(rect, uv, l0 + 1)
        params9 = torch.stack([
            tx - fx0, ty - fy0, tx2k - fx20k, ty2k - fy20k, frac[..., 0],
            (ix_raw < 0).to(torch.float32), (iy_raw < 0).to(torch.float32),
            (ix2k - (ix >> 1) + 1).to(torch.float32), (iy2k - (iy >> 1) + 1).to(torch.float32),
        ]).reshape(9, -1)
        out = env_select(env_tri_flat, env_rows.reshape(-1), params9)
        return out.reshape(uv.shape[:-1] + (4,))
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
