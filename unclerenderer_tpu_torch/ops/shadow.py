"""Directional shadow receiver: superblock PCF (``unclerenderer_tpu/ops/shadow.py``).

The shadow map (``render/common.py raster_shadow``) packs into a superblock
table: each row holds an 8x8 block of depths plus a +2 apron (100 of 128
lanes), ceil-quantized to u16 (``pack_shadow_blocks_u16``, the default) or
as f32 (``pack_shadow_blocks``, ``RenderSettings.shadow_table_u16=False``:
the reference's bit-exact oracle table).  Per receiver, K4 (``select9``,
``csrc/shadow_select9.cu``, an entry per row type) fetches the 3x3 texel
neighbourhood from it;
the compare and the PCF blend -- the deferred 4-tap or the forward 2x2
corners (``pcf``) -- stay plain tensor code (``_pcf_tail``), shared with
the reference's formulation.
"""

from __future__ import annotations

import torch

from ..core.passes import named_pass
from . import _cuda
from .fma import fma
from .texture import _to_int

U16_BORDER = 65535  # = always lit, the +inf analog


def shadow_block_shape(size: int) -> tuple:
    """8x8 blocks at every map size >= 2048 (100 of 128 lanes)."""
    b = max(4, min(8, size // 256))
    return b, b


def u16_values(table: torch.Tensor) -> torch.Tensor:
    """int16 storage of u16 depths -> their unsigned values as int32."""
    return table.to(torch.int32) & 0xFFFF


def pack_shadow_blocks(shadow_map: torch.Tensor) -> torch.Tensor:
    """(S, S) depth -> (S/bh * S/bw, 128) f32 superblock rows, the layout of
    ``pack_shadow_blocks_u16`` with the depths as they are and +inf (= always
    lit) outside the map: compares are unquantized."""
    return _pack_blocks_core(shadow_map.to(torch.float32), float("inf"))


def pack_shadow_blocks_u16(shadow_map: torch.Tensor) -> torch.Tensor:
    """(S, S) depth -> (S/bh * S/bw, 128) superblock rows of
    ``q = ceil(clip(d, 0, 1) * 65535)`` (stored as int16 bit patterns).
    Row r = block (by, bx) holds texels [by*bh .. by*bh+bh+1] x
    [bx*bw .. bx*bw+bw+1] (apron +2 on the positive side), border 65535
    outside the map, channel y_in_block*(bw+2) + x_in_block."""
    q = torch.clamp(torch.ceil(shadow_map.to(torch.float32) * 65535.0), 0.0, 65535.0)
    return _pack_blocks_core(q.to(torch.int32), U16_BORDER).to(torch.int16)


def _pack_blocks_core(sm: torch.Tensor, border) -> torch.Tensor:
    s = sm.shape[0]
    bh, bw = shadow_block_shape(s)
    c = (bh + 2) * (bw + 2)
    cpad = 128 if c <= 128 else 256
    nby, nbx = s // bh, s // bw
    # the map with its +2 apron (border beyond the edge), then one strided
    # window per block
    padded = torch.full((s + bh, s + bw), border, dtype=sm.dtype, device=sm.device)
    padded[:s, :s] = sm
    win = padded.unfold(0, bh + 2, bh)[:nby].unfold(1, bw + 2, bw)[:, :nbx]
    flat = win.reshape(nby * nbx, c)
    out = torch.zeros((nby * nbx, cpad), dtype=sm.dtype, device=sm.device)
    out[:, :c] = flat
    return out


def select9_ref(table: torch.Tensor, row: torch.Tensor, base: torch.Tensor, deltas) -> torch.Tensor:
    """Plain version of K4: out[n, k] = table[row[n], base[n] + deltas[k]]
    as f32.  table (rows, lanes) int16 (u16 bits) or f32; row/base (N,)
    i32.  An f32 lane comes out as ``x + 0``, the value of the reference's
    one-hot lane sum (-0 becomes +0; every other value, inf and NaN
    included, is kept)."""
    lanes = table.shape[1]
    d = torch.as_tensor(deltas, dtype=torch.int64, device=table.device)
    idx = row.long()[:, None] * lanes + base.long()[:, None] + d[None, :]
    got = table.reshape(-1)[idx]
    if table.dtype == torch.float32:
        return got + 0.0
    return u16_values(got).to(torch.float32)


def pcf_deltas(bw: int) -> tuple:
    """Lane offsets of a 3x3 neighbourhood in rows of blocks ``bw`` wide
    with their +2 apron, in (dy*3 + dx) order."""
    return tuple(dy * (bw + 2) + dx for dy in range(3) for dx in range(3))


# the 3x3 deltas of every block width shadow_block_shape gives -> that width
_PCF_BW = {pcf_deltas(bw): bw for bw in range(4, 9)}


# K4's C entry (and launch count) of each row type
_SELECT9_ENTRY = {torch.int16: "shadow_select9", torch.float32: "shadow_select9_f32"}


def select9(table: torch.Tensor, row: torch.Tensor, base: torch.Tensor, deltas) -> torch.Tensor:
    """K4 wrapper (same contract as ``select9_ref``) for the 3x3 deltas
    ``pcf_deltas(bw)``, bw = 4..8, that the frame uses; the same on both
    devices.  u16 rows (int16 storage) launch ``shadow_select9``, f32 rows
    ``shadow_select9_f32``."""
    bw = _PCF_BW.get(tuple(deltas))
    if bw is None:
        raise ValueError(f"select9: deltas {tuple(deltas)} are not a 3x3 of pcf_deltas(4..8)")
    entry = _SELECT9_ENTRY.get(table.dtype)
    if entry is None or table.dim() != 2 or table.shape[1] % 8:
        raise ValueError("select9: table must be (rows, lanes) int16 or float32 with "
                         "lanes % 8 == 0")
    if _cuda.on_cpu(entry, table):
        return select9_ref(table, row, base, deltas)
    # .contiguous() costs a dispatcher call even when it returns its tensor
    if row.dtype != torch.int32 or not row.is_contiguous():
        row = row.to(torch.int32).contiguous()
    if base.dtype != torch.int32 or not base.is_contiguous():
        base = base.to(torch.int32).contiguous()
    dev = _cuda.check_cuda(entry, table, row, base)
    if table.data_ptr() % 16:  # aligned word loads of its rows
        raise ValueError("select9: the table must be 16-byte aligned")
    n = row.shape[0]
    out = torch.empty((n, 9), dtype=torch.float32, device=table.device)
    _cuda.launch(entry, dev, table.data_ptr(), row.data_ptr(), base.data_ptr(),
                 out.data_ptr(), n, table.shape[1], bw)
    return out


def hom_dot4(p3: torch.Tensor, m: torch.Tensor) -> list:
    """Columns of ``[p, 1] @ m`` for (..., 3) points and a (4, 4) matrix,
    summed pairwise without contraction -- the reference's XLA:CPU dot
    order ``(x*m0 + y*m1) + (z*m2 + 1*m3)`` (0 differing values measured on
    24k random points)."""
    x, y, z = p3[..., 0], p3[..., 1], p3[..., 2]
    return [(x * m[0, j] + y * m[1, j]) + (z * m[2, j] + m[3, j]) for j in range(4)]


def _shadow_project(world_pos, light_view_proj, size: int, shadow_bias):
    """World -> light uv, compare depth, and the 3x3 neighbourhood base
    (xi/yi true base, xi0/yi0 clamped into the map)."""
    sp = hom_dot4(world_pos, light_view_proj)
    w = sp[3]
    w = torch.where(w != 0.0, w, torch.ones_like(w))
    cx, cy, cz = sp[0] / w, sp[1] / w, sp[2] / w
    uv = torch.stack([cx * 0.5 + 0.5, cy * -0.5 + 0.5], dim=-1)
    compare = cz - shadow_bias
    tx = uv[..., 0] * size - 0.5
    ty = uv[..., 1] * size - 0.5
    x0 = torch.floor(tx)
    y0 = torch.floor(ty)
    fx = tx - x0
    fy = ty - y0
    # clamp in float before the int conversion (saturating, like XLA's)
    xi = torch.clamp(_to_int(x0), -2, size - 1)
    yi = torch.clamp(_to_int(y0), -2, size - 1)
    xi0 = torch.clamp(xi, 0, size - 1)
    yi0 = torch.clamp(yi, 0, size - 1)
    return uv, compare, fx, fy, xi, yi, xi0, yi0


def _pcf_blend(passed, fx, fy, uv, shadow_strength, pcf: str = "deferred"):
    """PCF blend from 9 pass planes, lerp(1, s, strength); outside the map
    or strength <= 0 -> 1.  ``pcf="deferred"``: the 4-tap blend (bilinear
    taps at +0, +x, +y, +xy), whose two outer multiply-adds carry the
    reference's contractions (the inner ones multiply 0/1 planes and are
    exact either way); ``"forward"``: 4 point taps at the half-texel
    diagonals, the 2x2 corners' average."""
    def lin(dx, dy):
        c00 = passed[dy * 3 + dx]
        c10 = passed[dy * 3 + dx + 1]
        c01 = passed[(dy + 1) * 3 + dx]
        c11 = passed[(dy + 1) * 3 + dx + 1]
        top = c00 * (1 - fx) + c10 * fx
        bot = c01 * (1 - fx) + c11 * fx
        return fma(top, 1 - fy, bot * fy)

    if pcf == "deferred":
        s4 = 0.25 * (lin(0, 0) + lin(1, 0) + lin(0, 1) + lin(1, 1))
    elif pcf == "forward":
        s4 = 0.25 * (passed[0] + passed[1] + passed[3] + passed[4])
    else:
        raise ValueError(f"pcf must be 'deferred' or 'forward', got {pcf!r}")
    s4 = fma(s4 - 1.0, shadow_strength, 1.0)
    in_range = (uv[..., 0] >= 0.0) & (uv[..., 0] <= 1.0) & (uv[..., 1] >= 0.0) & (uv[..., 1] <= 1.0)
    return torch.where((shadow_strength > 0.0) & in_range, s4, torch.ones_like(s4))


def _pcf_tail(nb9, compare, fx, fy, uv, xi, yi, xi0, yi0, size: int, shadow_strength,
              pcf: str = "deferred"):
    """Comparison + PCF blend.  nb9: 9 depth planes in (dy*3+dx) order."""
    passed = []
    for dy in range(3):
        for dx in range(3):
            txc, tyc = xi0 + dx, yi0 + dy
            true_x, true_y = xi + dx, yi + dy
            in_map = (true_x >= 0) & (true_x < size) & (true_y >= 0) & (true_y < size)
            ok = (compare <= nb9[dy * 3 + dx]) | ~in_map | (txc != true_x) | (tyc != true_y)
            passed.append(ok.to(torch.float32))
    return _pcf_blend(passed, fx, fy, uv, shadow_strength, pcf)


@named_pass("ShadowPCF")
def shadow_factor_blocks(blocks_flat, size: int, world_pos, light_view_proj,
                         shadow_strength, shadow_bias, pcf: str = "deferred") -> torch.Tensor:
    """PCF shadow factor (H, W) from the superblock table (``pcf``: the
    deferred or the forward blend).  On the u16 table the compare value
    quantizes into the same ceil domain as the stored depths, so
    comparisons stay conservative; on the f32 table they are unquantized."""
    bh, bw = shadow_block_shape(size)
    nbx = size // bw
    uv, compare, fx, fy, xi, yi, xi0, yi0 = _shadow_project(
        world_pos, light_view_proj, size, shadow_bias)
    row = torch.div(yi0, bh, rounding_mode="floor") * nbx + torch.div(xi0, bw, rounding_mode="floor")
    base = torch.remainder(yi0, bh) * (bw + 2) + torch.remainder(xi0, bw)
    nb = select9(blocks_flat, row.reshape(-1), base.reshape(-1), pcf_deltas(bw))
    nb = nb.reshape(compare.shape + (9,))
    nb9 = [nb[..., k] for k in range(9)]
    if blocks_flat.dtype == torch.int16:
        compare = torch.clamp(torch.ceil(compare * 65535.0), 0.0, 65536.0)
    return _pcf_tail(nb9, compare, fx, fy, uv, xi, yi, xi0, yi0, size, shadow_strength, pcf)
