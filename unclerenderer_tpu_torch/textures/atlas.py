"""Pyramid texture atlases (``unclerenderer_tpu/textures/atlas.py``): every
texture's mip chain packed into one array that the samplers read with row
gathers (``ops/texture.py``).  The reference's layouts and numbers exactly:

* ``build_pyramid_quad_atlas`` -- each texel row holds its own 2x2
  bilinear quad (C channels per corner); mip L of a texture sits at the
  x-offset ``2 * (w0 - (w0 >> L))`` from the texture origin, so a sampler
  computes every mip rectangle from ``(x0, y0, w0, h0)`` alone;
* ``build_pyramid_tri_atlas`` -- the packed-trilinear rows: the quad plus
  the 3x3 parent neighbourhood at the next mip (16C lanes), and with
  ``cube=True`` seamless cube faces whose borders hold the neighbouring
  faces' texels (32C lanes);
* ``build_atlas`` -- the shelf atlas (``TextureAtlas``): every (texture,
  mip) rectangle packed by height into one array, with a per-texture table
  of mip rectangles whose entries past the chain repeat its last mip.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

_log = logging.getLogger(__name__)

MAX_MIPS = 14  # mip table entries a texture: chains up to 8192


@dataclasses.dataclass
class TextureAtlas:
    data: np.ndarray = None          # (H, W, C) float32 linear
    mip_x: np.ndarray = None         # (n_tex, MAX_MIPS) int32
    mip_y: np.ndarray = None         # (n_tex, MAX_MIPS) int32
    mip_w: np.ndarray = None         # (n_tex, MAX_MIPS) int32
    mip_h: np.ndarray = None         # (n_tex, MAX_MIPS) int32
    mip_count: np.ndarray = None     # (n_tex,) int32

    @property
    def num_textures(self) -> int:
        return 0 if self.mip_x is None else int(self.mip_x.shape[0])


class _ShelfPacker:
    """Simple shelf packer: rows of decreasing height."""

    def __init__(self, width: int):
        self.width = width
        self.rows: list[list[int]] = []  # [y, x_cursor, row_height]
        self.height = 0

    def place(self, w: int, h: int) -> tuple[int, int]:
        for row in self.rows:
            if row[1] + w <= self.width and h <= row[2]:
                x = row[1]
                row[1] += w
                return x, row[0]
        y = self.height
        self.rows.append([y, w, h])
        self.height += h
        return 0, y


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def build_atlas(texture_mips: list[list[np.ndarray]], pad: int = 0) -> TextureAtlas:
    """Pack mip chains (each a list of (h, w, C) float32 arrays) into one
    shelf atlas: rectangles sorted by height then width (descending), a
    power-of-two width of at least 128 and the widest mip, doubled while
    its square is under 1.3x the rectangles' area (up to 16384), the
    height rounded up to 8 rows.  The LOD clamp is baked into the mip
    table: entries past a chain repeat its last mip."""
    n = len(texture_mips)
    atlas = TextureAtlas(
        mip_x=np.zeros((n, MAX_MIPS), np.int32),
        mip_y=np.zeros((n, MAX_MIPS), np.int32),
        mip_w=np.ones((n, MAX_MIPS), np.int32),
        mip_h=np.ones((n, MAX_MIPS), np.int32),
        mip_count=np.zeros(n, np.int32),
    )
    if n == 0:
        atlas.data = np.zeros((8, 128, 4), np.float32)
        return atlas

    rects = []  # (h, w, texture, mip), tallest first
    for t, mips in enumerate(texture_mips):
        atlas.mip_count[t] = len(mips)
        for lv, img in enumerate(mips):
            rects.append((img.shape[0], img.shape[1], t, lv))
    rects.sort(key=lambda r: (-r[0], -r[1]))

    total_area = sum(r[0] * r[1] for r in rects)
    width = 1 << int(np.ceil(np.log2(max(128, max(r[1] for r in rects)))))
    while width * width < total_area * 1.3 and width < 16384:
        width *= 2

    packer = _ShelfPacker(width)
    places = {(t, lv): packer.place(w + pad, h + pad) for h, w, t, lv in rects}

    channels = texture_mips[0][0].shape[-1]
    data = np.zeros((_round_up(max(packer.height, 8), 8), width, channels), np.float32)
    for t, mips in enumerate(texture_mips):
        for lv, img in enumerate(mips):
            x, y = places[(t, lv)]
            h, w = img.shape[:2]
            data[y:y + h, x:x + w] = img
            atlas.mip_x[t, lv], atlas.mip_y[t, lv] = x, y
            atlas.mip_w[t, lv], atlas.mip_h[t, lv] = w, h
        last = len(mips) - 1
        for table in (atlas.mip_x, atlas.mip_y, atlas.mip_w, atlas.mip_h):
            table[t, len(mips):] = table[t, last]
    atlas.data = data
    _log.info(f"texture atlas: {n} textures, {len(rects)} mips packed into "
              f"{width}x{data.shape[0]} ({data.nbytes / 1e6:.1f} MB f32)")
    return atlas


# Seamless cube-face borders: a border texel's centre direction (u/v
# extrapolated past the face), re-addressed by the dominant-axis rule,
# lands on the neighbouring face's texel, orientation included.  The
# conventions mirror ops/texture.py cube_direction_to_face_uv (D3D face
# fetch); face order +X, -X, +Y, -Y, +Z, -Z.


def _cube_face_dir(f: int, uc: np.ndarray, vc: np.ndarray) -> np.ndarray:
    """Face-local centred coords (uc, vc in [-1, 1], extrapolation ok) ->
    direction, the inverse of the per-face (u, v) selection."""
    one = np.ones_like(uc)
    if f == 0:
        return np.stack([one, -vc, -uc], -1)
    if f == 1:
        return np.stack([-one, -vc, uc], -1)
    if f == 2:
        return np.stack([uc, one, vc], -1)
    if f == 3:
        return np.stack([uc, -one, -vc], -1)
    if f == 4:
        return np.stack([uc, -vc, one], -1)
    return np.stack([-uc, -vc, -one], -1)


def _cube_dir_to_texel(d: np.ndarray, s: int):
    """Directions (..., 3) -> (face, iy, ix) nearest texel on an s-sized
    face."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = np.where(
        is_x, np.where(x >= 0, 0, 1),
        np.where(is_y, np.where(y >= 0, 2, 3), np.where(z >= 0, 4, 5)),
    ).astype(np.int32)
    ma = np.maximum(np.where(is_x, ax, np.where(is_y, ay, az)), 1e-20)
    u = np.where(is_x, np.where(x >= 0, -z, z),
                 np.where(is_y, x, np.where(z >= 0, x, -x)))
    v = np.where(is_x, -y, np.where(is_y, np.where(y >= 0, z, -z), -y))
    uu = (u / ma + 1.0) * 0.5
    vv = (v / ma + 1.0) * 0.5
    ix = np.clip(np.floor(uu * s).astype(np.int64), 0, s - 1)
    iy = np.clip(np.floor(vv * s).astype(np.int64), 0, s - 1)
    return face, iy, ix


def _cube_extend(faces: list[np.ndarray]) -> list[np.ndarray]:
    """6 (s, s, c) face images -> 6 (s+2, s+2, c) images whose 1-texel
    border holds the adjacent faces' texels (corners take the nearest texel
    of whichever face the corner direction's dominant axis picks)."""
    s, c = faces[0].shape[0], faces[0].shape[-1]
    stack = np.stack(faces)  # (6, s, s, c)
    exts = []
    border_y, border_x = np.meshgrid(
        np.arange(-1, s + 1), np.arange(-1, s + 1), indexing="ij"
    )
    on_border = (
        (border_y == -1) | (border_y == s) | (border_x == -1) | (border_x == s)
    )
    by = border_y[on_border].astype(np.float64)
    bx = border_x[on_border].astype(np.float64)
    uc = (bx + 0.5) / s * 2.0 - 1.0
    vc = (by + 0.5) / s * 2.0 - 1.0
    for f in range(6):
        ext = np.zeros((s + 2, s + 2, c), faces[f].dtype)
        ext[1:-1, 1:-1] = faces[f]
        nf, niy, nix = _cube_dir_to_texel(_cube_face_dir(f, uc, vc), s)
        ext[border_y[on_border] + 1, border_x[on_border] + 1] = stack[nf, niy, nix]
        exts.append(ext)
    return exts


def build_pyramid_quad_atlas(texture_mips: list[list[np.ndarray]], wrap=True,
                             dtype=np.float32, ext_of=None):
    """Quad atlas with an arithmetic mip layout (module docstring).
    Textures must be power-of-two sized.

    wrap: a bool or a per-texture list (WRAP vs CLAMP quads).  ext_of:
    optional callable (t, lv) -> (h+2, w+2, C) border-extended level image;
    when given, the quad's +x/+y/+xy channels come from it instead of the
    wrap/clamp shifts (cube faces bake cross-face borders this way).  Any
    channel count C (all chains agree).

    Returns (data (H, W, 4*C), rect0 (n_tex, 4) i32 = (x0, y0, w0, h0)).
    """
    n = len(texture_mips)
    rect0 = np.zeros((n, 4), np.int32)
    if n == 0:
        return np.zeros((8, 128, 16), np.float32), rect0
    channels = texture_mips[0][0].shape[-1]
    wraps = [wrap] * n if isinstance(wrap, bool) else list(wrap)

    rows = []
    for t, chain in enumerate(texture_mips):
        h0, w0 = chain[0].shape[:2]
        if (w0 & (w0 - 1)) or (h0 & (h0 - 1)):
            raise ValueError(f"pyramid atlas requires power-of-two textures, got {w0}x{h0}")
        # Tall (h0 > w0) chains have mips past the point the width saturates
        # at 1; each of those gets its own extra column.
        tail = max(h0.bit_length() - w0.bit_length(), 0)
        rows.append((h0, 2 * w0 + tail, t))
    rows.sort(key=lambda r: (-r[0], -r[1]))

    width = max(128, 1 << int(np.ceil(np.log2(max(r[1] for r in rows)))))
    total_area = sum(r[0] * r[1] for r in rows)
    while width * width < total_area * 1.3 and width < 16384:
        width *= 2

    packer = _ShelfPacker(width)
    places = {}
    for h, w, t in rows:
        places[t] = packer.place(w, h)
    height = _round_up(max(packer.height, 8), 8)
    data = np.zeros((height, width, 4 * channels), dtype)
    c = channels

    # Mip rectangles: offset 2*(w0 - w_lv) plus one extra column per tail
    # level whose width already saturated at 1 (tall textures) -- the
    # samplers' rect arithmetic (ops/texture.py).
    mip_rects = {}
    occupancy = np.zeros((height, width), np.uint8)
    for t, chain in enumerate(texture_mips):
        x0, y0 = places[t]
        h0, w0 = chain[0].shape[:2]
        lw0 = int(np.log2(w0))
        rects = []
        for lv, img in enumerate(chain):
            xl = x0 + 2 * (w0 - max(w0 >> lv, 1)) + max(lv - lw0, 0)
            h, w = img.shape[:2]
            rects.append((xl, y0, w, h))
            occupancy[y0 : y0 + h, xl : xl + w] += 1
        mip_rects[t] = rects
    if occupancy.max() > 1:
        raise RuntimeError("pyramid atlas mip rectangles overlap")
    del occupancy

    for t, chain in enumerate(texture_mips):
        # the quad's +x/+y/+xy shifted copies (wrap duplicates the first
        # row/column, clamp the last)
        x0, y0 = places[t]
        h0, w0 = chain[0].shape[:2]
        rect0[t] = (x0, y0, w0, h0)
        for lv, img in enumerate(chain):
            xl, _, w, h = mip_rects[t][lv]
            dst = data[y0 : y0 + h, xl : xl + w]
            if ext_of is not None:
                ext = ext_of(t, lv)
                dst[..., 0:c] = ext[1:-1, 1:-1]
                dst[..., c : 2 * c] = ext[1:-1, 2:]
                dst[..., 2 * c : 3 * c] = ext[2:, 1:-1]
                dst[..., 3 * c :] = ext[2:, 2:]
                continue
            ex = 0 if wraps[t] else w - 1  # wrap -> col 0, clamp -> last col
            ey = 0 if wraps[t] else h - 1
            dst[..., 0:c] = img
            dst[:, : w - 1, c : 2 * c] = img[:, 1:]
            dst[:, w - 1, c : 2 * c] = img[:, ex]
            dst[: h - 1, :, 2 * c : 3 * c] = img[1:]
            dst[h - 1, :, 2 * c : 3 * c] = img[ey]
            dst[: h - 1, : w - 1, 3 * c :] = img[1:, 1:]
            dst[: h - 1, w - 1, 3 * c :] = img[1:, ex]
            dst[h - 1, : w - 1, 3 * c :] = img[ey, 1:]
            dst[h - 1, w - 1, 3 * c :] = img[ey, ex]
    _log.info("pyramid quad atlas: %d textures into %dx%d (%.1f MB %s)",
              n, width, height, data.nbytes / 1e6, np.dtype(dtype).name)
    return data, rect0


def build_pyramid_tri_atlas(texture_mips: list[list[np.ndarray]],
                            dtype=np.float32, wrap=False, cube=False):
    """Packed-trilinear pyramid atlas: each texel row carries both taps of a
    trilinear sample of a C-channel texture --

      lanes     0:4C -- the texel's own 2x2 bilinear quad at its mip
                        (corners TL, TR, BL, BR like the quad atlas),
      lanes  4C:13C -- the 3x3 neighbourhood of its PARENT texel at the
                        next mip (row-major, wrap- or edge-padded),
      lanes 13C:16C -- zero pad to 16C.

    A uv on texel ix at mip L has its mip-L+1 bilinear base in
    {ix>>1 - 1, ix>>1}, so the 3x3 centred on (ix>>1, iy>>1) always holds
    the parent 2x2: one row gather per trilinear sample.

    wrap: bool or per-texture list, as in ``build_pyramid_quad_atlas``.
    cube=True (exactly 6 equal square CLAMP chains): seamless cube-edge
    filtering -- the quad neighbours and the parent windows hold cross-face
    texels, and five border texels follow the 13C payload
    (L = (x-1, y), T = (x, y-1), Cr = (x-1, y-1), L2 = (x-1, y+1),
    T2 = (x+1, y-1)), so rows widen to 32C.  The last level packs its own
    padded 3x3 as its "parent" (the sampler's lod clamp gives it weight 0).
    """
    for chain in texture_mips:
        h0, w0 = chain[0].shape[:2]
        if len(chain) > max(int(w0).bit_length(), int(h0).bit_length()):
            raise ValueError(f"tri atlas chain longer than the mip pyramid ({w0}x{h0}, "
                             f"got {len(chain)} levels)")
    c = texture_mips[0][0].shape[-1]
    if c & (c - 1):
        raise ValueError(f"tri atlas channel count must be a power of two, got {c}")
    wraps = [wrap] * len(texture_mips) if isinstance(wrap, bool) else list(wrap)

    exts = None
    ext_of = None
    if cube:
        levels_n = len(texture_mips[0])
        if (len(texture_mips) != 6 or any(wraps)
                or any(len(ch) != levels_n for ch in texture_mips)):
            raise ValueError("cube atlas needs 6 CLAMP face chains of equal length")
        exts = [
            _cube_extend([ch[lv].astype(np.float32) for ch in texture_mips])
            for lv in range(levels_n)
        ]

        def ext_of(t, lv):
            return exts[lv][t]

    quad, rect0 = build_pyramid_quad_atlas(texture_mips, wrap=wrap,
                                           dtype=np.float32, ext_of=ext_of)
    height, width = quad.shape[:2]
    row_c = (32 if cube else 16) * c
    data = np.zeros((height, width, row_c), np.float32)
    data[..., : 4 * c] = quad
    del quad
    for t, chain in enumerate(texture_mips):
        x0, y0, w0, _h0 = (int(v) for v in rect0[t])
        lw0 = int(np.log2(w0))
        pad_mode = "wrap" if wraps[t] else "edge"
        levels = len(chain)
        for lv, img in enumerate(chain):
            h, w = img.shape[:2]
            # the quad atlas's per-level x offset (incl. the tall tail shift)
            xl = x0 + 2 * (w0 - max(w0 >> lv, 1)) + max(lv - lw0, 0)
            nxt = chain[min(lv + 1, levels - 1)].astype(np.float32)
            if cube and lv + 1 < levels:
                pad = exts[lv + 1][t]  # cross-face parent window
            elif cube:
                pad = exts[lv][t] if nxt.shape[0] == h else np.pad(
                    nxt, ((1, 1), (1, 1), (0, 0)), mode="edge")
            else:
                pad = np.pad(nxt, ((1, 1), (1, 1), (0, 0)), mode=pad_mode)
            # parent centre of texel i is i>>1; a saturated self-referencing
            # parent level is uniform along that axis, so the sampler's
            # clipped select stays exact
            py = np.minimum(np.arange(h) >> 1, nxt.shape[0] - 1)
            px = np.minimum(np.arange(w) >> 1, nxt.shape[1] - 1)
            for j in range(3):
                rows = pad[py + j]
                for i in range(3):
                    lo = 4 * c + (j * 3 + i) * c
                    data[y0:y0 + h, xl:xl + w, lo:lo + c] = rows[:, px + i]
            if cube:
                # minus-edge border texels for the sampler's ix/iy == -1
                # bilinear bases: L, T, corner, L2, T2
                ext = exts[lv][t]
                for k, (oy, ox) in enumerate(((1, 0), (0, 1), (0, 0), (2, 0), (0, 2))):
                    lo = 13 * c + k * c
                    data[y0:y0 + h, xl:xl + w, lo:lo + c] = ext[oy : oy + h, ox : ox + w]
    if np.dtype(dtype) != np.float32:
        data = data.astype(dtype)
    _log.info("pyramid tri atlas: %d chains into %dx%d (%.1f MB %s)",
              len(texture_mips), width, height, data.nbytes / 1e6, np.dtype(dtype).name)
    return data, rect0
