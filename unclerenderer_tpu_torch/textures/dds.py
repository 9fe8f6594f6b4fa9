"""DDS loader (``unclerenderer_tpu/textures/dds.py``): header parse and
decode to numpy, as the D3D12 renderer's ddspp path
(``TextureLoader.cpp:178-363``): 2D, 3D (volume), array textures and
cubemaps with full mip chains.  BC1-5 decode natively, with a numpy
fallback byte-equal to it; BC6H/BC7 natively only; RGBA8, BGRA8, RGBA16F,
RGBA32F, R32F and RG16 directly.

Outputs RGBA, uint8 for LDR formats and float32 for HDR ones.  No sRGB
decode here: the caller decides per use.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

from ..core.logging import log_error, log_warning
from . import native

# DXGI formats we care about
DXGI_BC1 = 71
DXGI_BC1_SRGB = 72
DXGI_BC2 = 74
DXGI_BC2_SRGB = 75
DXGI_BC3 = 77
DXGI_BC3_SRGB = 78
DXGI_BC4 = 80
DXGI_BC5 = 83
DXGI_BC6H_UF16 = 95
DXGI_BC6H_SF16 = 96
DXGI_BC7 = 98
DXGI_BC7_SRGB = 99
DXGI_RGBA8 = 28
DXGI_RGBA8_SRGB = 29
DXGI_BGRA8 = 87
DXGI_RGBA16F = 10
DXGI_RGBA32F = 2
DXGI_R32F = 41
DXGI_RG16_UNORM = 35

_BC_KIND = {DXGI_BC1: 1, DXGI_BC1_SRGB: 1, DXGI_BC2: 2, DXGI_BC2_SRGB: 2,
            DXGI_BC3: 3, DXGI_BC3_SRGB: 3, DXGI_BC4: 4, DXGI_BC5: 5}
_BC67 = {DXGI_BC6H_UF16: 6, DXGI_BC6H_SF16: 7, DXGI_BC7: 8, DXGI_BC7_SRGB: 8}
_BLOCK_BYTES = {1: 8, 2: 16, 3: 16, 4: 8, 5: 16, 6: 16, 7: 16, 8: 16}


@dataclasses.dataclass
class DdsImage:
    width: int = 0
    height: int = 0
    mip_count: int = 1
    is_cube: bool = False
    is_srgb_format: bool = False
    is_hdr: bool = False
    # 3D (volume) textures: depth > 1; mips[0][mip] -> (depth_m, h, w, 4)
    # with depth_m = max(1, depth >> mip) (``TextureLoader.cpp:178-363``)
    depth: int = 1
    is_volume: bool = False
    # texture arrays (DX10 arraySize): one mips[] entry per item
    array_size: int = 1
    # mips[face_or_item][mip] -> (h, w, 4) uint8 or float32
    mips: list = dataclasses.field(default_factory=list)


def _decode_bc_numpy(data: bytes, width: int, height: int, kind: int) -> np.ndarray | None:
    """Pure-numpy BC1/3/4/5 fallback (vectorized over blocks)."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    nblocks = bw * bh
    block_bytes = _BLOCK_BYTES[kind]
    raw = np.frombuffer(data, np.uint8, count=nblocks * block_bytes).reshape(nblocks, block_bytes)

    def color_block(cb):
        c0 = cb[:, 0].astype(np.uint16) | (cb[:, 1].astype(np.uint16) << 8)
        c1 = cb[:, 2].astype(np.uint16) | (cb[:, 3].astype(np.uint16) << 8)

        def expand(c):
            # integer expansion, bit-identical to the native decoder
            c = c.astype(np.int32)
            r = (((c >> 11) & 31) * 255 + 15) // 31
            g = (((c >> 5) & 63) * 255 + 31) // 63
            b = ((c & 31) * 255 + 15) // 31
            return np.stack([r, g, b], axis=-1).astype(np.int32)

        p0, p1 = expand(c0), expand(c1)
        four = c0 > c1
        punch = ~four if kind == 1 else np.zeros_like(four)
        if kind != 1:
            four = np.ones_like(four)
        p2 = np.where(four[:, None], (2 * p0 + p1) // 3, (p0 + p1) // 2)
        p3 = np.where(four[:, None], (p0 + 2 * p1) // 3, 0)
        pal = np.stack([p0, p1, p2, p3], axis=1)  # (n, 4, 3)
        idx = (
            cb[:, 4].astype(np.uint32)
            | (cb[:, 5].astype(np.uint32) << 8)
            | (cb[:, 6].astype(np.uint32) << 16)
            | (cb[:, 7].astype(np.uint32) << 24)
        )
        sels = (idx[:, None] >> (2 * np.arange(16, dtype=np.uint32))[None, :]) & 3  # (n,16)
        rgb = np.take_along_axis(pal, sels[:, :, None].astype(np.int64), axis=1)
        alpha = np.where(punch[:, None] & (sels == 3), 0, 255)
        return rgb, alpha

    def alpha_block(ab):
        a0 = ab[:, 0].astype(np.int32)
        a1 = ab[:, 1].astype(np.int32)
        eight = ab[:, 0] > ab[:, 1]
        steps8 = np.stack([a0, a1] + [((7 - i) * a0 + i * a1) // 7 for i in range(1, 7)], axis=1)
        steps6 = np.stack(
            [a0, a1]
            + [((5 - i) * a0 + i * a1) // 5 for i in range(1, 5)]
            + [np.zeros_like(a0), np.full_like(a0, 255)],
            axis=1,
        )
        pal = np.where(eight[:, None], steps8, steps6)  # (n, 8)
        bits = np.zeros(ab.shape[0], np.uint64)
        for i in range(6):
            bits |= ab[:, 2 + i].astype(np.uint64) << np.uint64(8 * i)
        sels = (bits[:, None] >> (3 * np.arange(16, dtype=np.uint64))[None, :]) & np.uint64(7)
        return np.take_along_axis(pal, sels.astype(np.int64), axis=1)  # (n, 16)

    texels = np.zeros((nblocks, 16, 4), np.int32)
    if kind in (1, 2, 3):
        cb = raw[:, 8:] if kind != 1 else raw
        rgb, alpha = color_block(cb)
        texels[:, :, :3] = rgb
        texels[:, :, 3] = alpha
        if kind == 2:
            nib = np.zeros((nblocks, 16), np.int32)
            for i in range(16):
                nib[:, i] = ((raw[:, i // 2] >> ((i & 1) * 4)) & 15) * 17
            texels[:, :, 3] = nib
        elif kind == 3:
            texels[:, :, 3] = alpha_block(raw[:, :8])
    elif kind in (4, 5):
        red = alpha_block(raw[:, :8])
        texels[:, :, 0] = red
        if kind == 5:
            texels[:, :, 1] = alpha_block(raw[:, 8:16])
            texels[:, :, 2] = 0
        else:
            texels[:, :, 1] = red
            texels[:, :, 2] = red
        texels[:, :, 3] = 255
    else:
        return None

    out = texels.astype(np.uint8).reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    out = out.reshape(bh * 4, bw * 4, 4)
    return np.ascontiguousarray(out[:height, :width])


def _decode_mip(data: bytes, width: int, height: int, dxgi: int) -> np.ndarray | None:
    if dxgi in _BC_KIND:
        kind = _BC_KIND[dxgi]
        out = native.bc_decode(data, width, height, kind)
        if out is None:
            out = _decode_bc_numpy(data, width, height, kind)
        return out
    if dxgi in _BC67:
        out = native.bc67_decode(data, width, height, _BC67[dxgi])
        if out is None:
            log_warning(f"BC6H/BC7 (dxgi {dxgi}) requires the native library; using gray")
            fill = 0.5 if dxgi in (DXGI_BC6H_UF16, DXGI_BC6H_SF16) else 128
            dt = np.float32 if dxgi in (DXGI_BC6H_UF16, DXGI_BC6H_SF16) else np.uint8
            return np.full((height, width, 4), fill, dt)
        return out
    if dxgi in (DXGI_RGBA8, DXGI_RGBA8_SRGB):
        a = np.frombuffer(data, np.uint8, count=width * height * 4).reshape(height, width, 4)
        return a.copy()
    if dxgi == DXGI_BGRA8:
        a = np.frombuffer(data, np.uint8, count=width * height * 4).reshape(height, width, 4)
        return a[..., [2, 1, 0, 3]].copy()
    if dxgi == DXGI_RGBA16F:
        a = np.frombuffer(data, np.float16, count=width * height * 4).reshape(height, width, 4)
        return a.astype(np.float32)
    if dxgi == DXGI_RGBA32F:
        return np.frombuffer(data, np.float32, count=width * height * 4).reshape(height, width, 4).copy()
    if dxgi == DXGI_R32F:
        r = np.frombuffer(data, np.float32, count=width * height).reshape(height, width, 1)
        out = np.zeros((height, width, 4), np.float32)
        out[..., 0] = r[..., 0]
        out[..., 3] = 1.0
        return out
    if dxgi == DXGI_RG16_UNORM:
        rg = np.frombuffer(data, np.uint16, count=width * height * 2).reshape(height, width, 2)
        out = np.zeros((height, width, 4), np.float32)
        out[..., :2] = rg.astype(np.float32) / 65535.0
        out[..., 3] = 1.0
        return out
    log_error(f"unsupported DDS dxgi format {dxgi}")
    return None


def _mip_size_bytes(width: int, height: int, dxgi: int) -> int:
    if dxgi in _BC_KIND or dxgi in _BC67:
        kind = _BC_KIND.get(dxgi) or _BC67[dxgi]
        bb = _BLOCK_BYTES[kind]
        return ((width + 3) // 4) * ((height + 3) // 4) * bb
    bpp = {DXGI_RGBA8: 4, DXGI_RGBA8_SRGB: 4, DXGI_BGRA8: 4, DXGI_RGBA16F: 8,
           DXGI_RGBA32F: 16, DXGI_R32F: 4, DXGI_RG16_UNORM: 4}.get(dxgi)
    if bpp is None:
        return 0
    return width * height * bpp


_FOURCC_TO_DXGI = {
    b"DXT1": DXGI_BC1,
    b"DXT2": DXGI_BC2,
    b"DXT3": DXGI_BC2,
    b"DXT4": DXGI_BC3,
    b"DXT5": DXGI_BC3,
    b"ATI1": DXGI_BC4,
    b"BC4U": DXGI_BC4,
    b"ATI2": DXGI_BC5,
    b"BC5U": DXGI_BC5,
}


def load_dds(path: str | Path) -> DdsImage | None:
    try:
        data = Path(path).read_bytes()
    except OSError as e:
        log_error(f"failed to read DDS {path}: {e}")
        return None
    if len(data) < 128 or data[:4] != b"DDS ":
        log_error(f"not a DDS file: {path}")
        return None
    (_size, flags, height, width, _pitch, depth, mip_count) = struct.unpack(
        "<7I", data[4:32]
    )
    mip_count = max(1, mip_count)
    pf_flags, fourcc = struct.unpack("<I4s", data[80:88])
    rgb_bits, rmask, gmask, bmask, amask = struct.unpack("<5I", data[88:108])
    caps2 = struct.unpack("<I", data[112:116])[0]
    is_cube = bool(caps2 & 0x200)
    # volume: DDSD_DEPTH header flag or DDSCAPS2_VOLUME
    is_volume = bool(flags & 0x800000) or bool(caps2 & 0x200000)
    depth = max(1, depth) if is_volume else 1
    array_size = 1
    offset = 128
    dxgi = None
    if fourcc == b"DX10":
        dxgi, dim, _misc, asize, _misc2 = struct.unpack("<5I", data[128:148])
        offset = 148
        is_volume = is_volume or dim == 4  # D3D10_RESOURCE_DIMENSION_TEXTURE3D
        if not is_volume and not is_cube:
            array_size = max(1, asize)
    elif pf_flags & 0x4:  # FOURCC
        dxgi = _FOURCC_TO_DXGI.get(fourcc)
    elif pf_flags & 0x40:  # uncompressed RGB
        if rgb_bits == 32:
            if rmask == 0x000000FF and gmask == 0x0000FF00:
                dxgi = DXGI_RGBA8
            elif rmask == 0x00FF0000:
                dxgi = DXGI_BGRA8
            elif rmask == 0x0000FFFF and gmask == 0xFFFF0000:
                dxgi = DXGI_RG16_UNORM
    if dxgi is None:
        log_error(f"unrecognized DDS pixel format in {path}")
        return None

    img = DdsImage(
        width=width,
        height=height,
        mip_count=mip_count,
        is_cube=is_cube,
        depth=depth,
        is_volume=is_volume,
        array_size=array_size,
        is_srgb_format=dxgi in (DXGI_BC1_SRGB, DXGI_BC2_SRGB, DXGI_BC3_SRGB,
                                DXGI_RGBA8_SRGB, DXGI_BC7_SRGB),
        is_hdr=dxgi in (DXGI_BC6H_UF16, DXGI_BC6H_SF16, DXGI_RGBA16F,
                        DXGI_RGBA32F, DXGI_R32F),
    )
    pos = offset
    if is_volume:
        # one subresource chain; mip m holds depth_m slices back to back
        vol_mips = []
        w, h, d = width, height, depth
        for _mip in range(mip_count):
            slices = []
            for _z in range(d):
                nbytes = _mip_size_bytes(w, h, dxgi)
                if nbytes == 0 or pos + nbytes > len(data):
                    log_error(f"DDS data truncated in {path}")
                    return None
                decoded = _decode_mip(data[pos : pos + nbytes], w, h, dxgi)
                if decoded is None:
                    return None
                slices.append(decoded)
                pos += nbytes
            vol_mips.append(np.stack(slices, axis=0))
            w, h, d = max(1, w // 2), max(1, h // 2), max(1, d // 2)
        img.mips.append(vol_mips)
        return img
    n_items = 6 if is_cube else array_size
    for _item in range(n_items):
        face_mips = []
        w, h = width, height
        for _mip in range(mip_count):
            nbytes = _mip_size_bytes(w, h, dxgi)
            if nbytes == 0 or pos + nbytes > len(data):
                log_error(f"DDS data truncated in {path}")
                return None
            decoded = _decode_mip(data[pos : pos + nbytes], w, h, dxgi)
            if decoded is None:
                return None
            face_mips.append(decoded)
            pos += nbytes
            w, h = max(1, w // 2), max(1, h // 2)
        img.mips.append(face_mips)
    return img
