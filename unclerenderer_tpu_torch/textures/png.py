"""PNG decoder and encoder (``unclerenderer_tpu/textures/png.py``): stdlib
zlib inflate plus native (or numpy) scanline unfiltering, always expanded
to RGBA8 as the D3D12 renderer's stb_image path
(``TextureLoader.cpp:365-495``); 1/2/4/8/16-bit gray, gray+alpha, RGB,
RGBA and palette (with ``tRNS``), non-interlaced (Adam7 only through PIL
where it is installed).  ``encode_png``/``save_png`` write 8-bit RGB(A)
with the stdlib alone, for the CLI's output.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ..core.logging import log_error, log_warning
from . import native

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# color type -> channels
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth_predict(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a.astype(np.int16) + b.astype(np.int16) - c.astype(np.int16)
    pa = np.abs(p - a)
    pb = np.abs(p - b)
    pc = np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)).astype(np.uint8)


def _unfilter_python(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Pure-numpy fallback; row loop with vectorized columns where possible."""
    src = np.frombuffer(raw, dtype=np.uint8).reshape(height, stride + 1)
    filters = src[:, 0]
    data = src[:, 1:]
    out = np.zeros((height, stride), dtype=np.uint8)
    zero_row = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        f = int(filters[y])
        row = data[y]
        up = out[y - 1] if y > 0 else zero_row
        if f == 0:
            out[y] = row
        elif f == 1:  # Sub: per-lane cumulative sum mod 256
            lanes = row.reshape(-1, bpp) if stride % bpp == 0 else None
            if lanes is not None:
                out[y] = (np.cumsum(lanes.astype(np.uint64), axis=0) & 0xFF).astype(
                    np.uint8
                ).reshape(-1)
            else:
                acc = row.copy()
                for x in range(bpp, stride):
                    acc[x] = (int(acc[x]) + int(acc[x - bpp])) & 0xFF
                out[y] = acc
        elif f == 2:  # Up
            out[y] = row + up
        elif f == 3:  # Average (x-sequential)
            acc = out[y]
            for x in range(stride):
                a = int(acc[x - bpp]) if x >= bpp else 0
                acc[x] = (int(row[x]) + ((a + int(up[x])) >> 1)) & 0xFF
        elif f == 4:  # Paeth (x-sequential)
            acc = out[y]
            for x in range(stride):
                a = int(acc[x - bpp]) if x >= bpp else 0
                c = int(up[x - bpp]) if x >= bpp else 0
                b = int(up[x])
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                acc[x] = (int(row[x]) + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {f}")
    return out.reshape(-1)


def decode_png(data: bytes) -> np.ndarray | None:
    """Decode PNG bytes -> (H, W, 4) uint8 RGBA, or None on failure."""
    if not data.startswith(_PNG_SIG):
        return None
    pos = 8
    width = height = 0
    bit_depth = color_type = interlace = 0
    palette = None
    trns = None
    idat_parts = []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            width, height, bit_depth, color_type, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", chunk
            )
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, dtype=np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(chunk, dtype=np.uint8)
        elif ctype == b"IDAT":
            idat_parts.append(chunk)
        elif ctype == b"IEND":
            break
    if width == 0 or height == 0 or not idat_parts:
        return None
    if interlace != 0:
        # Adam7 is rare; use PIL if present rather than implementing it.
        try:
            import io

            from PIL import Image

            img = Image.open(io.BytesIO(data)).convert("RGBA")
            return np.asarray(img, dtype=np.uint8)
        except ImportError:
            log_error("interlaced PNG unsupported without PIL")
            return None
    channels = _CHANNELS.get(color_type)
    if channels is None or bit_depth not in (1, 2, 4, 8, 16):
        log_error(f"unsupported PNG color type {color_type} depth {bit_depth}")
        return None

    raw = zlib.decompress(b"".join(idat_parts))
    if bit_depth < 8:
        # Sub-byte depths: unfilter at byte granularity then unpack bits.
        bits_per_px = bit_depth * channels
        stride = (width * bits_per_px + 7) // 8
        bpp = 1
    else:
        bytes_per_sample = bit_depth // 8
        bpp = channels * bytes_per_sample
        stride = width * bpp

    flat = native.png_unfilter(raw, height, stride, bpp)
    if flat is None:
        flat = _unfilter_python(raw, height, stride, bpp)
    rows = flat.reshape(height, stride)

    if bit_depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, : width * bit_depth * channels]
        groups = bits.reshape(height, width * channels, bit_depth)
        weights = (1 << np.arange(bit_depth - 1, -1, -1)).astype(np.uint16)
        vals = (groups * weights).sum(axis=2)
        if color_type != 3:
            vals = (vals * (255 // ((1 << bit_depth) - 1))).astype(np.uint8)
        img = vals.reshape(height, width, channels).astype(np.uint8)
    elif bit_depth == 16:
        img16 = rows.reshape(height, width, channels, 2)
        img = img16[..., 0]  # take high byte (matches stb's 8-bit load)
    else:
        img = rows.reshape(height, width, channels)

    if color_type == 3:  # palette
        if palette is None:
            return None
        idx = img[..., 0]
        rgb = palette[idx]
        if trns is not None:
            alpha_lut = np.full(palette.shape[0], 255, np.uint8)
            alpha_lut[: trns.size] = trns
            a = alpha_lut[idx][..., None]
        else:
            a = np.full((height, width, 1), 255, np.uint8)
        return np.concatenate([rgb, a], axis=2)
    if color_type == 0:  # gray
        g = img[..., 0:1]
        return np.concatenate([g, g, g, np.full_like(g, 255)], axis=2)
    if color_type == 4:  # gray + alpha
        g = img[..., 0:1]
        return np.concatenate([g, g, g, img[..., 1:2]], axis=2)
    if color_type == 2:  # RGB
        a = np.full((height, width, 1), 255, np.uint8)
        return np.concatenate([img, a], axis=2)
    return img  # RGBA


def load_png(path: str | Path) -> np.ndarray | None:
    try:
        data = Path(path).read_bytes()
    except OSError as e:
        log_error(f"failed to read PNG {path}: {e}")
        return None
    out = decode_png(data)
    if out is None:
        log_warning(f"failed to decode PNG {path}")
    return out


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF))


def encode_png(img_u8: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W, 4) uint8 -> PNG bytes: 8-bit RGB or RGBA, filter
    0 on every row."""
    img = np.ascontiguousarray(img_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"encode_png: expects (H, W, 3|4) uint8, got {img.shape} {img.dtype}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    color_type = 2 if c == 3 else 6
    return (_PNG_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_png(path: str | Path, rgb_u8: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as an RGB8 PNG (the reference CLI writes the
    same image with PIL)."""
    Path(path).write_bytes(encode_png(rgb_u8))
