"""Texture loading and building (``unclerenderer_tpu/textures/image.py``):
mip chains, the procedural grid and solid-colour textures, the combined
material texture (every map of a material fused into one 16-channel texel)
with its u8 storage encoding, and the file loader (DDS, PNG, JPEG) with the
D3D12 renderer's path-keyed cache and LoadOrDefault / LoadOrSolidColor
fallbacks (``TextureLoader.cpp:66-135``, ``:497-744``).  The reference's
numbers exactly.  Textures land as float32 linear RGBA mip chains.
"""

from __future__ import annotations

import logging
import threading
from pathlib import Path

import numpy as np

from ..core.logging import log_error, log_warning
from ..core.paths import resolve_path_case_insensitive
from ..mathlib import srgb_to_linear
from .dds import load_dds
from .png import load_png

_log = logging.getLogger(__name__)


def generate_mips(base: np.ndarray) -> list[np.ndarray]:
    """Full mip chain by 2x2 box filter."""
    mips = [base.astype(np.float32)]
    cur = mips[0]
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h, w = cur.shape[:2]
        nh, nw = max(1, h // 2), max(1, w // 2)
        # odd sizes are trimmed (the reference's assets are power-of-two)
        trimmed = cur[: nh * 2 if h > 1 else 1, : nw * 2 if w > 1 else 1]
        if h > 1 and w > 1:
            cur = trimmed.reshape(nh, 2, nw, 2, -1).mean(axis=(1, 3))
        elif h > 1:
            cur = trimmed.reshape(nh, 2, 1, -1).mean(axis=1).reshape(nh, 1, -1)
        else:
            cur = trimmed.reshape(1, nw, 2, -1).mean(axis=2)
        mips.append(cur.astype(np.float32))
    return mips


def default_grid_texture(size: int = 256, cells: int = 8) -> np.ndarray:
    """Checkerboard default (``FTextureLoader::CreateDefaultGridTexture``)."""
    yy, xx = np.mgrid[0:size, 0:size]
    cell = size // cells
    checker = ((xx // cell) + (yy // cell)) % 2
    light = np.array([200, 200, 200, 255], np.float32) / 255.0
    dark = np.array([80, 80, 80, 255], np.float32) / 255.0
    return np.where(checker[..., None] == 0, light, dark).astype(np.float32)


def solid_color_texture(rgba, size: int = 4) -> np.ndarray:
    c = np.asarray(rgba, np.float32).reshape(1, 1, 4)
    return np.broadcast_to(c, (size, size, 4)).copy()


# Combined material texture: every map of a material resampled to one
# resolution and fused into one texel (absent maps baked to neutral values),
# padded to 16 channels.
COMBINED_C = 16  # 0:4 base RGBA | 4 roughness, 5 metallic | 6:8 normal RG | 8:11 emissive RGB | 11:16 pad
COMBINED_NEUTRAL = np.array([1, 1, 1, 1, 1, 1, 0.5, 0.5, 1, 1, 1, 0, 0, 0, 0, 0], np.float32)
# slot -> (combined channels, source channels); MR follows glTF G=rough B=metal
COMBINED_SLOT_CH = (
    (slice(0, 4), slice(0, 4)),
    (slice(4, 6), slice(1, 3)),
    (slice(6, 8), slice(0, 2)),
    (slice(8, 11), slice(0, 3)),
)


def encode_combined_u8(img: np.ndarray) -> np.ndarray:
    """Quantize one COMBINED_C-channel linear-f32 image to the u8 material
    atlas storage: colour channels (base rgb 0:3, emissive rgb 8:11) on a
    gamma-2.0 byte curve (``round(sqrt(v) * 255)``), everything else as
    linear bytes.  Out-of-range values clip (logged: an HDR map lost its
    range)."""
    if img.shape[-1] != COMBINED_C:
        raise ValueError(f"encode_combined_u8: expects {COMBINED_C} channels, got {img.shape}")
    peak = float(img.max(initial=0.0))
    if peak > 1.0 + 1e-5:
        _log.warning("encode_combined_u8: HDR input (max %.3g > 1) clipped to 1.0 in the u8 "
                     "material atlas", peak)
    x = np.clip(img.astype(np.float32), 0.0, 1.0)
    out = x.copy()
    for sl in (slice(0, 3), slice(8, 11)):
        out[..., sl] = np.sqrt(x[..., sl])
    return np.round(out * 255.0).astype(np.uint8)


def resize_bilinear(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Host-side bilinear resample (half-texel centers, clamp)."""
    h, w = img.shape[:2]
    if (h, w) == (th, tw):
        return img
    ys = (np.arange(th, dtype=np.float64) + 0.5) * (h / th) - 0.5
    xs = (np.arange(tw, dtype=np.float64) + 0.5) * (w / tw) - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)[None, :, None]
    r0 = img[y0]
    r1 = img[y1]
    top = r0[:, x0] * (1.0 - fx) + r0[:, x1] * fx
    bot = r1[:, x0] * (1.0 - fx) + r1[:, x1] * fx
    return top * (1.0 - fy) + bot * fy


def combined_chain(slot_chains: list) -> list[np.ndarray]:
    """Fuse up to 4 single-map mip chains (or None) into one combined chain
    at the largest resolution; combined level L takes the source level of
    matching size."""
    tw = max((c[0].shape[1] for c in slot_chains if c), default=1)
    th = max((c[0].shape[0] for c in slot_chains if c), default=1)
    levels = max(int(np.log2(max(tw, th))) + 1, 1)
    out = []
    for lv in range(levels):
        w, h = max(tw >> lv, 1), max(th >> lv, 1)
        img = np.tile(COMBINED_NEUTRAL, (h, w, 1))
        for si, chain in enumerate(slot_chains):
            if chain is None:
                continue
            shift = int(np.log2(tw)) - int(np.log2(max(chain[0].shape[1], 1)))
            src = chain[min(max(lv - shift, 0), len(chain) - 1)]
            dst_sl, src_sl = COMBINED_SLOT_CH[si]
            img[..., dst_sl] = resize_bilinear(src, h, w)[..., src_sl]
        out.append(img)
    return out


def load_image(path: str | Path, srgb: bool = False) -> list[np.ndarray] | None:
    """Load any supported image -> list of float32 linear RGBA mips, or None.

    DDS files keep their baked mip chain; PNG/JPG get a generated chain
    (reference: DDS full chain ``TextureLoader.cpp:178-363``, stb 1 mip
    ``:365-495`` -- we improve on the 1-mip PNG path since minification
    without mips aliases badly in a software sampler).
    """
    p = resolve_path_case_insensitive(Path(path))
    suffix = p.suffix.lower()
    if suffix == ".dds":
        dds = load_dds(p)
        if dds is None:
            return None
        face = dds.mips[0]
        mips = []
        for level in face:
            if level.dtype == np.uint8:
                f = level.astype(np.float32) / 255.0
            else:
                f = level.astype(np.float32)
            if srgb and not dds.is_hdr:
                f = np.concatenate([srgb_to_linear(f[..., :3]), f[..., 3:4]], axis=-1)
            mips.append(f)
        # Extend a partial chain down to 1x1 for uniform sampling math.
        if mips[-1].shape[0] > 1 or mips[-1].shape[1] > 1:
            mips = mips[:-1] + generate_mips(mips[-1])
        return mips
    if suffix == ".png":
        img = load_png(p)
        if img is None:
            return None
        f = img.astype(np.float32) / 255.0
        if srgb:
            f = np.concatenate([srgb_to_linear(f[..., :3]), f[..., 3:4]], axis=-1)
        return generate_mips(f)
    if suffix in (".jpg", ".jpeg"):
        try:
            from PIL import Image

            img = np.asarray(Image.open(p).convert("RGBA"), np.uint8)
        except ImportError:
            log_error(f"JPEG decode requires PIL: {path}")
            return None
        except OSError as e:
            log_error(f"failed to read JPEG {path}: {e}")
            return None
        f = img.astype(np.float32) / 255.0
        if srgb:
            f = np.concatenate([srgb_to_linear(f[..., :3]), f[..., 3:4]], axis=-1)
        return generate_mips(f)
    log_error(f"unsupported texture format: {path}")
    return None


class TextureCache:
    """Path-keyed cache with LoadOrDefault / LoadOrSolidColor semantics."""

    def __init__(self) -> None:
        self._cache: dict[str, list[np.ndarray]] = {}
        self._lock = threading.Lock()
        # Paths that fell back to the default grid (the reference's
        # default-texture fallback, TextureLoader.cpp:497-744).  Recorded so
        # benchmarks can report machine-readable asset substitutions instead
        # of only a log line.
        self.substitutions: list[str] = []

    def _key(self, path: str, srgb: bool) -> str:
        return f"{path}|srgb" if srgb else str(path)

    def load_or_default(self, path: str, srgb: bool = False) -> list[np.ndarray]:
        key = self._key(path, srgb)
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        mips = load_image(path, srgb=srgb) if path else None
        if mips is None:
            if path:
                log_warning(f"texture load failed, using default grid: {path}")
                with self._lock:
                    if str(path) not in self.substitutions:
                        self.substitutions.append(str(path))
            grid = default_grid_texture()
            if srgb:
                grid = np.concatenate(
                    [srgb_to_linear(grid[..., :3]), grid[..., 3:4]], axis=-1
                )
            mips = generate_mips(grid)
        with self._lock:
            self._cache[key] = mips
        return mips

    def load_or_solid(self, path: str, rgba, srgb: bool = False) -> list[np.ndarray]:
        key = self._key(path, srgb)
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        mips = load_image(path, srgb=srgb) if path else None
        if mips is None:
            mips = generate_mips(solid_color_texture(rgba))
        with self._lock:
            self._cache[key] = mips
        return mips
