"""ctypes binding to the repository's native C++ asset helpers
(``native/*.cpp``: PNG scanline unfiltering, BC1-5 and BC6H/BC7 block
decoding, TrueType atlas baking), as ``unclerenderer_tpu/textures/native.py``.

The library is compiled from the sources with ``g++`` at first use into
``unclerenderer_tpu_torch/_build/`` (git-ignored), under a name that hashes
the sources, the flags and the host CPU (``-march=native``), so an edit or
another machine rebuilds; ``native/``'s own Makefile and prebuilt library
are not used.  The flags are the Makefile's, so the decoders and the font
bake give the same bytes.  Every entry point has a numpy fallback (BC6H/BC7
and the font bake degrade to a gray fill and the bitmap font): without
``g++`` or on a failed build the package works, slower at asset load.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ..core.logging import log_warning

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native", "-shared"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# (argtypes) of each entry point; all return int
SIGNATURES = {
    # in, out, height, stride, bpp
    "png_unfilter": [_P, _P, _L, _L, _L],
    # in, out (h, w, 4) u8, width, height, kind 1-5
    "bc_decode": [_P, _P, _L, _L, _I],
    # in, out (h, w, 4) f32 (kind 6, 7) or u8 (kind 8), width, height, kind
    "bc67_decode": [_P, _P, _L, _L, _I],
    # ttf bytes, size, pixel height, atlas, atlas w, atlas h, first char,
    # char count, glyphs (count, 9) f32
    "ttf_bake": [_P, _L, _F, _P, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
_lib_checked = False
# how the last get_native() fared: library path and build seconds (0.0 when
# it was already built), or the reason there is none
build_info: dict = {}


def sources() -> list[Path]:
    return sorted(NATIVE_DIR.glob("*.cpp"))


def _host_cpu() -> str:
    """What ``-march=native`` compiles for: the machine and its CPU flags."""
    try:
        with open("/proc/cpuinfo", encoding="utf-8", errors="replace") as f:
            flags = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        flags = ""
    return platform.machine() + flags


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_host_cpu().encode())
    return BUILD_DIR / f"libnative-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile ``native/*.cpp`` into one library unless it is already built.
    Returns (library path, build seconds; 0.0 when already built).  Raises
    ``RuntimeError`` when there is no compiler or the build fails."""
    out = library_path()
    if out.is_file():
        return out, 0.0
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ or $CXX) to build native/*.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, sources())],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building native/*.cpp failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds leave one complete file
    return out, time.perf_counter() - t0


def get_native():
    """The loaded library with its entries bound, or None (logged once)
    when it cannot be built or loaded."""
    global _lib, _lib_checked
    with _lock:
        if _lib_checked:
            return _lib
        _lib_checked = True
        try:
            path, secs = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        except (RuntimeError, OSError, AttributeError) as e:
            log_warning(f"native library unavailable ({e}); using the numpy asset decoders")
            build_info.update(path=None, error=str(e))
            return None
        build_info.update(path=str(path), seconds=secs)
        _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def png_unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray | None:
    """Unfilter PNG scanlines; (height*stride,) u8, or None without the
    library or on a bad filter byte."""
    lib = get_native()
    if lib is None:
        return None
    src = np.frombuffer(raw, dtype=np.uint8)
    if src.size < height * (stride + 1):
        return None
    out = np.empty(height * stride, dtype=np.uint8)
    if lib.png_unfilter(_ptr(src), _ptr(out), height, stride, bpp) != 0:
        return None
    return out


def bc67_decode(data: bytes, width: int, height: int, kind: int) -> np.ndarray | None:
    """Decode BC6H (kind 6 UF16 / 7 SF16 -> f32) or BC7 (kind 8 -> u8);
    None without the library."""
    lib = get_native()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    dt = np.float32 if kind in (6, 7) else np.uint8
    out = np.empty((height, width, 4), dtype=dt)
    if lib.bc67_decode(_ptr(src), _ptr(out), width, height, kind) != 0:
        return None
    return out


def bc_decode(data: bytes, width: int, height: int, kind: int) -> np.ndarray | None:
    """Decode a BC1-5 mip to (height, width, 4) u8; None without the
    library."""
    lib = get_native()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty((height, width, 4), dtype=np.uint8)
    if lib.bc_decode(_ptr(src), _ptr(out), width, height, kind) != 0:
        return None
    return out
