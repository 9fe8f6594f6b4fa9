"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

Build.  Each source is compiled by its own ``nvcc`` process for ``sm_90a``
(all started together), and the objects are linked into ONE shared library
with a plain C interface, at first use, into ``unclerenderer_tpu_torch/_build``
(git-ignored).  The library name carries a hash of the sources, the
headers they include (``csrc/*.cuh``) and the flags, so an edit rebuilds.
``-fmad=false`` keeps nvcc from contracting multiply-adds: the kernels
spell out the reference's contractions with ``__fmaf_rn`` and must not
gain others.

Launch path. Every C entry takes device pointers, integers and the stream,
and returns ``cudaGetLastError()``. ``library()`` loads the library once and
``bind`` binds it once: ``argtypes``/``restype`` on each entry, and a table
from every kernel wrapper to its C function (wrappers that share one entry
keep their own counts: K9, K11 and K12 are the byte copy of
``copy_bytes.cu``, ``ENTRY``). Per call a wrapper runs ``check_cuda`` -- one
pass over its tensors (CUDA, one device index, contiguous) that returns the
device index -- allocates its outputs and calls ``launch``: one dict lookup,
the device's raw current stream handle
(``torch._C._cuda_getCurrentRawStream``: it follows PyTorch's current
stream, CUDA-graph capture included, and builds no ``Stream`` object; the
stream is never cached across calls) and the ctypes call with pointers as
plain ints (``c_void_p`` argtypes take ints), holding the GIL. A non-zero
return raises ``RuntimeError``; a launch is counted in ``LAUNCHES``, one
count per kernel wrapper, which ``chip_smoke.py`` reads to show which
kernels a run went through (a launch captured into a frame program's CUDA
graph counts at each replay instead, ``CAPTURED``). ``chip_smoke.py``'s
``launch_us`` measures a wrapper's host cost per call on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures: (argtypes) of each entry point; all return int
SIGNATURES = {
    # coef, tri_id, valid, tile_start, tile_count, out_key, out_id,
    # n_tiles, chunk, tile_h, tile_w, n_tx, y_off, want_ids, ortho, stream
    "binned_raster": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    # coef, valid, overlap, ids, out_key, out_id,
    # n_tiles, n_chunks, chunk, tile_h, tile_w, n_tx, y_off, want_ids, ortho, stream
    "giant_raster": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    # coef, tri_id, valid, tile_start, tile_count, rec, out_key, out_id,
    # out_attr, n_tiles, chunk, tile_h, tile_w, n_tx, y_off, r_cols, ortho, stream
    "binned_raster_attrs": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                            _P],
    # kernel_debug_print: coef, tri_id, valid, tile_start, tile_count, rec (or
    # NULL), out_key, out_id, out_attr, n_tiles, chunk, tile_h, tile_w, n_tx,
    # y_off, r_cols, want_ids, ortho, recut, stream
    "binned_raster_debug": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                            _I, _I, _P],
    # coef, valid, overlap, ids, rec, out_key, out_id, out_attr,
    # n_tiles, n_chunks, chunk, tile_h, tile_w, n_tx, y_off, r_cols, ortho, stream
    "giant_raster_attrs": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                           _P],
    # table, row, base, out, n, lanes, bw (block width: the 3x3's deltas), stream;
    # u16 rows, and f32 rows
    "shadow_select9": [_P, _P, _P, _P, _I, _I, _I, _P],
    "shadow_select9_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    # table, idx, out, n, c, is_bf16, stream
    "gather_rows": [_P, _P, _P, _L, _I, _I, _P],
    # top, out, top_h, top_w, levels, stream
    "hzb_tail": [_P, _P, _I, _I, _I, _P],
    # env, env_rows, params (9, n), out, n, lanes, is_bf16, stream
    "env_select": [_P, _P, _P, _P, _L, _I, _I, _P],
    # atlas (rows, 256), rows_idx, params (7, n), out (n, 16), n, dtype, stream
    "mat_select": [_P, _P, _P, _P, _L, _I, _P],
    # src, dst, n bytes, stream
    "copy_bytes": [_P, _P, _L, _P],
    # coef (T, 16), bbox (4, T), valid (T,) bool, mask (scratch), out_depth, out_id
    # (or NULL), t_count, width, height, tile_h, tile_w, y_off, want_ids, ortho,
    # depth_max, stream
    "exhaustive_raster": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    # a, b, ka, kb, out, n, stream
    "merge_select": [_P, _P, _P, _P, _P, _L, _P],
    # M1: coef, tri_id, valid, rows, tile_start (or NULL), tile_count (or NULL),
    # arec, atlas, out_key, out_id, stats (or NULL), scratch, n_blocks, chunk,
    # tile_h, tile_w, width, height, y_offset, full_height, atlas_width, lanes,
    # atlas_dtype, bilinear, stream
    "masked_raster": [_P] * 12 + [_I] * 12 + [_P],
    # the present's u8 conversion: f32 colour, u8 out, n values, stream
    "present_u8": [_P, _P, _L, _P],
    # the material tap's footprint: rec (n, 128), uv (n, 2), out planes, n, width,
    # row0, the slot's offset-scale / rotation / rect lanes, max_aniso (0: trilinear)
    "tap_footprint": [_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P],
    # the resolve's attributes: rec (n, 128), world_pos, v_normal, tangent4, uv,
    # v_color out, n, width, row0
    "interp_attrs": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _P],
    # the material taps: atlas (rows, 256), rec, planes, out (n, 16), n,
    # atlas_width, atlas rows, rect lane, n_taps (0: trilinear), dtype, select
    "material_tap": [_P, _P, _P, _P, _L, _I, _L, _I, _I, _I, _I, _P],
}

# kernel wrapper -> its C entry, where the two names differ
ENTRY = {"materialize_rows": "copy_bytes", "copy_rows": "copy_bytes", "materialize": "copy_bytes"}

# launches per kernel wrapper (K2/K3 share giant_raster; with records, K1 and
# K2/K3 count under binned_raster_attrs and giant_raster_attrs; K1 under
# kernel_debug_print under binned_raster_debug; K4 on f32 rows under
# shadow_select9_f32; M1, the masked raster, under masked_raster; the
# present's u8 conversion under present_u8; the resolve's attribute
# interpolation under interp_attrs, the material tap's two kernels under
# tap_footprint and material_tap)
LAUNCHES = {name: 0 for name in [n for n in SIGNATURES if n not in ENTRY.values()] + list(ENTRY)}

# kernel wrapper -> bound C function, and device index -> raw current
# stream handle; both set by ``bind``
_FNS: dict = {}
_stream = None

# when set, called with (wrapper name, "kernel" or "plain version") at every
# launch and every dispatch to a plain version (the Renderer's graph dump)
LAUNCH_LOG = None

# while ``render/program.py`` captures a CUDA graph, the Counter its launches
# are recorded in: a captured launch runs at each replay, and the program
# adds the recorded counts to LAUNCHES then, not at capture
CAPTURED = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    """Headers the sources include (from their own directory)."""
    return sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libkernels-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels unless the current sources are already built.
    Returns (library path, build seconds; 0 when already built)."""
    out = library_path()
    if out.is_file():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as obj_dir:
        objs = [Path(obj_dir) / f"{src.stem}.o" for src in sources()]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources(), objs)
        ]
        logs = [(p, p.communicate()[0]) for p in procs]
        failed = [f"{p.args[-1]}:\n{log}" for p, log in logs if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
    secs = time.perf_counter() - t0
    os.replace(tmp, out)
    return out, secs


def build_source(name: str, source: str) -> Path:
    """Compile one stand-alone CUDA source text (a kernel design sweep's)
    with the kernels' flags into ``_build/<name>.so``; returns its path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD_DIR / f"{name}.cu", BUILD_DIR / f"{name}.so"
    src.write_text(source)
    res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-shared", "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name} ({res.returncode}):\n{res.stderr}")
    return lib


def bind(lib, current_stream) -> None:
    """Bind the C entries of ``lib`` once: each one's ``argtypes`` and
    ``restype`` set, every kernel wrapper mapped to its entry, and
    ``current_stream(device index)`` as the source of each launch's stream."""
    global _stream
    entries = {name: getattr(lib, name) for name in SIGNATURES}
    for name, fn in entries.items():
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    _FNS.clear()
    _FNS.update({w: entries[ENTRY.get(w, w)] for w in LAUNCHES})
    _stream = current_stream


@functools.lru_cache(maxsize=None)
def library() -> ctypes.PyDLL:
    """Build (unless built) and load the kernels, and bind them.  Loaded as
    a ``PyDLL``: a call keeps the GIL (the entries only enqueue work, a few
    microseconds) instead of releasing and re-taking it around every launch."""
    lib = ctypes.PyDLL(str(build()[0]))
    bind(lib, torch._C._cuda_getCurrentRawStream)
    return lib


def launch(name: str, device: int, *args) -> None:
    """Call the C entry of kernel wrapper ``name`` with ``args`` (ints,
    pointers as ints, None for NULL) on the current stream of CUDA device
    ``device``; raise on a launch error, else count the launch."""
    fn = _FNS.get(name)
    if fn is None:
        library()
        fn = _FNS[name]
    err = fn(*args, _stream(device))
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    (LAUNCHES if CAPTURED is None else CAPTURED)[name] += 1
    if LAUNCH_LOG is not None:
        LAUNCH_LOG(name, "kernel")


def printf_fifo(nbytes: int = 0) -> int:
    """The current device's printf FIFO in bytes, grown to ``nbytes`` first
    where it is smaller.  The CUDA runtime lets it grow only before the
    process launches its first kernel that prints -- PyTorch's kernels with
    device asserts count --, so a caller that wants more than the 1 MiB
    default calls this before any other CUDA work (the Renderer does under
    ``kernel_debug_print``)."""
    fn = library().printf_fifo
    fn.argtypes, fn.restype = [_L], _L
    return int(fn(int(nbytes)))


def copy(name: str, x: torch.Tensor) -> torch.Tensor:
    """A fresh tensor equal to the contiguous CUDA tensor ``x``, made by the
    byte copy kernel and counted for wrapper ``name`` (K9, K11, K12)."""
    dev = check_cuda(name, x)
    out = torch.empty_like(x)  # x is contiguous, so out is too, with x's strides
    nbytes = x.nbytes
    if nbytes:
        launch(name, dev, x.data_ptr(), out.data_ptr(), nbytes)
    return out


def ptr(t: torch.Tensor | None) -> int | None:
    """Device pointer of an optional tensor (None passes NULL)."""
    return None if t is None else t.data_ptr()


def check_cuda(name: str, *tensors: torch.Tensor) -> int:
    """Kernel inputs must be contiguous tensors on one CUDA device; returns
    that device's index."""
    dev = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev


def on_cpu(name: str, t: torch.Tensor) -> bool:
    """Wrapper dispatch: True for CPU tensors (plain version), False for
    CUDA tensors (kernel); any other device raises."""
    if t.is_cuda:
        return False
    if t.is_cpu:
        if LAUNCH_LOG is not None:
            LAUNCH_LOG(name, "plain version")
        return True
    raise ValueError(f"{name}: unsupported device {t.device}")
