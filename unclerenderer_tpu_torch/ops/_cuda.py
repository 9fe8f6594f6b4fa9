"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process for ``sm_90a`` (all
started together), and the objects are linked into ONE shared library with a
plain C interface, at first use, into ``unclerenderer_tpu_torch/_build``
(git-ignored).  The library name carries a hash of the sources and flags, so
an edited source rebuilds.  ``-fmad=false`` keeps nvcc from contracting
multiply-adds: the kernels spell out the reference's contractions with
``__fmaf_rn`` and must not gain others.

Every C entry point takes device pointers, integers and the stream, and
returns ``cudaGetLastError()``; ``launch`` raises on a non-zero code and
counts the launch in ``LAUNCHES`` (one count per kernel wrapper, read by
``chip_smoke.py`` to show which kernels a run went through).  Wrappers that
share one C entry keep their own counts (``ENTRY``): K9, K11 and K12 are
the byte copy of ``copy_bytes.cu``.
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
    # table, row, base, deltas (host int[9]), out, n, lanes, stream
    "shadow_select9": [_P, _P, _P, _P, _P, _I, _I, _P],
    # table, idx, out, n, c, is_bf16, stream
    "gather_rows": [_P, _P, _P, _I, _I, _I, _P],
    # top, dims (host int[3 * levels]: w, h, offset), out, top_h, top_w,
    # levels, stream
    "hzb_tail": [_P, _P, _P, _I, _I, _I, _P],
    # env, env_rows, params (9, n), out, n, lanes, is_bf16, stream
    "env_select": [_P, _P, _P, _P, _L, _I, _I, _P],
    # atlas, rows_idx, params (7, n), out, n, c, lanes, dtype, stream
    "mat_select": [_P, _P, _P, _P, _L, _I, _I, _I, _P],
    # src, dst, n bytes, stream
    "copy_bytes": [_P, _P, _L, _P],
    # a, b, ka, kb, out, n, stream
    "merge_select": [_P, _P, _P, _P, _P, _L, _P],
}

# kernel wrapper -> its C entry, where the two names differ
ENTRY = {"materialize_rows": "copy_bytes", "copy_rows": "copy_bytes", "materialize": "copy_bytes"}

# launches per kernel wrapper (K2/K3 share giant_raster)
LAUNCHES = {name: 0 for name in [n for n in SIGNATURES if n not in ENTRY.values()] + list(ENTRY)}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


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
    for src in sources():
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


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call the C entry of kernel wrapper ``name`` on the current stream;
    raise on a launch error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), ENTRY.get(name, name))(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    LAUNCHES[name] += 1


def copy(name: str, x: torch.Tensor) -> torch.Tensor:
    """A fresh tensor equal to the contiguous CUDA tensor ``x``, made by the
    byte copy kernel and counted for wrapper ``name`` (K9, K11, K12)."""
    check_cuda(name, x)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    nbytes = x.numel() * x.element_size()
    if nbytes:
        launch(name, ptr(x), ptr(out), nbytes)
    return out


def ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Kernel inputs must be contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def on_cpu(name: str, t: torch.Tensor) -> bool:
    """Wrapper dispatch: True for CPU tensors (plain version), False for
    CUDA tensors (kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")
