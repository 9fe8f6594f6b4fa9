"""On-disk cache of the built scene (``unclerenderer_tpu/core/scenecache.py``):
the warm start.

A cold ``Renderer`` decodes the glTF, generates tangents, decodes textures,
fuses the combined material and packs the atlases; this module keeps the
finished product -- the ``SceneData`` and every ``DeviceScene`` host array
(``render/packing.py scene_host_arrays``) -- keyed by the scene description
and validated against the (size, mtime) of every asset file the build read,
so a warm start is a mapped read and the same ``params.upload_scene`` as a
cold build.

Layout per entry, format v3 as the reference's (one raw ``.npy`` per array,
opened with ``mmap_mode="r"``), under ``<cache_dir>/torch/``:

* ``<key>.arrays/<name>.npy`` -- one array each (bfloat16 as its uint16
  bit patterns, as the host arrays already hold it);
* ``<key>.meta.json`` -- scalar results and the consumed-file freshness list;
* ``<key>.scene.pkl`` -- the pickled ``SceneData``.

``cache_dir`` is ``$UNCLERENDERER_SCENE_CACHE`` or
``~/.cache/unclerenderer_scenes`` (an empty variable turns the cache off),
the reference's own directory: the port keeps to its ``torch/``
subdirectory, mixes a port tag into the key and ``meta.json``'s format, and
unpickles with an unpickler that admits only this package, numpy and plain
builtin types, so a reference entry (whose pickle names the JAX package's
classes) is a miss, never an import.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import shutil
import time
from pathlib import Path

import numpy as np

from .logging import log_info, log_warning

FORMAT_VERSION = 3  # the reference's v3 layout: raw per-array .npy dir
PORT_TAG = "unclerenderer_tpu_torch"  # in the key and meta["format"]
SUBDIR = "torch"
_MAX_ENTRIES = 6  # evict the oldest beyond this (atlases are hundreds of MB)

# the plain builtin types whose pickles name them (the others have opcodes)
_BUILTINS = frozenset({"set", "frozenset", "bytearray", "slice", "range", "complex"})


def cache_dir() -> Path | None:
    """The port's entry directory, or None when the cache is off."""
    env = os.environ.get("UNCLERENDERER_SCENE_CACHE")
    if env == "":
        return None  # explicitly disabled
    root = Path(env) if env else Path.home() / ".cache" / "unclerenderer_scenes"
    return root / SUBDIR


def _stat_sig(path: str) -> tuple:
    st = os.stat(path)
    return (st.st_size, st.st_mtime_ns)


def _format() -> str:
    return f"{PORT_TAG}/v{FORMAT_VERSION}"


def scene_key(scene_path: Path, model_files: list[str], settings_sig: tuple) -> str:
    """Hash of everything known before the build runs: the scene JSON
    bytes, the model files' stats and the atlas-layout settings."""
    h = hashlib.sha256()
    h.update(f"{_format()}|{settings_sig}".encode())
    try:
        h.update(Path(scene_path).read_bytes())
    except OSError:
        h.update(str(scene_path).encode())
    for f in sorted(set(model_files)):
        try:
            h.update(f"{f}|{_stat_sig(f)}".encode())
        except OSError:
            h.update(f"{f}|missing".encode())
    return h.hexdigest()[:32]


def model_files_of(scene_path: Path) -> list[str]:
    """Geometry freshness set: each model file named by the scene JSON plus
    any .bin buffers next to it (glTF external buffers live alongside)."""
    from ..scene.scene_json import load_scene_json

    files: list[str] = []
    try:
        models, _light, _cam = load_scene_json(scene_path)
    except Exception:  # noqa: BLE001 -- the key degrades to the JSON bytes
        return files
    root = Path(scene_path).parent.parent
    for m in models or []:
        p = Path(m.mesh_path)
        if not p.is_absolute():
            p = root / p
        if p.is_file():
            files.append(str(p))
            files.extend(str(b) for b in sorted(p.parent.glob("*.bin")))
    return files


class _PortUnpickler(pickle.Unpickler):
    """Admits the port's own classes, numpy and plain builtin types only."""

    def find_class(self, module, name):
        top = module.split(".", 1)[0]
        if top in (PORT_TAG, "numpy") or (module == "builtins" and name in _BUILTINS):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"scene cache: refusing {module}.{name}")


def load(key: str):
    """Return ``(scene_data, host_arrays, meta)`` or None on a miss, a stale
    entry or an entry that is not the port's."""
    d = cache_dir()
    if d is None:
        return None
    adir, meta_p, pkl = d / f"{key}.arrays", d / f"{key}.meta.json", d / f"{key}.scene.pkl"
    if not (adir.is_dir() and meta_p.is_file() and pkl.is_file()):
        return None
    try:
        meta = json.loads(meta_p.read_text())
        if meta.get("format") != _format():
            return None
        for f, sig in meta["files"]:
            if _stat_sig(f) != tuple(sig):
                return None  # an asset changed since the build
        t0 = time.monotonic()
        arrays, total = {}, 0
        for name in meta["names"]:
            p = adir / f"{name}.npy"
            total += p.stat().st_size
            arrays[name] = np.load(p, mmap_mode="r")
        scene_data = _PortUnpickler(io.BytesIO(pkl.read_bytes())).load()
        os.utime(meta_p)  # freshen for the eviction order
        log_info(f"scene cache HIT {key[:12]} ({total / 1e6:.0f} MB mapped in "
                 f"{time.monotonic() - t0:.2f}s)")
        return scene_data, arrays, meta
    except Exception as e:  # noqa: BLE001 -- any corrupt or foreign entry is a miss
        log_warning(f"scene cache entry {key[:12]} unreadable ({e!r}); rebuilding")
        return None


def store(key: str, scene_data, host_arrays: dict, meta_extra: dict, files: list[str]) -> None:
    """Persist a finished build: ``host_arrays`` are the build's numpy
    arrays (never device tensors), ``files`` every asset file it read."""
    d = cache_dir()
    if d is None:
        return
    try:
        d.mkdir(parents=True, exist_ok=True)
        t0 = time.monotonic()
        arrays = {name: np.asarray(v) for name, v in host_arrays.items() if v is not None}
        meta = {
            "format": _format(),
            "names": sorted(arrays),
            "files": [[f, list(_stat_sig(f))] for f in sorted(set(files))],
            **meta_extra,
        }
        tmp = d / f"{key}.tmp.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        total = 0
        for name, a in arrays.items():
            np.save(tmp / f"{name}.npy", a)
            total += (tmp / f"{name}.npy").stat().st_size
        adir = d / f"{key}.arrays"
        shutil.rmtree(adir, ignore_errors=True)
        tmp.replace(adir)
        (d / f"{key}.scene.pkl").write_bytes(pickle.dumps(scene_data))
        (d / f"{key}.meta.json").write_text(json.dumps(meta))
        log_info(f"scene cache STORE {key[:12]} ({total / 1e6:.0f} MB in "
                 f"{time.monotonic() - t0:.1f}s)")
        _evict(d)
    except Exception as e:  # noqa: BLE001 -- caching must never break a build
        log_warning(f"scene cache store failed ({e!r})")


def _evict(d: Path) -> None:
    entries = sorted(d.glob("*.meta.json"), key=lambda p: p.stat().st_mtime)
    for meta_p in entries[:-_MAX_ENTRIES]:
        stem = meta_p.name[: -len(".meta.json")]
        shutil.rmtree(d / f"{stem}.arrays", ignore_errors=True)
        for suffix in (".meta.json", ".scene.pkl"):
            (d / f"{stem}{suffix}").unlink(missing_ok=True)
