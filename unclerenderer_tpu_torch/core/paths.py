"""Path helpers (``unclerenderer_tpu/core/paths.py``): case-insensitive
resolution for Windows-authored assets."""

from __future__ import annotations

import os
from pathlib import Path

# names the reference checkout's ``Assets`` directory (Sponza's glTF and DDS
# set, the reference scenes), which the repository does not hold
ASSETS_ENV = "UNCLERENDERER_ASSETS"


def reference_asset(relative: str) -> str:
    """``relative`` under the directory that ``UNCLERENDERER_ASSETS`` names,
    or "" (no file) when the variable is unset: callers then take their
    absent-asset fallback."""
    root = os.environ.get(ASSETS_ENV, "")
    return str(Path(root) / relative) if root else ""


def resolve_path_case_insensitive(path: Path) -> Path:
    """Resolve a path that may differ in case from the file on disk (scene
    files written on Windows name e.g. ``CompareBasecolor/`` for
    ``CompareBaseColor/``)."""
    path = Path(path)
    if path.exists():
        return path
    parts = path.parts
    for anchor_len in range(len(parts) - 1, 0, -1):
        cur = Path(*parts[:anchor_len])
        if cur.exists():
            break
    else:
        return path
    for comp in parts[anchor_len:]:
        if (cur / comp).exists():
            cur = cur / comp
            continue
        try:
            match = next(
                (e for e in cur.iterdir() if e.name.lower() == comp.lower()), None
            )
        except OSError:
            return path
        if match is None:
            return path
        cur = match
    return cur
