"""Path helpers (``unclerenderer_tpu/core/paths.py``): case-insensitive
resolution for Windows-authored assets."""

from __future__ import annotations

from pathlib import Path


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
