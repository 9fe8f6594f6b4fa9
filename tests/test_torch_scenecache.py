"""The port's built-scene cache (``unclerenderer_tpu_torch/core/scenecache.py``),
modelled on the reference's ``tests/test_scenecache.py`` but on scene files
written by ``render/testing.py write_scene``: a warm Renderer is bit-exact
against the cold one (arrays and frames), an asset touch invalidates, the
atlas settings key the entry, an empty ``UNCLERENDERER_SCENE_CACHE`` turns
the cache off, eviction bounds the entries, and a reference entry in the
same directory is never read nor imports the JAX package."""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from unclerenderer_tpu_torch.core import scenecache
from unclerenderer_tpu_torch.render.params import RenderSettings
from unclerenderer_tpu_torch.render.renderer import Renderer, scene_cache_key
from unclerenderer_tpu_torch.render.testing import write_scene
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

ROOT = Path(__file__).resolve().parents[1]
SETTINGS = RenderSettings(width=64, height=64, shadow_map_size=64)


def _write(root):
    return write_scene(root, 2, masked=True, emissive=True, texture_transform=True,
                       n_materials=2, tex_size=64)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("scenecache_scene"))


@pytest.fixture
def cache_env(tmp_path, monkeypatch):
    monkeypatch.setenv("UNCLERENDERER_SCENE_CACHE", str(tmp_path / "sc"))
    return tmp_path / "sc" / scenecache.SUBDIR


def _renderer(scene, settings=SETTINGS):
    return Renderer(scene, settings=settings, device="cpu")


def test_roundtrip_bit_exact(scene, cache_env):
    cold = _renderer(scene)
    assert not cold.scene_cache_hit
    assert set(cold.setup_phase_s) == {"cache_load", "scene_build", "build_and_upload"}
    assert len(list(cache_env.glob("*.arrays"))) == 1, "the cold build stored no entry"
    warm = _renderer(scene)
    assert warm.scene_cache_hit
    assert set(warm.setup_phase_s) == {"cache_load", "device_upload"}
    for f in dataclasses.fields(cold.device_scene):
        a, b = getattr(cold.device_scene, f.name), getattr(warm.device_scene, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert torch.equal(a, b), f.name
    for f in dataclasses.fields(cold.scene_data):
        a, b = getattr(cold.scene_data, f.name), getattr(warm.scene_data, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    assert [m.name for m in warm.scene_data.models] == [m.name for m in cold.scene_data.models]
    assert warm.settings == cold.settings
    assert (warm.env_mip_count, warm.texture_substitutions) == (cold.env_mip_count,
                                                                cold.texture_substitutions)
    # carried 64^2 frames: bit-equal, counters too
    for i in range(2):
        a, b = cold.render_frame(), warm.render_frame()
        for k in ("color", "hdr", "depth", "tri_id", "object_id"):
            assert torch.equal(a[k], b[k]), f"frame {i} {k}"
        assert {k: int(v) for k, v in a["raster_stats"].items()} == {
            k: int(v) for k, v in b["raster_stats"].items()}
        assert int((a["tri_id"] >= 0).sum()) > 500


def test_reload_goes_through_the_cache(scene, cache_env, monkeypatch):
    from unclerenderer_tpu_torch.render import renderer as renderer_mod

    """A reload builds with the Renderer's synced settings, whose key may
    differ from the construction's: the first reload stores under it, the
    second reads it back without building."""
    r = _renderer(scene)
    before = r.render_frame()["color"].clone()
    r.reload_scene(scene, background=False)

    def no_build(*_a, **_k):
        raise AssertionError("the reload built the scene instead of reading the cache")

    monkeypatch.setattr(renderer_mod, "build_scene", no_build)
    assert r.reload_scene(scene, background=False) is None
    assert torch.equal(r.render_frame()["color"], before)


def test_asset_touch_invalidates(scene, cache_env):
    r = _renderer(scene)
    key = scene_cache_key(Path(scene), SETTINGS, r.assets_root)
    assert scenecache.load(key) is not None
    meta = json.loads((cache_env / f"{key}.meta.json").read_text())
    files = [f for f, _sig in meta["files"]]
    assert any(f.endswith(".png") for f in files) and any(f.endswith(".dds") for f in files)
    st = os.stat(files[0])
    os.utime(files[0], ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    try:
        assert scenecache.load(key) is None
        assert not _renderer(scene).scene_cache_hit  # rebuilt and stored again
        assert scenecache.load(key) is not None
    finally:
        os.utime(files[0], ns=(st.st_atime_ns, st.st_mtime_ns))
    # the geometry's files are in the key itself
    (buf,) = Path(scene).parent.parent.glob("Models/*.bin")
    st = os.stat(buf)
    os.utime(buf, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    try:
        assert scene_cache_key(Path(scene), SETTINGS, r.assets_root) != key
    finally:
        os.utime(buf, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert scene_cache_key(Path(scene), SETTINGS, r.assets_root) == key


def test_atlas_settings_change_the_key(scene, cache_env):
    base = scene_cache_key(Path(scene), SETTINGS, Path(scene).parent.parent)
    for change in ({"material_atlas_u8": not SETTINGS.material_atlas_u8},
                   {"material_packed_trilinear": True},
                   {"enable_combined_material": not SETTINGS.enable_combined_material}):
        other = dataclasses.replace(SETTINGS, **change)
        assert scene_cache_key(Path(scene), other, Path(scene).parent.parent) != base, change
    assert scene_cache_key(Path(scene), SETTINGS, Path("/elsewhere")) != base
    assert _renderer(scene).scene_cache_hit is False
    other = dataclasses.replace(SETTINGS, material_atlas_u8=not SETTINGS.material_atlas_u8)
    assert _renderer(scene, other).scene_cache_hit is False
    assert len(list(cache_env.glob("*.meta.json"))) == 2


def test_disabled_by_empty_env(scene, monkeypatch, tmp_path):
    monkeypatch.setenv("UNCLERENDERER_SCENE_CACHE", "")
    assert scenecache.cache_dir() is None
    assert scenecache.load("deadbeef") is None
    monkeypatch.setenv("HOME", str(tmp_path))  # the default directory, were it used
    assert not _renderer(scene).scene_cache_hit
    assert not _renderer(scene).scene_cache_hit
    assert not (tmp_path / ".cache").exists()


def test_eviction_bounds_entries(cache_env, monkeypatch):
    cache_env.mkdir(parents=True, exist_ok=True)
    monkeypatch.setattr(scenecache, "_MAX_ENTRIES", 2)
    for i in range(4):
        (cache_env / f"k{i}.arrays").mkdir()
        (cache_env / f"k{i}.arrays" / "a.npy").write_bytes(b"x")
        for suffix in (".meta.json", ".scene.pkl"):
            (cache_env / f"k{i}{suffix}").write_bytes(b"x")
        t = time.time() - 100 + i
        os.utime(cache_env / f"k{i}.meta.json", (t, t))
    scenecache._evict(cache_env)
    assert sorted(p.name for p in cache_env.glob("*.arrays")) == ["k2.arrays", "k3.arrays"]
    assert not (cache_env / "k0.meta.json").exists()
    assert not (cache_env / "k1.scene.pkl").exists()


def test_reference_entry_is_never_read(scene, tmp_path):
    """A fresh process: a cold port Renderer stores its entry; then the
    reference's own pickle of the scene (its ``SceneData``, a class of the
    JAX package) is planted both where the reference keeps its entries (the
    cache directory itself, under the port's key) and over the port's
    entry.  The next port Renderer misses and rebuilds, the unpickler
    refuses the class, and neither JAX nor the JAX package is imported."""
    from unclerenderer_tpu.scene.build import build_scene as j_build_scene

    planted = tmp_path / "reference_scene.pkl"
    planted.write_bytes(pickle.dumps(j_build_scene(Path(scene))))
    assert b"unclerenderer_tpu.scene.build" in planted.read_bytes()
    code = textwrap.dedent(f"""
        import json, pathlib, shutil, sys
        from unclerenderer_tpu_torch.core import scenecache
        from unclerenderer_tpu_torch.render.params import RenderSettings
        from unclerenderer_tpu_torch.render.renderer import Renderer, scene_cache_key
        scene = pathlib.Path({str(scene)!r})
        s = RenderSettings(width=64, height=64, shadow_map_size=64)
        cold = Renderer(scene, settings=s, device="cpu")
        key = scene_cache_key(scene, s, cold.assets_root)
        d = scenecache.cache_dir()
        top = d.parent
        shutil.copytree(d / (key + ".arrays"), top / (key + ".arrays"))
        meta = json.loads((d / (key + ".meta.json")).read_text())
        (top / (key + ".meta.json")).write_text(json.dumps({{**meta, "format": 3}}))
        shutil.copy({str(planted)!r}, top / (key + ".scene.pkl"))
        shutil.copy({str(planted)!r}, d / (key + ".scene.pkl"))
        assert scenecache.load(key) is None
        warm = Renderer(scene, settings=s, device="cpu")
        top_mods = {{m.split(".")[0] for m in sys.modules}}
        print(cold.scene_cache_hit, warm.scene_cache_hit,
              sorted(t for t in top_mods if t.startswith("jax") or t == "unclerenderer_tpu"))
    """)
    env = {**os.environ, "UNCLERENDERER_SCENE_CACHE": str(tmp_path / "sc")}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "False False []"
    assert "refusing unclerenderer_tpu.scene.build.SceneData" in res.stderr
