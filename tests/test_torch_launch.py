"""The port's kernel launch path (``unclerenderer_tpu_torch/ops/_cuda.py``)
on the CPU, against a stub library: each C entry is bound once, a launch
passes ints and the stream, a non-zero return raises, every wrapper keeps
its own count, and the input checks refuse what no kernel takes."""

import ctypes
from types import SimpleNamespace

import pytest
import torch

from unclerenderer_tpu_torch.ops import _cuda
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module

WRAPPERS = ["binned_raster", "giant_raster", "binned_raster_attrs", "giant_raster_attrs",
            "binned_raster_debug", "shadow_select9", "shadow_select9_f32", "gather_rows", "hzb_tail", "env_select", "mat_select",
            "materialize_rows", "merge_select", "copy_rows", "materialize", "exhaustive_raster",
            "masked_raster", "present_u8", "tap_footprint", "interp_attrs", "material_tap"]


class StubEntry:
    """A C entry: records each call, returns ``err``."""

    def __init__(self):
        self.calls, self.err = [], 0

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


class StubLibrary:
    """A loaded library: one ``StubEntry`` per C entry, each attribute
    lookup counted."""

    def __init__(self):
        self.entries = {name: StubEntry() for name in _cuda.SIGNATURES}
        self.lookups = {name: 0 for name in _cuda.SIGNATURES}

    def __getattr__(self, name):
        if name not in _cuda.SIGNATURES:
            raise AttributeError(name)
        self.lookups[name] += 1
        return self.entries[name]


@pytest.fixture
def stub():
    """The launch path bound to a stub library, whose current stream of
    device d is 1000 + d; the real binding and counts restored after."""
    saved = (dict(_cuda._FNS), _cuda._stream, dict(_cuda.LAUNCHES))
    lib = StubLibrary()
    _cuda.bind(lib, lambda device: 1000 + device)
    _cuda.reset_launches()
    yield lib
    _cuda._FNS.clear()
    _cuda._FNS.update(saved[0])
    _cuda._stream = saved[1]
    _cuda.LAUNCHES.update(saved[2])


def test_every_wrapper_has_a_count_and_an_entry():
    assert sorted(_cuda.LAUNCHES) == sorted(WRAPPERS)
    assert {_cuda.ENTRY.get(w, w) for w in WRAPPERS} == set(_cuda.SIGNATURES)


def test_bind_sets_each_entry_once(stub):
    for _ in range(5):
        _cuda.launch("materialize", 0, 16, 32, 4)
        _cuda.launch("copy_rows", 0, 16, 32, 4)
        _cuda.launch("gather_rows", 0, 1, 2, 3, 263184, 2, 1)
    assert stub.lookups == {name: 1 for name in _cuda.SIGNATURES}
    for name, entry in stub.entries.items():
        assert entry.argtypes == _cuda.SIGNATURES[name] and entry.restype is ctypes.c_int
        assert entry.argtypes[-1] is ctypes.c_void_p  # the stream, last


@pytest.mark.parametrize("device", [0, 3])
def test_launch_passes_ints_and_the_current_stream(stub, device):
    _cuda.launch("merge_select", device, 0x7F0000000010, 0x7F0000000020, 0x7F0000000030,
                 0x7F0000000040, 0x7F0000000050, 1080 * 1920)
    (call,) = stub.entries["merge_select"].calls
    assert call == (0x7F0000000010, 0x7F0000000020, 0x7F0000000030, 0x7F0000000040,
                    0x7F0000000050, 1080 * 1920, 1000 + device)
    assert all(type(a) is int for a in call)
    _cuda.launch("giant_raster", device, 1, 2, 3, None, 5, None, 6, 7, 8, 9, 10, 11, 0.0, 0, 1)
    assert stub.entries["giant_raster"].calls[0][3] is None  # NULL for an absent tensor


def test_launch_raises_on_a_nonzero_return_and_does_not_count(stub):
    stub.entries["copy_bytes"].err = 700
    with pytest.raises(RuntimeError, match="copy_rows.*700"):
        _cuda.launch("copy_rows", 0, 16, 32, 4)
    assert _cuda.LAUNCHES["copy_rows"] == 0


def test_copy_wrappers_share_copy_bytes_and_keep_their_own_counts(stub):
    for n, name in enumerate(["materialize_rows", "copy_rows", "copy_rows", "materialize",
                              "materialize", "materialize"]):
        _cuda.launch(name, 0, 16 * n, 32 * n, 4 * n)
    assert [c[2] for c in stub.entries["copy_bytes"].calls] == [0, 4, 8, 12, 16, 20]
    assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {
        "materialize_rows": 1, "copy_rows": 2, "materialize": 3}


def _tensor_like(device_index, contiguous=True):
    """A stand-in for a CUDA tensor (the checks read only these)."""
    return SimpleNamespace(is_cuda=True, get_device=lambda: device_index,
                           is_contiguous=lambda: contiguous, device=f"cuda:{device_index}")


def test_check_returns_the_device_index():
    assert _cuda.check_cuda("merge_select", *[_tensor_like(2) for _ in range(4)]) == 2


@pytest.mark.parametrize("case", ["cpu", "non_contiguous", "cpu_and_meta", "two_cuda_devices",
                                  "non_contiguous_stand_in"])
def test_check_refuses(case):
    tensors = {
        "cpu": [torch.zeros(4)],
        "non_contiguous": [torch.zeros(4, 4).t()],
        "cpu_and_meta": [torch.zeros(4), torch.zeros(4, device="meta")],
        "two_cuda_devices": [_tensor_like(0), _tensor_like(1)],
        "non_contiguous_stand_in": [_tensor_like(0), _tensor_like(0, contiguous=False)],
    }[case]
    with pytest.raises(ValueError):
        _cuda.check_cuda("gather_rows", *tensors)


def test_on_cpu_dispatch():
    assert _cuda.on_cpu("materialize", torch.zeros(4))
    assert not _cuda.on_cpu("materialize", _tensor_like(0))
    with pytest.raises(ValueError):
        _cuda.on_cpu("materialize", torch.zeros(4, device="meta"))


def test_every_local_include_is_a_hashed_header():
    """A source includes, from ``csrc``, only headers that ``headers()``
    lists, so every file the build reads is in the library's hash."""
    hashed = {h.name for h in _cuda.headers()}
    included = set()
    for src in _cuda.sources() + _cuda.headers():
        for line in src.read_text().splitlines():
            if line.startswith('#include "'):
                included.add(line.split('"')[1])
    assert "raster_common.cuh" in included
    assert included <= hashed, included - hashed


@pytest.mark.parametrize("edited", ["raster_common.cuh", "giant_raster.cu"])
def test_library_name_follows_sources_and_headers(tmp_path, monkeypatch, edited):
    """An edit to a source or to a header it includes gives the library a
    new name, so the next build compiles it."""
    for f in _cuda.sources() + _cuda.headers():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    before = _cuda.library_path()
    assert _cuda.library_path() == before
    with open(tmp_path / edited, "a") as f:
        f.write("\n// edited\n")
    assert _cuda.library_path() != before
