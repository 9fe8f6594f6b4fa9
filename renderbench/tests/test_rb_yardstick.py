"""The frozen trace, busy-share and roofline arithmetic against the
originals it was copied from (``core/traceparse.py``, ``chip_smoke.py``'s
``device_busy`` and ``work_binned``)."""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from renderbench import roofline, trace
from unclerenderer_tpu_torch.core import traceparse
from unclerenderer_tpu_torch.render import testing as port_testing

torch.set_num_threads(1)


def _events(seed: int) -> list:
    """A synthetic Chrome trace: nested pass ranges on a host thread,
    launches inside them and the device rows they made (some with no
    launch, under a stream range), overlapping rows included."""
    rng = np.random.default_rng(seed)
    ev, t, corr = [], 0.0, 0
    names = list(traceparse.PASS_NAMES) + ["Untile", "(none)"]
    for frame in range(3):
        for p in rng.choice(len(names), 6):
            dur = float(rng.uniform(50, 400))
            if names[p] != "(none)":
                ev.append({"ph": "X", "cat": "user_annotation", "name": names[p], "ts": t,
                           "dur": dur, "pid": 1, "tid": 1})
            for _ in range(int(rng.integers(1, 5))):
                lt = t + float(rng.uniform(0, dur))
                corr += 1
                ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "ts": lt, "dur": 3.0, "pid": 1, "tid": 1,
                           "args": {"correlation": corr}})
                ev.append({"ph": "X", "cat": "kernel", "name": f"k{int(rng.integers(4))}",
                           "ts": lt + float(rng.uniform(5, 60)), "dur": float(rng.uniform(1, 90)),
                           "pid": 0, "tid": 7, "args": {"correlation": corr}})
            t += dur + float(rng.uniform(0, 80))
        ev.append({"ph": "X", "cat": "gpu_user_annotation", "name": "MaterialResolve", "ts": t,
                   "dur": 50.0, "pid": 0, "tid": 7})
        ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": t + 10,
                   "dur": 20.0, "pid": 0, "tid": 7, "args": {"correlation": 10**6 + frame}})
        t += 100.0
    return ev


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pass_times_are_traceparse(tmp_path, seed):
    ev = _events(seed)
    (tmp_path / "x.pt.trace.json").write_text(json.dumps({"traceEvents": ev}))
    assert trace.scope_paths(ev) == traceparse.scope_paths(ev)
    theirs = traceparse.parse_pass_times(tmp_path, n_frames=3)
    assert trace.pass_times(ev, 3) == pytest.approx(theirs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_busy_union_is_device_busy(tmp_path, seed):
    ev = _events(seed)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    ours = trace.busy_union(trace.device_rows(ev))
    assert ours / 1e3 == pytest.approx(chip_smoke.device_busy(path)["busy_ms"])
    rows = trace.device_rows(ev)
    t0, t1 = rows[0][0] - 5.0, max(b for _a, b, _n in rows) + 7.0
    gaps = trace.idle_gaps(rows, t0, t1)
    assert sum(d for _s, d in gaps) == pytest.approx(t1 - t0 - ours)


def _k1_call(seed: int):
    """A K1 call's positional arguments from a small binned raster of
    random triangles (``render/testing.py masked_raster_setup``'s setups)."""
    from unclerenderer_tpu_torch.ops import raster_kernels as rk

    setup, _arec = port_testing.masked_raster_setup("random", seed, "cpu", width=128, height=64)
    calls = []
    orig = rk.binned_raster

    def rec(*args, **kwargs):
        calls.append(args)
        return orig(*args, **kwargs)

    rk.binned_raster = rec
    try:
        rk.rasterize_binned(setup, 128, 64, tile_h=16, tile_w=64)
    finally:
        rk.binned_raster = orig
    assert calls, "no K1 call"
    return calls


@pytest.mark.parametrize("seed", [0, 3])
def test_work_binned_is_chip_smokes(seed):
    for args in _k1_call(seed):
        moved, ops, _pairs, _kept = chip_smoke.work_binned(*args)
        assert roofline.work_binned(*args) == (moved, ops)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fma_is_the_ports(seed):
    from unclerenderer_tpu_torch.ops.fma import fma as port_fma

    g = torch.Generator().manual_seed(seed)
    a, b, c = (torch.randn(4096, generator=g) * 10.0 ** float(e) for e in (0, 2, -1))
    assert torch.equal(roofline.fma(a, b, c), port_fma(a, b, c))
    assert torch.equal(roofline.fma(a, 0.1, c), port_fma(a, 0.1, c))
