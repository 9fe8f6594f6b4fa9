"""The end-to-end metrics over a synthetic timeline with a stall in it."""

import numpy as np
import pytest

from renderbench import timeline


def _timeline(stall_at=None, stall_s=0.0, n=200, frame_s=0.08):
    t_start = 100.0
    presents, t = [], t_start
    for i in range(n):
        t += frame_s + (stall_s if i == stall_at else 0.0)
        presents.append(t)
    return t_start, presents


def test_frame_ms_counts_all_time_over_all_frames():
    t0, steady = _timeline()
    assert timeline.frame_ms(t0, steady, [1] * 200) == pytest.approx(80.0)
    t0, stalled = _timeline(stall_at=57, stall_s=2.0)
    # a 2 s stall spread over the 200 frames: +10 ms a frame, where a
    # median of blocks would not move
    assert timeline.frame_ms(t0, stalled, [1] * 200) == pytest.approx(90.0)


def test_frame_ms_of_clips_counts_each_frame():
    t0, presents = _timeline(n=20, frame_s=0.8)  # clips of 10 frames
    assert timeline.frame_ms(t0, presents, [10] * 20) == pytest.approx(80.0)


def test_p95_takes_every_interval_and_the_tail():
    t0, presents = _timeline(n=200)
    assert timeline.frame_ms_p95(t0, presents) == pytest.approx(80.0)
    # 20 stalled frames of 200 (10%): the 95th percentile is in the stalls
    rng = np.random.default_rng(0)
    stalls = set(rng.choice(200, 20, replace=False).tolist())
    t, out = t0, []
    for i in range(200):
        t += 0.08 + (0.05 if i in stalls else 0.0)
        out.append(t)
    assert timeline.frame_ms_p95(t0, out) == pytest.approx(130.0)
    # the first interval runs from the window's start
    assert timeline.frame_ms_p95(t0, [t0 + 1.0]) == pytest.approx(1000.0)


def test_end_to_end_names_and_units():
    """Each end-to-end metric's reader (``metrics/<name>.py``) over the
    run's context: the arithmetic above, the peak in GiB, set-up as it is;
    ``clip_frame_ms`` is ``frame_ms``'s arithmetic under its own bound."""
    from renderbench import run

    t0, presents = _timeline(n=10)
    ctx = {"timeline": {"t_start": t0, "presents": presents, "frames": [1] * 10},
           "peak_bytes": 3 * 2**30, "setup_s": 12.5}
    bench = run.load_bench()
    got = {m["name"]: (run.metric_module(m["name"]).read(ctx), m["unit"])
           for m in bench["end_to_end"]}
    assert {k: u for k, (_v, u) in got.items()} == {
        "frame_ms": "ms", "clip_frame_ms": "ms", "frame_ms_p95": "ms", "peak_gib": "GiB",
        "setup_s": "s"}
    assert got["clip_frame_ms"][0] == got["frame_ms"][0] == timeline.frame_ms(t0, presents,
                                                                              [1] * 10)
    assert got["peak_gib"][0] == 3.0 and got["setup_s"][0] == 12.5
