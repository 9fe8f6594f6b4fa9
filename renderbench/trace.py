"""Reading a ``torch.profiler`` Chrome trace: the device rows, their busy
union, the idle gaps and what the host was doing in each, and device time
by named pass.

Frozen copies of the port's arithmetic: ``busy_union`` is
``chip_smoke.py device_busy``'s (the union of the device rows' intervals),
``scope_paths`` and ``pass_times`` are ``unclerenderer_tpu_torch/core/
traceparse.py``'s (a device row is tied to its launch by the correlation
id, and its path is the names of the host ranges around the launch; the
first pass name found in the path takes the row's time).
"""

from __future__ import annotations

import json
from collections import defaultdict

#: the frame's named passes (``core/passes.py named_pass``), as
#: ``core/traceparse.py PASS_NAMES`` lists them
PASS_NAMES = (
    "ShadowMap", "VisibilityRaster", "MaskedRaster", "MaterialResolve", "BuildHZB",
    "ShadowPCF", "IBLAmbient", "SkyAtmosphere", "TemporalAA", "AutoExposure", "Tonemap", "CAS",
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("user_annotation", "cpu_op", "python_function")


def load(path) -> list:
    with open(path) as fh:
        return json.load(fh).get("traceEvents", [])


def device_rows(events) -> list:
    """(start us, end us, name) of every device row, by start."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), str(e.get("name")))
                  for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)


def busy_union(rows) -> float:
    """Microseconds in which some device row ran: the union of the rows'
    intervals (``rows`` sorted by start)."""
    if not rows:
        return 0.0
    busy, end = 0.0, rows[0][0]
    for a, b, _name in rows:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def idle_gaps(rows, t0: float, t1: float) -> list:
    """(start us, length us) of each stretch of [t0, t1] in which no
    device row ran."""
    gaps, end = [], t0
    for a, b, _name in rows:
        if a > end:
            gaps.append((end, min(a, t1) - end))
        end = max(end, b)
        if end >= t1:
            break
    if end < t1:
        gaps.append((end, t1 - end))
    return [g for g in gaps if g[1] > 0]


def host_label(events, t: float, tid=None) -> str:
    """The innermost host range or op open at time ``t`` (on thread
    ``tid``, or any), with the ranges around it: "outer/inner", or
    "(host Python, no op)" when none is open."""
    around = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in HOST_CATS
              and (tid is None or e.get("tid") == tid)
              and float(e["ts"]) <= t < float(e["ts"]) + float(e.get("dur", 0.0))]
    if not around:
        return "(host Python, no op)"
    around.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
    return "/".join(str(e.get("name")) for e in around[-3:])


def short_name(name: str, keep: int = 120) -> str:
    """A device operation's name cut to ``keep`` characters (template
    arguments make some kernel names thousands long)."""
    return name if len(name) <= keep else name[:keep - 3] + "..."


def top_ops(rows, n: int = 10) -> list:
    """[name, seconds] of the ``n`` device operations that took most time."""
    by = defaultdict(float)
    for a, b, name in rows:
        by[short_name(name)] += b - a
    return [[k, v / 1e6] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _paths_at(ranges, times) -> list:
    """For each time in ``times``, the "/"-joined names of the ranges of one
    track around it, outermost first."""
    spans = sorted((float(e["ts"]), -float(e.get("dur", 0)), str(e.get("name", "")))
                   for e in ranges)
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [""] * len(times)
    stack, j = [], 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            start, neg_dur, name = spans[j]
            while stack and stack[-1][0] < start:
                stack.pop()
            stack.append((start - neg_dur, name))
            j += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        out[i] = "/".join(name for end, name in stack if end >= t)
    return out


def scope_paths(events) -> list:
    """(name, duration us, scope path) of every device row of a trace."""
    host = defaultdict(list)
    stream = defaultdict(list)
    launch = {}
    rows = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == "user_annotation":
            host[(e.get("pid"), e.get("tid"))].append(e)
        elif cat == "gpu_user_annotation":
            stream[(e.get("pid"), e.get("tid"))].append(e)
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = e
        elif cat in DEVICE_CATS:
            rows.append(e)
    queries = defaultdict(list)
    for i, e in enumerate(rows):
        src = launch.get((e.get("args") or {}).get("correlation"))
        if src is not None:
            queries[("host", (src.get("pid"), src.get("tid")))].append((i, float(src["ts"])))
        else:
            queries[("stream", (e.get("pid"), e.get("tid")))].append((i, float(e["ts"])))
    paths = [""] * len(rows)
    for (kind, track), qs in queries.items():
        ranges = (host if kind == "host" else stream).get(track, [])
        for (i, _t), path in zip(qs, _paths_at(ranges, [t for _i, t in qs])):
            paths[i] = path
    return [(str(e.get("name", "")), float(e.get("dur", 0)), path)
            for e, path in zip(rows, paths)]


def pass_times(events, n_frames: int, pass_names=PASS_NAMES) -> dict:
    """Device ms a frame by named pass, plus "(other)" and "(total)"; {}
    when the trace holds no device row."""
    sums: dict = defaultdict(float)
    total = 0.0
    for _name, dur_us, hay in scope_paths(events):
        if not dur_us:
            continue
        total += dur_us
        hit = next((p for p in pass_names if p in hay), None)
        sums[hit if hit is not None else "(other)"] += dur_us
    if not total:
        return {}
    out = {k: v / 1e3 / n_frames for k, v in sums.items()}
    out["(total)"] = total / 1e3 / n_frames
    return out
