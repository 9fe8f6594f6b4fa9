"""Per-pass device time from a ``torch.profiler`` trace
(``unclerenderer_tpu/core/traceparse.py``).

``Renderer.profile_trace`` records rendered frames with ``torch.profiler``
and writes its Chrome trace (``*.pt.trace.json``, or ``.json.gz``).
Every ``named_pass`` and sub-scope (``core/passes.py``) is a
``record_function`` range there: a ``user_annotation`` event on the host
thread that made the pass's launches.  A device row -- an event of category
``kernel``, ``gpu_memcpy`` or ``gpu_memset`` -- is tied to its launch by
its ``correlation`` id (the ``cuda_runtime`` or ``cuda_driver`` event of
the same id, on that host thread; the kernels of ``ops/_cuda.py`` are
launched by the CUDA runtime too), and its scope path is the names of the
ranges that enclose the launch, outermost first.  A row whose launch is
not in the trace falls back to the ``gpu_user_annotation`` ranges around it
on its device stream, where this PyTorch emits them.  The bucketing is the
reference's: the first entry of ``pass_names`` found in the path takes the
row's duration, else ``"(other)"``; ``"(total)"`` sums every row; times
are per frame.  A trace with no device row (a CPU run) gives ``{}``, as the
reference's CPU backend does.
"""

from __future__ import annotations

import gzip
import json
from collections import defaultdict
from pathlib import Path

#: every named_pass of the reference package (the port wraps the same
#: functions; ShadowPCF's second, the XLA path's, has no port)
PASS_NAMES = (
    "ShadowMap",
    "VisibilityRaster",
    "MaskedRaster",
    "MaterialResolve",
    "BuildHZB",
    "ShadowPCF",
    "IBLAmbient",
    "SkyAtmosphere",
    "TemporalAA",
    "AutoExposure",
    "Tonemap",
    "CAS",
)

#: the port's own sub-scopes, which the reference has no counterpart of:
#: the anisotropic tap's, nested in ``MaterialTap``
PORT_SUB_SCOPES = ("AnisoFootprint", "AnisoTaps")

#: nested sub-scopes, listed BEFORE the passes so the first-match
#: attribution picks the finer bucket (deepest first); the reference's
#: after the port's own
SUB_SCOPES = PORT_SUB_SCOPES + (
    "Untile", "LevelMerge", "GpuDebugPrint", "GiantCompact", "GiantKernel",
    "RecGather", "InterpAttr", "MaterialTap", "NormalMap",
    "FineBinning", "RasterKernel", "MidLevel", "GiantLevel", "Compaction",
    "VertexSetup", "ShadowPack", "DirectLighting",
)
PASS_NAMES_FINE = SUB_SCOPES + PASS_NAMES

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def find_trace_file(trace_dir) -> Path | None:
    """The newest ``*.trace.json`` or ``*.trace.json.gz`` under
    ``trace_dir``."""
    hits = [p for pat in ("*.trace.json", "*.trace.json.gz") for p in Path(trace_dir).rglob(pat)]
    hits.sort(key=lambda p: p.stat().st_mtime)
    return hits[-1] if hits else None


def load_events(path) -> list:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as fh:
        return json.load(fh).get("traceEvents", [])


def _paths_at(ranges, times) -> list:
    """For each time in ``times``, the "/"-joined names of the ranges of one
    track around it, outermost first.  A track's ranges nest (they are the
    scopes of one thread or stream), so one sweep with a stack finds them."""
    spans = sorted((float(e["ts"]), -float(e.get("dur", 0)), str(e.get("name", "")))
                   for e in ranges)
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [""] * len(times)
    stack, j = [], 0  # open (end, name), outermost first
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
    host = defaultdict(list)     # (pid, tid) -> user_annotation events
    stream = defaultdict(list)   # (pid, tid) -> gpu_user_annotation events
    launch = {}                  # correlation id -> launch event
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
    # each row's query: (track ranges, track key, time)
    queries = defaultdict(list)  # (kind, track) -> [(row index, time)]
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


def parse_pass_times(trace_dir, pass_names=PASS_NAMES, n_frames: int = 1,
                     other_top: list | None = None) -> dict:
    """Device time per named pass from the newest trace under ``trace_dir``:
    ``{pass: ms}`` per frame, plus ``"(other)"`` (rows in no pass) and
    ``"(total)"``; ``{}`` without a trace or device rows.  ``other_top``
    collects the (us, path) of the unattributed rows."""
    f = find_trace_file(trace_dir)
    if f is None:
        return {}
    sums: dict = defaultdict(float)
    total = 0.0
    for _name, dur_us, hay in scope_paths(load_events(f)):
        if not dur_us:
            continue
        total += dur_us
        hit = next((p for p in pass_names if p in hay), None)
        sums[hit if hit is not None else "(other)"] += dur_us
        if hit is None and other_top is not None:
            other_top.append((dur_us, hay))
    if not total:
        return {}
    out = {k: v / 1e3 / max(n_frames, 1) for k, v in sums.items()}
    out["(total)"] = total / 1e3 / max(n_frames, 1)
    return out
