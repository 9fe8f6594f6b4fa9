"""Timing on the card, shared by ``chip_smoke.py`` and the kernel design
sweeps (``unclerenderer_tpu_torch/sweeps``)."""

from __future__ import annotations

import statistics
import subprocess
import time

import torch


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn`` without the host's launch cost:
    ``reps`` calls captured in one CUDA graph, replayed, timed with CUDA
    events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = cuda_ms(graph.replay, reps=3)
    del graph
    return ms / reps


def host_us(fn, calls: int = 1000, blocks: int = 3) -> float:
    """Host microseconds per call of ``fn``: ``blocks`` runs of ``calls``
    calls with no synchronisation inside a run, median over the runs."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def in_turns(a, b, timer=host_us) -> tuple[float, float]:
    """``timer`` of ``a`` and ``b`` taken in turns (a, b, b, a), each the
    mean of its two runs."""
    a1, b1, b2, a2 = timer(a), timer(b), timer(b), timer(a)
    return (a1 + a2) / 2, (b1 + b2) / 2
