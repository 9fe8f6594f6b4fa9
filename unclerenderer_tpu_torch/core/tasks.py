"""Host task pool for asset IO (``unclerenderer_tpu/core/tasks.py``): the
D3D12 renderer's ``FTaskScheduler`` (hardware threads - 1 workers) and
``FParallelFor``, used as it uses them: parallel texture decode and
material fusing at scene load.  The native decoders (ctypes calls) release
the interpreter lock, so threads decode in parallel.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Sequence

_scheduler: ThreadPoolExecutor | None = None
_scheduler_lock = threading.Lock()
_enabled = True


def set_task_system_enabled(flag: bool) -> None:
    """Honours the UseTaskSystem config key: when off, ``schedule_task`` and
    ``parallel_map`` run synchronously on the caller."""
    global _enabled
    _enabled = bool(flag)


def get_scheduler() -> ThreadPoolExecutor:
    """The process's pool, (hardware threads - 1) workers, made at first use."""
    global _scheduler
    with _scheduler_lock:
        if _scheduler is None:
            workers = max(1, (os.cpu_count() or 2) - 1)
            _scheduler = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="task")
        return _scheduler


def schedule_task(fn: Callable, *args, **kwargs) -> Future:
    """One task on the pool; with the task system off it runs inline and
    returns a completed future (its exception, if any, stored in it)."""
    if not _enabled:
        f: Future = Future()
        try:
            f.set_result(fn(*args, **kwargs))
        except Exception as e:  # stored for the caller, as the pool would
            f.set_exception(e)
        return f
    return get_scheduler().submit(fn, *args, **kwargs)


def parallel_map(fn: Callable, items: Sequence, use_tasks: bool = True) -> list:
    """``[fn(x) for x in items]`` on the pool.  Serial when the task system
    is off, for one item, and on a pool worker itself (a task -- e.g. a
    background scene reload -- that waited on futures queued behind it
    would deadlock a small pool)."""
    on_pool_worker = threading.current_thread().name.startswith("task")
    if not _enabled or not use_tasks or len(items) <= 1 or on_pool_worker:
        return [fn(it) for it in items]
    return list(get_scheduler().map(fn, items))
