"""Pass-name markers (``unclerenderer_tpu/core/passes.py``): the PIX
GPU-marker analog, and the port's one tracing system.

``named_pass(name)`` wraps a pass function, and ``scope(name)`` a block of
one, in a ``torch.profiler`` range (``record_function``), so a profiler
trace groups the kernels a pass launches under its name
(``core/traceparse.py`` buckets them; ``Renderer.profile_trace``).  The
range is entered only while a profiler records (``tracing()``): otherwise
a scope costs that one check.  The open names also form a stack that
``scope_path`` reads, which the Renderer's graph dump writes beside each op.
The Renderer and the programs open host spans the same way (dotted names:
``Renderer.frame``, ``FrameProgram.replay``, ...), so a trace names what
the host did inside a call.

A graph replay records no range, so a captured program times its passes
on the device instead: while ``DeviceSpans.capturing`` is open (the
capture of ``render/program.py``), ``scope`` records a timing CUDA event
(``external=True``: an event record node of the graph) at the entry and
the exit of every top-level ``named_pass`` and of the material resolve's
sub-scopes (``TIMED_SUB_SCOPES``), beside the program's first and last
events.  Entry and exit are paired by the call stack, never by name
(``ShadowPCF`` names three nested functions).  After a replay the events
are read where the work happens, never with a host sync: at the
program's next replay, or at ``collect()``, a replay whose last event has
completed goes into ``STORE`` as ``DeviceSpan`` records; one that has not
(back-to-back replays overwrite the events) is counted as unread.  Each
program counts its replays read and unread.  ``DeviceSpans.running``
times an op-by-op run the same way, with events recorded afresh.

Tracing is on while a ``torch.profiler`` session records, or where a
program's ``sink`` is set (the Renderer's GpuTiming); off, a replay costs
one check.  ``STORE``'s records take their launch time from
``time.time_ns()``, the clock of the profiler's Chrome trace: a trace's
``ts`` is ``time.time_ns() / 1e3`` less its ``baseTimeNanoseconds / 1e3``.

``COUNTERS`` holds a frame's device counters (the resolve's interpolated
and tapped pixels, those its kernels took, and the anisotropic tap's pixel
and tap counts, ``render/common.py resolve_materials``): the Renderer adds
each frame's to the store's running sums on the device while a profiler
records, and ``totals()`` reads the sums once, after the frames.

Leaf module: every ``ops`` module can use it without the ``render`` layer.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import NamedTuple

import torch

_OPEN: list = []  # the open pass and sub-scope names, outermost first
_PASSES = [0]  # named_pass scopes open
_CAPTURING: list = []  # the DeviceSpans of the capture in progress
_PENDING: list = []  # DeviceSpans whose last replay is unread
_NO_RANGE = contextlib.nullcontext()

#: the material resolve's sub-scopes, timed in a captured frame (the
#: anisotropic ones inside each ``MaterialTap``)
TIMED_SUB_SCOPES = ("RecGather", "InterpAttr", "MaterialTap", "NormalMap", "AnisoFootprint",
                    "AnisoTaps")
#: the most timing events a program records (its first and last included):
#: those of the masked anisotropic frame with a tap per material slot, whose
#: 26 spans are the most a frame opens
MAX_EVENTS = 54


@contextlib.contextmanager
def scope(name: str, _pass: bool = False):
    """``name`` on the stack of open names and, while a profiler records,
    as a profiler range around the block (the reference's
    ``jax.named_scope``); inside a capture, a timed span of the program
    where ``name`` is a top-level pass or a timed sub-scope."""
    _OPEN.append(name)
    timed = _CAPTURING and (name in TIMED_SUB_SCOPES or (_pass and not _PASSES[0]))
    spans = _CAPTURING[-1] if timed else None
    _PASSES[0] += _pass
    try:
        # looked up per call, so a caller may swap the range for a no-op
        rng = torch.autograd.profiler.record_function(name) if tracing() else _NO_RANGE
        with rng:
            mark = spans.enter(name) if spans is not None else None
            yield
            if mark is not None:
                spans.exit(mark)
    finally:
        _PASSES[0] -= _pass
        _OPEN.pop()


def scope_path() -> str:
    """The open names, outermost first, joined by "/" ("" outside any)."""
    return "/".join(_OPEN)


def named_pass(name: str):
    """Runs the decorated pass function inside ``scope(name)``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with scope(name, _pass=True):
                return fn(*args, **kwargs)

        return wrapper

    return deco


class DeviceSpan(NamedTuple):
    """One span of a replay read from its events: ``name`` is a pass or
    sub-scope, or the program's own name for its first-to-last span;
    ``start_ms`` its start after the program's first event, ``ms`` its
    length; ``t_ns`` the replay's launch time (``time.time_ns()``)."""

    program: str
    frame: int
    name: str
    start_ms: float
    ms: float
    t_ns: int


class SpanStore:
    """The replays' device spans, the newest ``limit``, in memory."""

    def __init__(self, limit: int = 16384):
        self.records: collections.deque = collections.deque(maxlen=limit)

    def reset(self) -> None:
        self.records.clear()

    def spans(self, program: str) -> dict:
        """``{frame: {name: ms}}`` of ``program``'s read replays, the ms of
        a name that recurs in a replay summed."""
        out: dict = collections.defaultdict(lambda: collections.defaultdict(float))
        for r in self.records:
            if r.program == program:
                out[r.frame][r.name] += r.ms
        return out


STORE = SpanStore()


def tracing() -> bool:
    """Whether a ``torch.profiler`` session is recording."""
    return torch.autograd._profiler_enabled()


def _timing_event():
    return torch.cuda.Event(enable_timing=True, external=True)


class DeviceSpans:
    """The timing events of one captured program (``program``: its name in
    the records), the replay whose events are to be read, and the counts
    of replays read and unread.  ``sink``, where set, takes each read
    replay's records too and keeps tracing on.  ``event`` makes an event (a
    test passes a fake)."""

    def __init__(self, program: str, event=_timing_event):
        self.program = program
        self.sink = None
        self._event = event
        self._marks: list = []  # [name, start event, end event or None]
        self._first = self._last = None
        self._pending = None  # (frame, launch ns) of the replay not yet read
        self._replays = 0
        self.read = self.unread = 0

    def _record(self):
        e = self._event()
        e.record()
        return e

    @contextlib.contextmanager
    def capturing(self):
        """The block (inside a graph capture, or op by op in ``running``)
        between the program's first and last events, its scopes timed."""
        self._first = self._record()
        _CAPTURING.append(self)
        try:
            yield
        finally:
            _CAPTURING.pop()
        self._last = self._record()

    def enter(self, name: str):
        """The span ``name`` opened: its mark, or None past the cap."""
        if 2 * (len(self._marks) + 2) > MAX_EVENTS:
            return None
        self._marks.append([name, self._record(), None])
        return self._marks[-1]

    def exit(self, mark) -> None:
        mark[2] = self._record()

    def events(self) -> int:
        """The timing events the program records a replay."""
        return 2 * len(self._marks) + (self._first is not None) + (self._last is not None)

    def launch(self) -> None:
        """Called just before the graph is replayed: the previous replay's
        events are read (or counted unread: this replay overwrites them),
        and this replay's are kept to read where tracing is on."""
        if self._pending is not None:
            self.settle()
        if self._last is not None and (self.sink is not None or tracing()):
            self._pending = (self._replays, time.time_ns())
            _PENDING.append(self)
        self._replays += 1

    @contextlib.contextmanager
    def running(self):
        """The block run op by op and timed as a replay is: its events
        recorded afresh around it (the previous run's read first), read at
        the next run or at ``collect()``."""
        if self._pending is not None:
            self.settle()
        self._marks = []
        t_ns = time.time_ns()
        with self.capturing():
            yield
        self._pending = (self._replays, t_ns)
        _PENDING.append(self)
        self._replays += 1

    def settle(self, wait: bool = False) -> list:
        """Read the pending replay's events into ``STORE`` (and ``sink``)
        if its last event has completed (``wait``: once it has), else count
        it unread; the records read."""
        frame, t_ns = self._pending
        self._pending = None
        _PENDING.remove(self)
        if wait:
            self._last.synchronize()
        elif not self._last.query():
            self.unread += 1
            return []
        first = self._first
        recs = [DeviceSpan(self.program, frame, self.program, 0.0, first.elapsed_time(self._last),
                           t_ns)]
        recs += [DeviceSpan(self.program, frame, name, first.elapsed_time(a), a.elapsed_time(b),
                            t_ns) for name, a, b in self._marks]
        STORE.records.extend(recs)
        self.read += 1
        if self.sink is not None:
            self.sink(recs)
        return recs


def collect(wait: bool = False) -> None:
    """Read every program's pending replay (``DeviceSpans.settle``;
    ``wait``: once it has completed, a host sync)."""
    for spans in list(_PENDING):
        spans.settle(wait)


class CounterStore:
    """Running sums of the frames' device counters, kept on the device:
    ``add`` launches one add a counter and reads nothing back."""

    def __init__(self):
        self.sums: dict = {}

    def reset(self) -> None:
        self.sums.clear()

    def add(self, counters: dict) -> None:
        for k, v in counters.items():
            self.sums[k] = self.sums[k] + v if k in self.sums else v.clone()

    def totals(self) -> dict:
        """``{name: int}`` of the sums (a host sync)."""
        return {k: int(v) for k, v in self.sums.items()}


COUNTERS = CounterStore()
