"""Pass-name markers (``unclerenderer_tpu/core/passes.py``): the PIX
GPU-marker analog.

``named_pass(name)`` wraps a pass function, and ``scope(name)`` a block of
one, in a ``torch.profiler`` range (``record_function``), so a profiler
trace groups the kernels a pass launches under its name
(``core/traceparse.py`` buckets them; ``Renderer.profile_trace``).  With
no profiler running a range costs a few microseconds on the host and no
device work or synchronisation.  The open names also form a stack that
``scope_path`` reads, which the Renderer's graph dump writes beside each op.

Leaf module: every ``ops`` module can use it without the ``render`` layer.
"""

from __future__ import annotations

import contextlib
import functools

import torch

_OPEN: list = []  # the open pass and sub-scope names, outermost first


@contextlib.contextmanager
def scope(name: str):
    """``name`` as a profiler range around the block (the reference's
    ``jax.named_scope``), and on the stack of open names."""
    _OPEN.append(name)
    try:
        # looked up per call, so a caller may swap the range for a no-op
        with torch.autograd.profiler.record_function(name):
            yield
    finally:
        _OPEN.pop()


def scope_path() -> str:
    """The open names, outermost first, joined by "/" ("" outside any)."""
    return "/".join(_OPEN)


def named_pass(name: str):
    """Runs the decorated pass function inside ``scope(name)``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with scope(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco
