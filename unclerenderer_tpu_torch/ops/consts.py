"""Constant tensors that the frame reads, made once per device.

A frame that built ``torch.tensor([...], device=dev)`` from a host list on
every call would copy from pageable host memory onto the card each time: a
copy that waits for the device, and that a CUDA graph cannot capture.
``device_constant`` makes each such tensor once per (values, dtype, device)
and hands the same tensor back on every later call, so a captured frame
reads it from a fixed address.  Callers only read what it returns.
"""

from __future__ import annotations

import torch

_CACHE: dict = {}


def device_constant(values, device, dtype=torch.float32) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made on the
    first call for these (values, dtype, device) and shared after.
    ``values`` is a number or a nested tuple (hashable); the first call
    must not be under CUDA-graph capture (the frame's warm-up makes it)."""
    device = torch.device(device)
    key = (values, dtype, device)
    t = _CACHE.get(key)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"device_constant {values!r}: make it once outside CUDA-graph "
                               "capture first (a warm-up frame does)")
        t = _CACHE[key] = torch.tensor(values, dtype=dtype, device=device)
    return t
