"""Carry scenes, frame parameters and frame state between the reference
package and the port, as numpy arrays.

``to_port(src, cls, device="cuda")`` reads every field of the port dataclass
``cls`` from ``src`` (any object with the same attribute names whose values
are array-likes, e.g. the reference's dataclasses of JAX arrays -- converted
through ``np.asarray``, so this module never imports JAX) and returns a
``cls`` of tensors on ``device`` (the card unless the caller names
another).  ``to_numpy(obj)`` goes back to a dict of
numpy arrays in the reference's dtypes.

Dtypes: bf16 leaves travel as their 16-bit patterns (ml_dtypes bfloat16 ->
uint16 view -> ``torch.bfloat16``), u8 atlases as they are, int32 stays
int32, bool stays bool; u32 (``object_ids``) widens to int64 because torch
has no general uint32 arithmetic.  The frame's ``object_id`` image is
uint32, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def array_to_tensor(x, device="cuda") -> torch.Tensor:
    # np.array(order="C") copies and keeps a 0-d array 0-d (ascontiguousarray
    # would make it (1,))
    a = np.array(x, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device)


def tensor_to_array(t: torch.Tensor, u32: bool = False) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
    a = t.numpy()
    return a.astype(np.uint32) if u32 else a


# fields that are uint32 in the reference
_U32_FIELDS = ("object_ids", "object_id")


def to_port(src, cls, device="cuda"):
    """Reference object (or dict) -> port dataclass ``cls`` on ``device``."""
    get = src.get if isinstance(src, dict) else (lambda k: getattr(src, k, None))
    vals = {}
    for f in dataclasses.fields(cls):
        v = get(f.name)
        vals[f.name] = None if v is None else array_to_tensor(v, device)
    return cls(**vals)


def to_numpy(obj) -> dict:
    """Port dataclass (or dict of tensors, nested dicts allowed) -> dict of
    numpy arrays in the reference's dtypes."""
    items = (
        obj.items() if isinstance(obj, dict)
        else ((f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj))
    )
    out = {}
    for k, v in items:
        if isinstance(v, dict):
            out[k] = to_numpy(v)
        elif isinstance(v, torch.Tensor):
            out[k] = tensor_to_array(v, u32=k in _U32_FIELDS)
        else:
            out[k] = v
    return out
