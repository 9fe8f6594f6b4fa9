"""Host cost of each piece of the kernel launch path (``ops/_cuda.py``),
the way the port launched its kernels before the launch path was bound
once (a ``Stream`` object per call, the entry looked up per call, a
``c_void_p`` per pointer, ``torch.device`` compares, ``empty_like`` with a
memory format, the GIL released around each call) and the way it does now.

Host microseconds per call on a (4, 4) int32 tensor, 5 runs of 2000 calls
with no synchronisation inside a run, the previous way and now taken in
turns.  Run from the repository root on a CUDA machine::

    python3 -m unclerenderer_tpu_torch.sweeps.launch_path [--out FILE.json]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json

import torch

from ..ops import _cuda, probes
from ..timing import host_us, in_turns, nvidia_smi


def pieces() -> dict:
    """piece -> (previous way, now), each a function of no arguments."""
    def old_on_cpu(t):
        return t.device.type == "cpu"

    def old_check(*tensors):
        d = tensors[0].device
        for t in tensors:
            if t.device != d or t.device.type != "cuda" or not t.is_contiguous():
                raise ValueError("bad input")

    _cuda.library()
    old_lib = ctypes.CDLL(str(_cuda.build()[0]))  # releases the GIL around each call
    old_lib.copy_bytes.argtypes = _cuda.SIGNATURES["copy_bytes"]
    old_lib.copy_bytes.restype = ctypes.c_int
    old_library = functools.lru_cache(maxsize=None)(lambda: old_lib)

    def old_launch(name, *args):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(old_library(), _cuda.ENTRY.get(name, name))(*args, stream)
        if err != 0:
            raise RuntimeError(f"cudaError {err}")

    def old_materialize(x):
        if old_on_cpu(x):
            return x.clone()
        old_check(x)
        y = torch.empty_like(x, memory_format=torch.contiguous_format)
        n = x.numel() * x.element_size()
        if n:
            old_launch("materialize", ctypes.c_void_p(x.data_ptr()),
                       ctypes.c_void_p(y.data_ptr()), n)
        return y

    x = torch.zeros((4, 4), dtype=torch.int32, device="cuda")
    y = torch.empty_like(x)
    quad = (x[0], x[1], x[2].float(), x[3].float())
    fn, cdll_fn = _cuda._FNS["materialize"], old_lib.copy_bytes
    raw = torch._C._cuda_getCurrentRawStream
    sp = torch.cuda.current_stream().cuda_stream
    return {
        "stream": (lambda: torch.cuda.current_stream().cuda_stream, lambda: raw(0)),
        "entry lookup": (lambda: getattr(old_library(), _cuda.ENTRY.get("materialize")),
                         lambda: _cuda._FNS.get("materialize")),
        "pointer": (lambda: ctypes.c_void_p(x.data_ptr()), x.data_ptr),
        "dispatch (on_cpu)": (lambda: old_on_cpu(x), lambda: _cuda.on_cpu("materialize", x)),
        "check, 1 tensor": (lambda: old_check(x), lambda: _cuda.check_cuda("materialize", x)),
        "check, 4 tensors": (lambda: old_check(*quad),
                             lambda: _cuda.check_cuda("merge_select", *quad)),
        "allocation": (lambda: torch.empty_like(x, memory_format=torch.contiguous_format),
                       lambda: torch.empty_like(x)),
        "ctypes call, no kernel": (
            lambda: cdll_fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()), 0, sp),
            lambda: fn(x.data_ptr(), y.data_ptr(), 0, sp)),
        "ctypes call + kernel launch": (
            lambda: cdll_fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()), 64, sp),
            lambda: fn(x.data_ptr(), y.data_ptr(), 64, sp)),
        "GIL released (CDLL) vs kept (PyDLL), kernel launch": (
            lambda: cdll_fn(x.data_ptr(), y.data_ptr(), 64, sp),
            lambda: fn(x.data_ptr(), y.data_ptr(), 64, sp)),
        "whole wrapper (materialize)": (lambda: old_materialize(x), lambda: probes.materialize(x)),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("launch_path sweep: needs a CUDA card")
    smi = nvidia_smi()
    timer = functools.partial(host_us, calls=2000, blocks=5)
    result = {"device": smi, "us_per_call": {}}
    print(f"launch path, host us per call ({smi}):")
    for piece, (old, new) in pieces().items():
        old_us, new_us = in_turns(old, new, timer)
        result["us_per_call"][piece] = {"previous": old_us, "now": new_us}
        print(f"  {piece:52s} {old_us:7.3f} previously, {new_us:7.3f} now")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
