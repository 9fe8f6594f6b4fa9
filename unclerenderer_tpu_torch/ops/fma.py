"""Single-rounding f32 multiply-add, matching the reference's contractions.

XLA:CPU compiles the JAX package with LLVM floating-point contraction on, so
a jitted ``a*x + b*y + c`` runs as ``fma(a, x, b*y) + c``: the first add of
two products becomes an FMA whose addend is the SECOND product, every later
``+ p*q`` becomes ``fma(p, q, acc)``, a ``- p*q`` becomes ``fma(-p, q, acc)``
and an add of a non-product stays a plain add (measured against the
reference on 2^20 random operands: 0 differing results; the uncontracted
form differs in 14-28% of them).  Depth and triangle ids are bit-exact
contracts of the port, so every expression that feeds them spells its
contraction out with these helpers, and the CUDA kernels issue the same
``__fmaf_rn`` / ``__fmul_rn`` / ``__fadd_rn`` sequence (compiled with
``-fmad=false`` so nvcc adds no contraction of its own).

``fma`` is exact: the f64 product of two f32 values is exact, the f64 sum is
rounded to odd (TwoSum error term), and rounding a round-to-odd f64 to f32
is a correctly rounded single rounding (53 >= 24 + 2 bits).
"""

from __future__ import annotations

import numpy as np
import torch


def _f64(x):
    """An operand in f64: a tensor widened, a Python number rounded to f32
    (the value the reference's f32 operand holds) and kept on the host as a
    scalar, so that no constant is copied onto the device."""
    if isinstance(x, torch.Tensor):
        return x.double()
    return float(np.float32(x))


def fma(a, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` with one rounding (IEEE fusedMultiplyAdd); at
    least one operand is a tensor."""
    a, b, c = (_f64(t) for t in (a, b, c))
    u = a * b  # exact: 24 + 24 bits < 53
    v = c
    if isinstance(u, torch.Tensor) and isinstance(v, torch.Tensor):
        u, v = torch.broadcast_tensors(u, v)
    s = u + v
    bp = s - u
    err = (u - (s - bp)) + (v - bp)  # TwoSum: s + err == u + v exactly
    even = (s.contiguous().view(torch.int64) & 1) == 0
    bump = (err != 0) & even & torch.isfinite(s)
    inf = torch.full_like(s, float("inf"))
    odd = torch.where(bump, torch.nextafter(s, torch.where(err > 0, inf, -inf)), s)
    return odd.float()


def fdot(pairs, const=None) -> torch.Tensor:
    """``p0*q0 + p1*q1 + ... [+ const]`` contracted like XLA:CPU:
    ``fma(pn, qn, ... fma(p2, q2, fma(p0, q0, p1*q1)))`` then ``+ const``."""
    (p0, q0), rest = pairs[0], pairs[1:]
    if not rest:
        acc = p0 * q0
    else:
        p1, q1 = rest[0]
        acc = fma(p0, q0, p1 * q1)
        for p, q in rest[1:]:
            acc = fma(p, q, acc)
    if const is not None:
        acc = acc + const
    return acc


def fdiff(a, b, c, d) -> torch.Tensor:
    """``a*b - c*d`` contracted like XLA:CPU: ``fma(a, b, -(c*d))``."""
    return fma(a, b, -(c * d))
