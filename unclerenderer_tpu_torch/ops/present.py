"""The present's u8 conversion: a frame's colour as the UNORM backbuffer
stores it, ``clip(rint(x * 255), 0, 255)`` as uint8, round half to even
(``unclerenderer_tpu/render/renderer.py:779``).

* ``to_u8_host`` -- the conversion of a float image on the host (the CPU
  Renderer's present, the overlays composited on the host, the CLI's orbit
  PNGs);
* ``present_u8`` -- the card's conversion, a kernel (``csrc/present_u8.cu``;
  not a TPU kernel: the reference converts on the host), with its plain
  version ``present_u8_ref`` beside it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda


def to_u8_host(img: np.ndarray) -> np.ndarray:
    """A float image on the host as uint8: the product by 255 in the
    image's precision, rounded half to even, clipped to [0, 255]."""
    return np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)


def present_u8_ref(color: torch.Tensor) -> torch.Tensor:
    """Plain version of ``present_u8``: the same formula in torch, NaN sent
    to 0 (numpy's cast gives 0 on x86-64; torch's is undefined)."""
    y = torch.round(color * 255.0).clamp_(0.0, 255.0)
    return torch.nan_to_num_(y, nan=0.0).to(torch.uint8)


def present_u8(color: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """A float32 colour of any shape as uint8 of the same shape, byte-equal
    to ``to_u8_host`` on every finite value (+-inf to 255 and 0, NaN to 0).
    The port's frames are float32: any other dtype raises rather than
    converting.  On the card one launch writes ``out`` (a contiguous uint8
    tensor of the colour's shape on its device; None allocates one); on the
    CPU the plain version."""
    if color.dtype != torch.float32:
        raise TypeError(f"present_u8: expects a float32 colour, got {color.dtype}")
    if _cuda.on_cpu("present_u8", color):
        return present_u8_ref(color) if out is None else out.copy_(present_u8_ref(color))
    if out is None:
        out = torch.empty(color.shape, dtype=torch.uint8, device=color.device)
    elif out.dtype != torch.uint8 or out.shape != color.shape:
        raise ValueError(f"present_u8: out must be uint8 of shape {tuple(color.shape)}, got "
                         f"{out.dtype} {tuple(out.shape)}")
    dev = _cuda.check_cuda("present_u8", color, out)
    if color.numel():
        _cuda.launch("present_u8", dev, color.data_ptr(), out.data_ptr(), color.numel())
    return out
