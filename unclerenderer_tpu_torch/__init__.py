"""UncleRenderer on PyTorch + CUDA: the port of ``unclerenderer_tpu`` to one
NVIDIA H100.

The JAX package stays the reference.  This package mirrors its layout
(``render/``, ``ops/``) and function names; plain tensor code is PyTorch and
every Pallas kernel on the ported path is a hand-written CUDA kernel under
``csrc/`` (built by ``ops/_cuda.py`` at first use).  It imports no JAX.

Entry point: ``render.deferred.deferred_frame(scene, params, state,
settings) -> (out, new_state)`` over ``render.params`` dataclasses of tensors.
"""

__version__ = "0.1.0"
