"""Tensor ops and kernel wrappers of the port (``unclerenderer_tpu/ops``)."""
