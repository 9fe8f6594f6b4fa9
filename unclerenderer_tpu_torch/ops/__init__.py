"""Tensor ops and kernel wrappers of the port (``unclerenderer_tpu/ops``)."""

from .raster import (
    CULL_BACK,
    CULL_FRONT,
    CULL_NONE,
    DEPTH_MAX,
    DEPTH_MIN,
    RasterSetup,
    rasterize,
    triangle_setup,
    triangle_setup_expanded,
    viewport_homogeneous,
)
