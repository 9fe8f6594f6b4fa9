"""``aniso.taps_per_pixel``: ``counters.ratio``, the trilinear taps the
anisotropic material tap took over its valid (pixel, slot) pairs."""

from renderbench import counters

read = counters.ratio("aniso_taps", "aniso_pixels")
