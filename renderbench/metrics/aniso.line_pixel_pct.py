"""``aniso.line_pixel_pct``: ``counters.ratio``, the percent of the
anisotropic tap's valid (pixel, slot) pairs whose footprint is anisotropic
(extent > 0: its taps not coincident)."""

from renderbench import counters

read = counters.ratio("aniso_line_pixels", "aniso_pixels", 100.0)
