"""``interp_attr.kernel_pixel_pct``: ``counters.ratio``, the percent of the
resolve's valid pixels whose attributes its kernel R1 interpolated
(``attr_kernel_pixels`` over ``attr_pixels``); the rest took the plain path."""

from renderbench import counters

read = counters.ratio("attr_kernel_pixels", "attr_pixels", 100.0)
