"""``material_tap.kernel_pixel_pct``: ``counters.ratio``, the percent of the
material tap's valid (pixel, slot) pairs that its two kernels took
(``tap_kernel_pixels`` over ``tap_pixels``); the rest took the plain path."""

from renderbench import counters

read = counters.ratio("tap_kernel_pixels", "tap_pixels", 100.0)
