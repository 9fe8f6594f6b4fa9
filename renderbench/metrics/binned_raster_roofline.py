"""``binned_raster_roofline``: ``readers.binned_raster_roofline``."""

from renderbench import readers

CALLS = readers.BINNED_CALLS
read = readers.binned_raster_roofline
