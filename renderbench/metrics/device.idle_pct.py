"""``device.idle_pct``: ``readers.device_idle_pct``."""

from renderbench import readers

read = readers.device_idle_pct
