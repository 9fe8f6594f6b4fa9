"""``device.idle_pct.clip``: ``readers.device_idle_pct``."""

from renderbench import readers

read = readers.device_idle_pct
