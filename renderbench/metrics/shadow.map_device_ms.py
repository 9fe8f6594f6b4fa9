"""``shadow.map_device_ms``: ``readers.map_device_ms``."""

from renderbench import readers

read = readers.map_device_ms
