"""``program.frame_device_ms``: ``readers.frame_device_ms``."""

from renderbench import readers

read = readers.frame_device_ms
